// Phased FIR as a fused fabric + array kernel (paper Fig 3b with the phased
// mapping) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fir_conv_pallas of the JAX package,
// src/repro/kernels/fir_conv/kernel.py.  One window of L = taps + P - 1
// input samples produces P outputs through an (L, P) tap bank whose
// structural zeros stand for the DPU's pad constants:
//   out[b, m * P + p] = sum_l wbank[l, p] * (idx[m, l] < 0 ? 0
//                                            : x[b, idx[m, l]])
// with x (batch, n) float32, idx (M, L) int32 (PAD = -1 reads as 0), wbank
// (L, P) float32 and out (batch, M * P) float32.
//
// What bounds it on this card: bytes and launch latency.  The Fig-9 front
// end (batch 4, n 4096, 9 taps, P 8: 512 windows of 16) reads 64 KB of
// signal and 32 KB of window indices and writes 64 KB, about 0.05 us at
// 3.35 TB/s.  The design is one thread per output (b, m, p): the P threads
// of one window read the same L indices and samples (a broadcast within the
// warp) and their own tap-bank column, accumulating in float32 in the order
// l = 0..L-1.  The ragged edge is masked, so no window row is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fir_conv_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                const float* __restrict__ wbank, float* __restrict__ out,
                int n, int m, int win, int phases) {
  const int64_t per_batch = static_cast<int64_t>(m) * phases;
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= per_batch) return;
  const int64_t b = blockIdx.y;
  const int64_t row = e / phases;
  const int p = static_cast<int>(e - row * phases);
  const float* xb = x + b * n;
  const int32_t* ri = idx + row * win;
  float acc = 0.f;
  for (int l = 0; l < win; ++l) {
    const int32_t i = ri[l];
    const float v = i < 0 ? 0.f : xb[i];
    acc = fmaf(v, wbank[static_cast<int64_t>(l) * phases + p], acc);
  }
  out[b * per_batch + e] = acc;
}

}  // namespace

extern "C" {

// x (batch, n) float32; idx (m, win) int32 in [-1, n); wbank (win, phases)
// float32; out (batch, m * phases) float32.  Returns the cudaGetLastError()
// code of the launch (0 = success).
int repro_fir_conv(const void* x, const void* idx, const void* wbank,
                   void* out, int batch, int n, int m, int win, int phases,
                   void* stream) {
  const int64_t per_batch = static_cast<int64_t>(m) * phases;
  const dim3 grid(static_cast<unsigned>((per_batch + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  fir_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<const float*>(wbank), static_cast<float*>(out), n, m, win,
      phases);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
