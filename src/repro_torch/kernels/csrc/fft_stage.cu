// One radix-2 DIT FFT stage as a fused fabric + array kernel (paper Fig 3a)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fft_stage_pallas of the JAX package,
// src/repro/kernels/fft_stage/kernel.py.  A stage gathers the butterfly
// pairs of an interleaved-real signal of length 2n, grouped by twiddle class
// (the stage's composed shuffle plan), and multiplies each (nb, 4) block of
// class j by that class's 4x4 real butterfly matrix:
//   y[b, ((j * nb + blk) * 4 + o)] =
//       sum_i tw[j, o, i] * x[b, idx[(j * nb + blk) * 4 + i]]
// with x, y (batch, 2n) float32, idx (2n,) int32 (the PAD entries of the
// plan are clipped to index 0 by the wrapper, as the JAX package does; their
// twiddle column is zero) and tw (half, 4, 4) float32.  The output is in the
// flat (j, blk, o) layout the next stage's composed gather reads.
//
// What bounds it on this card: bytes and, below them, launch latency.  A
// stage of the Fig-9 STFT frames (batch 124, n 256) moves about 0.5 MB and
// does 8 flops per output element, so it is a fraction of a microsecond at
// 3.35 TB/s.  The design is one thread per output element (b, e): the four
// threads of one (j, blk) row read the same four gathered inputs (a
// broadcast within the warp) and their own twiddle row, and accumulate in
// float32 in the order i = 0..3.  Keeping the whole FFT (all log2 n stages)
// in shared memory in one launch is left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fft_stage_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                 const float* __restrict__ tw, float* __restrict__ y, int n2,
                 int nb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n2) return;
  const int64_t b = blockIdx.y;
  const int row = e >> 2;          // (j * nb + blk)
  const int o = e & 3;
  const int j = row / nb;
  const float* xb = x + b * n2;
  const int32_t* ri = idx + 4 * row;
  const float* t = tw + (16 * j + 4 * o);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc = fmaf(t[i], xb[ri[i]], acc);
  y[b * n2 + e] = acc;
}

}  // namespace

extern "C" {

// x, y (batch, n2) float32 with n2 = 2n = half * nb * 4; idx (n2,) int32 in
// [0, n2); tw (half, 4, 4) float32.  Returns the cudaGetLastError() code of
// the launch (0 = success).
int repro_fft_stage(const void* x, const void* idx, const void* tw, void* y,
                    int batch, int n2, int nb, void* stream) {
  const dim3 grid(static_cast<unsigned>((n2 + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  fft_stage_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<const float*>(tw), static_cast<float*>(y), n2, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
