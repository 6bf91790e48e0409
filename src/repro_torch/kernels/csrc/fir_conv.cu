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
// (L, P) float32 and out (batch, M * P) float32.  The index table is read,
// not derived from the FIR plan, because the TPU kernel takes any table.
//
// What bounds it on this card: launch latency, then the chain of dependent
// loads.  The Fig-9 front end (batch 4, n 4096, 9 taps, P 8: 512 windows of
// 16) reads 64 KB of signal and 32 KB of window indices and writes 64 KB,
// about 0.05 us at 3.35 TB/s, against a launch floor of about 1.2 us (an
// 8 x 128 copy).  So the design keeps the dependent steps after the launch
// to two round trips to memory, indices then samples: one thread an output,
// 64 threads (64 / P windows) a block, 256 blocks over the 132 SMs at Fig
// 9's input; L and P are template parameters, so each thread loads its
// window's L indices as 16-byte loads (the P threads of a window read the
// same ones, one transaction), its L taps beside them, then issues all L of
// its signal loads before its first FMA, and sums in float32 in the order l
// = 0..L-1, the order of the generic body and of the kernel this one
// replaced.  Staging a block's indices and taps in shared memory first was
// measured on the H100 and ran 0.1-0.2 us slower: the barrier and the
// shared-memory round trip sit on the chain.  Shapes without an
// instantiation take the generic body, the kernel this file held before the
// unrolled one: one thread an output, 256 threads a block, a runtime loop
// over l (the P threads of a window read the same indices and samples, a
// broadcast within the warp).  The ragged edge is masked, so no window row
// is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kGenericThreads = 256;

template <int L, int P>
__global__ void __launch_bounds__(kThreads)
fir_conv_unrolled(const float* __restrict__ x,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ wbank, float* __restrict__ out,
                  int n, int m) {
  static_assert(kThreads % P == 0 && L % 4 == 0, "P | block, 4 | L");
  constexpr int R = kThreads / P;            // windows a block
  const int r = threadIdx.x / P, p = threadIdx.x - r * P;
  const int row = blockIdx.x * R + r;
  if (row >= m) return;
  const int4* ri = reinterpret_cast<const int4*>(idx) +
                   static_cast<int64_t>(row) * (L / 4);
  int32_t iv[L];
  float wv[L], xv[L];
#pragma unroll
  for (int l = 0; l < L; l += 4) {
    const int4 w = __ldg(ri + l / 4);
    iv[l] = w.x;
    iv[l + 1] = w.y;
    iv[l + 2] = w.z;
    iv[l + 3] = w.w;
  }
#pragma unroll
  for (int l = 0; l < L; ++l) wv[l] = __ldg(wbank + l * P + p);
  const float* xb = x + static_cast<int64_t>(blockIdx.y) * n;
#pragma unroll
  for (int l = 0; l < L; ++l) xv[l] = iv[l] < 0 ? 0.f : __ldg(xb + iv[l]);
  float acc = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) acc = fmaf(xv[l], wv[l], acc);
  out[(static_cast<int64_t>(blockIdx.y) * m + row) * P + p] = acc;
}

__global__ void __launch_bounds__(kGenericThreads)
fir_conv_generic(const float* __restrict__ x,
                 const int32_t* __restrict__ idx,
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

template <int L, int P>
int launch_unrolled(const void* x, const void* idx, const void* wbank,
                    void* out, int batch, int n, int m, cudaStream_t stream) {
  constexpr int R = kThreads / P;
  const dim3 grid(static_cast<unsigned>((m + R - 1) / R),
                  static_cast<unsigned>(batch));
  fir_conv_unrolled<L, P><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<const float*>(wbank), static_cast<float*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (batch, n) float32; idx (m, win) int32 in [-1, n); wbank (win, phases)
// float32; out (batch, m * phases) float32.  (win, phases) = (16, 8), Fig
// 9's 9 taps at 8 phases, takes the unrolled body when idx is 16-byte
// aligned, every other call the generic one.  Returns the
// cudaGetLastError() code of the launch (0 = success).
int repro_fir_conv(const void* x, const void* idx, const void* wbank,
                   void* out, int batch, int n, int m, int win, int phases,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win == 16 && phases == 8 && reinterpret_cast<uintptr_t>(idx) % 16 == 0)
    return launch_unrolled<16, 8>(x, idx, wbank, out, batch, n, m, s);
  const int64_t per_batch = static_cast<int64_t>(m) * phases;
  const dim3 grid(
      static_cast<unsigned>((per_batch + kGenericThreads - 1) /
                            kGenericThreads),
      static_cast<unsigned>(batch));
  fir_conv_generic<<<grid, kGenericThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<const float*>(wbank), static_cast<float*>(out), n, m, win,
      phases);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
