// Fused shuffling-fabric gather + GEMM (paper §V) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package,
// src/repro/kernels/shuffle_gemm/kernel.py:
//   * shuffle_gemm_blocks          — one (t, n_out) operand shared by every
//                                    row (FIR taps, mel filterbank, DCT, DWT,
//                                    block-circulant dnn);
//   * shuffle_gemm_grouped_blocks  — a grouped (G, t, n_out) operand; row r
//                                    in flat (reps, G, nb) order contracts
//                                    against w[(r / nb) % G] (the FFT
//                                    butterflies).
// Both compute, per batch row b and output row r,
//   out[b, r, :] = (where(idx[r, :] < 0, pad[r, :], x[b, idx[r, :]])
//                   * scale[r, :]) @ w[g(r)]
// and the blocks form is the grouped form with G = 1, nb = R, reps = 1 (its
// (B, R, n_out) output has the same memory as the flat (B, R * n_out) one),
// so one kernel body serves both; each keeps its own C entry point.
//
// What bounds it on this card: memory traffic and launch latency, not
// arithmetic.  The contractions are tiny (t = 4..129, n_out = 1..24 on the
// Fig-9 path): a grouped call at B = 4 moves about 0.57 MB (x 254 KB, idx
// 63 KB, out 254 KB; pad is read only at its PAD entries), about 0.2 us at
// 3.35 TB/s, so the few-us launch dominates.  The design is therefore the simplest correct one: one
// thread per output element (b, r, o); the thread walks the t gathered
// inputs of its row, takes the pad constant where idx < 0, applies the
// per-element scale, and accumulates in float32 against w[g(r)].  Threads of
// one row read the same idx/pad/scale words (broadcast within the warp) and
// neighbouring rows read neighbouring words.  The ragged edge of the last
// block is masked in the kernel, so rows need no padding to a tile multiple.
// float32 and bfloat16 are accepted; both accumulate in float32 and store in
// the input type.  Staging x and w in shared memory, and tensor-core
// (wgmma) contraction for wide operands, are left to a later tuning pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
shuffle_gemm_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                    const T* __restrict__ pad, const T* __restrict__ scale,
                    const T* __restrict__ w, T* __restrict__ out, int n_in,
                    int rows, int t, int n_out, int groups, int nb) {
  const int64_t per_batch = static_cast<int64_t>(rows) * n_out;
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= per_batch) return;
  const int64_t b = blockIdx.y;
  const int r = static_cast<int>(e / n_out);
  const int o = static_cast<int>(e - static_cast<int64_t>(r) * n_out);
  const int g = (r / nb) % groups;
  const T* xb = x + b * n_in;
  const int64_t row = static_cast<int64_t>(r) * t;
  const T* wg = w + static_cast<int64_t>(g) * t * n_out + o;
  float acc = 0.f;
  for (int k = 0; k < t; ++k) {
    const int32_t i = idx[row + k];
    float v = i < 0 ? to_f32(pad[row + k]) : to_f32(xb[i]);
    if (scale != nullptr) v *= to_f32(scale[row + k]);
    acc = fmaf(v, to_f32(wg[static_cast<int64_t>(k) * n_out]), acc);
  }
  out[b * per_batch + e] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const void* idx, const void* pad, const void* scale,
           const void* w, void* out, int batch, int n_in, int rows, int t,
           int n_out, int groups, int nb, void* stream) {
  const int64_t per_batch = static_cast<int64_t>(rows) * n_out;
  const dim3 grid(static_cast<unsigned>((per_batch + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  shuffle_gemm_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const T*>(pad), static_cast<const T*>(scale),
      static_cast<const T*>(w), static_cast<T*>(out), n_in, rows, t, n_out,
      groups, nb);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* idx, const void* pad,
             const void* scale, const void* w, void* out, int batch, int n_in,
             int rows, int t, int n_out, int groups, int nb, int dtype,
             void* stream) {
  switch (dtype) {
    case 0:
      return launch<float>(x, idx, pad, scale, w, out, batch, n_in, rows, t,
                           n_out, groups, nb, stream);
    case 1:
      return launch<__nv_bfloat16>(x, idx, pad, scale, w, out, batch, n_in,
                                   rows, t, n_out, groups, nb, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void copy_kernel(const float* __restrict__ x, float* __restrict__ y,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i];
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x (batch, n_in); idx/pad/scale
// (rows, t), scale may be null; w (t, n_out); out (batch, rows, n_out).
// Returns the cudaGetLastError() code of the launch (0 = success).
int repro_shuffle_gemm_blocks(const void* x, const void* idx, const void* pad,
                              const void* scale, const void* w, void* out,
                              int batch, int n_in, int rows, int t, int n_out,
                              int dtype, void* stream) {
  return dispatch(x, idx, pad, scale, w, out, batch, n_in, rows, t, n_out,
                  /*groups=*/1, /*nb=*/rows, dtype, stream);
}

// As above with w (groups, t, n_out) and rows = reps * groups * nb in flat
// (reps, groups, nb) order; out (batch, rows * n_out).
int repro_shuffle_gemm_grouped_blocks(const void* x, const void* idx,
                                      const void* pad, const void* scale,
                                      const void* w, void* out, int batch,
                                      int n_in, int reps, int groups, int nb,
                                      int t, int n_out, int dtype,
                                      void* stream) {
  return dispatch(x, idx, pad, scale, w, out, batch, n_in, reps * groups * nb,
                  t, n_out, groups, nb, dtype, stream);
}

// Capability probe: y[:n] = x[:n] (float32).
int repro_copy_f32(const float* x, float* y, int n, void* stream) {
  copy_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
