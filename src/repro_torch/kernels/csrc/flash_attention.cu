// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with GQA, causal and sliding-window masks, tanh logit softcap and ragged
// sequence tails, in float32 or bfloat16.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd of the JAX package,
// src/repro/kernels/flash_attention/kernel.py, and computes what its
// _kernel computes:
//   s   = (q * 1/sqrt(hd)) . k            (float32)
//   s   = softcap * tanh(s / softcap)     when softcap > 0
//   s   = -1e30 where k >= skv, or (causal) k > q, or (window) k <= q - window
//   out = softmax(s) v, as an online softmax with float32 running max m,
//         denominator l and accumulator, divided by max(l, 1e-30) and
//         stored in the query's type.
// Query head h reads kv head h / (heads / kv_heads); K and V are never
// expanded.  Layouts are the entry point's own, (B, S, H, hd) for q and out
// and (B, Skv, KV, hd) for k and v, contiguous, so no transpose is made.
//
// What bounds it on this card: operations.  A causal layer at the
// starcoder2-3b width (S 4096, 24 heads, hd 128) is 103 GFLOP against 0.6
// GB of inputs and outputs; the float32 rate outside the tensor cores is the
// ceiling.  The design is the TPU kernel's dataflow re-cut for an SM: the
// TPU's sequential kv grid axis is a loop inside one block per (batch x
// head, 64-query tile), so the running state never leaves registers.  Eight
// warps hold eight query rows each; per 32-key tile the block stages K and V
// in shared memory (float32, row stride padded so the per-lane float4 reads
// of K hit distinct banks), each lane scores one key against its warp's
// eight rows, the warp reduces the tile's max and sum with shuffles, and
// each lane accumulates hd/32 output columns of P.V for its eight rows.
// Kv tiles that the causal or window mask covers wholly are skipped, which
// changes no row that sees at least one key.  Query tiles run heaviest
// first (causal tiles late in the sequence read the most keys).  Simple
// float32 FMA: no wgmma, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;              // query rows per warp
constexpr int kBQ = kWarps * kRows;   // 64 query rows per block
constexpr int kBK = 32;               // keys per tile, one per lane
constexpr float kNegInf = -1e30f;     // the TPU kernel's fill, not -inf

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// NS = head-dim columns per lane (hd <= 32 * NS).
template <int NS>
constexpr size_t smem_bytes() {
  constexpr int W = 32 * NS, LD = W + 4;
  return sizeof(float) * (kBQ * LD + kBK * LD + kBK * W + kBQ * kBK);
}

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int skv, int heads, int kv_heads, int hd, int causal,
                       int window, float softcap, float scale) {
  constexpr int W = 32 * NS;   // head dim padded to the lanes' columns
  constexpr int LD = W + 4;    // q/k tile row stride: float4-aligned, and
                               // 4 words past a bank multiple
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][LD], pre-scaled
  float* ks = qs + kBQ * LD;                     // [kBK][LD]
  float* vs = ks + kBK * LD;                     // [kBK][W]
  float* ps = vs + kBK * W;                      // [kBQ][kBK] probabilities

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / heads, h = blockIdx.y - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int64_t q_step = static_cast<int64_t>(heads) * hd;
  const int64_t kv_step = static_cast<int64_t>(kv_heads) * hd;
  const T* qb = q + (static_cast<int64_t>(b) * sq * heads + h) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * skv * kv_heads + kvh) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * skv * kv_heads + kvh) * hd;
  T* ob = out + (static_cast<int64_t>(b) * sq * heads + h) * hd;

  for (int e = tid; e < kBQ * W; e += kThreads) {
    const int r = e / W, c = e - r * W;
    const int pos = q0 + r;
    qs[r * LD + c] =
        (c < hd && pos < sq) ? to_float(qb[pos * q_step + c]) * scale : 0.f;
  }

  // kv tiles any row of this query tile can see
  int k_begin = 0, k_end = skv;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  if (causal) k_end = min(skv, q0 + kBQ);
  k_begin = (k_begin / kBK) * kBK;

  const int r0 = warp * kRows;
  float m[kRows], l[kRows], acc[kRows][NS];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and q is staged)
    for (int e = tid; e < kBK * W; e += kThreads) {
      const int r = e / W, c = e - r * W;
      const int pos = k0 + r;
      const bool in = c < hd && pos < skv;
      ks[r * LD + c] = in ? to_float(kb[pos * kv_step + c]) : 0.f;
      vs[r * W + c] = in ? to_float(vb[pos * kv_step + c]) : 0.f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < W / 4; ++d4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(qs + (r0 + r) * LD)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // masks and the online softmax update, one row at a time
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + r0 + r;
      float x = s[r];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool seen = kpos < skv;
      if (causal) seen = seen && kpos <= qpos;
      if (window > 0) seen = seen && kpos > qpos - window;
      x = seen ? x : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(x - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NS; ++i) acc[r][i] *= alpha;
      ps[(r0 + r) * kBK + lane] = p;
    }
    __syncwarp();

    // acc += P . V over the tile's keys; lane owns columns lane + 32 i
#pragma unroll 2
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pr[r] = reinterpret_cast<const float4*>(ps + (r0 + r) * kBK)[j4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j4 * 4 + jj) * W + lane;
        float vv[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) vv[i] = vrow[32 * i];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = lane_of(pr[r], jj);
#pragma unroll
          for (int i = 0; i < NS; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
        }
      }
    }
    __syncwarp();      // ps is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + qpos * q_step;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) store(orow + c, acc[r][i] / denom);
    }
  }
}

template <typename T, int NS>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int heads, int kv_heads, int hd, int causal,
           int window, float softcap, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<NS>();
  // Above 48 KB a block's dynamic shared memory needs this opt-in, once
  // per kernel; the first launch comes before any graph capture.
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(batch * heads));
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  flash_attention_kernel<T, NS><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, heads,
      kv_heads, hd, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int batch, int sq, int skv, int heads, int kv_heads, int hd,
             int causal, int window, float softcap, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                        causal, window, softcap, stream);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                        causal, window, softcap, stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                        causal, window, softcap, stream);
  return launch<T, 8>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                      causal, window, softcap, stream);
}

}  // namespace

extern "C" {

// q/out (batch, sq, heads, hd); k/v (batch, skv, kv_heads, hd); all
// contiguous, of one type: dtype 0 float32, 1 bfloat16.  heads % kv_heads
// == 0, 1 <= hd <= 256, batch * heads <= 65535 (the wrapper checks).
// Returns the CUDA error code of the launch (0 = success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int batch, int sq, int skv, int heads,
                          int kv_heads, int hd, int causal, int window,
                          float softcap, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                           causal, window, softcap, s);
  return dispatch<__nv_bfloat16>(q, k, v, out, batch, sq, skv, heads,
                                 kv_heads, hd, causal, window, softcap, s);
}

}  // extern "C"
