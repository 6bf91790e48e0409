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
//                                    butterflies), or one (G, t, n_out) a
//                                    batch row, w (B, G, t, n_out) (a
//                                    weight batch stride of G * t * n_out
//                                    elements, as below).
// Both compute, per batch row b and output row r,
//   out[b, r, :] = (where(idx[r, :] < 0, pad[r, :], x[b, idx[r, :]])
//                   * scale[r, :]) @ w[g(r)]
// and the blocks form is the grouped form with G = 1, nb = R, reps = 1 (its
// (B, R, n_out) output has the same memory as the flat (B, R * n_out) one).
// The blocks form also takes one operand per batch row, w (B, t, n_out):
// batch row b contracts against w[b] (a weight batch stride of t * n_out
// elements; 0 is the shared operand).  A wave of requests whose graphs
// registered different weights (the serving scheduler's cross-graph wave)
// is then one launch, as the JAX package's vmap over the Pallas kernel
// gives a batched grid.
// A third entry, repro_shuffle_gemm_chain, runs a list of such steps, each
// gathering from the one before, in one launch; any of its steps may take
// one operand a batch row (body 4's per-row instance).
//
// The order of each output's sum is a function of t alone, in every body,
// so that a call's rows agree bit for bit whichever body, batch or block
// computes them (a per-row call with the shared call on w[b], a meshed
// call with the unmeshed one, a row alone with the row in a batch):
//   t < 32   one float32 fmaf chain over k = 0..t-1 in order;
//   t >= 32  (blocks form) eight partial fmaf chains, partial l over
//            k = l, l + 8, ... in order, combined as
//            ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)).
// The grouped form and the chain keep the single chain at every t.  Each
// value is the PAD constant where idx < 0, else the gathered one, times the
// scale where there is one; the result is stored in the input type.
//
// What bounds them on this card.  Fig 9's calls (4 batch rows) move 0.05-0.6
// MB and take the ~1.2 us launch floor plus one or two dependent memory
// round trips: latency.  The paper suite's calls (4096 batch rows, 131072
// for the 2-D DCT-32) move 4-67 MB and should be bound by bytes, 2-20 us
// at 3.35 TB/s; what each block repeats for every batch row or tile was
// their cost.  The bodies:
//
// 1. Sequential (every grouped call; a blocks call of fewer than 16
//    multiply-adds an output, or without a staged layout; per-row calls
//    with t < 32 or too wide to stage): one thread per output element
//    (b, r, o) walks its row's t gathered inputs in device memory.  Fig
//    9's 9-tap FIR and framing adjoint, the DWTs, the butterflies: a walk
//    as short as the launch.
// 2. Staged (blocks form, one operand for every batch row): a block takes
//    one tile of rt rows and a chunk of batch rows.  It stages w and the
//    tile's tables once (cp.async, as they lie; a contiguous row's table
//    is its first index alone), then walks its batch rows a pass at a
//    time: each batch row's span of x [lo, hi) — the positions the
//    tile's rows read, found once per plan on the host
//    (kernels/shuffle_gemm/tiling.py): affine in the tile for a FIR's
//    windows and in-order rows, else a table — comes in by 16-byte
//    cp.async, the next pass's behind the current one's FMAs (two
//    buffers).  A thread owns nb batch rows x no outputs of a row (no 4:
//    one 16-byte read of w a k), so each table entry and operand value
//    it reads serves nb x no FMAs; from t >= 64 the eight partial sums
//    sit in eight lanes (lane l takes k = l, l + 8, ...) and meet by
//    __shfl_xor_sync, below it one thread keeps them (four partial sets
//    live at most: each folded into the tree once its partner is done).
//    w's rows of 8 or more 16-byte chunks are read by 8 lanes at 8 k: each
//    row's chunks are permuted (j ^ (k & 7)) so they fall in 8 bank
//    groups.  The launch sizes the grid to the card (tiles x chunks of
//    batch rows, about a block a resident slot) and, where the batch is
//    too small for that, fewer batch rows a pass and, at 8 lanes, one a
//    thread: the register tile only, never the order of a sum.  float32
//    stays on CUDA-core FMAs: TF32 misses the 1e-5 parity tolerance.
//    Before it, dct2_32's calls took one batch row a block and staged the
//    4 KB operand for each; PERF.md §6 has the times before and after.
// 3. Wide rows (per-row calls, t >= 32): a block takes a few rows of one
//    batch row and stages that row's operand w[b] and gathered values, K
//    split over 8 lanes (the partial sums above).
// 4. Chains (repro_shuffle_gemm_chain): consecutive butterflies of an
//    STFT/iSTFT stage or an FFT (and their backward) each read only what
//    the step before wrote, within one tile.  The host (kernels/
//    shuffle_gemm/chain.py) cuts the list into segments, each segment's
//    vectors into equal tiles that no step reads across, and lays out a
//    block's shared memory; it packs the tables of every step after the
//    first (indices rebased to the tile, PAD values, scales) into two
//    device buffers: the steps whose tables every tile shares (periodic),
//    and the others, one row a tile.  A block is persistent: it stages
//    the descriptors, the shared tables and every step's operand once,
//    then walks groups of `slots` tiles of the flat (batch row, tile)
//    list — each group's own tables by cp.async, its first step from
//    device memory, every later step between two shared-memory buffers
//    with one __syncthreads a step, only the last step's output to
//    device memory.  Each thread owns rows (16-byte index, operand and
//    output accesses for the t 4, n_out 4 butterfly); per output the
//    arithmetic is body 1's at t < 32, rounded to the input type between
//    steps, so a chain is bit for bit its steps launched one at a time
//    through the grouped entry.  Three layouts spread the butterflies'
//    shared-memory reads over the banks: the buffers swizzled (16-byte
//    chunks xor'ed with bits 5-7 of the position, the next step's
//    indices written to match), a row's two (even, even + 1) pairs read
//    as two 8-byte loads, and the operands of steps under 8 rows a group
//    with group g's chunk kk at kk ^ ((g >> 1) & 3).  Before, a block ran
//    one group of one batch row and staged everything again for it: a
//    1024-point FFT staged 156,240 B for each of 4096 batch rows, one
//    block an SM; PERF.md §6 has the times before and after.
//    A chain whose steps take one operand a batch row (a served wave of
//    graphs that registered different operands) runs the per-row instance
//    (kRows): those steps' operands are not staged; each row reads its
//    batch row's operand, w + b * G * t * n_out, from device memory
//    through the read-only cache, with the same arithmetic, so every batch
//    row is bit for bit the shared chain on its operands.  The shared
//    instance is compiled apart and does not read the per-row flags.
//
// Bodies 1 and 3 take batch row b on grid row b.  A batch past the grid's
// y extent (65535) runs their layered instance (kLayered): b = z *
// gridDim.y + y, the grid's z layers holding the rest.  The staged body
// and the chain walk their batch rows in the block and need no layers.
//
// float32 and bfloat16 are accepted; every body accumulates in float32 and
// stores in the input type.  Times are device times on an NVIDIA H100 80GB
// HBM3 at 700 W (tools/blocks_timing.py, chip_smoke.py); PERF.md §6 has
// them all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
constexpr int kSplitT = 32;         // t from which a blocks sum is 8 partials
constexpr int kLanes = 8;           // lanes that split one output's K
constexpr int kWideThreads = 256;
constexpr int kStagedThreads = 256;
constexpr int kMaxSub = 32;         // steps of one chain launch
constexpr int kChainThreads = 512;
constexpr int kSharedBytes = 227 * 1024;   // a block's opt-in maximum
constexpr int kMaxGridY = 65535;           // the grid's y extent

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) / 16 * 16;
}

// The eight partial sums of a t >= 32 blocks output, combined in the order
// of the xor tree of __shfl_xor_sync over 8 lanes (m = 4, 2, 1).
__device__ __forceinline__ float tree8(const float (&p)[8]) {
  return ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]));
}

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy of `bytes` (a multiple of 2) into 16-byte aligned shared memory by
// the threads first, first + stride, ... (block-wide by default): 16-byte
// cp.async where the source is 16-byte aligned, 4-byte where it is 4-byte
// aligned, the rest (bfloat16 tails) by plain 2-byte loads.  Every
// cp.async is issued before any completes; the block waits for them in
// copies_landed().
__device__ __forceinline__ void copy_in(void* dst, const void* src,
                                        int bytes, int first = threadIdx.x,
                                        int stride = blockDim.x) {
  char* d = static_cast<char*>(dst);
  const char* g = static_cast<const char*>(src);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    for (int e = first; e < bytes / 16; e += stride)
      cp_async16(d + 16 * e, g + 16 * e);
    done = bytes / 16 * 16;
  }
  if ((reinterpret_cast<uintptr_t>(g) & 3) == 0) {
    for (int e = done / 4 + first; e < bytes / 4; e += stride)
      cp_async4(d + 4 * e, g + 4 * e);
    done = bytes / 4 * 4;
  }
  for (int e = done / 2 + first; e < bytes / 2; e += stride)
    reinterpret_cast<uint16_t*>(d)[e] =
        reinterpret_cast<const uint16_t*>(g)[e];
}

// `rows` rows of `row_bytes` (contiguous in device memory) into shared
// memory rows `dst_stride` bytes apart: 16-byte cp.async where every row
// start is 16-byte aligned on both sides, else 4-byte, else 2-byte loads.
__device__ __forceinline__ void copy_rows(char* dst, const void* src,
                                          int rows, int row_bytes,
                                          int dst_stride,
                                          int first = threadIdx.x,
                                          int stride = blockDim.x) {
  const char* g = static_cast<const char*>(src);
  const int al = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15) |
                 row_bytes | dst_stride;
  const int unit = (al & 15) == 0 ? 16 : (al & 3) == 0 ? 4 : 2;
  const int per = row_bytes / unit;
  for (int e = first; e < rows * per; e += stride) {
    const int r = e / per, u = e - r * per;
    char* d = dst + r * dst_stride + u * unit;
    const char* s = g + static_cast<int64_t>(r) * row_bytes + u * unit;
    if (unit == 16)
      cp_async16(d, s);
    else if (unit == 4)
      cp_async4(d, s);
    else
      *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
  }
}

// `bytes` (a multiple of 16) of 16-byte chunks into shared memory with
// chunk e at e ^ ((e >> shift) & mask): a permutation inside each run of
// (mask + 1) << ... chunks, so the destination stays one dense region.
// 16-byte cp.async where the source is 16-byte aligned, else 4-byte; by
// the threads first, first + stride, ...
__device__ __forceinline__ void copy_xor(char* dst, const void* src,
                                         int bytes, int shift, int mask,
                                         int first = threadIdx.x,
                                         int stride = blockDim.x) {
  const char* g = static_cast<const char*>(src);
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    for (int e = first; e < bytes / 16; e += stride)
      cp_async16(dst + 16 * (e ^ ((e >> shift) & mask)), g + 16 * e);
    return;
  }
  for (int e = first; e < bytes / 4; e += stride) {
    const int c = e >> 2;
    cp_async4(dst + 16 * (c ^ ((c >> shift) & mask)) + 4 * (e & 3),
              g + 4 * e);
  }
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// One element into shared memory from its gathered address: a 4-byte
// cp.async for float32, a load and a store for bfloat16.
__device__ __forceinline__ void gather_in(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void gather_in(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  *dst = *src;
}

// The batch row of this block: grid rows (y) first, then grid layers (z)
// in the layered instance.
template <bool kLayered>
__device__ __forceinline__ int64_t batch_row() {
  return kLayered ? static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y
                  : static_cast<int64_t>(blockIdx.y);
}

// The grid's (x, y, z) for `batch` rows: one layer of `batch` grid rows up
// to kMaxGridY, else as few layers as hold them, filled evenly (at most
// z - 1 idle grid rows).
__host__ __forceinline__ dim3 batch_grid(int64_t x, int batch) {
  const int z = (batch + kMaxGridY - 1) / kMaxGridY;
  const int y = (batch + z - 1) / z;
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(y),
              static_cast<unsigned>(z));
}

int log2_or_minus1(int v);

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = 1;
  }
  return n;
}

// Allow kernel kKernel the opt-in shared memory, once per kernel (before
// any graph capture, on its first call).
template <auto kKernel>
int allow_shared() {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done = true;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// 1. Sequential body: one thread per output element
// ---------------------------------------------------------------------------

template <typename T, bool kLayered, bool kSplit>
__global__ void __launch_bounds__(kThreads)
shuffle_gemm_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                    const T* __restrict__ pad, const T* __restrict__ scale,
                    const T* __restrict__ w, T* __restrict__ out, int batch,
                    int n_in, int rows, int t, int n_out, int groups, int nb,
                    int64_t w_stride) {
  const int64_t per_batch = static_cast<int64_t>(rows) * n_out;
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t b = batch_row<kLayered>();
  if (e >= per_batch || (kLayered && b >= batch)) return;
  const int r = static_cast<int>(e / n_out);
  const int o = static_cast<int>(e - static_cast<int64_t>(r) * n_out);
  const int g = (r / nb) % groups;
  const T* xb = x + b * n_in;
  const int64_t row = static_cast<int64_t>(r) * t;
  const T* wg = w + b * w_stride + static_cast<int64_t>(g) * t * n_out + o;
  float acc = 0.f;
  if (kSplit) {                       // the blocks form at t >= 32
    float p[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < t; k0 += 8) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int k = k0 + l;
        if (k >= t) break;
        const int32_t i = idx[row + k];
        float v = i < 0 ? to_f32(pad[row + k]) : to_f32(xb[i]);
        if (scale != nullptr) v *= to_f32(scale[row + k]);
        p[l] = fmaf(v, to_f32(wg[static_cast<int64_t>(k) * n_out]), p[l]);
      }
    }
    acc = tree8(p);
  } else {
    for (int k = 0; k < t; ++k) {
      const int32_t i = idx[row + k];
      float v = i < 0 ? to_f32(pad[row + k]) : to_f32(xb[i]);
      if (scale != nullptr) v *= to_f32(scale[row + k]);
      acc = fmaf(v, to_f32(wg[static_cast<int64_t>(k) * n_out]), acc);
    }
  }
  out[b * per_batch + e] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const void* idx, const void* pad, const void* scale,
           const void* w, void* out, int batch, int n_in, int rows, int t,
           int n_out, int groups, int nb, int64_t w_stride, bool split,
           cudaStream_t stream) {
  const int64_t per_batch = static_cast<int64_t>(rows) * n_out;
  const dim3 grid = batch_grid((per_batch + kThreads - 1) / kThreads, batch);
  auto* body = grid.z > 1 ? (split ? shuffle_gemm_kernel<T, true, true>
                                   : shuffle_gemm_kernel<T, true, false>)
                          : (split ? shuffle_gemm_kernel<T, false, true>
                                   : shuffle_gemm_kernel<T, false, false>);
  body<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const T*>(pad), static_cast<const T*>(scale),
      static_cast<const T*>(w), static_cast<T*>(out), batch, n_in, rows, t,
      n_out, groups, nb, w_stride);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. Staged rows (blocks form, one operand for every batch row)
// ---------------------------------------------------------------------------

// The layout of kernels/shuffle_gemm/tiling.py staged_tiling, in elements
// and bytes.  Shared memory: w (t rows of ws elements, dense; where wxor,
// row k's 16-byte chunks permuted, chunk j at j ^ (k & wxor)) at 0; the
// tile's
// tables as they lie in device memory, row r at r * rs: the indices
// (int32) at off_idx, the PAD values (T) at off_pad and the scales (T) at
// off_scale (-1: none); two buffers of bg * nb batch rows of row_bytes
// each at off_buf.  The span of tile q: from the spans table where there
// is one, else [max(0, hi - len), min(n_in, hi)) with hi = hi0 + q * step.
struct Staged {
  int batch, n_in, rows, t, n_out;
  int rt, bg, chunk;            // rows a tile, batch groups a pass, batch
                                // rows a block
  int ws, rs, row_bytes;
  int off_idx, off_pad, off_scale, off_buf;
  int mode;                     // kGather, kPadded (PAD entries: a table
                                // at off_pad, or all of value 0) or kRun
  int step, hi0, len;           // the affine spans
  int wxor;                     // w's row k: 16-byte chunk j at j ^ (k & wxor)
  int wshift;                   // log2 of w's 16-byte chunks a row
};

// How a staged row reads its values: by its index table, the same with
// PAD entries, or one contiguous run (idx[r, k] = idx[r, 0] + k, no PAD).
enum StagedMode { kGather = 0, kPadded = 1, kRun = 2 };

// Load kNO consecutive operand values (16 or 8 bytes for kNO 4) as floats.
template <int kNO>
__device__ __forceinline__ void load_w(float (&v)[kNO], const float* p) {
  if constexpr (kNO == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int q = 0; q < kNO; ++q) v[q] = p[q];
  }
}
template <int kNO>
__device__ __forceinline__ void load_w(float (&v)[kNO],
                                       const __nv_bfloat16* p) {
  if constexpr (kNO == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(h[i]);
  } else {
#pragma unroll
    for (int q = 0; q < kNO; ++q) v[q] = __bfloat162float(p[q]);
  }
}

// Store kNO consecutive outputs (one 16- or 8-byte store for kNO 4).
template <int kNO>
__device__ __forceinline__ void store_out(float* p, const float (&v)[kNO]) {
  if constexpr (kNO == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kNO; ++q) p[q] = v[q];
  }
}
template <int kNO>
__device__ __forceinline__ void store_out(__nv_bfloat16* p,
                                          const float (&v)[kNO]) {
  if constexpr (kNO == 4) {
    __nv_bfloat16 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __float2bfloat16(v[i]);
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  } else {
#pragma unroll
    for (int q = 0; q < kNO; ++q) p[q] = __float2bfloat16(v[q]);
  }
}

// Where output group og's kNO operand values lie in w's row k: 16-byte
// chunk (og * kNO * es / 16) ^ (k & wxor), at its offset in the chunk.
template <typename T, int kNO>
__device__ __forceinline__ int w_col(int og, int k, int wxor) {
  constexpr int per = 16 / static_cast<int>(sizeof(T));   // a chunk's
  const int e = og * kNO;
  return ((e / per) ^ (k & wxor)) * per + e % per;
}

// One k of a thread's kNB x kNO outputs: the value of each batch row (the
// PAD constant where idx < 0, else the staged x, times the scale), fmaf
// into acc.  xo[n] locates batch row n's x[b, 0] in the staged buffer (its
// span's first element at xs[xo[n] + lo]); i0 is the row's first index
// (kRun).
template <typename T, int kNO, int kNB, int kMode>
__device__ __forceinline__ void staged_term(
    float (&acc)[kNB][kNO], const T* __restrict__ xs, const int (&xo)[kNB],
    int lo, int i0, const int32_t* __restrict__ it, const T* __restrict__ pt,
    const T* __restrict__ st, const T* __restrict__ wsm, int og, int wxor,
    int k, int ws) {
  const int32_t i = kMode == kRun ? i0 + k : it[k];
  float wv[kNO];
  load_w<kNO>(wv, wsm + k * ws + w_col<T, kNO>(og, k, wxor));
  const float sc = st != nullptr ? to_f32(st[k]) : 1.f;
  float pv = 0.f;
  int ic = i;
  if constexpr (kMode == kPadded) {
    if (i < 0 && pt != nullptr) {
      pv = to_f32(pt[k]);
      if (st != nullptr) pv *= sc;
    }
    ic = i < 0 ? lo : i;
  }
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
    float v = to_f32(xs[xo[n] + ic]);
    if (st != nullptr) v *= sc;
    if constexpr (kMode == kPadded) v = i < 0 ? pv : v;
#pragma unroll
    for (int q = 0; q < kNO; ++q) acc[n][q] = fmaf(v, wv[q], acc[n][q]);
  }
}

template <int kNO, int kNB>
__device__ __forceinline__ void zero(float (&a)[kNB][kNO]) {
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int q = 0; q < kNO; ++q) a[n][q] = 0.f;
}

// a = a + b, element by element
template <int kNO, int kNB>
__device__ __forceinline__ void add(float (&a)[kNB][kNO],
                                    const float (&b)[kNB][kNO]) {
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int q = 0; q < kNO; ++q) a[n][q] = a[n][q] + b[n][q];
}

// One partial sum: acc = the fmaf chain over k = k0, k0 + dk, ... < t.
template <typename T, int kNO, int kNB, int kMode>
__device__ __forceinline__ void staged_partial(
    float (&acc)[kNB][kNO], const T* __restrict__ xs, const int (&xo)[kNB],
    int lo, int i0, const int32_t* __restrict__ it,
    const T* __restrict__ pt, const T* __restrict__ st,
    const T* __restrict__ wsm, int og, int wxor, int t, int ws, int k0,
    int dk) {
  zero(acc);
  for (int k = k0; k < t; k += dk)
    staged_term<T, kNO, kNB, kMode>(acc, xs, xo, lo, i0, it, pt, st, wsm,
                                    og, wxor, k, ws);
}

// A thread's kNB x kNO sums over k = 0..t-1 in the order of the header:
// one chain (not kSplit); the eight partials in one thread (kLanes 1),
// each computed whole and folded into the tree as soon as its partner is
// — (p0 + p4) + (p2 + p6), then (p1 + p5) + (p3 + p7): four sets live at
// most —, or one a lane of eight (kLanes 8; every lane ends with the
// combined sums).
template <typename T, int kNO, int kNB, int kLanes, bool kSplit, int kMode>
__device__ __forceinline__ void staged_sums(
    float (&sum)[kNB][kNO], const T* __restrict__ xs, const int (&xo)[kNB],
    int lo, int i0, const int32_t* __restrict__ it,
    const T* __restrict__ pt, const T* __restrict__ st,
    const T* __restrict__ wsm, int og, int wxor, int t, int ws, int lane) {
#define PARTIAL(ACC, K0, DK)                                                 \
  staged_partial<T, kNO, kNB, kMode>(ACC, xs, xo, lo, i0, it, pt, st, wsm,  \
                                     og, wxor, t, ws, K0, DK)
  if constexpr (kSplit && kLanes == 1) {
    float a[kNB][kNO], b[kNB][kNO], c[kNB][kNO];
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {     // h 0: p0, p4, p2, p6; h 1: p1, ...
      PARTIAL(b, h, 8);
      PARTIAL(c, h + 4, 8);
      add(b, c);                      // p_h + p_{h+4}
      PARTIAL(c, h + 2, 8);
      PARTIAL(sum, h + 6, 8);
      add(c, sum);                    // p_{h+2} + p_{h+6}
      add(b, c);
      if (h == 0) {
#pragma unroll
        for (int n = 0; n < kNB; ++n)
#pragma unroll
          for (int q = 0; q < kNO; ++q) a[n][q] = b[n][q];
      }
    }
    add(a, b);                        // the first half + the second
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int q = 0; q < kNO; ++q) sum[n][q] = a[n][q];
  } else {
    PARTIAL(sum, kSplit ? lane : 0, kSplit ? kLanes : 1);
    if constexpr (kSplit) {
#pragma unroll
      for (int m = kLanes / 2; m > 0; m /= 2)
#pragma unroll
        for (int n = 0; n < kNB; ++n)
#pragma unroll
          for (int q = 0; q < kNO; ++q)
            sum[n][q] += __shfl_xor_sync(0xffffffffu, sum[n][q], m, kLanes);
    }
  }
#undef PARTIAL
}

// Pass p's batch rows [b_lo + p * pb, ...) below b_hi: each row's span of
// x by the 16-byte chunks that hold it (whole chunks of the row's own
// storage, nch at most), into buffer p & 1; one cp.async group.
__device__ __forceinline__ void stage_rows(char* buf, uintptr_t xa, int es,
                                           int n_in, int2 span, int64_t b_lo,
                                           int64_t b_hi, int pb, int nch,
                                           int row_bytes, int p) {
  if (span.y > span.x) {
    char* const dst = buf + (p & 1) * pb * row_bytes;
    const int64_t b0 = b_lo + static_cast<int64_t>(p) * pb;
    for (int e = threadIdx.x; e < pb * nch; e += blockDim.x) {
      const int n = e / nch, c = e - n * nch;
      const int64_t b = b0 + n;
      if (b >= b_hi) break;
      const uintptr_t row = xa + static_cast<uintptr_t>(b * n_in) * es;
      const uintptr_t first = row + static_cast<uintptr_t>(span.x) * es;
      const uintptr_t end = row + static_cast<uintptr_t>(span.y) * es;
      const uintptr_t src = (first & ~static_cast<uintptr_t>(15)) + 16u * c;
      if (src < end)
        cp_async16(dst + n * row_bytes + 16 * c,
                   reinterpret_cast<const void*>(src));
    }
  }
  cp_async_commit();
}

// Two blocks an SM at least (128 registers a thread at most): the grid is
// sized from the occupancy, and the largest register tile (4 x 4 outputs,
// four partial sets) fits 128.
template <typename T, int kNO, int kNB, int kLanes, bool kSplit>
__global__ void __launch_bounds__(kStagedThreads, 2)
staged_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
              const T* __restrict__ pad, const T* __restrict__ scale,
              const T* __restrict__ w, T* __restrict__ out,
              const int2* __restrict__ spans, const Staged a) {
  extern __shared__ int4 smem[];
  char* const base = reinterpret_cast<char*>(smem);
  const T* const wsm = reinterpret_cast<const T*>(base);
  const int32_t* const itab =
      reinterpret_cast<const int32_t*>(base + a.off_idx);
  const T* const ptab =
      a.off_pad >= 0 ? reinterpret_cast<const T*>(base + a.off_pad) : nullptr;
  const T* const stab =
      a.off_scale >= 0 ? reinterpret_cast<const T*>(base + a.off_scale)
                       : nullptr;
  char* const buf = base + a.off_buf;
  constexpr int es = static_cast<int>(sizeof(T));

  const int r0 = blockIdx.x * a.rt;
  const int nr = min(a.rt, a.rows - r0);
  const int64_t b_lo = static_cast<int64_t>(blockIdx.y) * a.chunk;
  const int64_t b_hi = min(static_cast<int64_t>(a.batch), b_lo + a.chunk);
  int2 span;
  if (spans != nullptr) {
    span = spans[blockIdx.x];
  } else {
    const int hi = a.hi0 + static_cast<int>(blockIdx.x) * a.step;
    span = make_int2(max(0, hi - a.len), min(a.n_in, hi));
  }
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int pb = a.bg * kNB;                      // batch rows a pass
  const int passes = (static_cast<int>(b_hi - b_lo) + pb - 1) / pb;
  const int nch = a.row_bytes / 16;

  // w and the tile's tables, once for every batch row of the block, by
  // cp.async as they lie (rows rs elements apart)
  const int64_t row0 = static_cast<int64_t>(r0) * a.t;
  if (a.wxor)
    copy_xor(base, w, a.t * a.n_out * es, a.wshift, a.wxor);
  else
    copy_in(base, w, a.t * a.n_out * es);
  if (a.mode != kRun)
    copy_rows(base + a.off_idx, idx + row0, nr, 4 * a.t, 4 * a.rs);
  else                                 // a run: each row's first index
    for (int r = threadIdx.x; r < nr; r += blockDim.x)
      cp_async4(base + a.off_idx + 4 * r * a.rs, idx + row0 + r * a.t);
  if (a.off_pad >= 0)
    copy_rows(base + a.off_pad, pad + row0, nr, es * a.t, es * a.rs);
  if (a.off_scale >= 0)
    copy_rows(base + a.off_scale, scale + row0, nr, es * a.t, es * a.rs);
  cp_async_commit();

  if (passes > 0)
    stage_rows(buf, xa, es, a.n_in, span, b_lo, b_hi, pb, nch, a.row_bytes,
               0);

  const int n_og = a.n_out / kNO;
  const int cols = a.rt * n_og * kLanes;          // a batch group's threads
  const int total = a.bg * cols;
  const int iters = (total + blockDim.x - 1) / blockDim.x;
  const int lane = threadIdx.x % kLanes;
  const int64_t per = static_cast<int64_t>(a.rows) * a.n_out;
  for (int p = 0; p < passes; ++p) {
    if (p + 1 < passes) {
      stage_rows(buf, xa, es, a.n_in, span, b_lo, b_hi, pb, nch,
                 a.row_bytes, p + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* const xs = reinterpret_cast<const T*>(
        buf + (p & 1) * pb * a.row_bytes);
    const int64_t b0 = b_lo + static_cast<int64_t>(p) * pb;
    for (int iter = 0; iter < iters; ++iter) {
      // every thread runs every iteration (the lanes' shuffles see whole
      // warps); one past the last column repeats it and stores nothing
      const int q0 = iter * blockDim.x + threadIdx.x;
      const int q = q0 < total ? q0 : total - 1;
      const int grp = q / cols;
      const int c = (q - grp * cols) / kLanes;
      const int og = c % n_og;
      int r = c / n_og;
      const bool ok = q0 < total && r < nr;
      r = r < nr ? r : nr - 1;
      const int64_t bt = b0 + static_cast<int64_t>(grp) * kNB;
      const int64_t left = b_hi - bt;
      const int nbv = left < kNB ? static_cast<int>(left) : kNB;
      // a warp with no batch row left in its groups (a batch smaller than
      // a pass) skips the pass; the lanes of a row never straddle groups
      if (__all_sync(0xffffffffu, !ok || nbv <= 0)) continue;
      // batch row n's x[b, lo] lies (first & 15) bytes into its staged
      // row: xo[n] + i is x[b, i] for every i of the span
      int xo[kNB];
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        const uintptr_t first =
            xa + static_cast<uintptr_t>((bt + n) * a.n_in + span.x) * es;
        xo[n] = ((grp * kNB + n) * a.row_bytes +
                 static_cast<int>(first & 15)) / es - span.x;
      }
      const int s0 = r * a.rs;
      const int32_t* const it = itab + s0;
      const T* const pt = ptab != nullptr ? ptab + s0 : nullptr;
      const T* const st = stab != nullptr ? stab + s0 : nullptr;
      const int i0 = a.mode == kRun ? it[0] : 0;
      float sum[kNB][kNO];
#define SUMS(MODE)                                                           \
  staged_sums<T, kNO, kNB, kLanes, kSplit, MODE>(                            \
      sum, xs, xo, span.x, i0, it, pt, st, wsm, og, a.wxor, a.t, a.ws, lane)
      if (a.mode == kRun)
        SUMS(kRun);
      else if (a.mode == kPadded)
        SUMS(kPadded);
      else
        SUMS(kGather);
#undef SUMS
      if (ok) {
        T* const ob = out + bt * per +
                      static_cast<int64_t>(r0 + r) * a.n_out + og * kNO;
        if constexpr (kLanes == 1) {
#pragma unroll
          for (int n = 0; n < kNB; ++n)
            if (n < nbv) store_out<kNO>(ob + n * per, sum[n]);
        } else {
          // every lane holds the sums: lane l stores entries l, l + 8, ...
#pragma unroll
          for (int e = 0; e < kNB * kNO; ++e)
            if (e % kLanes == lane && e / kNO < nbv)
              ob[(e / kNO) * per + e % kNO] =
                  from_f32<T>(sum[e / kNO][e % kNO]);
        }
      }
    }
    __syncthreads();
  }
}

// dims of repro_shuffle_gemm_blocks' staged layout (tiling.py
// StagedTiling.dims): rt, lanes, no, nb, split, bg, threads, ws, rs,
// row_bytes, off_idx, off_pad, off_scale, off_buf, total, mode, step, hi0,
// len, wxor (rt 0: no staged layout); then four ints the launch fills
// in: grid x (tiles), grid y (chunks), batch rows a block, the body (2).
constexpr int kStagedDims = 20;

template <typename T, int kNO, int kNB, int kLanes, bool kSplit>
int launch_staged_as(const void* x, const void* idx, const void* pad,
                     const void* scale, const void* w, void* out,
                     const int2* spans, Staged a, int threads, int smem,
                     int* grid_out, cudaStream_t stream) {
  auto* body = staged_kernel<T, kNO, kNB, kLanes, kSplit>;
  int err = allow_shared<staged_kernel<T, kNO, kNB, kLanes, kSplit>>();
  if (err) return err;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, body, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  // tiles x chunks blocks, about one a resident slot: each walks its
  // chunk's passes with the operand and tables staged once
  const int tiles = (a.rows + a.rt - 1) / a.rt;
  // a batch too small for the layout's batch groups: fewer groups a pass
  // (their buffers idle), so that tiles x passes still reach every SM
  while (a.bg > 1 &&
         tiles * ((static_cast<int64_t>(a.batch) + a.bg * kNB - 1) /
                  (a.bg * kNB)) < sm_count())
    a.bg /= 2;
  const int pb = a.bg * kNB;
  const int64_t passes = (static_cast<int64_t>(a.batch) + pb - 1) / pb;
  int64_t chunks = static_cast<int64_t>(sm_count()) * per_sm / tiles;
  chunks = chunks < 1 ? 1 : chunks > passes ? passes : chunks;
  if (chunks > kMaxGridY) chunks = kMaxGridY;
  const int64_t per_chunk = (passes + chunks - 1) / chunks;
  a.chunk = static_cast<int>(per_chunk * pb);
  chunks = (a.batch + a.chunk - 1) / a.chunk;
  grid_out[0] = tiles;
  grid_out[1] = static_cast<int>(chunks);
  grid_out[2] = a.chunk;
  grid_out[3] = 2;
  body<<<dim3(tiles, static_cast<unsigned>(chunks)), threads, smem,
         stream>>>(static_cast<const T*>(x),
                   static_cast<const int32_t*>(idx),
                   static_cast<const T*>(pad), static_cast<const T*>(scale),
                   static_cast<const T*>(w), static_cast<T*>(out), spans, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_staged(const void* x, const void* idx, const void* pad,
                  const void* scale, const void* w, void* out, int batch,
                  int n_in, int rows, int t, int n_out, const int2* spans,
                  int* d, cudaStream_t stream) {
  const int rt = d[0], lanes = d[1], no = d[2], split = d[4];
  int nb = d[3];
  const int threads = d[6], total = d[14];
  Staged a{};
  a.batch = batch, a.n_in = n_in, a.rows = rows, a.t = t, a.n_out = n_out;
  a.rt = rt, a.bg = d[5], a.ws = d[7], a.rs = d[8], a.row_bytes = d[9];
  a.off_idx = d[10], a.off_pad = d[11], a.off_scale = d[12];
  a.off_buf = d[13], a.mode = d[15];
  a.step = d[16], a.hi0 = d[17], a.len = d[18], a.wxor = d[19];
  const int es = static_cast<int>(sizeof(T));
  const int wchunks = n_out * es / 16;
  a.wshift = a.wxor ? log2_or_minus1(wchunks) : 0;
  const int64_t table = static_cast<int64_t>(rt - 1) * a.rs + t;
  // the widest span a staged row holds: its 16-byte chunks, one more
  // where it starts off a chunk boundary
  const int64_t span = a.len;
  const bool ok =
      rt >= 1 && a.bg >= 1 && threads >= 32 && threads <= kStagedThreads &&
      threads % 32 == 0 && (no == 1 || no == 4) && n_out % no == 0 &&
      split == (t >= kSplitT) && (lanes == 1 || (lanes == kLanes && split)) &&
      a.ws == n_out && a.rs >= t &&
      (a.wxor == 0 || (a.wxor == 7 && no == 4 && lanes == kLanes &&
                       (n_out * es) % 16 == 0 && wchunks >= 8 &&
                       a.wshift >= 0)) &&
      a.row_bytes >= 16 && a.row_bytes % 16 == 0 &&
      static_cast<int64_t>(t) * a.ws * es <= a.off_idx &&
      a.off_idx % 16 == 0 && a.off_buf % 16 == 0 &&
      a.off_idx + 4 * table <= (a.off_pad >= 0 ? a.off_pad
                                : a.off_scale >= 0 ? a.off_scale
                                                   : a.off_buf) &&
      (a.off_pad < 0 || (a.off_pad % 16 == 0 &&
                         a.off_pad + es * table <=
                             (a.off_scale >= 0 ? a.off_scale : a.off_buf))) &&
      (a.off_scale < 0 || (a.off_scale % 16 == 0 &&
                           a.off_scale + es * table <= a.off_buf)) &&
      (a.off_scale >= 0) == (scale != nullptr) &&
      (a.off_pad < 0 || a.mode == kPadded) &&
      (a.mode == kGather || a.mode == kPadded || a.mode == kRun) &&
      a.len > 0 && (span * es + 14) / 16 + 1 <= a.row_bytes / 16 &&
      a.off_buf + 2LL * a.bg * nb * a.row_bytes <= total &&
      total <= kSharedBytes && rows >= 1 && batch >= 1;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int* g = d + kStagedDims;
  // one batch row a thread where eight lanes share each output and the
  // batch is too small to give every SM a block at nb rows a thread: the
  // register tile only (each output's order is t's, whatever nb)
  if (lanes == kLanes &&
      static_cast<int64_t>((rows + rt - 1) / rt) *
              ((static_cast<int64_t>(batch) + nb - 1) / nb) <
          sm_count())
    nb = 1;
#define STAGED(NO, NB, L, S)                                                 \
  if (no == NO && nb == NB && lanes == L && split == S)                     \
    return launch_staged_as<T, NO, NB, L, S>(x, idx, pad, scale, w, out,    \
                                             spans, a, threads, total, g,   \
                                             stream);
  STAGED(1, 8, 1, 0)
  STAGED(4, 4, 1, 0)
  STAGED(1, 8, 1, 1)
  STAGED(4, 4, 1, 1)
  STAGED(1, 8, 8, 1)
  STAGED(1, 1, 8, 1)
  STAGED(4, 4, 8, 1)
  STAGED(4, 1, 8, 1)
#undef STAGED
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// 3. Wide rows (per-row operands, t >= 32): staged rows, K split over lanes
// ---------------------------------------------------------------------------

// Rows a CTA takes: enough that its outputs fill the kWideThreads / kLanes
// lane groups once (at least one row).
__host__ __forceinline__ int wide_rows_per_cta(int rows, int n_out) {
  int rpc = (kWideThreads / kLanes) / n_out;
  rpc = rpc < 1 ? 1 : rpc;
  return rpc < rows ? rpc : rows;
}

template <typename T>
__host__ __forceinline__ size_t wide_shared_bytes(int t, int n_out, int rpc,
                                                  bool scaled) {
  const size_t rows = static_cast<size_t>(rpc) * t * sizeof(T);
  return align16(static_cast<int>(sizeof(T)) * t * n_out) +
         align16(static_cast<int>(rows)) +
         (scaled ? align16(static_cast<int>(rows)) : 0);
}

template <typename T, bool kLayered>
__global__ void __launch_bounds__(kWideThreads)
wide_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
            const T* __restrict__ pad, const T* __restrict__ scale,
            const T* __restrict__ w, T* __restrict__ out, int batch,
            int n_in, int rows, int t, int n_out, int rpc, int64_t w_stride) {
  extern __shared__ int4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  T* const ws = reinterpret_cast<T*>(base);                 // (t, n_out)
  T* const gs = reinterpret_cast<T*>(                       // (rpc, t)
      base + align16(static_cast<int>(sizeof(T)) * t * n_out));
  T* const ss = gs + align16(static_cast<int>(sizeof(T)) * rpc * t) /
                         static_cast<int>(sizeof(T));       // (rpc, t)
  const int64_t b = batch_row<kLayered>();
  if (kLayered && b >= batch) return;  // the whole block: no barrier skipped
  const int r0 = blockIdx.x * rpc;
  const int nr = rows - r0 < rpc ? rows - r0 : rpc;
  const int64_t row0 = static_cast<int64_t>(r0) * t;

  // every load in flight before any is used; the staged operand is this
  // batch row's
  copy_in(ws, w + b * w_stride, static_cast<int>(sizeof(T)) * t * n_out);
  if (scale != nullptr)
    copy_in(ss, scale + row0, static_cast<int>(sizeof(T)) * nr * t);
  const T* xb = x + b * n_in;
  for (int e = threadIdx.x; e < nr * t; e += blockDim.x) {
    const int32_t i = idx[row0 + e];
    gather_in(gs + e, i < 0 ? pad + row0 + e : xb + i);
  }
  copies_landed();

  // lane group per output, K split over its kLanes lanes.  Every lane of a
  // warp runs the same number of passes, so the shuffles see the full warp.
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int n_groups = blockDim.x / kLanes;
  const int total = nr * n_out;
  const int passes = (total + n_groups - 1) / n_groups;
  T* const ob = out + (b * rows + r0) * static_cast<int64_t>(n_out);
  for (int pass = 0; pass < passes; ++pass) {
    const int p = pass * n_groups + group;
    float acc = 0.f;
    if (p < total) {
      const int r = p / n_out, o = p - r * n_out;
      const T* gr = gs + r * t;
      const T* sr = ss + r * t;
      for (int k = lane; k < t; k += kLanes) {
        float v = to_f32(gr[k]);
        if (scale != nullptr) v *= to_f32(sr[k]);
        acc = fmaf(v, to_f32(ws[k * n_out + o]), acc);
      }
    }
#pragma unroll
    for (int m = kLanes / 2; m > 0; m /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, m, kLanes);
    if (p < total && lane == 0) ob[p] = from_f32<T>(acc);
  }
}

// The sequential or the wide body for a blocks call with no staged
// layout; writes its grid's x and y (z layers folded in), its rows a
// block (wide) and its body (0 sequential, 1 wide) to `launched`.
template <typename T>
int launch_blocks(const void* x, const void* idx, const void* pad,
                  const void* scale, const void* w, void* out, int batch,
                  int n_in, int rows, int t, int n_out, int64_t w_stride,
                  int* launched, cudaStream_t stream) {
  const bool split = t >= kSplitT;
  const int rpc = wide_rows_per_cta(rows, n_out);
  const size_t smem = wide_shared_bytes<T>(t, n_out, rpc, scale != nullptr);
  if (w_stride == 0 || !split || smem > static_cast<size_t>(kSharedBytes)) {
    const dim3 grid = batch_grid(
        (static_cast<int64_t>(rows) * n_out + kThreads - 1) / kThreads, batch);
    launched[0] = static_cast<int>(grid.x);
    launched[1] = static_cast<int>(grid.y * grid.z);
    launched[2] = 0;
    launched[3] = 0;
    return launch<T>(x, idx, pad, scale, w, out, batch, n_in, rows, t, n_out,
                     1, rows, w_stride, split, stream);
  }
  int err = allow_shared<wide_kernel<T, false>>();
  if (err == 0) err = allow_shared<wide_kernel<T, true>>();
  if (err) return err;
  int threads = rpc * n_out * kLanes;
  threads = threads < kWideThreads ? (threads + 31) / 32 * 32 : kWideThreads;
  const dim3 grid = batch_grid((rows + rpc - 1) / rpc, batch);
  launched[0] = static_cast<int>(grid.x);
  launched[1] = static_cast<int>(grid.y * grid.z);
  launched[2] = rpc;
  launched[3] = 1;
  auto* body = grid.z > 1 ? wide_kernel<T, true> : wide_kernel<T, false>;
  body<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const T*>(pad), static_cast<const T*>(scale),
      static_cast<const T*>(w), static_cast<T*>(out), batch, n_in, rows, t,
      n_out, rpc, w_stride);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 4. Chains: a list of steps in one launch, tile by tile in shared memory
// ---------------------------------------------------------------------------

struct Step {
  const void* w;       // (groups, t, n_out) in T
  int rows, t, n_out, groups, nb, periodic;
  int rpt;             // rows a tile
  int in_stride;       // floats a tile of the step's input buffer
  int vec;             // float32, t 4, n_out 4: 16-byte table, operand
                       // and output accesses
  int rpt_shift, nb_shift, groups_shift;   // log2 of rpt, nb and groups,
                                           // or -1
  int off_idx, off_pad, off_scale, off_w;  // shared-memory byte offsets
                                           // (-1: none); a step's own
                                           // tables' from its tile's row
  int wperm;           // vec, groups > 1: group g's 16-byte chunk kk
                       // staged at kk ^ ((g >> 1) & 3)
  int pairs;           // vec, and every row reads two (even, even + 1)
                       // pairs: two 8-byte gathers
  int swz;             // its output buffer swizzled (swizzle())
  int w_rows;          // one operand a batch row (the per-row instance)
};
static_assert(sizeof(Step) == 88, "chain.py STEP_BYTES mirrors this size");

struct Chain {
  const void* idx0;            // step 0's (rows, t) tables over the input
  const void* pad0;
  const void* scale0;          // or null
  const void* shared_tables;   // the periodic steps' tables, packed
  const void* own_tables;      // the other steps', one packed row a tile
  int64_t total;               // tiles of the launch: batch x tiles
  int batch, count, tiles, tiles_shift, slots, n_in, n_last;
  int pad0_zero;               // step 0's PAD values all 0: pad0 unread
  int off_shared, shared_bytes;
  int own_bytes;               // a tile's own tables (16-byte multiple)
  int off_own, off_buf, buf_bytes;   // the slots' regions
};

struct ChainSteps {
  Step s[kMaxSub];
};

__device__ __forceinline__ int divide(int a, int d, int shift) {
  return shift >= 0 ? a >> shift : a / d;
}

// A buffered output's position p in shared memory: the 16-byte chunk
// p >> 2 xor'ed in its low three bits with bits 5-7 of p, inside each
// aligned 32-float block (a float4 stays whole).  The butterflies' rows
// read pairs 8 floats apart, all in the same four banks unswizzled; the
// host writes the next step's indices swizzled to match (chain.py).
__device__ __forceinline__ int swizzle(int p) {
  return p ^ (((p >> 5) & 7) << 2);
}

// Elements of one batch row's operand of a per-row step.
__device__ __forceinline__ int64_t row_operand(const Step& st) {
  return static_cast<int64_t>(st.groups) * st.t * st.n_out;
}

// A step's input value k of a row: the PAD constant or the gathered one,
// times the scale.
template <typename T, typename In>
__device__ __forceinline__ float gathered(const In* src, int32_t i,
                                          const T* pad, const T* scale,
                                          int64_t e) {
  // no PAD table: every PAD value is 0 (times a finite scale: a zero)
  float v = i < 0 ? (pad != nullptr ? to_f32(pad[e]) : 0.f) : to_f32(src[i]);
  if (scale != nullptr) v *= to_f32(scale[e]);
  return v;
}

// One step over the rows of the block's slots; slot s holds flat tile
// j0 + s of the launch: tile k of batch row b, k0 + s past tile k0 of
// batch row b0 (b >= batch: no tile).  Step 0 (kStaged false) reads the
// chain input of batch row b with global indices, and its tables and
// operand from device memory; a later step reads the slot's slice of the
// input buffer (in_stride floats a slot, indices rebased and swizzled as
// its input was written) and its tables (the shared copy, or the slot's
// own row) and operand staged in shared memory.  Tables are (rows, t),
// operands (groups, t, n_out), a butterfly's chunks permuted (wperm).  The
// result goes to the output buffer (float32 values rounded to T,
// swizzled where swz) or, for the last step, to device memory.  Per
// output: gather, PAD constant, scale multiply, fmaf over k = 0..t-1 in
// order — the sequential body's arithmetic.
//
// kRows (the per-row instance): w_stride elements between batch rows'
// operands, 0 for a step whose operand every batch row shares.
template <typename T, typename In, bool kStaged, bool kLast, bool kRows>
__device__ __forceinline__ void run_step(
    const Step st, const Chain& c, int64_t b0, int k0, const char* base,
    const In* __restrict__ in, const int32_t* __restrict__ idx0,
    const T* __restrict__ pad0, const T* __restrict__ scale0,
    const T* __restrict__ w, float* __restrict__ buf_out,
    T* __restrict__ out, int64_t w_stride) {
  const int rpt = st.rpt, t = st.t, n_out = st.n_out, groups = st.groups;
  const int ept = rpt * n_out;
  for (int lr = threadIdx.x; lr < c.slots * rpt; lr += blockDim.x) {
    const int tc = divide(lr, rpt, st.rpt_shift);
    const int r = lr - tc * rpt;
    int k = k0 + tc;
    int64_t b = b0;
    if (k >= c.tiles) {
      const int q = divide(k, c.tiles, c.tiles_shift);
      b += q;
      k -= q * c.tiles;
    }
    if (b >= c.batch) continue;
    const int grow = k * rpt + r;                  // row within batch row
    const int blk = divide(grow, st.nb, st.nb_shift);
    const int g = st.groups_shift >= 0 ? blk & (groups - 1) : blk % groups;
    const int32_t* idx = idx0;
    const T* pad = pad0;
    const T* scale = scale0;
    int64_t row = static_cast<int64_t>(grow) * t;
    if (kStaged) {
      const char* tb = st.periodic ? base
                                   : base + c.off_own + tc * c.own_bytes;
      idx = reinterpret_cast<const int32_t*>(tb + st.off_idx);
      pad = st.off_pad >= 0 ? reinterpret_cast<const T*>(tb + st.off_pad)
                            : nullptr;
      scale = st.off_scale >= 0
                  ? reinterpret_cast<const T*>(tb + st.off_scale)
                  : nullptr;
      row = static_cast<int64_t>(r) * t;
    }
    const In* src = kStaged ? in + tc * st.in_stride : in + b * c.n_in;
    const T* wg = w + static_cast<int64_t>(g) * t * n_out;
    if constexpr (kRows) wg += b * w_stride;
    const int wp = st.wperm ? (g >> 1) & 3 : 0;
    float* ob = kLast ? nullptr : buf_out + tc * ept;
    T* og = kLast ? out + b * c.n_last + static_cast<int64_t>(k) * ept +
                        r * n_out
                  : nullptr;
    // the buffer position of output element e of this row: at(e)
    const bool swz = st.swz;
    const int rbase = r * n_out;
#define at(e) (swz ? swizzle(rbase + (e)) : rbase + (e))
    if constexpr (std::is_same<T, float>::value) {
      if (st.vec) {                    // the butterfly: t 4, n_out 4
        const int4 i4 = *reinterpret_cast<const int4*>(idx + row);
        float v[4];
        if (kStaged && st.pairs) {     // x[i], x[i + 1] for i = i4.x, i4.z
          const float2 p0 = *reinterpret_cast<const float2*>(src + i4.x);
          const float2 p1 = *reinterpret_cast<const float2*>(src + i4.z);
          v[0] = p0.x, v[1] = p0.y, v[2] = p1.x, v[3] = p1.y;
          if (scale != nullptr) {
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] *= to_f32(scale[row + j]);
          }
        } else {
          v[0] = gathered(src, i4.x, pad, scale, row);
          v[1] = gathered(src, i4.y, pad, scale, row + 1);
          v[2] = gathered(src, i4.z, pad, scale, row + 2);
          v[3] = gathered(src, i4.w, pad, scale, row + 3);
        }
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wv =
              *reinterpret_cast<const float4*>(wg + 4 * (kk ^ wp));
          acc[0] = fmaf(v[kk], wv.x, acc[0]);
          acc[1] = fmaf(v[kk], wv.y, acc[1]);
          acc[2] = fmaf(v[kk], wv.z, acc[2]);
          acc[3] = fmaf(v[kk], wv.w, acc[3]);
        }
        const float4 y = make_float4(acc[0], acc[1], acc[2], acc[3]);
        if (kLast)
          *reinterpret_cast<float4*>(og) = y;
        else
          *reinterpret_cast<float4*>(ob + at(0)) = y;
        continue;
      }
    }
    if (t == 1 && n_out == 1) {        // an adjoint reduction of width 1
      const float y = fmaf(gathered(src, idx[row], pad, scale, row),
                           to_f32(wg[0]), 0.f);
      if (kLast)
        *og = from_f32<T>(y);
      else
        ob[at(0)] = to_f32(from_f32<T>(y));
      continue;
    }
    for (int o0 = 0; o0 < n_out; o0 += 4) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0_ = 0; k0_ < t; k0_ += 4) {
        int32_t ii[4];
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ii[j] = k0_ + j < t ? idx[row + k0_ + j] : -1;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = k0_ + j < t
                     ? gathered(src, ii[j], pad, scale, row + k0_ + j)
                     : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k0_ + j >= t) break;
          const T* wr = wg + (k0_ + j) * n_out + o0;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (o0 + q < n_out) acc[q] = fmaf(v[j], to_f32(wr[q]), acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (o0 + q >= n_out) break;
        if (kLast)
          og[o0 + q] = from_f32<T>(acc[q]);
        else
          ob[at(o0 + q)] = to_f32(from_f32<T>(acc[q]));
      }
    }
#undef at
  }
}

// kRows: the per-row instance, where a step with w_rows reads batch row
// b's operand at st.w + b * groups * t * n_out from device memory, and is
// not staged.
template <typename T, bool kRows>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const T* __restrict__ x, T* __restrict__ out, const Chain c,
             const ChainSteps cs) {
  extern __shared__ int4 smem[];
  char* const base = reinterpret_cast<char*>(smem);
  Step* const sd = reinterpret_cast<Step*>(base);     // the descriptors
  float* const buf0 = reinterpret_cast<float*>(base + c.off_buf);
  float* const buf1 = buf0 + c.buf_bytes / 4;
  // thread s copies descriptor s from the parameters: every later read is
  // a shared-memory broadcast, not a dynamically indexed parameter load
  if (threadIdx.x < c.count) sd[threadIdx.x] = cs.s[threadIdx.x];

  // once a block: the shared tables in one run and each later step's
  // operand in one more (a butterfly's groups' chunks permuted: wperm)
  if (c.shared_bytes)
    copy_in(base + c.off_shared, c.shared_tables, c.shared_bytes);
  __syncthreads();                                 // the descriptors
  // warp k stages the operands of steps k + 1, k + 1 + warps, ...: the
  // per-step work of issuing them runs in the warps side by side
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  for (int s = 1 + warp; s < c.count; s += warps) {
    const Step st = sd[s];
    if (kRows && st.w_rows) continue;
    const int bytes = static_cast<int>(sizeof(T)) * st.groups * st.t *
                      st.n_out;
    if (st.wperm)
      copy_xor(base + st.off_w, st.w, bytes, 3, 3, threadIdx.x % 32, 32);
    else
      copy_in(base + st.off_w, st.w, bytes, threadIdx.x % 32, 32);
  }

  const int64_t groups = (c.total + c.slots - 1) / c.slots;
  for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t j0 = grp * c.slots;
    const int64_t b0 = j0 / c.tiles;
    const int k0 = static_cast<int>(j0 - b0 * c.tiles);
    // each slot's own tables: the packed row of its tile
    if (c.own_bytes)
      for (int s = 0; s < c.slots && j0 + s < c.total; ++s)
        copy_in(base + c.off_own + s * c.own_bytes,
                static_cast<const char*>(c.own_tables) +
                    ((j0 + s) % c.tiles) * c.own_bytes,
                c.own_bytes);

    // step 0 from device memory while the copies land
    {
      const Step st = sd[0];
      const int32_t* idx = static_cast<const int32_t*>(c.idx0);
      const T* pad = c.pad0_zero ? nullptr : static_cast<const T*>(c.pad0);
      const T* scale = static_cast<const T*>(c.scale0);
      const T* w = static_cast<const T*>(st.w);
      const int64_t ws = kRows && st.w_rows ? row_operand(st) : 0;
      if (c.count == 1)
        run_step<T, T, false, true, kRows>(st, c, b0, k0, base, x, idx, pad,
                                           scale, w, nullptr, out, ws);
      else
        run_step<T, T, false, false, kRows>(st, c, b0, k0, base, x, idx, pad,
                                            scale, w, buf0, out, ws);
    }
    copies_landed();

    for (int s = 1; s < c.count; ++s) {
      const Step st = sd[s];
      const float* in = s & 1 ? buf0 : buf1;
      float* bo = s & 1 ? buf1 : buf0;
      const bool rw = kRows && st.w_rows;
      const T* w = rw ? static_cast<const T*>(st.w)
                      : reinterpret_cast<const T*>(base + st.off_w);
      const int64_t ws = rw ? row_operand(st) : 0;
      if (s == c.count - 1)
        run_step<T, float, true, true, kRows>(st, c, b0, k0, base, in,
                                              nullptr, nullptr, nullptr, w,
                                              nullptr, out, ws);
      else
        run_step<T, float, true, false, kRows>(st, c, b0, k0, base, in,
                                               nullptr, nullptr, nullptr, w,
                                               bo, out, ws);
      __syncthreads();
    }
  }
}

int log2_or_minus1(int v) {
  return v > 0 && (v & (v - 1)) == 0 ? __builtin_ctz(v) : -1;
}

// A region [off, off + bytes) of a layout of `total` bytes: 16-byte
// aligned and inside it (off -1: no region, bytes must be 0).
bool region_ok(int off, int64_t bytes, int64_t total) {
  if (off < 0) return bytes == 0;
  return off % 16 == 0 && bytes >= 0 && off + bytes <= total;
}

// dims of repro_shuffle_gemm_chain (chain.py chain_launch_args): tiles,
// slots (the layout's), rows a slot (threads a block: one a row of the
// median step), shared tables' offset and bytes, a tile's own table
// bytes, floats a slot's buffer holds, the fixed region's end, whether
// step 0's PAD values are all 0, then per step rows, t, n_out, groups,
// nb, periodic, its idx, pad, scale and w offsets, wperm, pairs and swz;
// then three ints the launch fills in: blocks, slots used, shared bytes a
// block.
constexpr int kChainDims = 9;
constexpr int kChainStepDims = 13;

// rows_mask: bit s set where step s takes one operand a batch row (the
// per-row instance; 0: the shared one).
template <typename T>
int launch_chain(const void* x, void* out, int batch, int n_in, int count,
                 const void* const* ptrs, int* dims, unsigned rows_mask,
                 cudaStream_t stream) {
  const int tiles = dims[0], slots = dims[1], slot_rows = dims[2];
  const int buf_floats = dims[6], fixed = dims[7];
  if (count < 1 || count > kMaxSub || tiles < 1 || slots < 1 ||
      slot_rows < 1 || batch < 1 || buf_floats < 0 || fixed < 0 ||
      slots > kChainThreads ||
      (count < 32 && (rows_mask >> count) != 0u))
    return static_cast<int>(cudaErrorInvalidValue);
  Chain c{};
  ChainSteps cs{};
  c.idx0 = ptrs[0];
  c.pad0 = ptrs[1];
  c.scale0 = ptrs[2];
  c.shared_tables = ptrs[3 + count];
  c.own_tables = ptrs[4 + count];
  c.total = static_cast<int64_t>(batch) * tiles;
  c.batch = batch;
  c.count = count;
  c.tiles = tiles;
  c.tiles_shift = log2_or_minus1(tiles);
  c.n_in = n_in;
  c.off_shared = dims[3];
  c.shared_bytes = dims[4];
  c.own_bytes = dims[5];
  c.pad0_zero = dims[8];
  // slots a block: enough blocks for two an SM, at most the layout's
  const int64_t want = (c.total + 2LL * sm_count() - 1) / (2LL * sm_count());
  const int active =
      want < 1 ? 1 : want > slots ? slots : static_cast<int>(want);
  c.slots = active;
  const int es = static_cast<int>(sizeof(T));
  bool ok = c.idx0 != nullptr && c.pad0 != nullptr &&
            fixed >= align16(static_cast<int>(sizeof(Step)) * count) &&
            c.own_bytes % 16 == 0 &&
            region_ok(c.shared_bytes ? c.off_shared : -1, c.shared_bytes,
                      fixed) &&
            (c.shared_bytes == 0 || c.shared_tables != nullptr) &&
            (c.own_bytes == 0 || c.own_tables != nullptr);
  int need = 0;                         // buffered floats a slot's steps write
  for (int s = 0; s < count && ok; ++s) {
    Step& st = cs.s[s];
    const int* d = dims + kChainDims + kChainStepDims * s;
    st.w = ptrs[3 + s];
    st.rows = d[0];
    st.t = d[1];
    st.n_out = d[2];
    st.groups = d[3];
    st.nb = d[4];
    st.periodic = s > 0 && d[5];
    st.off_idx = d[6];
    st.off_pad = d[7];
    st.off_scale = d[8];
    st.off_w = d[9];
    st.wperm = d[10];
    st.pairs = d[11];
    st.swz = d[12];
    st.w_rows = (rows_mask >> s) & 1u;
    if (st.w_rows) st.wperm = 0;     // its operand is read, not staged
    ok = st.rows >= 1 && st.t >= 1 && st.n_out >= 1 && st.groups >= 1 &&
         st.nb >= 1 && st.rows % tiles == 0 &&
         st.rows % (st.groups * st.nb) == 0 && st.w != nullptr &&
         (st.wperm == 0 || (s > 0 && sizeof(T) == 4 && st.t == 4 &&
                            st.n_out == 4 && st.groups > 1)) &&
         (st.swz == 0 || (s + 1 < count &&
                          (st.rows / tiles * st.n_out) % 32 == 0));
    if (!ok) break;
    st.rpt = st.rows / tiles;
    st.in_stride = s > 0 ? cs.s[s - 1].rpt * cs.s[s - 1].n_out : 0;
    st.rpt_shift = log2_or_minus1(st.rpt);
    st.nb_shift = log2_or_minus1(st.nb);
    st.groups_shift = log2_or_minus1(st.groups);
    if (s + 1 < count && st.rpt * st.n_out > need)
      need = st.rpt * st.n_out;
    if (s == 0) {
      // 16-byte accesses to step 0's tables and operand in device memory
      st.vec = sizeof(T) == 4 && st.t == 4 && st.n_out == 4 &&
               ((reinterpret_cast<uintptr_t>(c.idx0) |
                 reinterpret_cast<uintptr_t>(st.w)) & 15) == 0;
      st.pairs = 0;
      continue;
    }
    st.vec = sizeof(T) == 4 && st.t == 4 && st.n_out == 4 &&
             (!st.w_rows || (reinterpret_cast<uintptr_t>(st.w) & 15) == 0);
    st.pairs = st.pairs && st.vec && st.in_stride % 2 == 0;
    const int64_t n = static_cast<int64_t>(st.rpt) * st.t;
    const int64_t limit = st.periodic ? fixed : c.own_bytes;
    ok = st.off_idx >= 0 && region_ok(st.off_idx, 4 * n, limit) &&
         region_ok(st.off_pad, st.off_pad >= 0 ? es * n : 0, limit) &&
         region_ok(st.off_scale, st.off_scale >= 0 ? es * n : 0, limit) &&
         st.off_w >= 0 &&
         region_ok(st.off_w, static_cast<int64_t>(es) * st.groups * st.t *
                                 st.n_out, fixed);
  }
  if (!ok || buf_floats < need) return static_cast<int>(cudaErrorInvalidValue);
  // the slots' regions after the fixed one: own tables, two buffers
  c.off_own = fixed;
  c.off_buf = c.off_own + active * c.own_bytes;
  c.buf_bytes = align16(4 * active * buf_floats);
  const int64_t total = c.off_buf + 2LL * c.buf_bytes;
  if (total > kSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const Step& last = cs.s[count - 1];
  c.n_last = last.rows * last.n_out;
  int threads = (active * slot_rows + 31) / 32 * 32;
  threads = threads > kChainThreads ? kChainThreads : threads;
  threads = threads < 32 ? 32 : threads;
  if (threads < count) threads = (count + 31) / 32 * 32;
  const int smem = static_cast<int>(total);
  auto* body = rows_mask ? chain_kernel<T, true> : chain_kernel<T, false>;
  int err = rows_mask ? allow_shared<chain_kernel<T, true>>()
                      : allow_shared<chain_kernel<T, false>>();
  if (err) return err;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, body, threads, smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const int64_t groups = (c.total + active - 1) / active;
  const int64_t resident = static_cast<int64_t>(sm_count()) * per_sm;
  const int64_t blocks = groups < resident ? groups : resident;
  int* g = dims + kChainDims + kChainStepDims * count;
  g[0] = static_cast<int>(blocks);
  g[1] = active;
  g[2] = smem;
  body<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c, cs);
  return static_cast<int>(cudaGetLastError());
}

__global__ void copy_kernel(const float* __restrict__ x, float* __restrict__ y,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i];
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x (batch, n_in); idx/pad/scale
// (rows, t), scale may be null; w (t, n_out) shared by every batch row
// (w_stride 0) or (batch, t, n_out), one a batch row (w_stride t * n_out);
// out (batch, rows, n_out).  dims: kStagedDims ints of a staged layout
// (kernels/shuffle_gemm/tiling.py; rt 0: none) and four the launch
// writes (its grid, rows or batch rows a block, body).  A shared operand
// with a staged layout takes the staged body (spans: per tile the (lo,
// hi) of x its rows read, or null where the layout's spans are affine);
// without one, the sequential body.  A per-row operand takes the wide
// body at t >= 32 where its staging fits shared memory, else the
// sequential one.  Returns the cudaGetLastError() code
// of the launch (0 = success); cudaErrorInvalidValue for a w_stride that is
// neither or a layout out of range.
int repro_shuffle_gemm_blocks(const void* x, const void* idx, const void* pad,
                              const void* scale, const void* w, void* out,
                              int batch, int n_in, int rows, int t, int n_out,
                              int w_stride, const void* spans, void* dims,
                              int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_stride != 0 && w_stride != t * n_out)
    return static_cast<int>(cudaErrorInvalidValue);
  int* d = static_cast<int*>(dims);
  const bool staged = d[0] != 0;
  if (staged && w_stride != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int2* sp = static_cast<const int2*>(spans);
  int* launched = d + kStagedDims;
  switch (dtype) {
    case 0:
      return staged
                 ? launch_staged<float>(x, idx, pad, scale, w, out, batch,
                                        n_in, rows, t, n_out, sp, d, s)
                 : launch_blocks<float>(x, idx, pad, scale, w, out, batch,
                                        n_in, rows, t, n_out, w_stride,
                                        launched, s);
    case 1:
      return staged
                 ? launch_staged<__nv_bfloat16>(x, idx, pad, scale, w, out,
                                                batch, n_in, rows, t, n_out,
                                                sp, d, s)
                 : launch_blocks<__nv_bfloat16>(x, idx, pad, scale, w, out,
                                                batch, n_in, rows, t, n_out,
                                                w_stride, launched, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above with w (groups, t, n_out), shared by every batch row (w_stride
// 0), or (batch, groups, t, n_out), one a batch row (w_stride groups * t *
// n_out), and rows = reps * groups * nb in flat (reps, groups, nb) order;
// out (batch, rows * n_out).  Always the sequential body, one fmaf chain at
// every t.  cudaErrorInvalidValue for a w_stride that is neither.
int repro_shuffle_gemm_grouped_blocks(const void* x, const void* idx,
                                      const void* pad, const void* scale,
                                      const void* w, void* out, int batch,
                                      int n_in, int reps, int groups, int nb,
                                      int t, int n_out, int w_stride,
                                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = reps * groups * nb;
  if (w_stride != 0 && w_stride != groups * t * n_out)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(x, idx, pad, scale, w, out, batch, n_in, rows, t,
                           n_out, groups, nb, w_stride, false, s);
    case 1:
      return launch<__nv_bfloat16>(x, idx, pad, scale, w, out, batch, n_in,
                                   rows, t, n_out, groups, nb, w_stride,
                                   false, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A chain of `count` steps in one launch.  x (batch, n_in); out (batch,
// rows * n_out of the last step).  ptrs: a host array of count + 5 device
// pointers: step 0's idx, pad and scale (null without a diag), every
// step's operand w (groups, t, n_out), or (batch, groups, t, n_out) where
// bit s of rows_mask is set, then the packed tables of the later periodic
// steps and of the others (a row a tile; either null when empty).  dims: a
// host array of kChainDims + kChainStepDims * count + 3 ints (see
// kChainDims); the last three are written.  Returns the CUDA error code of
// the launch (0 = success); cudaErrorInvalidValue for arguments out of
// range or a region outside the layout.
int repro_shuffle_gemm_chain(const void* x, void* out, int batch, int n_in,
                             int count, const void* ptrs, void* dims,
                             int rows_mask, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const* p = static_cast<const void* const*>(ptrs);
  int* d = static_cast<int*>(dims);
  const unsigned mask = static_cast<unsigned>(rows_mask);
  switch (dtype) {
    case 0:
      return launch_chain<float>(x, out, batch, n_in, count, p, d, mask, s);
    case 1:
      return launch_chain<__nv_bfloat16>(x, out, batch, n_in, count, p, d,
                                         mask, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Capability probe: y[:n] = x[:n] (float32).
int repro_copy_f32(const float* x, float* y, int n, void* stream) {
  copy_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
