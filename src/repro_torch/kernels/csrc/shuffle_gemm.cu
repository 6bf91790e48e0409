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
// (B, R, n_out) output has the same memory as the flat (B, R * n_out) one).
// The blocks form also takes one operand per batch row, w (B, t, n_out):
// batch row b contracts against w[b] (a weight batch stride of t * n_out
// elements; 0 is the shared operand).  A wave of requests whose graphs
// registered different weights (the serving scheduler's cross-graph wave)
// is then one launch, as the JAX package's vmap over the Pallas kernel
// gives a batched grid.  Each body only offsets its operand pointer by
// b * stride, so row b's arithmetic is the shared call's on w[b], bit for
// bit.
// A third entry, repro_shuffle_gemm_chain, runs a list of such steps, each
// gathering from the one before, in one launch.
//
// What bounds them on this card: latency, not bytes or arithmetic.  The
// Fig-9 calls move 0.05-0.6 MB and do under 1 MFLOP (0.02-0.2 us at 3.35
// TB/s), against a launch of about 2 us; past the launch, a call's time
// follows the longest chain of dependent steps in one thread.  Three bodies:
//
// 1. Sequential (t < kWideT, and every grouped call): one thread per output
//    element (b, r, o) walks the t gathered inputs of its row in order —
//    the PAD constant where idx < 0, times the scale, fmaf into a float32
//    sum — and stores in the input type.  For t of 1-9 (the FIR taps, the
//    adjoint reductions, the butterflies) that chain is as short as the
//    launch.  The ragged edge is masked; rows need no padding.
// 2. Wide rows (blocks form, t >= kWideT): the mel call (rows 31, t 129,
//    n_out 24) took 11.30 us on body 1, a chain of 129 dependent
//    idx -> x -> fmaf steps in each of only 2,976 threads.  Here a CTA
//    takes a few rows of one batch row and issues every load before using
//    any: w (t x n_out) by 16-byte cp.async, then the rows' gathered x
//    values (or PAD constants) and scales by 4-byte cp.async straight from
//    their gathered addresses, all in flight together.  Each output is then
//    owned by kLanes lanes that split K (lane l takes k = l, l + kLanes,
//    ...) and sum by __shfl_xor_sync: the chain per thread is t / kLanes
//    FMAs.  The mel call now takes 2.6 us.  No tensor cores: the mel call
//    is 0.77 MFLOP, about 0.01 us at the float32 FMA rate; TF32 wgmma
//    misses the 1e-5 parity tolerance, and a 3xTF32 split would lengthen a
//    call that is bound by latency.
// 3. Chains (repro_shuffle_gemm_chain): consecutive butterflies of an
//    STFT/iSTFT stage (and their backward) each read only what the step
//    before wrote, and in the Fig-9 STFT only within one 512-float frame;
//    one launch a step paid ~2.2 us each, 16 steps a forward.  The host
//    (kernels/shuffle_gemm/chain.py) cuts the list into segments, each
//    segment's vectors into equal tiles that no step reads across, and lays
//    out a block's shared memory; it packs the tables of every step after
//    the first (indices rebased to the tile, PAD values, scales; one tile's
//    copy where the tiles' tables agree) into two device buffers in that
//    layout.  One CTA runs one tile (or a few) of one batch row: it copies
//    the step descriptors into shared memory, stages the two packed buffers
//    by two contiguous runs of 16-byte cp.async and each step's operand by
//    one more (the warps side by side), computes the first step from device
//    memory meanwhile, waits once, then runs every later step between two
//    shared-memory buffers with one __syncthreads between steps, and writes
//    only the last step's output to device memory.  Each thread owns rows
//    (16-byte index, operand and output accesses for the t 4, n_out 4
//    butterfly); per output the arithmetic is body 1's (gather, PAD, scale,
//    fmaf over k = 0..t-1 in order, the result rounded to the input type
//    between steps), so a chain is bit for bit its steps launched one at a
//    time through the grouped entry.  A Fig-9 STFT chain of 8 takes 5.8 us
//    against 17.5 us for its steps launched one at a time; a first design
//    that staged each table and each operand row by a copy of its own took
//    12.8 us, the staging a chain of short dependent steps per thread
//    (tools/chain_ablation.py times the parts).
//
// Bodies 1 and 2 take batch row b on grid row b.  A batch past the grid's
// y extent (65535: the 2-D DCT-32 of 4096 blocks is one call on 131072
// rows) runs the bodies' layered instance (kLayered): b = z * gridDim.y +
// y, the grid's z layers holding the rest, one launch, each block still
// one batch row.  Smaller batches run the instance without the layer
// arithmetic or its bound check, which cost short calls up to 11%
// (tools/blocks_timing.py).
//
// float32 and bfloat16 are accepted; every body accumulates in float32 and
// stores in the input type.  The times above are device times on an NVIDIA
// H100 80GB HBM3 at 700 W from chip_smoke.py; PERF.md §6 has them all.

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
constexpr int kWideT = 32;          // t from which the blocks form splits K
constexpr int kLanes = 8;           // lanes that split one output's K
constexpr int kWideThreads = 256;
constexpr int kMaxSub = 32;         // steps of one chain launch
constexpr int kChainThreads = 512;
constexpr int kSharedBytes = 227 * 1024;   // a block's opt-in maximum
constexpr int kMaxGridY = 65535;           // the grid's y extent

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) / 16 * 16;
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
    const uint32_t ds = static_cast<uint32_t>(__cvta_generic_to_shared(d));
    for (int e = first; e < bytes / 16; e += stride)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       ds + 16 * e),
                   "l"(g + 16 * e)
                   : "memory");
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

// ---------------------------------------------------------------------------
// 1. Sequential body: one thread per output element
// ---------------------------------------------------------------------------

template <typename T, bool kLayered>
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
           int n_out, int groups, int nb, int64_t w_stride,
           cudaStream_t stream) {
  const int64_t per_batch = static_cast<int64_t>(rows) * n_out;
  const dim3 grid = batch_grid((per_batch + kThreads - 1) / kThreads, batch);
  auto* body = grid.z > 1 ? shuffle_gemm_kernel<T, true>
                          : shuffle_gemm_kernel<T, false>;
  body<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const T*>(pad), static_cast<const T*>(scale),
      static_cast<const T*>(w), static_cast<T*>(out), batch, n_in, rows, t,
      n_out, groups, nb, w_stride);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. Wide rows (blocks form): staged rows, K split over kLanes lanes
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
  // batch row's (w_stride 0: the one shared by every row)
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

template <typename T>
int launch_blocks(const void* x, const void* idx, const void* pad,
                  const void* scale, const void* w, void* out, int batch,
                  int n_in, int rows, int t, int n_out, int64_t w_stride,
                  cudaStream_t stream) {
  const int rpc = wide_rows_per_cta(rows, n_out);
  const size_t smem = wide_shared_bytes<T>(t, n_out, rpc, scale != nullptr);
  if (t < kWideT || smem > static_cast<size_t>(kSharedBytes))
    return launch<T>(x, idx, pad, scale, w, out, batch, n_in, rows, t, n_out,
                     1, rows, w_stride, stream);
  static bool configured = false;     // once, before any graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wide_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          wide_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  int threads = rpc * n_out * kLanes;
  threads = threads < kWideThreads ? (threads + 31) / 32 * 32 : kWideThreads;
  const dim3 grid = batch_grid((rows + rpc - 1) / rpc, batch);
  auto* body = grid.z > 1 ? wide_kernel<T, true> : wide_kernel<T, false>;
  body<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const T*>(pad), static_cast<const T*>(scale),
      static_cast<const T*>(w), static_cast<T*>(out), batch, n_in, rows, t,
      n_out, rpc, w_stride);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 3. Chains: a list of steps in one launch, tile by tile in shared memory
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
                                           // (-1: none)
};
static_assert(sizeof(Step) == 72, "chain.py STEP_BYTES mirrors this size");

struct Chain {
  const void* idx0;            // step 0's (rows, t) tables over the input
  const void* pad0;
  const void* scale0;          // or null
  const void* shared_tables;   // the periodic steps' tables, packed
  const void* own_tables;      // the other steps', one packed row a block
  int count, tiles, tpc, n_in, n_last, buf_floats, off_buf;
  int off_shared, shared_bytes, off_own, own_bytes;
  Step s[kMaxSub];
};

__device__ __forceinline__ int divide(int a, int d, int shift) {
  return shift >= 0 ? a >> shift : a / d;
}

// A step's input value k of a row: the PAD constant or the gathered one,
// times the scale.
template <typename T, typename In>
__device__ __forceinline__ float gathered(const In* src, int32_t i,
                                          const T* pad, const T* scale,
                                          int64_t e) {
  float v = i < 0 ? to_f32(pad[e]) : to_f32(src[i]);
  if (scale != nullptr) v *= to_f32(scale[e]);
  return v;
}

// One step over the rows of the block's tiles.  Step 0 (kStaged false)
// reads the chain input of batch row b with global indices, and its
// tables and operand from device memory; a later step reads the block's
// input buffer (one in_stride-float slice a tile, indices rebased) and
// its tables and operand staged in shared memory.  Tables are (rows, t),
// operands (groups, t, n_out), row-major in both.  The result goes to the
// block's output buffer (float32 values rounded to T) or, for the last
// step, to device memory.  Per output: gather, PAD constant, scale
// multiply, fmaf over k = 0..t-1 in order — the sequential body's
// arithmetic.
template <typename T, typename In, bool kStaged, bool kLast>
__device__ __forceinline__ void run_step(
    const Step st, const Chain& c, const In* __restrict__ in,
    const int32_t* __restrict__ idx, const T* __restrict__ pad,
    const T* __restrict__ scale, const T* __restrict__ w, float* buf_out,
    T* __restrict__ out, int64_t b, int k0) {
  const int rpt = st.rpt, t = st.t, n_out = st.n_out, groups = st.groups;
  const int ept = rpt * n_out;
  for (int lr = threadIdx.x; lr < c.tpc * rpt; lr += blockDim.x) {
    const int tc = divide(lr, rpt, st.rpt_shift);
    const int r = lr - tc * rpt;
    const int grow = (k0 + tc) * rpt + r;          // row within batch row
    const int blk = divide(grow, st.nb, st.nb_shift);
    const int g = st.groups_shift >= 0 ? blk & (groups - 1) : blk % groups;
    const int64_t row = static_cast<int64_t>(kStaged ? (st.periodic ? r : lr)
                                                     : grow) * t;
    const In* src = in + (kStaged ? tc * st.in_stride : 0);
    const T* wg = w + static_cast<int64_t>(g) * t * n_out;
    float* ob = kLast ? nullptr : buf_out + tc * ept + r * n_out;
    T* og = kLast ? out + b * c.n_last +
                        static_cast<int64_t>(k0 + tc) * ept + r * n_out
                  : nullptr;
    if constexpr (std::is_same<T, float>::value) {
      if (st.vec) {                    // the butterfly: t 4, n_out 4
        const int4 i4 = *reinterpret_cast<const int4*>(idx + row);
        const float v[4] = {gathered(src, i4.x, pad, scale, row),
                            gathered(src, i4.y, pad, scale, row + 1),
                            gathered(src, i4.z, pad, scale, row + 2),
                            gathered(src, i4.w, pad, scale, row + 3)};
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 wv = *reinterpret_cast<const float4*>(wg + 4 * k);
          acc[0] = fmaf(v[k], wv.x, acc[0]);
          acc[1] = fmaf(v[k], wv.y, acc[1]);
          acc[2] = fmaf(v[k], wv.z, acc[2]);
          acc[3] = fmaf(v[k], wv.w, acc[3]);
        }
        const float4 y = make_float4(acc[0], acc[1], acc[2], acc[3]);
        if (kLast)
          *reinterpret_cast<float4*>(og) = y;
        else
          *reinterpret_cast<float4*>(ob) = y;
        continue;
      }
    }
    if (t == 1 && n_out == 1) {        // an adjoint reduction of width 1
      const float y = fmaf(gathered(src, idx[row], pad, scale, row),
                           to_f32(wg[0]), 0.f);
      if (kLast)
        *og = from_f32<T>(y);
      else
        *ob = to_f32(from_f32<T>(y));
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
          ob[o0 + q] = to_f32(from_f32<T>(acc[q]));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const T* __restrict__ x, T* __restrict__ out, const Chain c) {
  extern __shared__ int4 smem[];
  char* const base = reinterpret_cast<char*>(smem);
  Step* const sd = reinterpret_cast<Step*>(base);     // the descriptors
  float* const buf0 = reinterpret_cast<float*>(base + c.off_buf);
  float* const buf1 = buf0 + align16(4 * c.buf_floats) / 4;
  const int j0 = blockIdx.x * c.tpc;               // tiles tpc | tiles
  const int64_t b = j0 / c.tiles;
  const int k0 = j0 - static_cast<int>(b) * c.tiles;
  // thread s copies descriptor s from the parameters: every later read is
  // a shared-memory broadcast, not a dynamically indexed parameter load
  if (threadIdx.x < c.count) sd[threadIdx.x] = c.s[threadIdx.x];

  // every later step's tables and operand in one burst: two packed runs
  // of tables and one run an operand
  if (c.shared_bytes)
    copy_in(base + c.off_shared, c.shared_tables, c.shared_bytes);
  if (c.own_bytes)
    copy_in(base + c.off_own,
            static_cast<const char*>(c.own_tables) +
                static_cast<int64_t>(k0 / c.tpc) * c.own_bytes,
            c.own_bytes);
  __syncthreads();                                 // the descriptors
  // warp k stages the operands of steps k + 1, k + 1 + warps, ...: the
  // per-step work of issuing them runs in the warps side by side
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  for (int s = 1 + warp; s < c.count; s += warps) {
    const Step st = sd[s];
    copy_in(base + st.off_w, st.w,
            static_cast<int>(sizeof(T)) * st.groups * st.t * st.n_out,
            threadIdx.x % 32, 32);
  }

  // step 0 from device memory while they land
  {
    const Step st = sd[0];
    const T* xb = x + b * c.n_in;
    const int32_t* idx = static_cast<const int32_t*>(c.idx0);
    const T* pad = static_cast<const T*>(c.pad0);
    const T* scale = static_cast<const T*>(c.scale0);
    const T* w = static_cast<const T*>(st.w);
    if (c.count == 1)
      run_step<T, T, false, true>(st, c, xb, idx, pad, scale, w, nullptr,
                                  out, b, k0);
    else
      run_step<T, T, false, false>(st, c, xb, idx, pad, scale, w, buf0, out,
                                   b, k0);
  }
  copies_landed();

  for (int s = 1; s < c.count; ++s) {
    const Step st = sd[s];
    const float* in = s & 1 ? buf0 : buf1;
    float* bo = s & 1 ? buf1 : buf0;
    const int32_t* idx = reinterpret_cast<const int32_t*>(base + st.off_idx);
    const T* pad = st.off_pad >= 0
                       ? reinterpret_cast<const T*>(base + st.off_pad)
                       : nullptr;
    const T* scale = st.off_scale >= 0
                         ? reinterpret_cast<const T*>(base + st.off_scale)
                         : nullptr;
    const T* w = reinterpret_cast<const T*>(base + st.off_w);
    if (s == c.count - 1)
      run_step<T, float, true, true>(st, c, in, idx, pad, scale, w, nullptr,
                                     out, b, k0);
    else
      run_step<T, float, true, false>(st, c, in, idx, pad, scale, w, bo, out,
                                      b, k0);
    __syncthreads();
  }
}

int log2_or_minus1(int v) {
  return v > 0 && (v & (v - 1)) == 0 ? __builtin_ctz(v) : -1;
}

// A region [off, off + bytes) of a layout of `total` bytes: 16-byte
// aligned and inside it (off -1: no region, bytes must be 0).
bool region_ok(int off, int64_t bytes, int total) {
  if (off < 0) return bytes == 0;
  return off % 16 == 0 && bytes >= 0 && off + bytes <= total;
}

template <typename T>
int launch_chain(const void* x, void* out, int batch, int n_in, int count,
                 const void* const* ptrs, const int* dims,
                 cudaStream_t stream) {
  const int tiles = dims[0], tpc = dims[1], threads = dims[2];
  const int total = dims[9];
  if (count < 1 || count > kMaxSub || tiles < 1 || tpc < 1 || tiles % tpc ||
      batch < 1 || threads < 32 || threads > kChainThreads || threads % 32 ||
      threads < count || total > kSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  Chain c{};
  c.idx0 = ptrs[0];
  c.pad0 = ptrs[1];
  c.scale0 = ptrs[2];
  c.shared_tables = ptrs[3 + count];
  c.own_tables = ptrs[4 + count];
  c.count = count;
  c.tiles = tiles;
  c.tpc = tpc;
  c.n_in = n_in;
  c.off_buf = dims[3];
  c.buf_floats = dims[4];
  c.off_shared = dims[5];
  c.shared_bytes = dims[6];
  c.off_own = dims[7];
  c.own_bytes = dims[8];
  const int es = static_cast<int>(sizeof(T));
  bool ok = c.idx0 != nullptr && c.pad0 != nullptr &&
            c.off_buf >= align16(static_cast<int>(sizeof(Step)) * count) &&
            region_ok(c.off_buf, 2LL * align16(4 * c.buf_floats), total) &&
            region_ok(c.shared_bytes ? c.off_shared : -1, c.shared_bytes,
                      total) &&
            region_ok(c.own_bytes ? c.off_own : -1, c.own_bytes, total) &&
            (c.shared_bytes == 0 || c.shared_tables != nullptr) &&
            (c.own_bytes == 0 || c.own_tables != nullptr);
  int need = 0;                         // buffered floats the steps write
  for (int s = 0; s < count && ok; ++s) {
    Step& st = c.s[s];
    const int* d = dims + 10 + 10 * s;
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
    ok = st.rows >= 1 && st.t >= 1 && st.n_out >= 1 && st.groups >= 1 &&
         st.nb >= 1 && st.rows % tiles == 0 &&
         st.rows % (st.groups * st.nb) == 0 && st.w != nullptr;
    if (!ok) break;
    st.rpt = st.rows / tiles;
    st.in_stride = s > 0 ? c.s[s - 1].rpt * c.s[s - 1].n_out : 0;
    st.rpt_shift = log2_or_minus1(st.rpt);
    st.nb_shift = log2_or_minus1(st.nb);
    st.groups_shift = log2_or_minus1(st.groups);
    if (s + 1 < count && st.rpt * st.n_out * tpc > need)
      need = st.rpt * st.n_out * tpc;
    if (s == 0) {
      // 16-byte accesses to step 0's tables and operand in device memory
      st.vec = sizeof(T) == 4 && st.t == 4 && st.n_out == 4 &&
               ((reinterpret_cast<uintptr_t>(c.idx0) |
                 reinterpret_cast<uintptr_t>(st.w)) & 15) == 0;
      continue;
    }
    st.vec = sizeof(T) == 4 && st.t == 4 && st.n_out == 4;
    const int64_t n = static_cast<int64_t>(st.rpt) *
                      (st.periodic ? 1 : tpc) * st.t;
    ok = st.off_idx >= 0 && region_ok(st.off_idx, 4 * n, total) &&
         region_ok(st.off_pad, st.off_pad >= 0 ? es * n : 0, total) &&
         region_ok(st.off_scale, st.off_scale >= 0 ? es * n : 0, total) &&
         st.off_w >= 0 &&
         region_ok(st.off_w,
                   static_cast<int64_t>(es) * st.groups * st.t * st.n_out,
                   total);
  }
  if (!ok || c.buf_floats < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const Step& last = c.s[count - 1];
  c.n_last = last.rows * last.n_out;
  static bool configured = false;     // once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int64_t blocks = static_cast<int64_t>(batch) * tiles / tpc;
  chain_kernel<T><<<static_cast<unsigned>(blocks), threads, total, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c);
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
// out (batch, rows, n_out).  t >= 32 takes the wide-row body where its
// staging fits shared memory.  Returns the cudaGetLastError() code of the
// launch (0 = success); cudaErrorInvalidValue for a w_stride that is
// neither.
int repro_shuffle_gemm_blocks(const void* x, const void* idx, const void* pad,
                              const void* scale, const void* w, void* out,
                              int batch, int n_in, int rows, int t, int n_out,
                              int w_stride, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_stride != 0 && w_stride != t * n_out)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_blocks<float>(x, idx, pad, scale, w, out, batch, n_in,
                                  rows, t, n_out, w_stride, s);
    case 1:
      return launch_blocks<__nv_bfloat16>(x, idx, pad, scale, w, out, batch,
                                          n_in, rows, t, n_out, w_stride, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above with w (groups, t, n_out) and rows = reps * groups * nb in flat
// (reps, groups, nb) order; out (batch, rows * n_out).  Always the
// sequential body.
int repro_shuffle_gemm_grouped_blocks(const void* x, const void* idx,
                                      const void* pad, const void* scale,
                                      const void* w, void* out, int batch,
                                      int n_in, int reps, int groups, int nb,
                                      int t, int n_out, int dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = reps * groups * nb;
  switch (dtype) {
    case 0:
      return launch<float>(x, idx, pad, scale, w, out, batch, n_in, rows, t,
                           n_out, groups, nb, 0, s);
    case 1:
      return launch<__nv_bfloat16>(x, idx, pad, scale, w, out, batch, n_in,
                                   rows, t, n_out, groups, nb, 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A chain of `count` steps in one launch.  x (batch, n_in); out (batch,
// rows * n_out of the last step).  ptrs: a host array of count + 5 device
// pointers: step 0's idx, pad and scale (null without a diag), every
// step's operand w (groups, t, n_out), then the packed tables of the later
// periodic steps and of the others (a row a block; either null when
// empty).  dims: a host array of 10 + 10 * count ints: tiles, tiles a
// block, threads a block, then the shared-memory layout of
// kernels/shuffle_gemm/chain.py chain_layout (buffer offset, floats a
// buffer, shared tables' offset and bytes, own tables' offset and bytes,
// total bytes), then per step rows, t, n_out, groups, nb, periodic and
// its idx, pad, scale and w offsets (-1: none; step 0 reads its own from
// device memory).  Returns the CUDA error code of the launch (0 =
// success); cudaErrorInvalidValue for arguments out of range or a region
// outside the layout.
int repro_shuffle_gemm_chain(const void* x, void* out, int batch, int n_in,
                             int count, const void* ptrs, const void* dims,
                             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const* p = static_cast<const void* const*>(ptrs);
  const int* d = static_cast<const int*>(dims);
  switch (dtype) {
    case 0:
      return launch_chain<float>(x, out, batch, n_in, count, p, d, s);
    case 1:
      return launch_chain<__nv_bfloat16>(x, out, batch, n_in, count, p, d,
                                         s);
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
