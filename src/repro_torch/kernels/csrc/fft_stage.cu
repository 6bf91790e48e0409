// Radix-2 DIT FFT stages as fused fabric + array kernels (paper Fig 3a)
// for Hopper (sm_90a): a list of S >= 1 stages in one launch.
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
// flat (j, blk, o) layout the next stage's composed gather reads.  Stage s
// of a list reads idx[s] ((S, 2n) int32) and the twiddles from row
// tw_row[s] of the stages' concatenated (sum of halves, 4, 4) twiddles;
// after the last stage an optional final scatter (the plan's gather back to
// natural order, PAD -> 0, as apply_plan does) writes the output.
//
// What bounds it on this card: launch latency, then the latency of each
// stage's dependent loads.  A 256-point FFT over the 124 Fig-9 STFT frames
// reads and writes 254 KB (0.15 us at 3.35 TB/s) and does 8 flops an
// element a stage (0.12 us at 67 TFLOP/s), far below the 1.7-1.9 us a
// launch costs, so the design spends one launch on all stages.  As the TPU
// kernel keeps a length-2n signal block in VMEM, a block keeps whole frames
// in shared memory: it loads its frames' 2n reals once, and with them the
// stages' index, twiddle and scatter tables where they fit (36 KB at n
// 256), all as asynchronous copies in flight at once, so the block waits
// on device memory once and no stage waits on it.  It
// then runs every stage between two 2n-float buffers: each thread owns
// (j, blk) rows, fixed for all stages; it gathers a row's 4 inputs by the
// stage's idx, multiplies by the class's 4x4 twiddle accumulating in
// float32 in the order i = 0..3, writes 4 outputs to the other buffer, and
// the block synchronises.  The last stage's output goes through the
// scatter to device memory.  That is the shared-memory branch, taken for a
// list of more than one stage or with a scatter, when the two buffers fit
// (n <= 8192: 128 KB): a 256-point frame is 128 threads, one frame a
// block, 124 blocks over 132 SMs; small n takes several frames a block.
// One stage without scatter (and every stage above n 8192) runs from
// device memory instead, one thread per (frame, row): one launch a stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 16;
constexpr int kMaxThreads = 512;
constexpr int kGlobalThreads = 256;
constexpr int kBufferBytes = 128 * 1024;     // two (frames, 2n) buffers
constexpr int kSharedBytes = 227 * 1024;     // a block's opt-in maximum

struct Stages {
  int count;
  int tw_rows;              // 4x4 twiddles of all stages
  int nb[kMaxStages];       // blocks a twiddle class
  int nb_shift[kMaxStages]; // log2 nb, or -1 when nb is no power of two
  int tw_row[kMaxStages];   // the stage's first 4x4 twiddle in tw
};

// The twiddle class of a row of stage s.
__device__ __forceinline__ int twiddle_class(const Stages& st, int s,
                                             int row) {
  return st.nb_shift[s] >= 0 ? row >> st.nb_shift[s] : row / st.nb[s];
}

// One (j, blk) row of a stage: y[4 row + o] = sum_i t[o][i] x[ri[i]],
// accumulated in the order i = 0..3.  kVec: t and out are 16-byte aligned
// (shared memory), read and written 16 bytes at a time.
template <bool kVec>
__device__ __forceinline__ void butterfly(const float* in, float* out,
                                          int row, int4 ri, const float* t) {
  const float g0 = in[ri.x], g1 = in[ri.y], g2 = in[ri.z], g3 = in[ri.w];
  float yo[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const float4 to = kVec ? reinterpret_cast<const float4*>(t)[o]
                           : make_float4(t[4 * o], t[4 * o + 1],
                                         t[4 * o + 2], t[4 * o + 3]);
    float acc = 0.f;
    acc = fmaf(to.x, g0, acc);
    acc = fmaf(to.y, g1, acc);
    acc = fmaf(to.z, g2, acc);
    acc = fmaf(to.w, g3, acc);
    yo[o] = acc;
  }
  if (kVec) {
    *reinterpret_cast<float4*>(out + 4 * row) =
        make_float4(yo[0], yo[1], yo[2], yo[3]);
  } else {
#pragma unroll
    for (int o = 0; o < 4; ++o) out[4 * row + o] = yo[o];
  }
}

// Block-wide asynchronous copy of `bytes` (a multiple of 16) into shared
// memory: every thread issues all its copies before any completes (16 bytes
// each where the source is aligned for it), so the block waits for device
// memory once, in copies_landed().
__device__ __forceinline__ void copy_in(void* dst, const void* src,
                                        int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const char* g = static_cast<const char*>(src);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int e = threadIdx.x; e < bytes / 16; e += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       d + 16 * e),
                   "l"(g + 16 * e)
                   : "memory");
  } else {
    for (int e = threadIdx.x; e < bytes / 4; e += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d + 4 * e),
                   "l"(g + 4 * e)
                   : "memory");
  }
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// All stages of `frames` frames a block in shared memory, then the scatter
// to y.  kStaged: the stages' index, twiddle and scatter tables are copied
// into shared memory too (they fit), else read from device memory.
template <bool kStaged>
__device__ __forceinline__ void run_shared(
    const float* __restrict__ x, const int32_t* __restrict__ idx,
    const float* __restrict__ tw, const int32_t* __restrict__ scatter,
    float* __restrict__ y, int batch, int n2, const Stages& stages,
    int frames) {
  extern __shared__ int4 smem[];
  float* const a = reinterpret_cast<float*>(smem);   // (frames, n2) x 2
  float* const b = a + frames * n2;
  const int rows = n2 >> 2;
  const int64_t f_first = static_cast<int64_t>(blockIdx.x) * frames;
  const int64_t left = batch - f_first;
  const int nf = left < frames ? static_cast<int>(left) : frames;
  copy_in(a, x + f_first * n2, 4 * nf * n2);
  const int32_t* it = idx;
  const float* tt = tw;
  const int32_t* st = scatter;
  if (kStaged) {
    int32_t* ti = reinterpret_cast<int32_t*>(b + frames * n2);
    float* tf = reinterpret_cast<float*>(ti + stages.count * n2);
    copy_in(ti, idx, 4 * stages.count * n2);
    copy_in(tf, tw, 64 * stages.tw_rows);
    if (scatter) {
      int32_t* ts = reinterpret_cast<int32_t*>(tf + 16 * stages.tw_rows);
      copy_in(ts, scatter, 4 * n2);
      st = ts;
    }
    it = ti;
    tt = tf;
  }
  copies_landed();

  // this thread's frame and first row, the same for every stage
  const int f = threadIdx.x / rows, row0 = threadIdx.x - f * rows;
  const float* in = a;
  for (int s = 0; s < stages.count; ++s) {
    float* out = s & 1 ? a : b;
    if (f < nf) {
      const int32_t* si = it + s * n2;
      const float* ts = tt + 16 * stages.tw_row[s];
      for (int row = row0; row < rows; row += blockDim.x) {
        const int4 ri = kStaged
            ? *reinterpret_cast<const int4*>(si + 4 * row)
            : make_int4(si[4 * row], si[4 * row + 1], si[4 * row + 2],
                        si[4 * row + 3]);
        butterfly<kStaged>(in + f * n2, out + f * n2, row, ri,
                           ts + 16 * twiddle_class(stages, s, row));
      }
    }
    __syncthreads();
    in = out;
  }

  float* dst = y + f_first * n2;           // last stage -> y, scattered
  for (int e = threadIdx.x; e < nf * n2; e += blockDim.x) {
    const int ff = e / n2, c = e - ff * n2;
    const int g = st ? st[c] : c;
    dst[e] = g < 0 ? 0.f : in[ff * n2 + g];
  }
}

// shared != 0: all stages of `frames` frames a block in shared memory (the
// stages' tables too when `staged`), then the scatter to y.  shared == 0:
// the one stage of the list from x to y in device memory, a (frame, row) a
// thread over the grid.
__global__ void __launch_bounds__(kMaxThreads)
fft_stages_kernel(const float* __restrict__ x,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ tw,
                  const int32_t* __restrict__ scatter, float* __restrict__ y,
                  int batch, int n2, const Stages stages, int frames,
                  int shared, int staged) {
  if (!shared) {
    const int rows = n2 >> 2;
    const int64_t total = static_cast<int64_t>(batch) * rows;
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         r < total; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
      const int64_t f = r / rows;
      const int row = static_cast<int>(r - f * rows);
      const int32_t* ri = idx + 4 * row;
      butterfly<false>(x + f * n2, y + f * n2, row,
                       make_int4(ri[0], ri[1], ri[2], ri[3]),
                       tw + 16 * twiddle_class(stages, 0, row));
    }
    return;
  }
  if (staged)
    run_shared<true>(x, idx, tw, scatter, y, batch, n2, stages, frames);
  else
    run_shared<false>(x, idx, tw, scatter, y, batch, n2, stages, frames);
}

}  // namespace

extern "C" {

// x, y (batch, n2) float32 with n2 = 2n; idx (count, n2) int32 in [0, n2);
// tw the stages' (half, 4, 4) float32 twiddles concatenated, half = n2 / 4
// / nb[s]; nb a host array of count ints; scatter null or (n2,) int32 in
// [-1, n2) (-1 = PAD, written as 0).  A list of more than one stage, or
// one with a scatter, runs in one launch in shared memory and needs
// 8 n2 <= 128 KB; one stage without scatter runs from device memory.
// Returns the CUDA error code of the launch (0 = success).
int repro_fft_stages(const void* x, const void* idx, const void* tw,
                     const void* scatter, void* y, int batch, int n2,
                     int count, const void* nb, void* stream) {
  Stages st{};
  const int* nbs = static_cast<const int*>(nb);
  if (batch < 1 || count < 1 || count > kMaxStages || n2 < 4 || n2 % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  st.count = count;
  for (int s = 0; s < count; ++s) {
    if (nbs[s] < 1 || (n2 / 4) % nbs[s])
      return static_cast<int>(cudaErrorInvalidValue);
    st.nb[s] = nbs[s];
    st.nb_shift[s] = (nbs[s] & (nbs[s] - 1)) ? -1 : __builtin_ctz(nbs[s]);
    st.tw_row[s] = st.tw_rows;
    st.tw_rows += n2 / 4 / nbs[s];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = n2 / 4;
  if (count == 1 && !scatter) {
    const int64_t work = static_cast<int64_t>(batch) * rows;
    const int64_t blocks = (work + kGlobalThreads - 1) / kGlobalThreads;
    fft_stages_kernel<<<static_cast<unsigned>(blocks < (1 << 20) ? blocks
                                                                 : 1 << 20),
                        kGlobalThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(idx),
        static_cast<const float*>(tw), nullptr, static_cast<float*>(y), batch,
        n2, st, 1, 0, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t frame_bytes = 2 * sizeof(float) * static_cast<size_t>(n2);
  if (frame_bytes > kBufferBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  int frames = rows >= 128 ? 1 : (128 + rows - 1) / rows;
  frames = frames < batch ? frames : batch;
  int threads = frames * rows;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const size_t tables =
      4 * (static_cast<size_t>(count) * n2 + 16 * st.tw_rows +
           (scatter ? n2 : 0));
  const int staged = frame_bytes * frames + tables <= kSharedBytes;
  fft_stages_kernel<<<(batch + frames - 1) / frames, threads,
                      frame_bytes * frames + (staged ? tables : 0), s>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<const float*>(tw), static_cast<const int32_t*>(scatter),
      static_cast<float*>(y), batch, n2, st, frames, 1, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
