// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with GQA, causal and sliding-window masks, tanh logit softcap and ragged
// sequence tails, in float32 or bfloat16, both on the tensor cores.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd of the JAX package,
// src/repro/kernels/flash_attention/kernel.py, and computes what its
// _kernel computes:
//   s   = (q . k) / sqrt(hd)              (float32)
//   s   = softcap * tanh(s / softcap)     when softcap > 0
//   s   = -1e30 where k >= skv, or (causal) k > q, or (window) k <= q - window
//   out = softmax(s) v, as an online softmax with float32 running max m,
//         denominator l and accumulator, divided by max(l, 1e-30) and
//         stored in the query's type.
// Query head h reads kv head h / (heads / kv_heads); K and V are never
// expanded.  Layouts are the entry point's own, (B, S, H, hd) for q and out
// and (B, Skv, KV, hd) for k and v, contiguous.  Both bodies below skip the
// kv tiles that the causal or window mask covers wholly for a block's query
// rows, which changes no row that sees at least one key, run query tiles
// heaviest first (causal tiles late in the sequence read the most keys),
// and keep the running state in registers across a loop over kv tiles (the
// TPU's sequential kv grid axis).  There are two bodies, one per type.
//
// bfloat16 (namespace tc).  What bounds it: bf16 tensor-core operations, 989
// TFLOP/s dense on the H100 SXM; the starcoder2-3b layer's 103 GFLOP take 0.104
// ms there, while its 55 MB of q, k, v and out take 16 us at 3.35 TB/s.  The
// design is FlashAttention-3's outline without its extras: one block per (batch
// x head, 128-query tile), two consumer warpgroups of 64 query rows each.  Each
// warpgroup runs S = Q K^T as wgmma m64nBKk16 (bf16 in, float32 accumulators)
// with Q and K in shared memory, scales S by 1/sqrt(hd) in float32, applies the
// softcap and masks, reduces each row's max and sum across the 4 threads that
// share it in the accumulator layout (quad shuffles), and runs O += P V as
// wgmma m64nDk16 with P converted to bf16 in registers: the accumulator
// fragment of S is, pair by pair, the A fragment of the second product, so P
// never touches shared memory.  The products of neighbouring tiles overlap
// (FlashAttention-3's intra-warpgroup pipelining): tile t + 1's Q K^T is issued
// with tile t's P V, and tile t + 1's softmax runs while that P V is on the
// tensor cores.  Next to the tensor cores, the softmax's float32 work is what
// bounds the kernel: its per-element code is compiled once per case (softcap or
// not, masked tile or not), so no element pays for a branch it does not take,
// and it works in log2 units, so each P is one ex2.  K and V tiles arrive by
// TMA (one thread issues them) into a ring of 2 stages, each tile completing on
// its own mbarrier, so K is refilled as soon as Q K^T is done with it, a tile
// ahead of V; Q is loaded once per block.  The head dim is padded to D = 64,
// 128 or 256 with zeros (TMA's out-of-bounds fill), and tiles are stored as
// 64-column chunks of 128-byte rows in the 128-byte swizzle that both TMA and
// wgmma read without bank conflicts.  Where TMA cannot describe the tensors (a
// row of hd bf16 values not a multiple of 16 bytes, e.g. hd 20, or an operand
// not 16-byte aligned) the same kernel loads each tile with plain loads into
// the same swizzled layout instead.  Tiles: D <= 128 takes 128 keys a tile (160
// KB of shared memory at D 128), D 256 takes 64 (192 KB; the O accumulator
// alone is 128 registers a thread).  The one deliberate difference from the
// float32 arithmetic is that P is rounded to bf16 before P V, as every
// tensor-core attention does; l sums the float32 P.  A launch allocates nothing
// and does not synchronise, so a CUDA graph can capture it; the TMA descriptors
// are encoded on the host per call, through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.
//
// float32 (namespace f32).  The TPU runs a float32 dot as bf16 passes on its
// matrix unit; this body runs it on the card's tensor cores with the operands
// split: x = big + small, big = tf32(x) and small = tf32(x - big), both
// rounded to nearest (cvt.rna), and a . b = big_a big_b + big_a small_b +
// small_a big_b, three wgmma m64nNk8 .f32.tf32.tf32 products into float32
// accumulators (the dropped small.small term is 2^-22 of the product).  That
// is float32 attention, not TF32 attention: one TF32 product would miss the
// float32 tolerance by two orders of magnitude.  What bounds it: TF32
// tensor-core operations, 495 TFLOP/s dense, three times the 2 S hd
// multiply-adds a pair of query and key: the starcoder2-3b layer's 103 GFLOP
// take 0.625 ms there, against 1.539 ms for a perfect kernel on the float32
// FMA pipes (67 TFLOP/s).  Next come the bytes each block reads from L2:
// split, a tile's K and V are four float32 operands, 2 KB a key at hd 128,
// and shared memory's rate into the narrow Q K^T products.  The design is
// the bfloat16 body's with the changes that TF32 and the doubled operands
// force:
// - TF32 wgmma takes only K-major operands (no transpose for .tf32), so P V
//   needs V^T with keys along K.  A pre-pass kernel (split_kv, one launch a
//   call) writes, per kv head and 16-, 32- or 64-key tile, K big and small
//   and V^T big and small as the exact shared-memory image the body reads,
//   swizzle included, into scratch the wrapper allocates; a tile's K half
//   and V half then each land with one bulk copy (TMA, no tensor map).  It
//   also permutes the keys of V^T inside each group of 8 as [0, 2, 4, 6, 1,
//   3, 5, 7]: a thread holds S columns (2t, 2t + 1) of a k-step, the TF32 A
//   fragment wants columns (t, t + 4), so P goes from the S accumulator to
//   the A fragments of P V in registers, as in the bfloat16 body.
// - Up to hd 128, Q big is held in registers as the A fragments of Q K^T
//   (RS wgmma), so of Q K^T's three products only small.big reads its A
//   operand from shared memory: those narrow products (N = BK) are
//   otherwise bound by shared memory's rate.  Q small sits in shared
//   memory, and two consumer warpgroups of 64 query rows share every K and
//   V tile (32- or 64-key tiles), halving the bytes read a query row.  At
//   hd 256, O alone is 128 registers a thread and Q big's fragments would
//   be 128 more, so one warpgroup keeps the first half of Q big's
//   fragments in registers and Q small and the second half of Q big in
//   shared memory (96 KB), with 16-key tiles, V^T rows of 64 bytes in the
//   64-byte swizzle.  (Two warpgroups that each own half of D, swapping
//   partial scores, measured slower on the H100: see PERF.md.)  K and V
//   halves of a tile have rings of two stages each; V t is awaited only
//   once the next Q K^T is on the tensor cores.  Q is pre-scaled by
//   1/sqrt(hd) in float32, as the TPU kernel does, and split by the block
//   with plain loads (any alignment, any hd) while the first tiles land.
// - The big.big product and the two correction products of S accumulate
//   apart and are added once a tile: the tensor cores' accumulation
//   truncates, and adding the small terms into the large sum a k-step at a
//   time cost float32 accuracy.  O accumulates on the tensor cores across
//   all of a row's tiles, so its error grows with the keys a row sees
//   (tools/flash_error.py on the H100: up to 6.8e-6 against float64 in
//   rows of 1025-4096 keys, where the same split arithmetic rounded to
//   nearest stays under 0.7e-6); a fresh accumulator a tile would take D /
//   2 more registers a thread, which neither layout has.
// - The softcap takes tanhf: its error, times the cap, must stay well under
//   the float32 tolerance.
// Every float32 shape runs this body: the scratch is aligned and padded by
// construction, and Q and the pre-pass read the inputs with plain loads, so
// no float32 operand needs a tensor map.

#include <cuda.h>          // CUtensorMap and its enums; no driver call links
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;     // the TPU kernel's fill, not -inf

// ---------------------------------------------------------------------------
// bfloat16: tensor-core body (wgmma, TMA, mbarriers)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarpgroups = 2;               // consumer warpgroups a block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBQ = 64 * kWarpgroups;        // 128 query rows a block
constexpr int kStages = 2;                   // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// D: head dim padded to whole 64-column chunks; BK: keys a tile.
template <int D>
struct Shape {
  static constexpr int kChunks = D / 64;
  static constexpr int kBK = D > 128 ? 64 : 128;
  static constexpr uint32_t kQBytes = kChunks * kBQ * 128;
  static constexpr uint32_t kTileBytes = kChunks * kBK * 128;   // K or V
  // Q, the K/V ring, its mbarriers and Q's, and slack to align the base to
  // 1 KB (the period of the 128-byte swizzle).
  static constexpr uint32_t kSmem =
      kQBytes + kStages * 2 * kTileBytes + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a tile of `rows` rows stored as 64-column
// chunks of 128-byte rows in the 128-byte swizzle (16-byte unit c / 8 of a
// row XOR row % 8), as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it.
__device__ __forceinline__ uint32_t swizzled(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `bar` with this parity to complete.  A phase that
// never completes (a copy that never lands) aborts the launch with an error
// after some seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  __syncwarp();
}

// One box of a 4-D (hd, heads, seq, batch) tensor map into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory writes of the generic proxy made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin register values in place across the asynchronous wgmma: nothing
// reading or writing them moves across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D (64 x 64, f32) {+}= A (64 x 16, bf16, K-major in shared memory)
//   x B (16 x 64, bf16, K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) {+}= A (64 x 16, bf16, K-major in shared memory)
//   x B (16 x 128, bf16, K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16, in registers) x B (16 x 64,
//   bf16, MN-major in shared memory: trans-b 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16, in registers) x B (16 x 128,
//   bf16, MN-major in shared memory: trans-b 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16, in registers) x B (16 x 256,
//   bf16, MN-major in shared memory: trans-b 1).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x (MUFU.EX2; 2^-1e30 flushes to 0, 2^0 is exactly 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = 1 - 2 / (2^(2 y log2 e) + 1) in float32 from two MUFU
// operations: within about 2e-7 of tanhf everywhere (the rounding of 1 - 2r
// near y = 0), 1 and -1 past |y| 44, and a third of tanhf's cost, which at
// gemma2's softcap was a third of the kernel's time.
__device__ __forceinline__ float tanh_f32(float y) {
  float r;
  const float e = ex2(2.f * kLog2e * y) + 1.f;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(e));
  return 1.f - 2.f * r;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Plain loads of rows [row0, row0 + rows) of one head (row stride `stride`
// elements, `n` rows in all) into the swizzled tile at `dst`, zero past hd
// and past n: the path for tensors TMA cannot describe.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n, int64_t stride, int hd,
                                          int rows) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    __nv_bfloat16 x = __ushort_as_bfloat16(0);
    if (c < hd && row0 + r < n) x = src[(row0 + r) * stride + c];
    *reinterpret_cast<__nv_bfloat16*>(dst + swizzled(r, c, rows)) = x;
  }
}

// One thread: the K or V tile of keys [k0, k0 + BK) of kv head kvh into
// shared memory at dst, completing on bar.
template <int D>
__device__ __forceinline__ void issue_tile(const CUtensorMap* map,
                                           uint32_t dst, uint32_t bar, int k0,
                                           int kvh, int b) {
  using S = Shape<D>;
  mbar_expect_tx(bar, S::kTileBytes);
#pragma unroll
  for (int c = 0; c < S::kChunks; ++c)
    tma_load(dst + c * S::kBK * 128, map, bar, 64 * c, kvh, k0, b);
}

template <int D, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int sq, int skv,
                   int heads, int kv_heads, int hd, int causal, int window,
                   float softcap, float scale) {
  using S = Shape<D>;
  constexpr int BK = S::kBK;
  constexpr int NS = BK / 2;        // S accumulators a thread
  constexpr int NO = D / 2;         // O accumulators a thread
  constexpr int KS = BK / 16;       // k-steps of P V

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* const base = smem_raw + pad;
  const uint32_t s_q = raw + pad;
  const uint32_t s_kv = s_q + S::kQBytes;   // stage st: K, then V
  // mbarriers: K's copies landed, kStages of them; V's; then Q's
  const uint32_t bars = s_kv + kStages * 2 * S::kTileBytes;
  const uint32_t bar_q = bars + 16 * kStages;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  // blockIdx.x walks (batch, head) fastest, so every head's heaviest query
  // tiles go first across the whole grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.x / heads, h = blockIdx.x - b * heads;
  const int kvh = h / (heads / kv_heads);

  // kv tiles any row of this query tile can see
  int k_begin = 0, k_end = skv;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  if (causal) k_end = min(skv, q0 + kBQ);
  k_begin = (k_begin / BK) * BK;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // K and V of tile t are in ring stage t % kStages; one mbarrier each
  // tells when its copy has landed, so K can be refilled as soon as Q K^T
  // is done with it, a tile before V.
  auto k_smem = [&](int t) {
    return s_kv + 2 * (t % kStages) * S::kTileBytes;
  };
  auto k_bar = [&](int t) { return bars + 8 * (t % kStages); };
  auto v_bar = [&](int t) { return bars + 8 * (kStages + t % kStages); };
  const CUtensorMap* const mk = &map_k;
  const CUtensorMap* const mv = &map_v;
  auto issue_k = [&](int t) {
    issue_tile<D>(mk, k_smem(t), k_bar(t), k_begin + t * BK, kvh, b);
  };
  auto issue_v = [&](int t) {
    issue_tile<D>(mv, k_smem(t) + S::kTileBytes, v_bar(t),
                  k_begin + t * BK, kvh, b);
  };

  const int64_t q_step = static_cast<int64_t>(heads) * hd;
  const int64_t kv_step = static_cast<int64_t>(kv_heads) * hd;
  const __nv_bfloat16* kb =
      k + (static_cast<int64_t>(b) * skv * kv_heads + kvh) * hd;
  const __nv_bfloat16* vb =
      v + (static_cast<int64_t>(b) * skv * kv_heads + kvh) * hd;
  if constexpr (kTma) {
    if (tid == 0) {
      for (int i = 0; i <= 2 * kStages; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bar_q, S::kQBytes);
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c)
        tma_load(s_q + c * kBQ * 128, &map_q, bar_q, 64 * c, h, q0, b);
      for (int t = 0; t < kStages && t < ntiles; ++t) {
        issue_k(t);
        issue_v(t);
      }
    }
    __syncwarp();
    mbar_wait(bar_q, 0);
  } else {
    load_tile<D>(base, q + (static_cast<int64_t>(b) * sq * heads + h) * hd,
                 q0, sq, q_step, hd, kBQ);
    fence_async_proxy();
  }

  // this thread's two rows in the accumulator layout
  const int row_a = q0 + wg * 64 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const int wq_lo = q0 + wg * 64, wq_hi = wq_lo + 63;
  const uint32_t q_wg = s_q + wg * 64 * 128;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const float scale_log2 = scale * kLog2e;
  float o[NO], s[NS], m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float al_a = 1.f, al_b = 1.f;
  uint32_t pa[KS][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = 0u;

  auto wait_k = [&](int t) {
    if constexpr (kTma) {
      mbar_wait(k_bar(t), (t / kStages) & 1);
    } else {                        // both of tile t, by plain loads
      __syncthreads();              // tile t - kStages is consumed
      const int k0 = k_begin + t * BK;
      unsigned char* ks = base + (k_smem(t) - s_q);
      load_tile<D>(ks, kb, k0, skv, kv_step, hd, BK);
      load_tile<D>(ks + S::kTileBytes, vb, k0, skv, kv_step, hd, BK);
      fence_async_proxy();
      __syncthreads();
    }
  };
  auto wait_v = [&](int t) {
    if constexpr (kTma) mbar_wait(v_bar(t), (t / kStages) & 1);
  };
  // S = Q K^T over all D columns (zero past hd), k-step kk reading 16:
  // chunk kk / 4, 32 bytes into its rows.  No branch between the wgmmas,
  // so they issue back to back.
  auto issue_qk = [&](int t) {
    const uint32_t ks = k_smem(t);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t chunk = kk >> 2, in = (kk & 3) * 32;
      wgmma_ss<BK>(s, smem_desc(q_wg + chunk * kBQ * 128 + in, 16, 1024),
                   smem_desc(ks + chunk * BK * 128 + in, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  // O += P V; V is MN-major: 16 keys a k-step (2 KB), chunks BK rows apart
  auto issue_pv = [&](int t) {
    const uint32_t vs = k_smem(t) + S::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<D>(o, pa[kk], smem_desc(vs + kk * 2048, BK * 128, 1024));
    wg_commit();
  };
  // Scale, softcap and masks in float32, then the online softmax of tile
  // t: s becomes P, m and l move, al_* is the factor O must take.  Scores
  // are kept in log2 units (x log2 e), so each P is one ex2 of a
  // difference; masked scores are -1e30 there too.  The softcap and the
  // masks are decided once a tile (the loop is compiled for each case), so
  // no element pays for a branch it does not take.  Element i of s sits at
  // row (i / 2) % 2 ? row_b : row_a, key k0 + 8 (i / 4) + 2 (lane % 4) + i
  // % 2.
  auto scores = [&](int k0, auto capped, auto masked) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x;
      if constexpr (decltype(capped)::value)
        x = softcap * tanh_f32(s[i] * scale * inv_cap) * kLog2e;
      else
        x = s[i] * scale_log2;
      if constexpr (decltype(masked)::value) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qpos = (i & 2) ? row_b : row_a;
        bool seen = kpos < skv;
        if (causal) seen = seen && kpos <= qpos;
        if (window > 0) seen = seen && kpos > qpos - window;
        x = seen ? x : kNegInf;
      }
      s[i] = x;
    }
  };
  auto softmax = [&](int t) {
    const int k0 = k_begin + t * BK;
    const bool masked = k0 + BK > skv || (causal && k0 + BK - 1 > wq_lo) ||
                        (window > 0 && k0 <= wq_hi - window);
    using Yes = std::true_type;
    using No = std::false_type;
    if (softcap > 0.f) {
      if (masked) scores(k0, Yes(), Yes());
      else scores(k0, Yes(), No());
    } else {
      if (masked) scores(k0, No(), Yes());
      else scores(k0, No(), No());
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i & 2) mx_b = fmaxf(mx_b, s[i]);
      else mx_a = fmaxf(mx_a, s[i]);
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    al_a = ex2(m_a - mn_a);
    al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = ex2(s[i] - ((i & 2) ? mn_b : mn_a));
      s[i] = p;
      if (i & 2) sum_b += p;
      else sum_a += p;
    }
    l_a = l_a * al_a + sum_a;       // this thread's part of the row sums
    l_b = l_b * al_b + sum_b;
  };
  // P in bf16 as wgmma A fragments: k-step kk takes s[8 kk .. 8 kk + 7]
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
  };

  // Software pipeline (FlashAttention-3's intra-warpgroup overlap): tile
  // t + 1's Q K^T is issued before tile t's P V, and its softmax runs while
  // that P V is still on the tensor cores; O takes its rescale after.
  if (ntiles > 0) {
    wait_k(0);
    fence_regs(s);
    wg_fence();
    issue_qk(0);
    wg_wait<0>();
    fence_regs(s);
    if constexpr (kTma) {
      __syncthreads();              // both warpgroups are done with K 0
      if (tid == 0 && kStages < ntiles) issue_k(kStages);
    }
    softmax(0);                     // O is zero: no rescale
    pack_p();
  }
  for (int t = 0; t + 1 < ntiles; ++t) {
    wait_k(t + 1);
    wait_v(t);
    fence_regs(s);
    fence_regs(o);
    fence_regs(pa);
    wg_fence();
    issue_qk(t + 1);
    issue_pv(t);
    wg_wait<1>();                   // Q K^T (t + 1) has landed
    fence_regs(s);
    softmax(t + 1);
    wg_wait<0>();                   // P V (t) too
    fence_regs(o);
    fence_regs(pa);
    if constexpr (kTma) {
      __syncthreads();              // both warpgroups are done with V t and
      if (tid == 0) {               // K t + 1
        if (t + kStages < ntiles) issue_v(t + kStages);
        if (t + 1 + kStages < ntiles) issue_k(t + 1 + kStages);
      }
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? al_b : al_a;
    pack_p();
  }
  if (ntiles > 0) {                 // the last tile's P V
    wait_v(ntiles - 1);
    fence_regs(o);
    fence_regs(pa);
    wg_fence();
    issue_pv(ntiles - 1);
    wg_wait<0>();
    fence_regs(o);
  }

  const float d_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float d_b = fmaxf(quad_sum(l_b), 1e-30f);
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * sq * heads + h) * hd;
  const bool pairs = (hd & 1) == 0;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int row = (i & 2) ? row_b : row_a;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (row >= sq || col >= hd) continue;
    const float dn = (i & 2) ? d_b : d_a;
    __nv_bfloat16* p = ob + row * q_step + col;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(o[i] / dn, o[i + 1] / dn);
    } else {
      p[0] = __float2bfloat16(o[i] / dn);
      if (col + 1 < hd) p[1] = __float2bfloat16(o[i + 1] / dn);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links no libcuda.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// (hd, heads, seq, batch) bf16 tensor, boxes of 64 columns x `rows` rows of
// one head, 128-byte swizzle; out-of-bounds columns and rows read as zero.
bool encode(CUtensorMap* map, const void* ptr, int hd, int heads, int seq,
            int batch, int rows) {
  const EncodeFn fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kTma>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int heads, int kv_heads, int hd, int causal,
           int window, float softcap, cudaStream_t stream) {
  constexpr uint32_t bytes = Shape<D>::kSmem;
  static bool configured = false;   // once per kernel, before any capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc<D, kTma>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap mq{}, mk{}, mv{};
  if (kTma && !(encode(&mq, q, hd, heads, sq, batch, kBQ) &&
                encode(&mk, k, hd, kv_heads, skv, batch, Shape<D>::kBK) &&
                encode(&mv, v, hd, kv_heads, skv, batch, Shape<D>::kBK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  flash_attention_tc<D, kTma><<<grid, kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, skv, heads, kv_heads, hd, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             int batch, int sq, int skv, int heads, int kv_heads, int hd,
             int causal, int window, float softcap, cudaStream_t stream) {
  // TMA needs 16-byte aligned bases and row strides (hd % 8 == 0)
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (hd % 8 == 0 && bases % 16 == 0)
    return launch<D, true>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                           causal, window, softcap, stream);
  return launch<D, false>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                          causal, window, softcap, stream);
}

int dispatch(const void* q, const void* k, const void* v, void* out,
             int batch, int sq, int skv, int heads, int kv_heads, int hd,
             int causal, int window, float softcap, cudaStream_t stream) {
  if (hd <= 64)
    return launch_d<64>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                        causal, window, softcap, stream);
  if (hd <= 128)
    return launch_d<128>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                         causal, window, softcap, stream);
  return launch_d<256>(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                       causal, window, softcap, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: tensor-core body on split-TF32 operands (wgmma .tf32, bulk copies)
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kSplitThreads = 256;           // the pre-pass's block
constexpr float kLog2e = 1.4426950408889634f;

// D: head dim padded to 64, 128 or 256.  Up to D 128, Q big is held in
// registers as the A fragments of Q K^T (kQReg) and two consumer
// warpgroups of 64 query rows share every K and V tile; at D 256 those
// fragments and O would not both fit, so one warpgroup keeps Q big's first
// kQRegSteps k-steps (half of them) in registers and the rest, with Q
// small, in shared memory.  BK: keys a tile; a ring of kStages K halves
// and one of kStages V halves.  A tile's four split operands (K big, K
// small, V^T big, V^T small) are BK x D floats each; the pre-pass writes them, tile
// after tile, as the shared-memory image this body reads, so one bulk copy
// lands a tile's K half (big, small) and one its V half.  Shared memory:
// Q small (and at D 256 Q big's second half), the two rings, their
// mbarriers, slack to align the base to 1 KB: 160 KB at D 64, 192 KB at D
// 128, 224 KB at D 256.
template <int D>
struct Shape {
  static constexpr bool kQReg = D <= 128;
  static constexpr int kQRegSteps = kQReg ? D / 8 : 16;
  static constexpr int kWG = kQReg ? 2 : 1;             // warpgroups a block
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBQ = 64 * kWG;                  // query rows a block
  static constexpr int kBK = D == 64 ? 64 : D == 128 ? 32 : 16;
  static constexpr int kStages = 2;
  // V^T rows hold BK keys: 128-byte rows (128-byte swizzle, 32 keys a
  // chunk) from 32 keys on, 64-byte rows in the 64-byte swizzle below.
  static constexpr bool kV64 = kBK < 32;
  static constexpr uint32_t kQBytes = kBQ * D * 4;      // Q small
  // Q big's k-steps past kQRegSteps, in shared memory
  static constexpr uint32_t kQBigBytes = kBQ * (D - 8 * kQRegSteps) * 4;
  static constexpr uint32_t kOpBytes = kBK * D * 4;     // one split operand
  static constexpr uint32_t kPart = 2 * kOpBytes;       // K or V: big, small
  static constexpr uint32_t kStage = 2 * kPart;         // a tile in the blob
  static constexpr uint32_t kSmem =
      kQBytes + kQBigBytes + 2 * kStages * (kPart + 8) + 1024;
};

// Nearest TF32 (10-bit mantissa) to x, ties away from zero, low 13 bits 0.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Byte offset of element (r, c) of a float32 tile of `rows` rows stored as
// 32-column chunks of 128-byte rows in the 128-byte swizzle (16-byte unit
// c / 4 of a row XOR row % 8).
__device__ __forceinline__ uint32_t swizzled(int r, int c, int rows) {
  return (c >> 5) * rows * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) +
         ((c & 3) << 2);
}

// Element (row, col) held at float index e of a tile image: the inverse of
// `swizzled` for `rows`-row tiles of 128-byte rows, and of the 64-byte
// swizzle (16-byte unit c / 4 XOR (row / 2) % 4, 16-float rows).
__device__ __forceinline__ void unswizzle128(int e, int rows, int& r, int& c) {
  const int chunk = e / (rows * 32), rem = e - chunk * rows * 32;
  r = rem >> 5;
  c = chunk * 32 + ((((rem >> 2) & 7) ^ (r & 7)) << 2) + (e & 3);
}
__device__ __forceinline__ void unswizzle64(int e, int& r, int& c) {
  r = e >> 4;
  c = ((((e >> 2) & 3) ^ ((r >> 1) & 3)) << 2) + (e & 3);
}

// Key at column c of a V^T row: inside each group of 8 the keys run
// [0, 2, 4, 6, 1, 3, 5, 7], so that the score accumulator's pair of keys
// (2t, 2t + 1) sits at the A fragment's columns (t, t + 4).
__device__ __forceinline__ int vt_key(int c) {
  const int w = c & 7;
  return (c & ~7) | (w < 4 ? 2 * w : 2 * w - 7);
}

// wgmma shared-memory descriptor, 64-byte swizzle (V^T rows of 16 keys).
__device__ __forceinline__ uint64_t smem_desc64(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

// One thread: `bytes` contiguous bytes from global memory into shared
// memory at dst by the TMA unit, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  tc::mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// D (64 x 16, f32) {+}= A (64 x 8, tf32, K-major in shared memory)
//   x B (8 x 16, tf32, K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) {+}= A (64 x 8, tf32, K-major in shared memory)
//   x B (8 x 32, tf32, K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) {+}= A (64 x 8, tf32, K-major in shared memory)
//   x B (8 x 64, tf32, K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) {+}= A (64 x 8, tf32, in registers) x B (8 x 16, tf32,
//   K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) {+}= A (64 x 8, tf32, in registers) x B (8 x 32, tf32,
//   K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) {+}= A (64 x 8, tf32, in registers) x B (8 x 64, tf32,
//   K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) {+}= A (64 x 8, tf32, in registers) x B (8 x 128, tf32,
//   K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}

// D (64 x 256, f32) {+}= A (64 x 8, tf32, in registers) x B (8 x 256, tf32,
//   K-major in shared memory); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, scale_d);
  else wgmma_rs_n256(d, a, db, scale_d);
}

// The pre-pass: tile j of kv head (b, kvh) -> its four split operands, each
// the shared-memory image the attention body reads.  K (BK rows x D) in the
// 128-byte swizzle; V transposed to V^T (D rows x BK keys, keys permuted
// by vt_key), zero past hd and past skv.  The tile is staged in shared
// memory in its natural layout, then each image is written in order, so
// both the reads and the writes of device memory are coalesced.
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
split_kv(const float* __restrict__ k, const float* __restrict__ v,
         float* __restrict__ blob, int skv, int kv_heads, int hd,
         int kv_tiles) {
  using S = Shape<D>;
  constexpr int BK = S::kBK, LD = D + 1, N = BK * D;
  __shared__ float kt[BK * LD], vt[BK * LD];
  const int j = blockIdx.x, bh = blockIdx.y;
  const int b = bh / kv_heads, kvh = bh - b * kv_heads;
  const int64_t step = static_cast<int64_t>(kv_heads) * hd;
  const int64_t head = (static_cast<int64_t>(b) * skv * kv_heads + kvh) * hd;
  for (int e = threadIdx.x; e < N; e += kSplitThreads) {
    const int r = e / D, c = e - r * D, pos = j * BK + r;
    const bool in = c < hd && pos < skv;
    kt[r * LD + c] = in ? k[head + pos * step + c] : 0.f;
    vt[r * LD + c] = in ? v[head + pos * step + c] : 0.f;
  }
  __syncthreads();
  float* out = blob + (static_cast<int64_t>(bh) * kv_tiles + j) * 4 * N;
  for (int e = threadIdx.x; e < N; e += kSplitThreads) {
    int r, c;
    unswizzle128(e, BK, r, c);
    const float x = kt[r * LD + c], big = tf32_rna(x);
    out[e] = big;
    out[N + e] = tf32_rna(x - big);
    if constexpr (S::kV64) unswizzle64(e, r, c);
    else unswizzle128(e, D, r, c);
    const float y = vt[vt_key(c) * LD + r], ybig = tf32_rna(y);
    out[2 * N + e] = ybig;
    out[3 * N + e] = tf32_rna(y - ybig);
  }
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads, 1)
flash_attention_split(const float* __restrict__ q,
                      const unsigned char* __restrict__ blob,
                      float* __restrict__ out, int sq, int skv, int heads,
                      int kv_heads, int hd, int kv_tiles, int causal,
                      int window, float softcap, float scale) {
  using S = Shape<D>;
  constexpr int BK = S::kBK, kBQ = S::kBQ, kThreads = S::kThreads;
  constexpr int SK = S::kStages, SV = S::kStages;   // the K, the V ring
  constexpr int NS = BK / 2;        // S accumulators a thread
  constexpr int NO = D / 2;         // O accumulators a thread
  constexpr int KQ = D / 8;         // k-steps of Q K^T
  constexpr int KR = S::kQRegSteps; //   of them with Q big in registers
  constexpr int KS = BK / 8;        // k-steps of P V

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* const base = smem_raw + pad;
  const uint32_t s_qs = raw + pad;            // Q small, Q big past KR,
  const uint32_t s_qb = s_qs + S::kQBytes;
  const uint32_t s_k = s_qb + S::kQBigBytes;  // the K ring, the V ring
  const uint32_t s_v = s_k + SK * S::kPart;
  const uint32_t bars = s_v + SV * S::kPart;  // K's mbarriers, then V's

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  // blockIdx.x walks (batch, head) fastest: heaviest query tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.x / heads, h = blockIdx.x - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int r_base = wg * 64;       // the warpgroup's first row in the block

  // kv tiles any row of this query tile can see
  int k_begin = 0, k_end = skv;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  if (causal) k_end = min(skv, q0 + kBQ);
  k_begin = (k_begin / BK) * BK;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const unsigned char* const tiles =
      blob + ((static_cast<int64_t>(b) * kv_heads + kvh) * kv_tiles +
              k_begin / BK) * S::kStage;
  auto k_smem = [&](int t) { return s_k + (t % SK) * S::kPart; };
  auto v_smem = [&](int t) { return s_v + (t % SV) * S::kPart; };
  auto k_bar = [&](int t) { return bars + 8 * (t % SK); };
  auto v_bar = [&](int t) { return bars + 8 * (SK + t % SV); };
  auto issue_k = [&](int t) {
    bulk_load(k_smem(t), tiles + static_cast<int64_t>(t) * S::kStage,
              S::kPart, k_bar(t));
  };
  auto issue_v = [&](int t) {
    bulk_load(v_smem(t),
              tiles + static_cast<int64_t>(t) * S::kStage + S::kPart,
              S::kPart, v_bar(t));
  };

  if (tid == 0) {
    for (int i = 0; i < SK + SV; ++i) tc::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int t = 0; t < SK && t < ntiles; ++t) issue_k(t);
    for (int t = 0; t < SV && t < ntiles; ++t) issue_v(t);
  }

  // this thread's two rows in the accumulator layout
  const int row_a = q0 + r_base + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const int wq_lo = q0 + r_base, wq_hi = wq_lo + 63;

  // Q, pre-scaled by 1/sqrt(hd) in float32 as the TPU kernel does, and
  // split by plain loads (any alignment, any hd) while the first tiles
  // land: Q small into shared memory, Q big's first KR k-steps as this
  // thread's A fragments (k-step kk: rows a and b, columns 8 kk + lane % 4
  // and 4 more), held in registers for the block, the rest (D 256) into
  // shared memory
  const int64_t q_step = static_cast<int64_t>(heads) * hd;
  const float* qb = q + (static_cast<int64_t>(b) * sq * heads + h) * hd;
  auto q_at = [&](int row, int c) {
    return (c < hd && row < sq) ? qb[row * q_step + c] * scale : 0.f;
  };
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const float x = q_at(q0 + r, c), big = tf32_rna(x);
    *reinterpret_cast<float*>(base + swizzled(r, c, kBQ)) = tf32_rna(x - big);
    if (c >= 8 * KR)
      *reinterpret_cast<float*>(base + S::kQBytes +
                                swizzled(r, c - 8 * KR, kBQ)) = big;
  }
  uint32_t qf[KR][4];
#pragma unroll
  for (int kk = 0; kk < KR; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      qf[kk][j] = __float_as_uint(tf32_rna(q_at(
          (j & 1) ? row_b : row_a, 8 * kk + (lane & 3) + ((j & 2) ? 4 : 0))));
  tc::fence_async_proxy();
  __syncthreads();

  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  // s: big.big of S; sc: its two correction products, summed apart (the
  // tensor cores' accumulation truncates, so the small terms are not
  // added into the large one a k-step at a time)
  float o[NO], s[NS], sc[NS], m_a = kNegInf, m_b = kNegInf, l_a = 0.f,
      l_b = 0.f;
  float al_a = 1.f, al_b = 1.f;
  uint32_t pb[KS][4], ps[KS][4];    // P big and small as A fragments
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = sc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pb[kk][j] = ps[kk][j] = 0u;

  auto wait_k = [&](int t) { tc::mbar_wait(k_bar(t), (t / SK) & 1); };
  auto wait_v = [&](int t) { tc::mbar_wait(v_bar(t), (t / SV) & 1); };
  // S = Q K^T over all D columns (zero past hd) as three TF32 products a
  // k-step: big.big into s, big.small and small.big into sc, Q big from
  // registers for the first KR k-steps (all of them up to D 128) and from
  // shared memory after, the rest from shared memory; k-step kk reads 8
  // columns, chunk kk / 4, 32 bytes into its rows.
  auto issue_qk = [&](int t) {
    const uint32_t kb = k_smem(t), ks = kb + S::kOpBytes;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const uint32_t in = (kk & 3) * 32;
      const uint32_t qa = (kk >> 2) * kBQ * 128 + r_base * 128 + in;
      const uint32_t ka = (kk >> 2) * BK * 128 + in;
      const uint64_t dkb = tc::smem_desc(kb + ka, 16, 1024);
      const uint64_t dks = tc::smem_desc(ks + ka, 16, 1024);
      if (kk < KR) {                // (resolved as the loop unrolls)
        wgmma_rs<BK>(s, qf[kk < KR ? kk : 0], dkb, kk > 0);
        wgmma_rs<BK>(sc, qf[kk < KR ? kk : 0], dks, kk > 0);
      } else {
        const uint64_t dqb =
            tc::smem_desc(s_qb + qa - (KR / 4) * kBQ * 128, 16, 1024);
        wgmma_ss<BK>(s, dqb, dkb, kk > 0);
        wgmma_ss<BK>(sc, dqb, dks, kk > 0);
      }
      wgmma_ss<BK>(sc, tc::smem_desc(s_qs + qa, 16, 1024), dkb, 1);
    }
    tc::wg_commit();
  };
  // The scores of the landed Q K^T, s + sc; the barrier marks the K tile
  // consumed by every warpgroup.
  auto gather_s = [&]() {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] += sc[i];
    __syncthreads();
  };
  // O += P V over the tile's keys, three TF32 products a k-step of 8 keys
  // with P in registers and V^T (K-major, as TF32 needs) in shared memory
  auto issue_pv = [&](int t) {
    const uint32_t vb = v_smem(t), vs = vb + S::kOpBytes;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint64_t dvb, dvs;
      if constexpr (S::kV64) {
        dvb = smem_desc64(vb + kk * 32, 512);
        dvs = smem_desc64(vs + kk * 32, 512);
      } else {
        const uint32_t off = (kk >> 2) * D * 128 + (kk & 3) * 32;
        dvb = tc::smem_desc(vb + off, 16, 1024);
        dvs = tc::smem_desc(vs + off, 16, 1024);
      }
      wgmma_rs<D>(o, pb[kk], dvb, 1);
      wgmma_rs<D>(o, pb[kk], dvs, 1);
      wgmma_rs<D>(o, ps[kk], dvb, 1);
    }
    tc::wg_commit();
  };
  // Softcap and masks in float32 on the pre-scaled scores, then the online
  // softmax of tile t in log2 units (each P one ex2 of a difference); the
  // loop is compiled for each case, as in the bfloat16 body.  Element i of
  // s sits at row (i / 2) % 2 ? row_b : row_a, key k0 + 8 (i / 4) + 2 (lane
  // % 4) + i % 2.
  auto scores = [&](int k0, auto capped, auto masked) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x;
      if constexpr (decltype(capped)::value)
        x = softcap * tanhf(s[i] * inv_cap) * kLog2e;
      else
        x = s[i] * kLog2e;
      if constexpr (decltype(masked)::value) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qpos = (i & 2) ? row_b : row_a;
        bool seen = kpos < skv;
        if (causal) seen = seen && kpos <= qpos;
        if (window > 0) seen = seen && kpos > qpos - window;
        x = seen ? x : kNegInf;
      }
      s[i] = x;
    }
  };
  auto softmax = [&](int t) {
    const int k0 = k_begin + t * BK;
    const bool masked = k0 + BK > skv || (causal && k0 + BK - 1 > wq_lo) ||
                        (window > 0 && k0 <= wq_hi - window);
    using Yes = std::true_type;
    using No = std::false_type;
    if (softcap > 0.f) {
      if (masked) scores(k0, Yes(), Yes());
      else scores(k0, Yes(), No());
    } else {
      if (masked) scores(k0, No(), Yes());
      else scores(k0, No(), No());
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i & 2) mx_b = fmaxf(mx_b, s[i]);
      else mx_a = fmaxf(mx_a, s[i]);
    }
    const float mn_a = fmaxf(m_a, tc::quad_max(mx_a));
    const float mn_b = fmaxf(m_b, tc::quad_max(mx_b));
    al_a = tc::ex2(m_a - mn_a);
    al_b = tc::ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = tc::ex2(s[i] - ((i & 2) ? mn_b : mn_a));
      s[i] = p;
      if (i & 2) sum_b += p;
      else sum_a += p;
    }
    l_a = l_a * al_a + sum_a;       // this thread's part of the row sums
    l_b = l_b * al_b + sum_b;
  };
  // P as TF32 A fragments, big and small: k-step kk holds keys 8 kk + 2t
  // (columns t) and 8 kk + 2t + 1 (columns t + 4) of rows a and b, which
  // V^T's key order matches
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float x[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1],
                          s[4 * kk + 3]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float big = tf32_rna(x[j]);
        pb[kk][j] = __float_as_uint(big);
        ps[kk][j] = __float_as_uint(tf32_rna(x[j] - big));
      }
    }
  };

  // The bfloat16 body's software pipeline: tile t + 1's Q K^T is issued
  // before tile t's P V, and its softmax runs while that P V is still on
  // the tensor cores; O takes its rescale after.  V t is awaited only once
  // Q K^T (t + 1) is on the tensor cores, and each ring slot is refilled
  // as soon as both warpgroups are done with it.
  if (ntiles > 0) {
    wait_k(0);
    tc::fence_regs(s);
    tc::fence_regs(sc);
    tc::wg_fence();
    issue_qk(0);
    tc::wg_wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(sc);
    gather_s();                     // both warpgroups are done with K 0
    if (tid == 0 && SK < ntiles) issue_k(SK);
    softmax(0);                     // O is zero: no rescale
    split_p();
  }
  for (int t = 0; t + 1 < ntiles; ++t) {
    wait_k(t + 1);
    tc::fence_regs(s);
    tc::fence_regs(sc);
    tc::fence_regs(o);
    tc::fence_regs(pb);
    tc::fence_regs(ps);
    tc::wg_fence();
    issue_qk(t + 1);
    wait_v(t);
    issue_pv(t);
    tc::wg_wait<1>();               // Q K^T (t + 1) has landed
    tc::fence_regs(s);
    tc::fence_regs(sc);
    gather_s();                     // both warpgroups are done with K t + 1
    if (tid == 0 && t + 1 + SK < ntiles) issue_k(t + 1 + SK);
    softmax(t + 1);
    tc::wg_wait<0>();               // P V (t) too
    tc::fence_regs(o);
    tc::fence_regs(pb);
    tc::fence_regs(ps);
    __syncthreads();                // both warpgroups are done with V t
    if (tid == 0 && t + SV < ntiles) issue_v(t + SV);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? al_b : al_a;
    split_p();
  }
  if (ntiles > 0) {                 // the last tile's P V
    wait_v(ntiles - 1);
    tc::fence_regs(o);
    tc::fence_regs(pb);
    tc::fence_regs(ps);
    tc::wg_fence();
    issue_pv(ntiles - 1);
    tc::wg_wait<0>();
    tc::fence_regs(o);
  }

  const float d_a = fmaxf(tc::quad_sum(l_a), 1e-30f);
  const float d_b = fmaxf(tc::quad_sum(l_b), 1e-30f);
  float* ob = out + (static_cast<int64_t>(b) * sq * heads + h) * hd;
  const bool pairs = (hd & 1) == 0;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int row = (i & 2) ? row_b : row_a;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (row >= sq || col >= hd) continue;
    const float dn = (i & 2) ? d_b : d_a;
    float* p = ob + row * q_step + col;
    if (pairs) {
      *reinterpret_cast<float2*>(p) = make_float2(o[i] / dn, o[i + 1] / dn);
    } else {
      p[0] = o[i] / dn;
      if (col + 1 < hd) p[1] = o[i + 1] / dn;
    }
  }
}

template <int D>
int split(const void* k, const void* v, void* blob, int batch, int skv,
          int kv_heads, int hd, int kv_tiles, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(kv_tiles),
                  static_cast<unsigned>(batch * kv_heads));
  split_kv<D><<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(blob), skv, kv_heads, hd, kv_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int attend(const void* q, const void* blob, void* out, int batch, int sq,
           int skv, int heads, int kv_heads, int hd, int kv_tiles,
           int causal, int window, float softcap, cudaStream_t stream) {
  constexpr uint32_t bytes = Shape<D>::kSmem;
  static bool configured = false;   // once per kernel, before any capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_split<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  constexpr int kBQ = Shape<D>::kBQ;
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  flash_attention_split<D><<<grid, Shape<D>::kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const unsigned char*>(blob),
      static_cast<float*>(out), sq, skv, heads, kv_heads, hd, kv_tiles,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// The caller's tiling (d, bk) must be one this file compiles, hold hd, and
// give kv_tiles tiles of bk keys over skv.
template <int D>
bool tiling(int d, int bk, int hd, int skv, int kv_tiles) {
  return d == D && bk == Shape<D>::kBK && hd <= D &&
         kv_tiles == (skv + bk - 1) / bk;
}

}  // namespace f32

}  // namespace

extern "C" {

// q/out (batch, sq, heads, hd); k/v (batch, skv, kv_heads, hd); all
// contiguous bfloat16 (the tensor-core body tc).  heads % kv_heads == 0,
// 1 <= hd <= 256, batch * heads <= 65535 (the wrapper checks).  Returns the
// CUDA error code of the launch (0 = success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int batch, int sq, int skv, int heads,
                          int kv_heads, int hd, int causal, int window,
                          float softcap, void* stream) {
  return tc::dispatch(q, k, v, out, batch, sq, skv, heads, kv_heads, hd,
                      causal, window, softcap,
                      static_cast<cudaStream_t>(stream));
}

// float32, step 1: k/v (batch, skv, kv_heads, hd) contiguous float32 ->
// blob (batch, kv_heads, kv_tiles, 4, bk * d) float32, each tile's K big, K
// small, V^T big, V^T small as the attention body's shared-memory images.
// (d, bk) is the wrapper's tiling: d in {64, 128, 256} with its bk, hd <= d,
// kv_tiles = ceil(skv / bk); anything else returns cudaErrorInvalidValue.
int repro_flash_split_kv(const void* k, const void* v, void* blob, int batch,
                         int skv, int kv_heads, int hd, int d, int bk,
                         int kv_tiles, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32::tiling<64>(d, bk, hd, skv, kv_tiles))
    return f32::split<64>(k, v, blob, batch, skv, kv_heads, hd, kv_tiles, s);
  if (f32::tiling<128>(d, bk, hd, skv, kv_tiles))
    return f32::split<128>(k, v, blob, batch, skv, kv_heads, hd, kv_tiles, s);
  if (f32::tiling<256>(d, bk, hd, skv, kv_tiles))
    return f32::split<256>(k, v, blob, batch, skv, kv_heads, hd, kv_tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// float32, step 2: q/out (batch, sq, heads, hd) contiguous float32 and the
// blob repro_flash_split_kv wrote with the same (d, bk, kv_tiles); the
// split-TF32 tensor-core body f32.  Returns the CUDA error code of the
// launch (0 = success).
int repro_flash_attention_f32(const void* q, const void* blob, void* out,
                              int batch, int sq, int skv, int heads,
                              int kv_heads, int hd, int d, int bk,
                              int kv_tiles, int causal, int window,
                              float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32::tiling<64>(d, bk, hd, skv, kv_tiles))
    return f32::attend<64>(q, blob, out, batch, sq, skv, heads, kv_heads, hd,
                           kv_tiles, causal, window, softcap, s);
  if (f32::tiling<128>(d, bk, hd, skv, kv_tiles))
    return f32::attend<128>(q, blob, out, batch, sq, skv, heads, kv_heads,
                            hd, kv_tiles, causal, window, softcap, s);
  if (f32::tiling<256>(d, bk, hd, skv, kv_tiles))
    return f32::attend<256>(q, blob, out, batch, sq, skv, heads, kv_heads,
                            hd, kv_tiles, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float32 body's tiling for head dim hd: *d the padded head dim, *bk
// the keys a tile (Shape<D>::kBK).  ref.f32_tiling must agree for every
// hd in [1, 256]; a card test holds the two together.  Returns
// cudaErrorInvalidValue for hd outside [1, 256].
int repro_flash_f32_tiling(int hd, int* d, int* bk) {
  if (hd < 1 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  *d = hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  *bk = *d == 64 ? f32::Shape<64>::kBK
                 : *d == 128 ? f32::Shape<128>::kBK : f32::Shape<256>::kBK;
  return 0;
}

}  // extern "C"
