// Ring attention's online-softmax fold, for Hopper: K3.
//
// Replaces tbus/parallel/collective.py:125 ring_attention.fold, the device
// compute of one ring step: the local queries q [lq, d] against one visiting
// key/value block k, v [lk, d] (f32 or bf16), folded into the f32 carry
// (m [lq], l [lq], o [lq, d]) exactly as :128-137 restate it, in f32 after
// the input cast:
//
//   s  = q k^T / sqrt(d)          m' = max(m, rowmax s)     a = exp(m - m')
//   l' = l a + rowsum exp(s - m')  o' = o a + exp(s - m') v
//
// The carry is updated in place (the reference is pure; the wrapper says
// so). With `final` set, the fold also ends the ring (the reference's
// :158): it writes out = (o' / l') in q's dtype instead of o', and still
// writes m' and l'. The first fold starts from m = -inf: a = exp(-inf) = 0
// there, never NaN, because m' is finite once a row has seen one finite
// score.
//
// d <= 256: products on the tensor cores over exact split terms.
// ---------------------------------------------------------------
// Both products are f32 in the reference. An f32 value splits exactly into
// three bf16 terms (gemm_sm90.cuh split3: hi + mid + lo == a, 24 bits),
// and a product of two bf16 values is exact in f32, so
//   s   = sum over i + j <= 2 of q_i . k_j^T   (6 passes; the 3 dropped
//         cross terms are ~2^-26 of |q||k|, below f32's own rounding)
//   p.v = sum over i + j <= 2 of p_i . v_j     (6 passes)
// with bf16 inputs one term each: s in 1 pass, p.v in 3 (only the f32 p
// is split). Each pass is a bf16 wgmma summed in f32; the smallest cross
// terms go first, while the accumulator is small. d is zero-padded to KD,
// the kernels' width: 128 for d <= 128, else the next multiple of 64 (192
// or 256). The zeros add nothing to s and give columns of o never written.
// Bound: operations, at 989 TFLOP/s (bf16 tensor cores, H100 SXM): 12
// passes of 2 * lq * lk * KD flops for f32 inputs, 4 for bf16. At lq = lk
// = 8192, d = 128: 0.208 ms and 0.069 ms (the same function on the CUDA
// cores' f32 FMA, 67 TFLOP/s, 0.513 ms); at d = 256: 0.417 ms and 0.139
// ms (FMA 1.026 ms). Bytes (q, k, v and the carry, each once) take ~0.01
// ms a fold at d = 128; the exps ~0.02 ms on the SFUs.
// Design, up to three launches:
// (1) fold_pack_kernel, memory-bound: q, k as qs [NT][lq_p][KD], ks
//     [NT][lk_p][KD] and v transposed into vt, NT terms each (3 for f32,
//     1 for bf16), bf16, zero-padded: lq_p to the block's rows, lk_p to the
//     tile's keys. bf16 q and k whose rows TMA can read as they lie (d a
//     multiple of 8, 16-byte aligned) are not copied: their TMA maps
//     zero-fill past d, lq and lk. vt makes v^T a K-major operand, as the
//     mainloop's descriptors take it, one tile after another: tile j of
//     term t is [kVRows][64] (one TMA box), row r holding keys kKeys j ..
//     of column r (64-key tiles), or of columns r and r + KD / 2 side by
//     side (32-key tiles: each 128-byte row then carries both halves').
// (2) fold_wgmma_kernel, one 384-thread block per kRows query rows and per
//     split of the key tiles (the splits fill the SMs: lq = 8192, d = 128
//     gives 64 row blocks, so keys split in 2 and 128 blocks run).
//     Warpgroup 0 is the producer (setmaxnreg.dec 40): one thread loads
//     the block's q once and then, per tile of kKeys keys, k's and v^T's
//     terms by TMA (boxes 64 wide, 128-byte swizzle) into rings of kStages
//     stages with full and empty mbarriers, as gemm_sm90.cuh does.
//     Warpgroups 1 and 2 (setmaxnreg.inc 232) are the consumers. Per tile:
//     s by wgmma m64n{kKeys}k16 (q and k from shared memory); scale, mask,
//     row max across the row's 4 threads by shuffles, the online rescale,
//     p = exp(s - m') split in registers into 3 bf16 terms (split3_bits:
//     integer arithmetic, no conversion instructions) that are wgmma's A
//     fragments as they lie (the accumulator of m64nNk16 is the A fragment
//     of the next product: FlashAttention-3's arrangement); p.v by wgmma
//     with A from registers into a fresh tile accumulator, then o = o a +
//     o_tile by f32 FMA. So the tensor core sums at most one tile's passes
//     before the result is rounded into o, never the block's keys.
//     KD = 128: 128 rows a block, each consumer owning 64 rows and all of
//     o's 128 columns, tiles of 64 keys. The two consumers take turns to
//     issue s (named barriers 1 and 2, FlashAttention-3's ping-pong), so
//     one's softmax runs while the other's products do. Shared memory for
//     f32 inputs (three terms): q 96 KiB, a tile's k and v^T 48 KiB each,
//     so one stage of each (192 KiB of the 227) and the splits'
//     parallelism do the overlapping: k for the next tile loads while this
//     tile's p.v runs, v while the next s runs. bf16 inputs take 3 stages.
//     Registers a consumer thread: o and o_tile 64 each, s 32, p's
//     fragments 48.
//     KD = 192, 256 (the wide heads): a consumer owning 64 rows and all of
//     o would hold 128 registers of o beside 128 of o_tile, and q for 128
//     rows in three terms (192 KiB) leaves no room for a tile. So a block
//     takes 64 rows, and both consumers work on all of them, each owning a
//     KD / 2 column half of o and of v^T: o and o_tile 64 registers each
//     at KD = 256, as at 128. Both need the same p, and no product is
//     issued twice; the ping-pong gives way to an exchange in shared
//     memory, shaped by what s costs:
//     - f32 inputs (s is half the tensor work, and its q operand's reads
//       of shared memory bound it): each consumer computes s over its half
//       of the head dim (every other k16 step from its c-th, every cross
//       term), writes that half and adds the other's (named barrier 3 on
//       both sides of the write), so both hold the same s and run the
//       same softmax. q takes 96 KiB at KD = 256, tiles hold 32 keys (k
//       and v^T 48 KiB each, one stage), the exchange 16 KiB.
//     - bf16 inputs (s is a quarter; a half of it costs less than its
//       exchange in f32): the first consumer computes s over the whole
//       head dim and the softmax, and hands p's A fragments and the
//       rescale over in shared memory (barrier 3: handed over; 4: read),
//       which the second takes as they lie, and after the last tile m and
//       l. 64-key tiles, 2 stages at KD = 256 and 3 at 192; the hand-over
//       25 KiB.
//     With one split (nsplit = 1: the wide heads at lq = 8192), the
//     consumers merge their (m, l, o) with the carry themselves, as (3)
//     would, and (3) is not launched.
// (3) fold_combine_kernel, one warp per row: each split's (m, l, o), all
//     relative to its own running max, merged with the carry:
//     m' = max(m, m_s), l' = l e^(m - m') + sum l_s e^(m_s - m'),
//     o' = o e^(m - m') + sum o_s e^(m_s - m'); with `final`, out = o' / l'.
// Keys past lk score -inf; padded rows are never written. Numerics: the
// products of the split terms are exact; the sums differ from the plain
// version's in order and in the tensor core's f32 additions (wide heads,
// f32 inputs: s is the f32 sum of its two halves' sums), the rescale
// happens per tile and per split, and exp is expf in both.
//
// d > 256: the chunked f32 FMA kernel (ring_fold_kernel). The split-term
// design does not fit there: q for 64 rows and a 32-key tile of k and of
// v^T, three terms each, take 240 KiB of shared memory at d = 320. No
// published model has heads that wide. One 256-thread block per 64 query
// rows and per chunk of 128 head-dim columns of o loops over lk in tiles
// of 64 keys with the online rescale inside the loop; each chunk's block
// recomputes all of s over every chunk of d in shared memory, and its m
// and l go to separate outputs, written by the chunk-0 block, since the
// other chunks' blocks still read the carry's old m. Bound: 4 * lq * lk
// * d flops at 67 TFLOP/s (f32).
//
// Interface: plain C, loaded with ctypes. dtype codes: 0 = f32, 1 = bf16;
// any d >= 1. tbus_ring_fold_scratch_bytes says how much device scratch
// the call needs (0 for d > 256). m_out and l_out may alias m and l when
// d <= 256 and must not otherwise. Launches on the given stream, does not
// synchronise, returns cudaGetLastError() (a launch refused for its
// shared memory or its grid returns that error and runs nothing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---- d <= 256: split terms on wgmma ----

constexpr int kMaxD = 256;         // the widest head the design takes
constexpr int kBox = 64 * 128;     // one TMA box: 64 rows x 64 bf16
constexpr int kFoldThreads = 384;  // producer + two consumer warpgroups
constexpr int kPackThreads = 256;
constexpr int kSmemCap = 232448;  // what a block may use (227 KiB)
constexpr int kBarBytes = 256;

// KD, the width d is padded to: 128, 192 or 256.
inline int padded_d(int d) { return d <= 128 ? 128 : (d + 63) / 64 * 64; }

template <int NT, int KD>
struct Fold {
  static constexpr bool kWide = KD > 128;
  // Wide heads: with three terms the consumers split s by head-dim halves
  // and exchange the halves (kSplitS); with one term the first computes s
  // and hands p's terms to the second (kShareP).
  static constexpr bool kSplitS = kWide && NT == 3;
  static constexpr bool kShareP = kWide && NT == 1;
  static constexpr int kRows = kWide ? 64 : 128;  // query rows per block
  static constexpr int kKeys = kWide && NT == 3 ? 32 : 64;  // keys per tile
  static constexpr int kDB = KD / 64;  // TMA boxes across the head dim
  static constexpr int kOCols = kWide ? KD / 2 : KD;  // o columns a consumer
  static constexpr int kVRows = KD * kKeys / 64;  // rows of a v^T term tile
  static constexpr int kQBytes = NT * kRows * KD * 2;
  static constexpr int kTileBytes = NT * kKeys * KD * 2;  // k's, and v^T's
  // Words a consumer thread hands over: p's A fragments and the rescale.
  static constexpr int kPWords = 3 * (kKeys / 16) * 4 + 2;
  // The consumers' exchange: their halves of s, or p's terms.
  static constexpr int kXBytes = kSplitS   ? 2 * 128 * (kKeys / 2) * 4
                                 : kShareP ? 128 * kPWords * 4
                                           : 0;
  static constexpr int kFit =
      (kSmemCap - 1024 - kBarBytes - kQBytes - kXBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr int kSmem =
      kQBytes + kStages * 2 * kTileBytes + kXBytes + kBarBytes + 1024;
  static_assert(KD % 64 == 0 && KD <= kMaxD, "padded width");
  static_assert(kStages >= 1, "q and one stage must fit");
  static_assert(kSmem <= kSmemCap, "shared memory");
  static_assert(kVRows <= 256, "a v^T term tile is one TMA box");
};

// d[64 x N] (+)= A[64 x 16] . B[N x 16]^T, A and B K-major in shared
// memory; acc = 0 ignores d's old values. N = 64 (d[32]) or 32 (d[16]).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x N] (+)= A[64 x 16] . B[N x 16]^T, A from registers (a: this
// thread's A fragment), B K-major in shared memory; acc = 0 ignores d.
// N = 128 (d[64]) or 96 (d[48]).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// Named barriers 1 and 2 (0 is __syncthreads'): the two consumer
// warpgroups' turns to issue s, 256 threads each (one warpgroup syncs, the
// other arrives).
__device__ __forceinline__ void turn_sync(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + (wg ^ 1)) : "memory");
}
// Named barriers 3 and 4, 256 threads each: the consumers' exchange (both
// sync on 3 around a split s; 3 says p is handed over, 4 that it was read).
template <int ID>
__device__ __forceinline__ void nb_sync() {
  asm volatile("bar.sync %0, 256;\n" :: "n"(ID) : "memory");
}
template <int ID>
__device__ __forceinline__ void nb_arrive() {
  asm volatile("bar.arrive %0, 256;\n" :: "n"(ID) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait0() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// p's split inside the fold, by integer arithmetic: conversion
// instructions issue at a quarter of the FMA rate, and the softmax would
// spend more issue slots on them than the tensor cores spend on a bf16
// tile. Each term rounds half away from zero (add half an ulp of 8 bits,
// drop the low 16) where split3 rounds half to even, so the terms may
// differ from split3's on a tie, but hi + mid + lo == a all the same:
// a - hi and its remainder are exact, and lo keeps 8 significant bits.
// Returns each term's f32 bits, whose low halves are zero.
__device__ __forceinline__ void split3_bits(float a, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x8000u) & 0xFFFF0000u;
  const float r = a - __uint_as_float(hi);
  mid = (__float_as_uint(r) + 0x8000u) & 0xFFFF0000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// The bf16x2 word of two such terms: a's upper half low, b's high.
__device__ __forceinline__ uint32_t pack_hi16(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// s (+)= q k^T over the cross terms, smallest first, in the k16 steps
// 0, STEP, 2 STEP, .. of the head dim's KD / 16 from the descriptors qd
// and kd (the first step's; a descriptor's address moves with its low
// bits): q's terms QT bytes apart, k's KT, their boxes of 64 columns kBox
// (q) and KB (k) apart.
template <int NT, int KD, int STEP, int QT, int KT, int KB, int N>
__device__ __forceinline__ void s_products(float (&sc)[N], uint64_t qd,
                                           uint64_t kd) {
#pragma unroll
  for (int sum = 2; sum >= 0; --sum)
#pragma unroll
    for (int qi = sum; qi >= 0; --qi) {
      const int kj = sum - qi;
      if (qi >= NT || kj >= NT) continue;
#pragma unroll
      for (int kk = 0; kk < KD / 16; kk += STEP) {
        const int off = 32 * (kk % 4);
        wgmma_ss(sc, qd + uint64_t((qi * QT + (kk / 4) * kBox + off) >> 4),
                 kd + uint64_t((kj * KT + (kk / 4) * KB + off) >> 4), 1);
      }
    }
}

struct FoldArgs {
  float* part_m;  // [nsplit][lq_p]
  float* part_l;  // [nsplit][lq_p]
  float* part_o;  // [nsplit][lq_p][KD]
  int lq_p, lk, lk_p, tiles, nsplit;
  float scale;
  // The carry and the output, for one split (nsplit == 1), which the fold
  // merges itself: m, l, o as fold_combine_kernel takes them.
  const float* m_in;
  const float* l_in;
  float* m_out;
  float* l_out;
  float* o;
  void* out;  // null, or [lq, d] in the input's dtype
  int lq, d;
};

template <int NT, int KD>
__global__ void __launch_bounds__(kFoldThreads, 1)
fold_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, FoldArgs args) {
  using F = Fold<NT, KD>;
  constexpr int S = F::kStages, KK = F::kKeys, DB = F::kDB;
  constexpr int QB = F::kRows / 64;        // q's 64-row boxes
  constexpr int kKBox = KK * 128;          // one k box: KK rows x 64 bf16
  constexpr int kVTerm = F::kVRows * 128;  // one term of a v^T tile
  constexpr int OC = F::kOCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  auto k_s = [&](int s) {
    return base + uint32_t(F::kQBytes + s * 2 * F::kTileBytes);
  };
  auto v_s = [&](int s) { return k_s(s) + uint32_t(F::kTileBytes); };
  const uint32_t x_at = uint32_t(F::kQBytes + S * 2 * F::kTileBytes);
  // The exchange, thread t's word i at [i][t]: [2][KK / 2][128] for the
  // consumers' halves of s (consumer c's at [c]), [kPWords][128] for p.
  float* const xs = reinterpret_cast<float*>(
      smem_raw + (base - sm90::smem_u32(smem_raw)) + x_at);
  const uint32_t bars = base + x_at + uint32_t(F::kXBytes);
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + uint32_t(8 * (1 + s)); };
  auto k_empty = [&](int s) { return bars + uint32_t(8 * (1 + S + s)); };
  auto v_full = [&](int s) { return bars + uint32_t(8 * (1 + 2 * S + s)); };
  auto v_empty = [&](int s) { return bars + uint32_t(8 * (1 + 3 * S + s)); };
  const int tid = threadIdx.x, wg = tid / 128;
  const int row0 = int(blockIdx.x) * F::kRows;
  const int split = int(blockIdx.y);
  const int t0 = int((long long)split * args.tiles / args.nsplit);
  const int t1 = int((long long)(split + 1) * args.tiles / args.nsplit);

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(k_full(s), 1);
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(k_empty(s), F::kShareP ? 1 : 2);
      sm90::mbar_init(v_empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread loads q once, then keeps both rings full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&q_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&k_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&v_map)) : "memory");
      sm90::mbar_expect_tx(q_full, F::kQBytes);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int c = 0; c < QB; ++c)
#pragma unroll
          for (int b = 0; b < DB; ++b) {
            sm90::tma_load(q_s + uint32_t(((t * QB + c) * DB + b) * kBox),
                           &q_map, q_full, 64 * b,
                           t * args.lq_p + row0 + 64 * c);
          }
      int s = 0;
      uint32_t ph = 0;
      for (int j = t0; j < t1; ++j) {
        const int key0 = j * KK;
        sm90::mbar_wait(k_empty(s), ph ^ 1);
        sm90::mbar_expect_tx(k_full(s), F::kTileBytes);
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int b = 0; b < DB; ++b) {
            sm90::tma_load(k_s(s) + uint32_t((t * DB + b) * kKBox), &k_map,
                           k_full(s), 64 * b, t * args.lk_p + key0);
          }
        sm90::mbar_wait(v_empty(s), ph ^ 1);
        sm90::mbar_expect_tx(v_full(s), F::kTileBytes);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          sm90::tma_load(v_s(s) + uint32_t(t * kVTerm), &v_map, v_full(s), 0,
                         (t * args.tiles + j) * F::kVRows);
        }
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // A consumer: query rows row0 + 64 qc .. + 63, o columns oc0 .. + OC - 1.
  // Thread t (warp w, lane l) holds rows 16 w + l / 4 and that + 8 of
  // them, and in s columns (keys) 8 j + 2 (l % 4) and that + 1, j = 0 ..
  // KK / 8 - 1 (wgmma's layout); in o the same with columns for keys.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = tid % 128, w = t / 32, l = t % 32;
  const int qc = F::kWide ? 0 : c;
  const int oc0 = F::kWide ? c * OC : 0;
  // This consumer's columns in a v^T term tile: rows of their own
  // (64-key tiles), or the second 64 bytes of each row (32-key tiles).
  const uint32_t v_cols =
      F::kWide ? uint32_t(KK == 64 ? c * OC * 128 : c * 64) : 0u;
  float o[OC / 2], ot[OC / 2], sc[KK / 2];
  uint32_t pf[3][KK / 16][4];  // p's terms as A fragments, per 16 keys
#pragma unroll
  for (int i = 0; i < OC / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // One split: the carry's m and l for this thread's rows, read before
  // any thread writes them (they may alias m_out and l_out).
  const int r0 = row0 + 64 * qc + 16 * w + l / 4;
  float m_in[2] = {0.f, 0.f}, l_in[2] = {0.f, 0.f};
  if (args.nsplit == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r0 + 8 * r < args.lq) {
        m_in[r] = args.m_in[r0 + 8 * r];
        l_in[r] = args.l_in[r0 + 8 * r];
      }
    }
  }
  // kSplitS: this consumer's half of the head dim, every other k16 step
  // from its c-th (32 bytes on).
  const uint32_t s_half = F::kSplitS ? uint32_t(32 * c) : 0u;
  const uint64_t q_desc =
      sm90::smem_desc(q_s + uint32_t(qc * DB * kBox) + s_half);
  sm90::mbar_wait(q_full, 0);
  // KD = 128: the warpgroups take turns to issue s (warpgroup 0 first),
  // so one's softmax runs while the other's products do (FlashAttention-3's
  // ping-pong). Each passes the turn once per tile; warpgroup 0 takes the
  // last pass after the loop, so every arrival is matched. The hand-over
  // of p (kShareP) is matched the same way: the buffer starts empty.
  if (!F::kWide && c == 1) turn_pass(c);
  if (F::kShareP && c == 1) nb_arrive<4>();
  int s = 0;
  uint32_t ph = 0;
  for (int j = t0; j < t1; ++j) {
    const int key0 = j * KK;
    float alpha[2];
    if (!F::kShareP || c == 0) {
      // s = q k^T over the cross terms, smallest first.
#pragma unroll
      for (int i = 0; i < KK / 2; ++i) sc[i] = 0.f;
      if (!F::kWide) turn_sync(c);
      sm90::mbar_wait(k_full(s), ph);
      fence_regs(sc);
      wgmma_fence();
      constexpr int QT = QB * DB * kBox, KT = DB * kKBox;
      s_products<NT, KD, F::kSplitS ? 2 : 1, QT, KT, kKBox>(
          sc, q_desc, sm90::smem_desc(k_s(s) + s_half));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (!F::kWide) turn_pass(c);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(sc);
      if (t == 0) sm90::mbar_arrive(k_empty(s));
      if constexpr (F::kSplitS) {
        // s = this half + the other's, the same sum in both (a + b == b +
        // a). The first barrier: the other has read what this one wrote.
        nb_sync<3>();
#pragma unroll
        for (int i = 0; i < KK / 2; ++i) {
          xs[(c * (KK / 2) + i) * 128 + t] = sc[i];
        }
        nb_sync<3>();
#pragma unroll
        for (int i = 0; i < KK / 2; ++i) {
          sc[i] += xs[((1 - c) * (KK / 2) + i) * 128 + t];
        }
      }

      // The online softmax on the fragments: sc[4 j + e] is row r = e / 2
      // (r0 or r0 + 8), key 8 j + 2 (l % 4) + e % 2.
      const bool tail = key0 + KK > args.lk;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < KK / 2; ++i) {
        const int key = key0 + 8 * (i / 4) + 2 * (l % 4) + (i % 2);
        float v = sc[i] * args.scale;
        if (tail && key >= args.lk) v = -INFINITY;
        sc[i] = v;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], v);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < KK / 2; i += 2) {
        uint32_t hi[2], mid[2], lo[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (i / 2) % 2;
          const float p = expf(sc[i + h] - m_run[r]);
          l_run[r] += p;
          split3_bits(p, hi[h], mid[h], lo[h]);
        }
        // Keys 16 kk .. 16 kk + 15 are A fragment kk: words (row r0, keys
        // +0/1), (r0 + 8, +0/1), (r0, +8/9), (r0 + 8, +8/9).
        const int kk = i / 8, word = (i % 8) / 2;
        pf[0][kk][word] = pack_hi16(hi[0], hi[1]);
        pf[1][kk][word] = pack_hi16(mid[0], mid[1]);
        pf[2][kk][word] = pack_hi16(lo[0], lo[1]);
      }
      if constexpr (F::kShareP) {
        // Hand p's terms and the rescale to the other consumer, whose
        // thread t holds the same rows and keys, once it has read the last.
        uint32_t* pw = reinterpret_cast<uint32_t*>(xs);
        nb_sync<4>();
#pragma unroll
        for (int i = 0; i < 3 * (KK / 16) * 4; ++i) {
          pw[i * 128 + t] = pf[i / (KK / 4)][(i / 4) % (KK / 16)][i % 4];
        }
        pw[(F::kPWords - 2) * 128 + t] = __float_as_uint(alpha[0]);
        pw[(F::kPWords - 1) * 128 + t] = __float_as_uint(alpha[1]);
        nb_arrive<3>();
      }
    } else {
      // kShareP's second consumer: p and the rescale from the first.
      const uint32_t* pw = reinterpret_cast<const uint32_t*>(xs);
      nb_sync<3>();
#pragma unroll
      for (int i = 0; i < 3 * (KK / 16) * 4; ++i) {
        pf[i / (KK / 4)][(i / 4) % (KK / 16)][i % 4] = pw[i * 128 + t];
      }
      alpha[0] = __uint_as_float(pw[(F::kPWords - 2) * 128 + t]);
      alpha[1] = __uint_as_float(pw[(F::kPWords - 1) * 128 + t]);
      nb_arrive<4>();
    }

    // o_tile = p v over the cross terms, smallest first; A from registers.
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) ot[i] = 0.f;
    sm90::mbar_wait(v_full(s), ph);
    fence_regs(ot);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int kk = 0; kk < KK / 16; ++kk) fence_regs(pf[i][kk]);
    wgmma_fence();
#pragma unroll
    for (int sum = 2; sum >= 0; --sum)
#pragma unroll
      for (int pi = sum; pi >= 0; --pi) {
        const int vj = sum - pi;
        if (vj >= NT) continue;
#pragma unroll
        for (int kk = 0; kk < KK / 16; ++kk) {
          wgmma_rs(ot, pf[pi][kk],
                   sm90::smem_desc(v_s(s) + uint32_t(vj * kVTerm) + v_cols +
                                   uint32_t(32 * kk)),
                   1);
        }
      }
    wgmma_commit_wait0();
    fence_regs(ot);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int kk = 0; kk < KK / 16; ++kk) fence_regs(pf[i][kk]);
    if (t == 0) sm90::mbar_arrive(v_empty(s));
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) {
      o[i] = fmaf(o[i], alpha[(i / 2) % 2], ot[i]);
    }
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
  }

  if (!F::kWide && c == 0) turn_sync(c);

  // This split's (m, l, o) for the block's rows, o relative to m; with
  // both consumers on the same rows (KD > 128), the first writes m and l.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if constexpr (F::kShareP) {
    // The second consumer's m and l, which only the first computed, once
    // the second has read the last p.
    uint32_t* pw = reinterpret_cast<uint32_t*>(xs);
    if (c == 0) {
      nb_sync<4>();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        pw[r * 128 + t] = __float_as_uint(m_run[r]);
        pw[(2 + r) * 128 + t] = __float_as_uint(l_run[r]);
      }
      nb_arrive<3>();
    } else {
      nb_sync<3>();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_run[r] = __uint_as_float(pw[r * 128 + t]);
        l_run[r] = __uint_as_float(pw[(2 + r) * 128 + t]);
      }
    }
  }
  if (args.nsplit == 1) {
    // The merge with the carry, as fold_combine_kernel makes it.
    using TO = typename std::conditional<NT == 3, float, __nv_bfloat16>::type;
    TO* const out = static_cast<TO*>(args.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= args.lq) continue;
      const float mx = fmaxf(m_in[r], m_run[r]);
      const float a_in = expf(m_in[r] - mx);  // 0 for the first fold's -inf
      const float a = expf(m_run[r] - mx);
      float ln = l_in[r] * a_in;
      ln += l_run[r] * a;
      float* const orow = args.o + (long long)row * args.d;
#pragma unroll
      for (int jj = 0; jj < OC / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = oc0 + 8 * jj + 2 * (l % 4) + h;
          if (col >= args.d) continue;
          float acc = orow[col] * a_in;
          acc += o[4 * jj + 2 * r + h] * a;
          if (out != nullptr) {
            store_out(out + (long long)row * args.d + col, acc / ln);
          } else {
            orow[col] = acc;
          }
        }
      if (l % 4 == 0 && (!F::kWide || c == 0)) {
        args.m_out[row] = mx;
        args.l_out[row] = ln;
      }
    }
    return;
  }
  const long long rows = (long long)split * args.lq_p;
  if (l % 4 == 0 && (!F::kWide || c == 0)) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      args.part_m[rows + r0 + 8 * r] = m_run[r];
      args.part_l[rows + r0 + 8 * r] = l_run[r];
    }
  }
  float* po = args.part_o + (rows + r0) * KD + oc0 + 2 * (l % 4);
#pragma unroll
  for (int jj = 0; jj < OC / 8; ++jj) {
    *reinterpret_cast<float2*>(po + 8 * jj) =
        make_float2(o[4 * jj], o[4 * jj + 1]);
    *reinterpret_cast<float2*>(po + 8 * KD + 8 * jj) =
        make_float2(o[4 * jj + 2], o[4 * jj + 3]);
  }
}

// The terms of an input value: its split for f32 inputs (NT = 3), the
// value itself for bf16 (NT = 1).
template <int NT>
__device__ __forceinline__ void terms(float a, float (&t)[3]) {
  if constexpr (NT == 1) {
    t[0] = a;
  } else {
    sm90::split3(a, t[0], t[1], t[2]);
  }
}

// Term i of eight consecutive values as four bf16x2 words.
__device__ __forceinline__ uint4 pack8(const float (&t)[8][3], int i) {
  return make_uint4(sm90::pack2(t[0][i], t[1][i]),
                    sm90::pack2(t[2][i], t[3][i]),
                    sm90::pack2(t[4][i], t[5][i]),
                    sm90::pack2(t[6][i], t[7][i]));
}

// Where (column col, key) of v lies in one term of vt: tile key / kKeys,
// row col % kVRows, and in that row the keys of column col's kVRows-wide
// group (see the top of the file).
template <int NT, int KD>
__device__ __forceinline__ long long vt_offset(int col, long long key) {
  using F = Fold<NT, KD>;
  return ((key / F::kKeys) * F::kVRows + col % F::kVRows) * 64 +
         (col / F::kVRows) * F::kKeys + key % F::kKeys;
}

// Blocks [0, row_blocks) write qs and ks (grid-stride over chunks of 8
// columns of a row); the rest write vt, one 64 keys x 64 columns tile of
// v each, through shared memory (read along d, written along keys).
template <typename T, int NT, int KD>
__global__ void __launch_bounds__(kPackThreads)
fold_pack_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, __nv_bfloat16* __restrict__ qs,
                 __nv_bfloat16* __restrict__ ks,
                 __nv_bfloat16* __restrict__ vt, int lq, int lk, int d,
                 long long lq_p, long long lk_p, int row_blocks) {
  const int tid = threadIdx.x;
  if (int(blockIdx.x) < row_blocks) {
    const int per_row = KD / 8;
    const long long chunks = (lq_p + lk_p) * per_row;
    for (long long ch = blockIdx.x * (long long)kPackThreads + tid;
         ch < chunks; ch += (long long)row_blocks * kPackThreads) {
      const long long r = ch / per_row;
      const int c0 = int(ch % per_row) * 8;
      const bool is_q = r < lq_p;
      const long long rr = is_q ? r : r - lq_p;
      const long long n = is_q ? lq : lk;
      const T* src = (is_q ? q : k) + rr * d;
      float t[8][3];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float a = rr < n && c0 + e < d ? to_f32(src[c0 + e]) : 0.f;
        terms<NT>(a, t[e]);
      }
      __nv_bfloat16* dst = (is_q ? qs : ks) + rr * KD + c0;
      const long long term_stride = (is_q ? lq_p : lk_p) * KD;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        *reinterpret_cast<uint4*>(dst + i * term_stride) = pack8(t, i);
      }
    }
    return;
  }
  __shared__ float tile[64][64 + 1];  // [key][column]
  const long long tt = blockIdx.x - row_blocks;
  const long long tiles64 = (lk_p + 63) / 64;
  const long long key0 = (tt % tiles64) * 64;
  const int c0 = int(tt / tiles64) * 64;
  const int j = tid % 64;
#pragma unroll
  for (int it = 0; it < 64 * 64 / kPackThreads; ++it) {
    const int i = it * (kPackThreads / 64) + tid / 64;
    tile[i][j] = key0 + i < lk && c0 + j < d
                     ? to_f32(v[(key0 + i) * d + c0 + j])
                     : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 64 * 64 / 8 / kPackThreads; ++h) {
    const int qd = tid + h * kPackThreads;
    const int r = qd / 8, kc = (qd % 8) * 8;
    if (key0 + kc >= lk_p) continue;  // 32-key tiles: past the last one
    float t[8][3];
#pragma unroll
    for (int e = 0; e < 8; ++e) terms<NT>(tile[kc + e][r], t[e]);
    const long long at = vt_offset<NT, KD>(c0 + r, key0 + kc);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      *reinterpret_cast<uint4*>(vt + i * lk_p * KD + at) = pack8(t, i);
    }
  }
}

// One warp per row, lane j on columns j, j + 32, ...: every lane reads
// the carry's m and l before lane 0 writes them, so they may alias m_out
// and l_out.
template <typename TO, int KD>
__global__ void __launch_bounds__(256)
fold_combine_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_o, int nsplit,
                    long long lq_p, const float* m_in,
                    const float* l_in, float* m_out, float* l_out,
                    float* o, TO* out, int lq, int d) {
  constexpr int E = KD / 32;
  const int row = int(blockIdx.x) * 8 + int(threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= lq) return;
  const float mi = m_in[row], li = l_in[row];
  float mx = mi;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[s * lq_p + row]);
  const float a_in = expf(mi - mx);  // 0 for the first fold's -inf
  float ln = li * a_in, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int col = 32 * e + lane;
    acc[e] = col < d ? o[(long long)row * d + col] * a_in : 0.f;
  }
  for (int s = 0; s < nsplit; ++s) {
    const long long pr = s * lq_p + row;
    const float a = expf(part_m[pr] - mx);
    ln += part_l[pr] * a;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[e] += part_o[pr * KD + 32 * e + lane] * a;
    }
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int col = 32 * e + lane;
    if (col >= d) continue;
    if (out != nullptr) {
      store_out(out + (long long)row * d + col, acc[e] / ln);
    } else {
      o[(long long)row * d + col] = acc[e];
    }
  }
  if (lane == 0) {
    m_out[row] = mx;
    l_out[row] = ln;
  }
}

// The scratch of one call: split operands, then the splits' partials,
// each 1024-byte aligned.
struct Layout {
  int nsplit, tiles, row_blocks;
  long long lq_p, lk_p, qs, ks, vt, pm, pl, po, bytes;
};

long long align1k(long long v) { return (v + 1023) / 1024 * 1024; }

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n <= 0) {
    n = 132;
  }
  return n;
}

template <int NT, int KD>
Layout layout(int lq, int lk) {
  using F = Fold<NT, KD>;
  Layout L;
  L.lq_p = (lq + F::kRows - 1) / F::kRows * F::kRows;
  L.lk_p = (lk + F::kKeys - 1) / F::kKeys * F::kKeys;
  L.row_blocks = int(L.lq_p / F::kRows);
  L.tiles = int(L.lk_p / F::kKeys);
  // Key splits fill the SMs; each split holds at least one tile.
  const int want = sm_count() / L.row_blocks;
  L.nsplit = want < 1 ? 1 : (want > L.tiles ? L.tiles : want);
  long long at = 0;
  L.qs = at; at = align1k(at + NT * L.lq_p * KD * 2);
  L.ks = at; at = align1k(at + NT * L.lk_p * KD * 2);
  L.vt = at; at = align1k(at + NT * L.lk_p * KD * 2);
  const long long parts = L.nsplit > 1 ? L.nsplit : 0;  // one merges itself
  L.pm = at; at = align1k(at + parts * L.lq_p * 4);
  L.pl = at; at = align1k(at + parts * L.lq_p * 4);
  L.po = at; at = align1k(at + parts * L.lq_p * KD * 4);
  L.bytes = at;
  return L;
}

template <typename T, int NT, int KD>
int launch_wgmma(const void* q, const void* k, const void* v, const float* m,
                 const float* l, float* m_out, float* l_out, float* o,
                 void* out, uint8_t* scratch, int lq, int lk, int d,
                 float scale, cudaStream_t stream) {
  using F = Fold<NT, KD>;
  const Layout L = layout<NT, KD>(lq, lk);
  auto* qs = reinterpret_cast<__nv_bfloat16*>(scratch + L.qs);
  auto* ks = reinterpret_cast<__nv_bfloat16*>(scratch + L.ks);
  auto* vt = reinterpret_cast<__nv_bfloat16*>(scratch + L.vt);
  // bf16 inputs whose rows TMA reads as they lie (16-byte aligned base
  // and rows) need no copy of q and k: their maps zero-fill past d, lq
  // and lk as the copies' padding would.
  const bool direct = NT == 1 && d % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const long long chunks = (L.lq_p + L.lk_p) * (KD / 8);
  long long row_blocks = (chunks + kPackThreads - 1) / kPackThreads;
  if (row_blocks > 1024) row_blocks = 1024;  // grid-stride beyond
  if (direct) row_blocks = 0;
  const long long vt_blocks = (L.lk_p + 63) / 64 * (KD / 64);
  fold_pack_kernel<T, NT, KD>
      <<<unsigned(row_blocks + vt_blocks), kPackThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), qs, ks, vt, lq, lk, d, L.lq_p, L.lk_p,
          int(row_blocks));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  CUtensorMap q_map, k_map, v_map;
  e = direct ? sm90::encode_kmajor_bf16(&q_map, q, lq, d, 64)
             : sm90::encode_kmajor_bf16(&q_map, qs, NT * L.lq_p, KD, 64);
  if (e == cudaSuccess) {
    e = direct
            ? sm90::encode_kmajor_bf16(&k_map, k, lk, d, F::kKeys)
            : sm90::encode_kmajor_bf16(&k_map, ks, NT * L.lk_p, KD, F::kKeys);
  }
  if (e == cudaSuccess) {
    e = sm90::encode_kmajor_bf16(&v_map, vt,
                                 (long long)NT * L.tiles * F::kVRows, 64,
                                 F::kVRows);
  }
  if (e != cudaSuccess) return int(e);
  e = cudaFuncSetAttribute(fold_wgmma_kernel<NT, KD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           F::kSmem);
  if (e != cudaSuccess) return int(e);
  FoldArgs args{reinterpret_cast<float*>(scratch + L.pm),
                reinterpret_cast<float*>(scratch + L.pl),
                reinterpret_cast<float*>(scratch + L.po),
                int(L.lq_p), lk, int(L.lk_p), L.tiles, L.nsplit, scale,
                m, l, m_out, l_out, o, out, lq, d};
  fold_wgmma_kernel<NT, KD>
      <<<dim3(unsigned(L.row_blocks), unsigned(L.nsplit)), kFoldThreads,
         F::kSmem, stream>>>(q_map, k_map, v_map, args);
  e = cudaGetLastError();
  if (e != cudaSuccess || L.nsplit == 1) return int(e);
  fold_combine_kernel<T, KD><<<unsigned((lq + 7) / 8), 256, 0, stream>>>(
      args.part_m, args.part_l, args.part_o, L.nsplit, L.lq_p, m, l,
      m_out, l_out, o, static_cast<T*>(out), lq, d);
  return int(cudaGetLastError());
}

// The instantiation for (d, dtype): its input type, terms and width.
template <typename T, int NT, int KD>
struct Inst {
  using Type = T;
  static constexpr int kNT = NT, kKD = KD;
};

// fn(Inst<...>{}) for the instantiation that takes d <= kMaxD and dtype.
template <class Fn>
auto with_inst(int d, int dtype, Fn&& fn) {
  const int kd = padded_d(d);
  if (dtype == 0) {
    if (kd == 128) return fn(Inst<float, 3, 128>{});
    if (kd == 192) return fn(Inst<float, 3, 192>{});
    return fn(Inst<float, 3, 256>{});
  }
  if (kd == 128) return fn(Inst<__nv_bfloat16, 1, 128>{});
  if (kd == 192) return fn(Inst<__nv_bfloat16, 1, 192>{});
  return fn(Inst<__nv_bfloat16, 1, 256>{});
}

// ---- d > 256: the chunked f32 FMA kernel ----

constexpr int kThreads = 256;
constexpr int kBQ = 64, kBK = 64, kChunk = 128;
constexpr int kLdq = kBQ + 4, kLdk = kBK + 4;  // padded rows, 16-byte aligned
constexpr int kChunkSmem =
    (kChunk * kLdq + kChunk * kLdk + kBK * kChunk + kBK * kLdq) *
    int(sizeof(float));

// Loads rows [r0g, r0g + rows) of x, columns [c0g, c0g + kChunk),
// transposed into dst [kChunk][ld], zero past the rows' end n and the
// columns' end d.
template <int ROWS, typename T>
__device__ __forceinline__ void load_t(float* dst, int ld, const T* x,
                                       int64_t r0g, int64_t n, int c0g,
                                       int d, int tid) {
  for (int i = tid; i < ROWS * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i % kChunk;
    dst[c * ld + r] = (r0g + r < n && c0g + c < d)
                          ? to_f32(x[(r0g + r) * d + c0g + c])
                          : 0.f;
  }
}

// s[4][4] += this thread's patch of Qt^T Kt over one chunk.
__device__ __forceinline__ void add_scores(float (&s)[4][4], const float* Qt,
                                           const float* Kt, int r0, int tx) {
#pragma unroll 8
  for (int c = 0; c < kChunk; ++c) {
    const float4 qa = *reinterpret_cast<const float4*>(&Qt[c * kLdq + r0]);
    const float4 kb = *reinterpret_cast<const float4*>(&Kt[c * kLdk + tx * 4]);
    const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
    const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
  }
}

// One block per 64 query rows and per 128 columns of o (blockIdx.y); with
// out set, it writes o' / l' there in T instead of o'.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_fold_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* m_in,
                 const float* l_in, float* m_out, float* l_out,
                 float* __restrict__ o_io, T* out, int lq, int lk, int d,
                 float scale) {
  constexpr int CPT = kChunk / 16;  // o columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // [kChunk][kLdq]  q chunk transposed
  float* Kt = Qt + kChunk * kLdq;    // [kChunk][kLdk]  k chunk transposed
  float* Vs = Kt + kChunk * kLdk;    // [kBK][kChunk]   v tile, this block's
  float* Pt = Vs + kBK * kChunk;     // [kBK][kLdq]     p transposed

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * 4;    // this thread's 4 query rows (local)
  const int c0 = tx * CPT;  // this thread's o columns (in the chunk)
  const int cb = int(blockIdx.y) * kChunk;  // first o column
  const int64_t q0 = int64_t(blockIdx.x) * kBQ;

  float mrow[4], lrow[4], acc[4][CPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int64_t r = q0 + r0 + ii;
    const bool ok = r < lq;
    mrow[ii] = ok ? m_in[r] : -INFINITY;
    lrow[ii] = ok ? l_in[r] : 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int c = cb + c0 + e;
      acc[ii][e] = (ok && c < d) ? o_io[r * d + c] : 0.f;
    }
  }

  for (int k0 = 0; k0 < lk; k0 += kBK) {
    __syncthreads();  // the last tile's Qt, Kt, Vs, Pt all read
    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
    for (int i = tid; i < kBK * kChunk; i += kThreads) {
      const int j = i / kChunk, c = i % kChunk;
      Vs[j * kChunk + c] = (k0 + j < lk && cb + c < d)
                               ? to_f32(v[int64_t(k0 + j) * d + cb + c])
                               : 0.f;
    }
    for (int dc = 0; dc < d; dc += kChunk) {
      if (dc > 0) __syncthreads();  // the last chunk's Qt and Kt read
      load_t<kBQ>(Qt, kLdq, q, q0, lq, dc, d, tid);
      load_t<kBK>(Kt, kLdk, k, k0, lk, dc, d, tid);
      __syncthreads();
      add_scores(s, Qt, Kt, r0, tx);
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] = (k0 + tx * 4 + jj < lk) ? s[ii][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[ii][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(mrow[ii], mx);
      const float alpha = expf(mrow[ii] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] = expf(s[ii][jj] - m_new);
        sum += s[ii][jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      lrow[ii] = lrow[ii] * alpha + sum;
      mrow[ii] = m_new;
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[ii][e] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + jj) * kLdq + r0]) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[j * kLdq + r0]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vb[CPT];
#pragma unroll
      for (int e = 0; e < CPT; e += 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Vs[j * kChunk + c0 + e]);
        vb[e] = t.x; vb[e + 1] = t.y; vb[e + 2] = t.z; vb[e + 3] = t.w;
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int e = 0; e < CPT; ++e)
          acc[ii][e] = fmaf(pv[ii], vb[e], acc[ii][e]);
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int64_t r = q0 + r0 + ii;
    if (r >= lq) continue;
    if (tx == 0 && blockIdx.y == 0) {
      m_out[r] = mrow[ii];
      l_out[r] = lrow[ii];
    }
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int c = cb + c0 + e;
      if (c >= d) continue;
      if (out != nullptr) {
        store_out(out + r * d + c, acc[ii][e] / lrow[ii]);
      } else {
        o_io[r * d + c] = acc[ii][e];
      }
    }
  }
}

template <typename T>
int launch_chunked(const void* q, const void* k, const void* v,
                   const float* m, const float* l, float* m_out,
                   float* l_out, float* o, void* out, int lq, int lk, int d,
                   float scale, cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory needs this opt-in, per device.
  const cudaError_t e = cudaFuncSetAttribute(
      ring_fold_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kChunkSmem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid(unsigned((lq + kBQ - 1) / kBQ),
                  unsigned((d + kChunk - 1) / kChunk));
  ring_fold_kernel<T><<<grid, kThreads, kChunkSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), m, l, m_out, l_out, o, static_cast<T*>(out),
      lq, lk, d, scale);
  return int(cudaGetLastError());
}
}  // namespace

// Bytes of device scratch a call with these shapes needs (256-byte
// aligned, as PyTorch allocates): the split operands and the key splits'
// partials for d <= 256, none for d > 256.
extern "C" long long tbus_ring_fold_scratch_bytes(int lq, int lk, int d,
                                                  int dtype) {
  if (lq <= 0 || lk <= 0 || d <= 0 || d > kMaxD) return 0;
  if (dtype != 0 && dtype != 1) return 0;
  return with_inst(d, dtype, [&](auto in) {
    using I = decltype(in);
    return layout<I::kNT, I::kKD>(lq, lk).bytes;
  });
}

// out: null, or (final fold) [lq, d] in q's dtype, written instead of o.
extern "C" int tbus_ring_fold(const void* q, const void* k, const void* v,
                              const void* m, const void* l, void* m_out,
                              void* l_out, void* o, void* out, void* scratch,
                              int lq, int lk, int d, float scale, int dtype,
                              void* stream) {
  if (lq <= 0 || lk <= 0 || d <= 0) return int(cudaSuccess);
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* of = static_cast<float*>(o);
  if (d > kMaxD) {
    return dtype == 0
               ? launch_chunked<float>(q, k, v, mf, lf, mo, lo, of, out, lq,
                                       lk, d, scale, s)
               : launch_chunked<__nv_bfloat16>(q, k, v, mf, lf, mo, lo, of,
                                               out, lq, lk, d, scale, s);
  }
  if (scratch == nullptr) return int(cudaErrorInvalidValue);
  auto* sc = static_cast<uint8_t*>(scratch);
  return with_inst(d, dtype, [&](auto in) {
    using I = decltype(in);
    return launch_wgmma<typename I::Type, I::kNT, I::kKD>(
        q, k, v, mf, lf, mo, lo, of, out, sc, lq, lk, d, scale, s);
  });
}
