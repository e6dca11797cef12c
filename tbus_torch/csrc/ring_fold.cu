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
// Products on the tensor cores over exact split terms; d <= 256, q resident.
// --------------------------------------------------------------------------
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
// d > 256: the head-dim-streamed fold (kStream).
// -----------------------------------------------
// Past 256 the wide heads' block does not fit: q for 64 rows in three
// terms beside a 32-key tile of k and v^T takes 240 KiB of shared memory
// at d = 320 (a block has 227), and a consumer warpgroup holds at most
// 128 columns of o beside as many of o_tile (one producer at 40 registers
// and two consumers at 232 use 64,512 of the SM's 65,536; a third does
// not fit). So neither q nor all of o stays in one block:
// - o's columns split across blocks. d pads to D, a multiple of 64, cut
//   into G = ceil(D / 256) column groups of OW = 192 or 256 columns (D / G
//   rounded up to 64; v^T is zero past d). A block (grid x = row block * G
//   + group, y = key split) owns 64 query rows and one group, each
//   consumer OW / 2 columns, as the wide heads' consumers own KD / 2.
// - q is streamed. Per tile of 64 keys (both dtypes: q no longer takes
//   the room), q's and k's 64-column chunks of the head dim (all their
//   terms, one TMA box each, 128-byte swizzle) go through a ring of
//   kChunkStages stages with full and empty mbarriers, and the tile of
//   v^T's group columns through a ring of its own (kStages). A chunk's
//   stage goes back as soon as the next chunk's products are issued
//   (wait_group 1); q is re-read from L2 once per key tile.
// - Every group computes all of s, with the wide heads' arrangement per
//   dtype: f32 inputs split each chunk's k16 steps between the consumers
//   and exchange the halves (barrier 3); bf16 inputs compute s in the
//   first consumer, which hands p to the second (barriers 3 and 4). So
//   the blocks of a row block never talk, and every G runs.
// - The fold always writes its (m, l, o) as partials and
//   fold_combine_kernel merges them with the carry (the wide heads merge
//   inside the fold where keys do not split): a group's blocks would
//   otherwise write m and l while another group's still read the carry's.
//   The partials cost 2 lq G OW f32 more bytes and one launch.
// Work, in passes of 2 lq lk over a width: f32 6 G D (s, in every group)
// + 6 G OW (p v), against the bound's 12 D: 1.6x at d = 320 (G 2, OW
// 192) and 1.5x at 512 (G 2, OW 256); bf16 G D + 3 G OW against 4 D:
// 1.4x and 1.25x. The repeat is counted against the kernel, not added to
// the bound. Bound: operations, at 989 TFLOP/s: 12 (f32) or 4 (bf16)
// passes of 2 lq lk D, at lq = lk = 8192: d = 320 0.521 and 0.174 ms,
// d = 512 0.834 and 0.278 ms. L2 reads into shared memory a fold: q NT 2
// lq D (lk / 64) and k NT 2 lk D (lq / 64), each G times, and v^T NT 2 lk
// G OW (lq / 64): f32 4.03 + 4.03 + 2.42 = 10.47 GB at d = 320, 6.44 +
// 6.44 + 3.22 = 16.11 GB at 512; bf16 1.34 + 1.34 + 0.81 = 3.49 GB and
// 2.15 + 2.15 + 1.07 = 5.37 GB. Over the bound's time that asks 19-20
// TB/s of the L2; the data sheet gives no L2 rate. chip_smoke.py reads
// what the fold reaches. Exchanging s between a row block's groups (one
// cluster) issued 1.1x / 1.0x the f32 passes and ran 15-28% faster at
// d = 320 / 512 (PERF.md), at the cost of a cluster launch, scratch,
// cross-block barriers and a limit of eight groups; no configuration
// runs these widths, so it is not kept.
//
// Interface: plain C, loaded with ctypes. dtype codes: 0 = f32, 1 = bf16;
// any d >= 1. tbus_ring_fold_scratch_bytes says how much device scratch
// the call needs. The carry (m, l, o) is updated in place at every width.
// Launches on the given stream, does not synchronise, returns
// cudaGetLastError() (a launch refused for its shared memory or its grid
// returns that error and runs nothing).

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

// ---- split terms on wgmma ----

constexpr int kMaxD = 256;         // the widest head whose q stays resident
constexpr int kBox = 64 * 128;     // one TMA box: 64 rows x 64 bf16
constexpr int kFoldThreads = 384;  // producer + two consumer warpgroups
constexpr int kPackThreads = 256;
constexpr int kSmemCap = 232448;  // what a block may use (227 KiB)
constexpr int kBarBytes = 256;

// KD, the width d is padded to: 128, 192 or 256; past 256, the next
// multiple of 64 (D).
inline int padded_d(int d) { return d <= 128 ? 128 : (d + 63) / 64 * 64; }

// Past 256: OW, the width of each of the G = ceil(D / 256) column groups
// (192 or 256).
inline int group_width(int d) {
  const int kd = padded_d(d), g = (kd + 255) / 256;
  return ((kd + g - 1) / g + 63) / 64 * 64;
}

// KD: the padded width (resident q), or a column group's (kStream).
template <int NT, int KD, bool kStream = false>
struct Fold {
  static constexpr bool kWide = KD > 128;
  // Wide heads: with three terms the consumers split s by head-dim halves
  // and exchange the halves (kSplitS); with one term the first computes s
  // and hands p's terms to the second (kShareP).
  static constexpr bool kSplitS = kWide && NT == 3;
  static constexpr bool kShareP = kWide && NT == 1;
  static constexpr int kRows = kWide ? 64 : 128;  // query rows per block
  // Keys per tile: 32 for the wide heads' f32 inputs, whose q takes the
  // room; 64 elsewhere.
  static constexpr int kKeys = kWide && NT == 3 && !kStream ? 32 : 64;
  static constexpr int kDB = KD / 64;  // TMA boxes across the head dim
  static constexpr int kOCols = kWide ? KD / 2 : KD;  // o columns a consumer
  static constexpr int kVRows = KD * kKeys / 64;  // rows of a v^T term tile
  static constexpr int kQBytes = kStream ? 0 : NT * kRows * KD * 2;
  static constexpr int kTileBytes = NT * kKeys * KD * 2;  // k's, and v^T's
  // kStream: a stage of the chunk ring, q's and k's terms over 64 columns.
  static constexpr int kChunkBytes = NT * (kRows + kKeys) * 128;
  // Words a consumer thread hands over: p's A fragments and the rescale.
  static constexpr int kPWords = 3 * (kKeys / 16) * 4 + 2;
  // The consumers' exchange: their halves of s, or p's terms.
  static constexpr int kXBytes = kSplitS   ? 2 * 128 * (kKeys / 2) * 4
                                 : kShareP ? 128 * kPWords * 4
                                           : 0;
  static constexpr int kFree = kSmemCap - 1024 - kBarBytes - kXBytes;
  // Resident q: stages of k and v^T tiles. kStream: stages of v^T tiles
  // (two where two chunks fit beside them, else one), and what is left
  // for chunks (at most six).
  static constexpr int kFit = (kFree - kQBytes) / (2 * kTileBytes);
  static constexpr int kVFit = (kFree - 2 * kChunkBytes) / kTileBytes;
  static constexpr int kStages = kStream ? (kVFit < 2 ? kVFit : 2)
                                 : kFit < 3 ? kFit : 3;
  static constexpr int kChunkFit =
      (kFree - kStages * kTileBytes) / kChunkBytes;
  static constexpr int kChunkStages =
      kStream ? (kChunkFit < 6 ? kChunkFit : 6) : 0;
  static constexpr int kRingBytes =
      kStream ? kChunkStages * kChunkBytes + kStages * kTileBytes
              : kQBytes + kStages * 2 * kTileBytes;
  static constexpr int kSmem = kRingBytes + kXBytes + kBarBytes + 1024;
  static_assert(KD % 64 == 0 && KD <= kMaxD, "padded width");
  static_assert(!kStream || kWide, "a column group is wider than 128");
  static_assert(kStages >= 1, "q and one stage must fit");
  static_assert(!kStream || kChunkStages >= 2, "two chunks must fit");
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

// The online softmax of one tile on s's fragments (sc[4 j + e] is row r
// = e / 2 of the thread's two, key key0 + 8 j + 2 (l % 4) + e % 2): scale,
// mask keys past lk, the row max across the row's 4 threads, the rescale
// alpha of the running (m, l), and p = exp(s - m') into l and, split in
// three bf16 terms, into p's A fragments.
template <int KK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[KK / 2], int key0, int lk, float scale, int l,
    float (&m_run)[2], float (&l_run)[2], float (&alpha)[2],
    uint32_t (&pf)[3][KK / 16][4]) {
  const bool tail = key0 + KK > lk;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < KK / 2; ++i) {
    const int key = key0 + 8 * (i / 4) + 2 * (l % 4) + (i % 2);
    float v = sc[i] * scale;
    if (tail && key >= lk) v = -INFINITY;
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
}

// One tile's o_tile = p v over the cross terms, smallest first, A from
// registers, B the v^T tile at v (its terms kVTerm bytes apart, this
// consumer's columns at its start) once v_full's phase ph has completed;
// then gives the tile back and rescales: o = o alpha + o_tile.
template <int NT, int KK, int N, int kVTerm>
__device__ __forceinline__ void pv_tile(float (&o)[N], float (&ot)[N],
                                        uint32_t (&pf)[3][KK / 16][4],
                                        const float (&alpha)[2], uint32_t v,
                                        uint32_t v_full, uint32_t v_empty,
                                        uint32_t ph, int t) {
#pragma unroll
  for (int i = 0; i < N; ++i) ot[i] = 0.f;
  sm90::mbar_wait(v_full, ph);
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
                 sm90::smem_desc(v + uint32_t(vj * kVTerm) +
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
  if (t == 0) sm90::mbar_arrive(v_empty);
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = fmaf(o[i], alpha[(i / 2) % 2], ot[i]);
}

struct FoldArgs {
  float* part_m;  // [nsplit][lq_p]
  float* part_l;  // [nsplit][lq_p]
  float* part_o;  // [nsplit][lq_p][po_cols]
  int lq_p, lk, lk_p, tiles, nsplit;
  float scale;
  // The carry and the output, for one split of the resident-q fold
  // (nsplit == 1), which merges them itself as fold_combine_kernel does.
  float* m;
  float* l;
  float* o;
  void* out;  // null, or [lq, d] in the input's dtype
  int lq, d;
  // kStream: D / 64 chunks, G column groups, G OW partial columns.
  int dblocks, groups, po_cols;
};

template <int NT, int KD, bool kStream>
__global__ void __launch_bounds__(kFoldThreads, 1)
fold_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, FoldArgs args) {
  using F = Fold<NT, KD, kStream>;
  constexpr int S = F::kStages, KK = F::kKeys, DB = F::kDB;
  constexpr int SC = F::kChunkStages;
  constexpr int SK = kStream ? SC : S;     // stages of k (chunks, kStream)
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
  // kStream: stage s of the chunk ring, q's terms then k's.
  auto c_s = [&](int s) { return base + uint32_t(s * F::kChunkBytes); };
  auto v_s = [&](int s) {
    return kStream ? base + uint32_t(SC * F::kChunkBytes + s * F::kTileBytes)
                   : k_s(s) + uint32_t(F::kTileBytes);
  };
  const uint32_t x_at = uint32_t(F::kRingBytes);
  // The exchange, thread t's word i at [i][t]: [2][KK / 2][128] for the
  // consumers' halves of s (consumer c's at [c]), [kPWords][128] for p.
  float* const xs = reinterpret_cast<float*>(
      smem_raw + (base - sm90::smem_u32(smem_raw)) + x_at);
  const uint32_t bars = base + x_at + uint32_t(F::kXBytes);
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + uint32_t(8 * (1 + s)); };
  auto k_empty = [&](int s) { return bars + uint32_t(8 * (1 + SK + s)); };
  auto v_full = [&](int s) { return bars + uint32_t(8 * (1 + 2 * SK + s)); };
  auto v_empty = [&](int s) {
    return bars + uint32_t(8 * (1 + 2 * SK + S + s));
  };
  const int tid = threadIdx.x, wg = tid / 128;
  // kStream: this block's column group, the fastest index of grid x.
  const int groups = kStream ? args.groups : 1;
  const int g = int(blockIdx.x) % groups;
  const int row0 = int(blockIdx.x) / groups * F::kRows;
  const int split = int(blockIdx.y);
  const int t0 = int((long long)split * args.tiles / args.nsplit);
  const int t1 = int((long long)(split + 1) * args.tiles / args.nsplit);

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < SK; ++s) {
      sm90::mbar_init(k_full(s), 1);
      sm90::mbar_init(k_empty(s), F::kShareP ? 1 : 2);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(v_empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread keeps the rings full (and, with resident
    // q, loads q once first).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&q_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&k_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&v_map)) : "memory");
      if constexpr (!kStream) {
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
      }
      int s = 0, cs = 0;
      uint32_t ph = 0, cph = 0;
      for (int j = t0; j < t1; ++j) {
        const int key0 = j * KK;
        if constexpr (kStream) {
          // q's and k's terms, chunk after chunk of the head dim.
          for (int b = 0; b < args.dblocks; ++b) {
            sm90::mbar_wait(k_empty(cs), cph ^ 1);
            sm90::mbar_expect_tx(k_full(cs), F::kChunkBytes);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              sm90::tma_load(c_s(cs) + uint32_t(t * kBox), &q_map, k_full(cs),
                             64 * b, t * args.lq_p + row0);
              sm90::tma_load(c_s(cs) + uint32_t(NT * kBox + t * kKBox),
                             &k_map, k_full(cs), 64 * b,
                             t * args.lk_p + key0);
            }
            if (++cs == SC) {
              cs = 0;
              cph ^= 1;
            }
          }
        } else {
          sm90::mbar_wait(k_empty(s), ph ^ 1);
          sm90::mbar_expect_tx(k_full(s), F::kTileBytes);
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int b = 0; b < DB; ++b) {
              sm90::tma_load(k_s(s) + uint32_t((t * DB + b) * kKBox), &k_map,
                             k_full(s), 64 * b, t * args.lk_p + key0);
            }
        }
        sm90::mbar_wait(v_empty(s), ph ^ 1);
        sm90::mbar_expect_tx(v_full(s), F::kTileBytes);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          sm90::tma_load(v_s(s) + uint32_t(t * kVTerm), &v_map, v_full(s), 0,
                         ((g * NT + t) * args.tiles + j) * F::kVRows);
        }
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // A consumer: query rows row0 + 64 qc .. + 63, o columns oc0 .. + OC - 1
  // (of the block's group, kStream).
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
  // any thread writes them.
  const int r0 = row0 + 64 * qc + 16 * w + l / 4;
  float m_in[2] = {0.f, 0.f}, l_in[2] = {0.f, 0.f};
  if (!kStream && args.nsplit == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r0 + 8 * r < args.lq) {
        m_in[r] = args.m[r0 + 8 * r];
        l_in[r] = args.l[r0 + 8 * r];
      }
    }
  }
  // kSplitS: this consumer's half of the head dim, every other k16 step
  // from its c-th (32 bytes on).
  const uint32_t s_half = F::kSplitS ? uint32_t(32 * c) : 0u;
  const uint64_t q_desc =
      sm90::smem_desc(q_s + uint32_t(qc * DB * kBox) + s_half);
  if (!kStream) sm90::mbar_wait(q_full, 0);
  // KD = 128: the warpgroups take turns to issue s (warpgroup 0 first),
  // so one's softmax runs while the other's products do (FlashAttention-3's
  // ping-pong). Each passes the turn once per tile; warpgroup 0 takes the
  // last pass after the loop, so every arrival is matched. The hand-over
  // of p (kShareP) is matched the same way: the buffer starts empty.
  if (!F::kWide && c == 1) turn_pass(c);
  if (F::kShareP && c == 1) nb_arrive<4>();
  int s = 0, cs = 0;
  uint32_t ph = 0, cph = 0;
  float alpha[2];
  for (int j = t0; j < t1; ++j) {
    const int key0 = j * KK;
    if (!F::kShareP || c == 0) {
      // s = q k^T over the cross terms, smallest first.
#pragma unroll
      for (int i = 0; i < KK / 2; ++i) sc[i] = 0.f;
      if constexpr (kStream) {
        // Chunk after chunk of the head dim; a chunk's stage goes back
        // once the next chunk's products are issued.
        constexpr int QT = kBox, CK = NT * kBox;
        int prev = 0;
        for (int b = 0; b < args.dblocks; ++b) {
          sm90::mbar_wait(k_full(cs), cph);
          fence_regs(sc);
          wgmma_fence();
          s_products<NT, 64, F::kSplitS ? 2 : 1, QT, kKBox, kKBox>(
              sc, sm90::smem_desc(c_s(cs) + s_half),
              sm90::smem_desc(c_s(cs) + uint32_t(CK) + s_half));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          if (b > 0) {
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
            if (t == 0) sm90::mbar_arrive(k_empty(prev));
          }
          prev = cs;
          if (++cs == SC) {
            cs = 0;
            cph ^= 1;
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(sc);
        if (t == 0) sm90::mbar_arrive(k_empty(prev));
      } else {
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
      }
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
      softmax_tile<KK>(sc, key0, args.lk, args.scale, l, m_run, l_run,
                       alpha, pf);
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
    pv_tile<NT, KK, OC / 2, kVTerm>(o, ot, pf, alpha, v_s(s) + v_cols,
                                    v_full(s), v_empty(s), ph, t);
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
  if (!kStream && args.nsplit == 1) {
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
        args.m[row] = mx;
        args.l[row] = ln;
      }
    }
    return;
  }
  // The partials: every group's m and l are the same, group 0 writes them.
  const long long rows = (long long)split * args.lq_p;
  if (l % 4 == 0 && (!F::kWide || c == 0) && g == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      args.part_m[rows + r0 + 8 * r] = m_run[r];
      args.part_l[rows + r0 + 8 * r] = l_run[r];
    }
  }
  const int pc = kStream ? args.po_cols : KD;
  float* po = args.part_o + (rows + r0) * pc + g * KD + oc0 + 2 * (l % 4);
#pragma unroll
  for (int jj = 0; jj < OC / 8; ++jj) {
    *reinterpret_cast<float2*>(po + 8 * jj) =
        make_float2(o[4 * jj], o[4 * jj + 1]);
    *reinterpret_cast<float2*>(po + 8 * pc + 8 * jj) =
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
template <int NT, int KD, bool kStream>
__device__ __forceinline__ long long vt_offset(int col, long long key) {
  using F = Fold<NT, KD, kStream>;
  return ((key / F::kKeys) * F::kVRows + col % F::kVRows) * 64 +
         (col / F::kVRows) * F::kKeys + key % F::kKeys;
}

// Blocks [0, row_blocks) write qs and ks (grid-stride over chunks of 8
// columns of a row, rows kd wide: KD, or D for kStream); the rest write
// vt, one 64 keys x 64 columns tile of v each, through shared memory (read
// along d, written along keys), each term of each KD-wide column group
// (one group below kStream) after the other.
template <typename T, int NT, int KD, bool kStream>
__global__ void __launch_bounds__(kPackThreads)
fold_pack_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, __nv_bfloat16* __restrict__ qs,
                 __nv_bfloat16* __restrict__ ks,
                 __nv_bfloat16* __restrict__ vt, int lq, int lk, int d,
                 long long lq_p, long long lk_p, int row_blocks, int kd) {
  const int tid = threadIdx.x;
  if (int(blockIdx.x) < row_blocks) {
    const int width = kStream ? kd : KD;
    const int per_row = width / 8;
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
      __nv_bfloat16* dst = (is_q ? qs : ks) + rr * width + c0;
      const long long term_stride = (is_q ? lq_p : lk_p) * width;
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
  // c0's column group and its first column in it.
  const int grp = kStream ? c0 / KD : 0;
  const int gc0 = kStream ? c0 - grp * KD : c0;
  __nv_bfloat16* const vg = vt + grp * NT * lk_p * KD;
#pragma unroll
  for (int h = 0; h < 64 * 64 / 8 / kPackThreads; ++h) {
    const int qd = tid + h * kPackThreads;
    const int r = qd / 8, kc = (qd % 8) * 8;
    if (key0 + kc >= lk_p) continue;  // 32-key tiles: past the last one
    float t[8][3];
#pragma unroll
    for (int e = 0; e < 8; ++e) terms<NT>(tile[kc + e][r], t[e]);
    const long long at = vt_offset<NT, KD, kStream>(gc0 + r, key0 + kc);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      *reinterpret_cast<uint4*>(vg + i * lk_p * KD + at) = pack8(t, i);
    }
  }
}

// One warp per row, lane j on columns j, j + 32, ..., KD columns a pass:
// each split's (m, l, o), o's rows po_cols wide, merged with the carry.
// With q resident (!kLoop) d <= KD = po_cols and one pass covers the row;
// past it (kLoop) the passes walk the row. Every lane reads the carry's m
// and l before lane 0 writes them, so the carry is updated in place.
template <typename TO, int KD, bool kLoop>
__global__ void __launch_bounds__(256)
fold_combine_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_o, int nsplit,
                    long long lq_p, int po_cols, float* m, float* l,
                    float* o, TO* out, int lq, int d) {
  constexpr int E = KD / 32;
  const int row = int(blockIdx.x) * 8 + int(threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= lq) return;
  const float mi = m[row], li = l[row];
  float mx = mi;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[s * lq_p + row]);
  const float a_in = expf(mi - mx);  // 0 for the first fold's -inf
  float ln = li * a_in;
  float* const orow = o + (long long)row * d;
  for (int c0 = 0; c0 < (kLoop ? d : 1); c0 += KD) {
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int col = c0 + 32 * e + lane;
      acc[e] = col < d ? orow[col] * a_in : 0.f;
    }
    for (int s = 0; s < nsplit; ++s) {
      const long long pr = s * lq_p + row;
      const float a = expf(part_m[pr] - mx);
      if (c0 == 0) ln += part_l[pr] * a;
      const float* const prow = part_o + pr * po_cols + c0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        // q resident: the partials' KD columns lie in every row.
        if (!kLoop || c0 + 32 * e + lane < d) acc[e] += prow[32 * e + lane] * a;
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int col = c0 + 32 * e + lane;
      if (col >= d) continue;
      if (out != nullptr) {
        store_out(out + (long long)row * d + col, acc[e] / ln);
      } else {
        orow[col] = acc[e];
      }
    }
  }
  __syncwarp();
  if (lane == 0) {
    m[row] = mx;
    l[row] = ln;
  }
}

// The scratch of one call: split operands, then the splits' partials,
// each 1024-byte aligned. kd: the operands' row width; groups: the column
// groups (1 below kStream).
struct Layout {
  int nsplit, tiles, row_blocks, kd, groups;
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

template <int NT, int KD, bool kStream>
Layout layout(int lq, int lk, int d) {
  using F = Fold<NT, KD, kStream>;
  Layout L;
  L.kd = kStream ? padded_d(d) : KD;
  L.groups = kStream ? (L.kd + KD - 1) / KD : 1;
  L.lq_p = (lq + F::kRows - 1) / F::kRows * F::kRows;
  L.lk_p = (lk + F::kKeys - 1) / F::kKeys * F::kKeys;
  L.row_blocks = int(L.lq_p / F::kRows);
  L.tiles = int(L.lk_p / F::kKeys);
  // Key splits fill the SMs; each split holds at least one tile.
  const int want = sm_count() / (L.row_blocks * L.groups);
  L.nsplit = want < 1 ? 1 : (want > L.tiles ? L.tiles : want);
  long long at = 0;
  L.qs = at; at = align1k(at + NT * L.lq_p * L.kd * 2);
  L.ks = at; at = align1k(at + NT * L.lk_p * L.kd * 2);
  L.vt = at; at = align1k(at + L.groups * NT * L.lk_p * KD * 2);
  // One split of resident q merges itself; kStream always writes partials.
  const long long parts = kStream || L.nsplit > 1 ? L.nsplit : 0;
  L.pm = at; at = align1k(at + parts * L.lq_p * 4);
  L.pl = at; at = align1k(at + parts * L.lq_p * 4);
  L.po = at; at = align1k(at + parts * L.lq_p * L.groups * KD * 4);
  L.bytes = at;
  return L;
}

template <typename T, int NT, int KD, bool kStream>
int launch_wgmma(const void* q, const void* k, const void* v, float* m,
                 float* l, float* o, void* out, uint8_t* scratch, int lq,
                 int lk, int d, float scale, cudaStream_t stream) {
  using F = Fold<NT, KD, kStream>;
  const Layout L = layout<NT, KD, kStream>(lq, lk, d);
  auto* qs = reinterpret_cast<__nv_bfloat16*>(scratch + L.qs);
  auto* ks = reinterpret_cast<__nv_bfloat16*>(scratch + L.ks);
  auto* vt = reinterpret_cast<__nv_bfloat16*>(scratch + L.vt);
  // bf16 inputs whose rows TMA reads as they lie (16-byte aligned base
  // and rows) need no copy of q and k: their maps zero-fill past d, lq
  // and lk as the copies' padding would.
  const bool direct = NT == 1 && d % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const long long chunks = (L.lq_p + L.lk_p) * (L.kd / 8);
  long long row_blocks = (chunks + kPackThreads - 1) / kPackThreads;
  if (row_blocks > 1024) row_blocks = 1024;  // grid-stride beyond
  if (direct) row_blocks = 0;
  const long long vt_blocks = (L.lk_p + 63) / 64 * (L.groups * KD / 64);
  fold_pack_kernel<T, NT, KD, kStream>
      <<<unsigned(row_blocks + vt_blocks), kPackThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), qs, ks, vt, lq, lk, d, L.lq_p, L.lk_p,
          int(row_blocks), L.kd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  CUtensorMap q_map, k_map, v_map;
  e = direct ? sm90::encode_kmajor_bf16(&q_map, q, lq, d, 64)
             : sm90::encode_kmajor_bf16(&q_map, qs, NT * L.lq_p, L.kd, 64);
  if (e == cudaSuccess) {
    e = direct ? sm90::encode_kmajor_bf16(&k_map, k, lk, d, F::kKeys)
               : sm90::encode_kmajor_bf16(&k_map, ks, NT * L.lk_p, L.kd,
                                          F::kKeys);
  }
  if (e == cudaSuccess) {
    e = sm90::encode_kmajor_bf16(
        &v_map, vt, (long long)L.groups * NT * L.tiles * F::kVRows, 64,
        F::kVRows);
  }
  if (e != cudaSuccess) return int(e);
  auto* kernel = fold_wgmma_kernel<NT, KD, kStream>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           F::kSmem);
  if (e != cudaSuccess) return int(e);
  FoldArgs args{reinterpret_cast<float*>(scratch + L.pm),
                reinterpret_cast<float*>(scratch + L.pl),
                reinterpret_cast<float*>(scratch + L.po),
                int(L.lq_p), lk, int(L.lk_p), L.tiles, L.nsplit, scale,
                m, l, o, out, lq, d, L.kd / 64, L.groups, L.groups * KD};
  const dim3 grid(unsigned(L.row_blocks * L.groups), unsigned(L.nsplit));
  kernel<<<grid, kFoldThreads, F::kSmem, stream>>>(q_map, k_map, v_map, args);
  e = cudaGetLastError();
  if (e != cudaSuccess || (!kStream && L.nsplit == 1)) return int(e);
  // The merge: o's padded width in one pass with q resident, passes of 128
  // columns past it.
  fold_combine_kernel<T, kStream ? 128 : KD, kStream>
      <<<unsigned((lq + 7) / 8), 256, 0, stream>>>(
          args.part_m, args.part_l, args.part_o, L.nsplit, L.lq_p,
          args.po_cols, m, l, o, static_cast<T*>(out), lq, d);
  return int(cudaGetLastError());
}

// The instantiation for (d, dtype): its input type, terms and width, and
// whether it streams q (d > kMaxD; the width is then a column group's).
template <typename T, int NT, int KD, bool kStream = false>
struct Inst {
  using Type = T;
  static constexpr int kNT = NT, kKD = KD;
  static constexpr bool kStreamed = kStream;
};

// fn(Inst<...>{}) for the instantiation that takes d and dtype.
template <class Fn>
auto with_inst(int d, int dtype, Fn&& fn) {
  if (d > kMaxD) {
    const bool w192 = group_width(d) == 192;
    if (dtype == 0) {
      if (w192) return fn(Inst<float, 3, 192, true>{});
      return fn(Inst<float, 3, 256, true>{});
    }
    if (w192) return fn(Inst<__nv_bfloat16, 1, 192, true>{});
    return fn(Inst<__nv_bfloat16, 1, 256, true>{});
  }
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
}  // namespace

// Bytes of device scratch a call with these shapes needs (256-byte
// aligned, as PyTorch allocates): the split operands and the partials.
extern "C" long long tbus_ring_fold_scratch_bytes(int lq, int lk, int d,
                                                  int dtype) {
  if (lq <= 0 || lk <= 0 || d <= 0) return 0;
  if (dtype != 0 && dtype != 1) return 0;
  return with_inst(d, dtype, [&](auto in) {
    using I = decltype(in);
    return layout<I::kNT, I::kKD, I::kStreamed>(lq, lk, d).bytes;
  });
}

// Folds k, v into the carry (m, l, o) in place; out: null, or (final
// fold) [lq, d] in q's dtype, written instead of o.
extern "C" int tbus_ring_fold(const void* q, const void* k, const void* v,
                              void* m, void* l, void* o, void* out,
                              void* scratch, int lq, int lk, int d,
                              float scale, int dtype, void* stream) {
  if (lq <= 0 || lk <= 0 || d <= 0) return int(cudaSuccess);
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  if (scratch == nullptr) return int(cudaErrorInvalidValue);
  auto* sc = static_cast<uint8_t*>(scratch);
  return with_inst(d, dtype, [&](auto in) {
    using I = decltype(in);
    return launch_wgmma<typename I::Type, I::kNT, I::kKD, I::kStreamed>(
        q, k, v, static_cast<float*>(m), static_cast<float*>(l),
        static_cast<float*>(o), out, sc, lq, lk, d, scale,
        static_cast<cudaStream_t>(stream));
  });
}
