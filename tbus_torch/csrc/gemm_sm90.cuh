// The port's one Hopper GEMM mainloop, shared by K1 and K2 (gemm_bf16.cu
// tbus_matmul_bf16_f32, tbus_dw_f32_bf16) and K6 (device_programs.cu
// tbus_dotbench), with the TMA, mbarrier and wgmma pieces that K3
// (ring_fold.cu) builds on, and the exact bf16 split of an f32 value:
//
//   C[Mp, Np] = A[Mp, Kp] . B[Np, Kp]^T
//
// or, where A is shorter than B along k (K2: A is Ka deep, B is Kp = 3 Ka
// deep), C = sum over the Kp / Ka slices B_s of A . B_s^T: the producer's
// k coordinate into A wraps every Ka.
//
// A and B bf16 and K-major (k contiguous) in device memory, every product
// exact on the tensor cores and summed in f32, the f32 accumulator handed
// to an epilogue functor that stores it. Raw PTX in asm volatile; no
// CUTLASS or CuTe. sm_90a only (wgmma and setmaxnreg).
//
// Bound: operations, 2 * Mp * Np * Kp flops at 989 TFLOP/s (bf16 tensor
// cores, H100 SXM). What it does about it: every operand byte reaches
// shared memory by TMA and every product is a wgmma, so no thread spends
// instructions or registers on addresses, conversions or fragments.
//
// Design. One 384-thread block per 128 x 256 output tile; the grid is
// (Np / 256, Mp / 128), so neighbouring blocks share A's rows in L2.
// Blocks go in clusters of two along M: the pair's tiles share B's 256
// rows, and each block loads half of them (128 rows) once for both, by
// TMA multicast, so a block reads 32 KiB of a stage's 48 KiB from L2.
// - Warpgroup 0 is the producer. It gives registers back (setmaxnreg.dec
//   40); one thread keeps TMA loads (cp.async.bulk.tensor.2d, 128-byte
//   swizzle, boxes 64 deep in k = 128 bytes) in flight into a ring of
//   kStages = 4 stages of 16 KiB of A and 32 KiB of B (192 KiB of dynamic
//   shared memory, each stage 1024-byte aligned for the swizzle).
// - Each stage has a full mbarrier (one arrival: the producer's
//   arrive.expect_tx of the stage's 48 KiB, completed by the transaction
//   bytes of its own two loads and of the peer block's multicast half of
//   B) and an empty one (four arrivals: one thread of each consumer
//   warpgroup of both blocks, since either block's multicast writes the
//   stage in both). Waits track the phase parity across wrap-around: the
//   consumers wait on full with parity ph, the producer on empty with
//   ph ^ 1 (a fresh barrier counts its phase before 0 as complete, so the
//   ring starts empty), ph flipping each time the stage index wraps.
//   Before it exits, the producer waits until both blocks have given back
//   every stage, so no arrival or multicast reaches a block that has gone.
// - Warpgroups 1 and 2 are the consumers (setmaxnreg.inc 232), each
//   owning 64 rows of the tile: per stage, four wgmma.mma_async
//   m64n256k16 (128 f32 accumulators a thread), committed as one group;
//   wait_group 1 lets one stage's products run while the next stage
//   arrives, and a stage goes back to the producer once its products have
//   retired.
// - Shared-memory matrix descriptors: start address >> 4, leading byte
//   offset 16 (unused by a swizzled K-major operand), stride byte offset
//   1024 (8 rows of 128 bytes), layout 1 = the 128-byte swizzle the TMA
//   writes. The four k16 steps of a stage advance the start address by 32
//   bytes; the hardware applies the swizzle to the full address.
//
// Shapes: Mp is a multiple of 256 (a cluster's two tiles), Np of 256 and
// Kp of 64 (the callers zero-pad their operands), so the mainloop has no
// ragged tile; the epilogue masks its own stores.
//
// The epilogue: Epi::operator()(row, col, v0, v1) for the sums at (row,
// col) and (row, col + 1), col even, in wgmma's register layout: thread t
// of a consumer warpgroup, warp w = t / 32 and lane l, holds rows 16 w +
// l / 4 and that + 8 of its warpgroup's 64, and columns 8 j + 2 (l % 4)
// and that + 1, j = 0..31.
//
// Numerics: each product of two bf16 values is exact in f32; only the
// order of the f32 sum differs from a plain product (wgmma's own
// accumulation order within k16, then stage by stage in k).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kCluster = 2;                   // blocks along M sharing B
constexpr int kThreads = 384;                 // producer + two consumers
constexpr int kABytes = kBM * kBK * 2;        // 16 KiB
constexpr int kBBytes = kBN * kBK * 2;        // 32 KiB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Arrives on the barrier at the same offset in block `rank` of the
// cluster (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n"
      :: "r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// A box of the 2-D map at (c0 = k, c1 = row) into shared memory at dst;
// its bytes complete on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// The same box, written at offset dst of every block in `mask` of the
// cluster, completing on the barrier at offset bar of each.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// Two values as a bf16x2 word (round to nearest even), the first in the
// low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The exact split of an f32 value a into three bf16 terms (as floats):
// hi = bf16_rn(a), mid = bf16_rn(a - hi), lo = bf16_rn(a - hi - mid).
// Both differences are exact in f32 (no -ftz: subnormals are kept), and
// each term takes the next 8 significant bits, so hi + mid + lo == a
// whenever lo's last bit is above bf16's least subnormal, 2^-133: for
// every finite a with |a| >= 2^-110, and for every a whose low bits
// below 2^-133 are zero. Elsewhere lo rounds as a bf16 subnormal, off by
// at most 2^-134. A finite a above bf16's largest finite value (where
// bf16_rn gives inf) takes hi = bf16_rz(a), so the split stays exact;
// +-inf splits to (+-inf, 0, 0) and NaN to (NaN, 0, 0).
__device__ __forceinline__ void split3(float a, float& hi, float& mid,
                                       float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(a));
  if (isinf(hi) && !isinf(a)) hi = __bfloat162float(__float2bfloat16_rz(a));
  if (!isfinite(hi)) {
    hi = a;
    mid = lo = 0.f;
    return;
  }
  const float r = a - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = __bfloat162float(__float2bfloat16_rn(r - mid));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 256] += A[64 x 16] . B[256 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <class Epi>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, int k_tiles,
                 int a_k_tiles, Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  auto a_stage = [&](int s) { return base + uint32_t(s * kStageBytes); };
  auto b_stage = [&](int s) { return a_stage(s) + uint32_t(kABytes); };
  auto full = [&](int s) { return bars + uint32_t(8 * s); };
  auto empty = [&](int s) { return bars + uint32_t(8 * (kStages + s)); };
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = int(blockIdx.y) * kBM, n0 = int(blockIdx.x) * kBN;
  uint32_t rank;  // this block's place in its cluster: its half of B
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both blocks' barriers exist before either uses them

  if (wg == 0) {
    // The producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&a_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&b_map)) : "memory");
      int s = 0;
      uint32_t ph = 0;
      const uint32_t half = rank * uint32_t(kBBytes / kCluster);
      const int b_row = n0 + int(rank) * (kBN / kCluster);
      for (int kt = 0, ka = 0; kt < k_tiles; ++kt) {
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), kStageBytes);
        tma_load(a_stage(s), &a_map, full(s), ka * kBK, m0);
        if (++ka == a_k_tiles) ka = 0;
        tma_load_multicast(b_stage(s) + half, &b_map, full(s), kt * kBK,
                           b_row, uint16_t((1u << kCluster) - 1));
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      // Both blocks have given back every stage: nothing more arrives.
      for (int i = 0; i < kStages; ++i) {
        mbar_wait(empty(s), ph ^ 1);
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // A consumer: rows 64 c .. 64 c + 63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, t = tid % 128;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(full(s), ph);
      const uint32_t a = a_stage(s) + uint32_t(c * 64 * 128);
      const uint32_t b = b_stage(s);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_m64n256k16(d, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // The previous stage's products have retired: give it back.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(d);
      if (kt > 0 && t == 0) {
#pragma unroll
        for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(empty(prev), r);
      }
      prev = s;
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    if (k_tiles > 0 && t == 0) {
#pragma unroll
      for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(empty(prev), r);
    }

    const int w = t / 32, l = t % 32;
    const int row = m0 + c * 64 + w * 16 + l / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (l % 4);
      epi(row, col, d[4 * j], d[4 * j + 1]);
      epi(row + 8, col, d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that the
// library needs no -lcuda; null where it is missing.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a K-major bf16 matrix [rows][k] (k a multiple of 64, the
// base 16-byte aligned): boxes of box_rows x 64, 128-byte swizzle.
inline cudaError_t encode_kmajor_bf16(CUtensorMap* map, const void* ptr,
                                      long long rows, long long k,
                                      int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(k), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(k) * 2};
  const cuuint32_t box[2] = {cuuint32_t(kBK), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The operand shape the mainloop takes for an m x k by k x n product:
// each dimension rounded up to the tile (at least one), out = {Mp, Kp, Np}
// with Mp a multiple of kBM * kCluster, Kp of kBK and Np of kBN.
inline void padded(long long m, long long k, long long n, long long out[3]) {
  const long long to[3] = {kBM * kCluster, kBK, kBN}, v[3] = {m, k, n};
  for (int i = 0; i < 3; ++i) {
    out[i] = (v[i] > 0 ? (v[i] + to[i] - 1) / to[i] : 1) * to[i];
  }
}

// True if (mp, np, kp) tile the mainloop exactly and fit its grid.
inline bool tiles(long long mp, long long np, long long kp) {
  return mp > 0 && np > 0 && kp > 0 && mp % (kBM * kCluster) == 0 &&
         np % kBN == 0 && kp % kBK == 0 && mp / kBM <= 65535 &&
         np <= 0x7fffffffLL && kp <= 0x7fffffffLL;
}

// Launches C = A . B^T with a_map over A [mp][ka] (boxes of kBM rows) and
// b_map over B [np][kp] (boxes of kBN / kCluster rows) on stream; the
// epilogue stores. ka = 0 means kp; otherwise kp is a multiple of ka and
// A's k coordinate wraps every ka.
template <class Epi>
cudaError_t gemm(const CUtensorMap& a_map, const CUtensorMap& b_map,
                 long long mp, long long np, long long kp, const Epi& epi,
                 cudaStream_t stream, long long ka = 0) {
  if (ka == 0) ka = kp;
  if (!tiles(mp, np, kp) || ka <= 0 || ka % kBK != 0 || kp % ka != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_sm90_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(unsigned(np / kBN), unsigned(mp / kBM));
  gemm_sm90_kernel<Epi><<<grid, kThreads, kSmemBytes, stream>>>(
      a_map, b_map, int(kp / kBK), int(ka / kBK), epi);
  return cudaGetLastError();
}

}  // namespace sm90
