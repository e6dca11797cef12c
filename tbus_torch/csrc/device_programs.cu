// The C++ device plane's programs, for Hopper: K4 u8_transform, K5 dot128,
// K6 dotbench and K7 fanout. The CUDA runtime (cuda_backend.cu, driven from the
// dispatch thread of cuda_runtime.cc) launches them from C++; the ctypes
// wrappers in tbus_torch/kernels/device_programs.py launch the same
// functions on PyTorch tensors. Plain C interface; each function launches
// on the given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().
//
// K4, tbus_u8_transform — replaces cpp/tpu/serve_engine.cc:28 step_mlir (the
// serving step, u8[bucket * token_bytes]) and the echo / xor255 / incr bodies
// of cpp/tpu/pjrt_runtime.cc:191 build_mlir (device methods, u8[length
// class]). out[i] = in[i], in[i] ^ 0xFF or in[i] + 1 mod 256. Bound: bytes, n
// read and n written at 3.35 TB/s (0.63 us at 1 MiB, 0.16 us at the 256 KiB
// serving step), out of reach at these sizes: on an H100 an empty kernel alone
// takes most of K4's time, so the launch, one round trip to memory and the
// tail set it. Design, from what the card measured (chip_smoke.py phase xi
// times K4 beside its first design's kernel and two probes of the floor;
// PERF.md has the numbers): the op is a template parameter (no branch in the
// body); one 16-byte load a thread, read-only with no L1 line, and one
// evict-first store; a grid of 256-thread blocks, a thread for each vector, up
// to 8 blocks an SM, so the path's sizes (4 KiB to 1 MiB) run in one wave with
// no second round. Four loads in flight a thread and 1-D TMA bulk copies
// through shared memory were slower at every path size; blocks spread one to
// an SM were no faster. Pointers with the same offset modulo 16 take a scalar
// head up to the 16-byte boundary, the vector body, then a scalar tail;
// pointers with different offsets take the scalar path throughout.
// tbus_u8_transform_v1 is the first design (a grid-stride loop, the op a
// runtime branch), kept as the baseline chip_smoke.py times beside it;
// tbus_k4_floor_empty and tbus_k4_floor_copy16 are probes of the card's floor
// for such a kernel (an empty kernel in K4's launch shape; one plain 16-byte
// load and store a thread).
//
// K5, tbus_dot128 — replaces pjrt_runtime.cc:207 dot128: y = x . W for x
// f32[k, 128] (the payload's bytes as little-endian f32) and W[i, j] = ((3i +
// 5j) mod 11 - 5) / 8, at precision HIGHEST, so in true f32. W's values are
// multiples of 1/8 up to 5/8, exact in bf16, and x splits exactly into three
// bf16 terms, so every product of a term and W is exact in f32: y = x_lo . W +
// x_mid . W + x_hi . W on the tensor cores, each summed in f32. Bound: bytes,
// x read and y written once, 2 MiB at 3.35 TB/s = 0.63 us at k = 2048 (the
// tensor work, 3 x 2 k 128^2 flops, takes 0.2 us at 989 TFLOP/s; the same
// function by f32 FMA on the CUDA cores, 1.0 us at 67 TFLOP/s). Design: W^T is
// built once, in bf16, into a 32 KiB device scratch the caller owns
// (tbus_dot128_weight), laid out as the shared-memory image wgmma reads: four
// slices of 32 columns, each two 64-deep boxes of 32 rows of 128 bytes,
// 16-byte chunks under the 128-byte swizzle, and the k index permuted so that
// a thread's A fragment is one contiguous float4 of x per row and k-step
// (dot128_phys). One block per 64 rows of x and per 32 columns of y (at k =
// 2048, 32 x 4 = 128 blocks: one wave on 132 SMs, so the tensor work is spread
// over the card), four warpgroups splitting k, so a thread holds 16 values of
// x (with one warpgroup a block, a thread's 64 values made one long chain).
// The block's slice of W^T arrives by one bulk copy (TMA) on an mbarrier; each
// thread loads its 2 rows x 16 values with all loads in flight; each row's 32
// values are scaled by an exact power of two that brings its largest |x| to at
// least 1 (rows of f32 subnormals would otherwise lose their bits below bf16's
// least subnormal); the split truncates on the bits (hi = the upper 16 bits, r
// = x - hi, mid = r's upper 16 bits, lo = r - mid: exact, no conversion
// instruction, where sm90::split3's conversions issue at a quarter of the
// rate), with inf and NaN handled only in a warp that holds one; the terms are
// the A fragments in registers for wgmma.m64n32k16, one accumulator a term so
// the three chains overlap, added (lo + mid) + hi; the scale undone (ldexpf);
// the four warpgroups' sums meet in shared memory and are added in order, one
// coalesced float4 store a thread. inf and NaN split to (a, 0, 0) and meet W's
// zeros as inf x 0 = NaN, as in the plain product. Sharing x's tile among the
// four column blocks of a cluster by multicast bulk copies was slower.
// dot128_v1 is the first design (f32 FMA, W built in every block), the
// baseline chip_smoke.py times beside it.
//
// K6, tbus_dotbench — replaces pjrt_runtime.cc:245 dotbench<N>x<T>: the
// f32 seed is rounded to bf16; A0[i, j] = bf16(bf16(((i + j) mod 7 - 3) /
// 8) + seed); W as dot128's, in bf16; T times v <- bf16(bf16(v . W) *
// bf16(1/N)) with each product summed in f32 on the tensor cores and
// rounded once; then the sum of v's N * N elements in f32, rounded once to
// bf16 and returned as f32. Bound: operations, T * 2 * N^3 flops at 989
// TFLOP/s (4.45 ms for dotbench4096x32); the checksum reads 2 N^2 bytes.
// Design: the operands live in device scratch the caller gives, padded to
// Np = N rounded up to 256 with zeros (zero rows and columns stay zero
// through the chain and add nothing to the sum), so no tile is ragged;
// W is stored transposed (n-major), so both operands are k-contiguous.
// Each product is gemm_sm90.cuh's TMA + wgmma mainloop (128 x 256 tiles,
// blocks paired along M sharing Wt's rows by TMA multicast, a 4-stage
// mbarrier ring, a producer warp and two wgmma consumer warpgroups) on
// three tensor maps encoded per call (v0, v1, Wt), with the bf16 rounding
// and the scale in its epilogue; only the order of each f32 sum differs
// from the plain version. The checksum is a two-pass reduction
// in a fixed order (block partials, then one block), so it is the same
// from run to run. Only the 4-byte seed and the 4-byte result cross PCIe.
//
// K7, tbus_fanout — replaces cpp/tpu/native_fanout.cc:166 fanout_mlir, the
// fused fan-out executable of the native collective engine: broadcast
// u8[bucket] -> u8[n * bucket] with row i = f(input, i), or scatter
// u8[n * bucket] -> u8[n * bucket] with row i = f(input row i, i); f is
// echo, x ^ 0xFF, or x + (i & 0xFF) mod 256 (the reference's iota is
// converted to ui8, so it wraps at 256 peers). Shapes: n up to 64 on the
// path, bucket = the device length class of the largest request (a
// multiple of 64). Bound: bytes, (bucket or n * bucket) read + n * bucket
// written at 3.35 TB/s (2.8 us for 8 x 1 MiB broadcast). Design: a grid
// over (16-byte chunks of a row, rows), __vadd4 with the peer byte
// replicated, a scalar path when a row does not start 16-byte aligned;
// the broadcast rows all read the one input row, which stays in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

int g_num_sms = 0;

int num_sms() {
  if (g_num_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_num_sms <= 0) g_num_sms = 132;
  }
  return g_num_sms;
}

// ---- K4 ----

constexpr int kU8Threads = 256;  // a block

template <int Op>
__device__ __forceinline__ uint32_t u8_op4(uint32_t v) {
  if constexpr (Op == 1) return v ^ 0xFFFFFFFFu;
  if constexpr (Op == 2) return __vadd4(v, 0x01010101u);
  return v;
}

template <int Op>
__device__ __forceinline__ uint8_t u8_op1(uint8_t b) {
  return Op == 1 ? uint8_t(b ^ 0xFF) : Op == 2 ? uint8_t(b + 1) : b;
}

// Thread c of the grid: vector c of the body (src, dst: the body's
// 16-byte aligned start), read once (non-coherent, no L1 line) and
// written evict-first; then vectors c + stride ... when the body is
// larger than the grid; then the bytes outside the body (the head
// before it, the tail after it), one a thread.
template <int Op>
__global__ void __launch_bounds__(kU8Threads)
u8_transform_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                    long long nv, const uint8_t* __restrict__ in,
                    uint8_t* __restrict__ out, long long n, long long head) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long c0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (long long c = c0; c < nv; c += stride) {
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(src + c));
    __stcs(dst + c, make_uint4(u8_op4<Op>(v.x), u8_op4<Op>(v.y),
                               u8_op4<Op>(v.z), u8_op4<Op>(v.w)));
  }
  const long long body = nv << 4;
  for (long long e = c0; e < n - body; e += stride) {
    const long long i = e < head ? e : e + body;
    out[i] = u8_op1<Op>(in[i]);
  }
}

// K4's first design, kept as the baseline chip_smoke.py times beside the
// one above: one 16-byte load a thread in a grid-stride loop of 256-thread
// blocks, the op a runtime branch, all scalar unless both pointers are
// 16-byte aligned.
__global__ void u8_transform_v1_kernel(const uint8_t* __restrict__ in,
                                       uint8_t* __restrict__ out,
                                       long long n, int op, int vector) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if (vector) {
    const long long n16 = n >> 4;
    const uint4* src = reinterpret_cast<const uint4*>(in);
    uint4* dst = reinterpret_cast<uint4*>(out);
    for (long long c = tid; c < n16; c += stride) {
      uint4 v = src[c];
      if (op == 1) {
        v.x ^= 0xFFFFFFFFu; v.y ^= 0xFFFFFFFFu;
        v.z ^= 0xFFFFFFFFu; v.w ^= 0xFFFFFFFFu;
      } else if (op == 2) {
        v.x = __vadd4(v.x, 0x01010101u); v.y = __vadd4(v.y, 0x01010101u);
        v.z = __vadd4(v.z, 0x01010101u); v.w = __vadd4(v.w, 0x01010101u);
      }
      dst[c] = v;
    }
    head = n16 << 4;
  }
  for (long long i = head + tid; i < n; i += stride) {
    const uint8_t b = in[i];
    out[i] = op == 1 ? uint8_t(b ^ 0xFF) : op == 2 ? uint8_t(b + 1) : b;
  }
}

// Probes of the floor under K4 (chip_smoke.py): nothing at all, and one
// plain 16-byte load and store a thread.
__global__ void floor_empty_kernel() {}

__global__ void floor_copy16_kernel(const uint4* __restrict__ in,
                                    uint4* __restrict__ out, long long nv) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c < nv) out[c] = in[c];
}

// The body of n bytes from in to out: a scalar head up to in's 16-byte
// boundary and nv vectors after it when both pointers share their offset
// modulo 16; otherwise no body (head = n).
void u8_body(const void* in, const void* out, long long n, long long* head,
             long long* nv) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(in);
  const uintptr_t b = reinterpret_cast<uintptr_t>(out);
  *head = n;
  *nv = 0;
  if (((a ^ b) & 15) == 0) {
    const long long h = (long long)((16 - (a & 15)) & 15);
    *head = h < n ? h : n;
    *nv = (n - *head) >> 4;
  }
}

// K4's grid: a thread for each vector of the body (or, with none, each
// byte), in 256-thread blocks, up to 8 blocks an SM (one wave).
unsigned u8_blocks(long long nv, long long n) {
  const long long work = nv > 0 ? nv : n;
  long long blocks = (work + kU8Threads - 1) / kU8Threads;
  const long long cap = (long long)num_sms() * 8;
  if (blocks > cap) blocks = cap;
  return unsigned(blocks < 1 ? 1 : blocks);
}

template <int Op>
void u8_launch(const void* in, void* out, long long n, cudaStream_t s) {
  long long head, nv;
  u8_body(in, out, n, &head, &nv);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  u8_transform_kernel<Op><<<u8_blocks(nv, n), kU8Threads, 0, s>>>(
      reinterpret_cast<const uint4*>(src + head),
      reinterpret_cast<uint4*>(dst + head), nv, src, dst, n, head);
}

// ---- K5 ----

constexpr int kDotCols = 128;
constexpr int kDotRowTile = 64;   // rows of x per block: wgmma's M
constexpr int kDotSliceCols = 32;  // columns of y per block: wgmma's N
constexpr int kDotSlices = kDotCols / kDotSliceCols;
constexpr int kDotBoxBytes = kDotSliceCols * 128;  // 32 rows x 64 k, bf16
constexpr int kDotSliceBytes = 2 * kDotBoxBytes;   // both boxes: 8 KiB
constexpr int kDotWeightBytes = kDotSlices * kDotSliceBytes;  // 32 KiB
constexpr int kDotThreads = 128;  // a warpgroup
constexpr int kDotGroups = 4;  // warpgroups a block, splitting k
constexpr int kDotPartStride = 36;  // floats a row of partial sums

// The k index of x (0..127) that wgmma's k slot s multiplies. In a k16
// step, thread l of a warp holds A's slots 2q, 2q + 1, 2q + 8, 2q + 9
// (q = l % 4) of its two rows; mapping them to x's 4q .. 4q + 3 makes
// each of the thread's loads one float4 of a row. B's slot s holds
// W[dot128_phys(s)][j], so the product is unchanged.
__host__ __device__ constexpr int dot128_phys(int s) {
  return (s & ~15) | ((s & 6) << 1) | ((s >> 2) & 2) | (s & 1);
}

// W^T's shared-memory image: element e of slice ns (32 columns j), box kb
// (k slots 64 kb ..), row r = j - 32 ns, byte chunk pc of the row's 128
// bytes, holding the logical chunk pc ^ (r % 8) (the 128-byte swizzle),
// 8 bf16 each.
__global__ void dot128_weight_kernel(__nv_bfloat16* __restrict__ w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kDotWeightBytes / 2) return;
  const int ns = e / (kDotSliceBytes / 2);
  const int kb = (e / (kDotBoxBytes / 2)) % 2;
  const int r = (e / 64) % kDotSliceCols;
  const int pc = (e / 8) % 8, el = e % 8;
  const int slot = kb * 64 + ((pc ^ (r & 7)) * 8) + el;
  const int i = dot128_phys(slot), j = ns * kDotSliceCols + r;
  w[e] = __float2bfloat16_rn(float((3 * i + 5 * j) % 11 - 5) * 0.125f);
}

// Keeps the compiler from moving reads or writes of the accumulators and
// the A fragments across the asynchronous products.
template <int S>
__device__ __forceinline__ void fence_dot(float (&d)[3][16],
                                          uint32_t (&a)[3][S][4]) {
#pragma unroll
  for (int tm = 0; tm < 3; ++tm) {
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[tm][i]) :: "memory");
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        asm volatile("" : "+r"(a[tm][s][e]) :: "memory");
      }
  }
}

// d[64 x 32] += A[64 x 16] . B[32 x 16]^T, A from registers (this
// thread's fragment), B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// a's three bf16 terms by truncation, as f32 bits with zero low halves:
// hi = a's upper 16 bits, r = a - hi (exact), mid = r's upper 16 bits,
// lo = r - mid (exact, at most 8 significant bits), so hi + mid + lo == a
// wherever lo is a normal f32 (|a| >= 2^-103), with no conversion and no
// branch. inf splits to (inf, 0, 0), NaN to (NaN, 0, 0).
__device__ __forceinline__ void split3_trunc(float a, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  const uint32_t b = __float_as_uint(a);
  const bool fin = isfinite(a);
  hi = fin || !isnan(a) ? b & 0xFFFF0000u : 0x7FC00000u;
  const float r = fin ? a - __uint_as_float(hi) : 0.f;
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// split3_trunc for a finite a.
__device__ __forceinline__ void split3_trunc_finite(float a, uint32_t& hi,
                                                    uint32_t& mid,
                                                    uint32_t& lo) {
  hi = __float_as_uint(a) & 0xFFFF0000u;
  const float r = a - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// A fragments of the three terms from this thread's values of x:
// a[term][s] = (row0, slots 2q/2q+1), (row0 + 8, 2q/2q+1), (row0,
// 2q+8/2q+9), (row0 + 8, 2q+8/2q+9), i.e. the (.x, .y) and (.z, .w) of
// xv[h][s], h = 0 for row0; term 0 hi, 2 lo.
template <bool Finite, int S>
__device__ __forceinline__ void split_fragments(const float4 (&xv)[2][S],
                                                uint32_t (&a)[3][S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = xv[h][s];
      const float c[4] = {v.x, v.y, v.z, v.w};
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (Finite) {
          split3_trunc_finite(c[e], hi[e], mid[e], lo[e]);
        } else {
          split3_trunc(c[e], hi[e], mid[e], lo[e]);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        a[0][s][2 * p + h] = __byte_perm(hi[2 * p], hi[2 * p + 1], 0x7632);
        a[1][s][2 * p + h] = __byte_perm(mid[2 * p], mid[2 * p + 1], 0x7632);
        a[2][s][2 * p + h] = __byte_perm(lo[2 * p], lo[2 * p + 1], 0x7632);
      }
    }
  }
}

// Block b: rows 64 (b / 4) .. of x, columns 32 (b % 4) .. of y, in G =
// kDotGroups warpgroups, warpgroup g taking k-steps [g S, (g + 1) S), S =
// 8 / G (x's columns 16 g S .. 16 (g + 1) S - 1). In warpgroup g, thread
// t, warp w = t / 32, lane l: rows 16 w + l / 4 and that + 8 of the
// block's 64 (A's fragment rows and the accumulator's), x's k 16 ks + 4
// (l % 4) .. + 3, y's columns 8 jj + 2 (l % 4) and that + 1. Each
// warpgroup's sums (scale undone) meet in shared memory and are added in
// the order of g, four columns a thread, one coalesced float4 store each.
__global__ void __launch_bounds__(kDotThreads * kDotGroups)
dot128_kernel(const float* __restrict__ x, float* __restrict__ y,
              const uint8_t* __restrict__ w, long long k) {
  constexpr int G = kDotGroups, S = 8 / G;
  extern __shared__ uint8_t dsm_raw[];
  __shared__ __align__(8) uint64_t bar_word;
  const uint32_t raw = sm90::smem_u32(dsm_raw);
  const uint32_t ws = (raw + 1023u) & ~1023u;
  // The warpgroups' partial sums [G][64][kDotPartStride], after W^T's
  // slice.
  float* part = reinterpret_cast<float*>(dsm_raw + (ws - raw) +
                                         kDotSliceBytes);
  const uint32_t bar = sm90::smem_u32(&bar_word);
  const long long tile = blockIdx.x / kDotSlices;
  const int slice = int(blockIdx.x % kDotSlices);
  const long long left = k - tile * kDotRowTile;
  const int tile_rows = left < kDotRowTile ? int(left) : kDotRowTile;
  const int t = threadIdx.x, g = t / kDotThreads, tw = t % kDotThreads;
  const int wp = tw / 32, l = tw % 32, q = l % 4;
  if (t == 0) {
    sm90::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::mbar_expect_tx(bar, kDotSliceBytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(ws),
           "l"(reinterpret_cast<uint64_t>(w + slice * kDotSliceBytes)),
           "r"(kDotSliceBytes), "r"(bar)
        : "memory");
  }

  // This thread's 2 rows x 4 S values of x, all loads in flight at once.
  const int r0 = 16 * wp + l / 4;  // of the block's 64 rows
  const long long row0 = tile * kDotRowTile + r0;
  float4 xv[2][S];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 8 * h;
    const float4* src =
        reinterpret_cast<const float4*>(x + row * kDotCols) + q;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      xv[h][s] = row < k ? __ldg(src + 4 * (g * S + s))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // Each row's largest |x| over this warpgroup's columns, on the bits
  // (|x|'s bits sort as |x| does, and inf or NaN above every finite
  // value), across the row's four threads (one quad); then its scale
  // 2^sc, the least that brings that |x| to at least 1 (sc = 0 for a row
  // there already, all zero, or holding inf or NaN, whose every sum is
  // inf or NaN whatever the rest). Skipped by a warp whose rows need none.
  int sc[2];
  bool special = false;  // a row of this thread holds inf or NaN
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t m = 0u;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 v = xv[h][s];
      m = max(m, __float_as_uint(v.x) & 0x7FFFFFFFu);
      m = max(m, __float_as_uint(v.y) & 0x7FFFFFFFu);
      m = max(m, __float_as_uint(v.z) & 0x7FFFFFFFu);
      m = max(m, __float_as_uint(v.w) & 0x7FFFFFFFu);
    }
    m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
    sc[h] = (m != 0u && m < 0x3F800000u) ? -ilogbf(__uint_as_float(m)) : 0;
    special |= m >= 0x7F800000u;
  }
  if (__any_sync(0xffffffffu, (sc[0] | sc[1]) != 0)) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float4& v = xv[h][s];
        v = make_float4(ldexpf(v.x, sc[h]), ldexpf(v.y, sc[h]),
                        ldexpf(v.z, sc[h]), ldexpf(v.w, sc[h]));
      }
  }

  // A warp whose rows are all finite splits without the inf and NaN
  // cases.
  uint32_t a[3][S][4];
  if (__any_sync(0xffffffffu, special)) {
    split_fragments<false>(xv, a);
  } else {
    split_fragments<true>(xv, a);
  }

  __syncthreads();  // the barrier is initialised before anyone waits
  sm90::mbar_wait(bar, 0);

  // One accumulator a term, so the three chains of S products overlap;
  // then d = (lo + mid) + hi, the smallest first.
  float d[3][16];
#pragma unroll
  for (int tm = 0; tm < 3; ++tm)
#pragma unroll
    for (int i = 0; i < 16; ++i) d[tm][i] = 0.f;
  fence_dot(d, a);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int ks = g * S + s;
    const uint64_t db = sm90::smem_desc(
        ws + uint32_t((ks / 4) * kDotBoxBytes + 32 * (ks % 4)));
#pragma unroll
    for (int tm = 2; tm >= 0; --tm) wgmma_m64n32k16_rs(d[tm], a[tm][s], db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_dot(d, a);
#pragma unroll
  for (int i = 0; i < 16; ++i) d[0][i] = (d[2][i] + d[1][i]) + d[0][i];

  // d[4 jj + 2 h + e]: row r0 + 8 h, column 8 jj + 2 q + e of the slice;
  // the scale undone (ldexpf: one rounding).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (sc[h] == 0) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      d[0][4 * jj + 2 * h] = ldexpf(d[0][4 * jj + 2 * h], -sc[h]);
      d[0][4 * jj + 2 * h + 1] = ldexpf(d[0][4 * jj + 2 * h + 1], -sc[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      *reinterpret_cast<float2*>(
          part + (g * kDotRowTile + r0 + 8 * h) * kDotPartStride + 8 * jj +
          2 * q) = make_float2(d[0][4 * jj + 2 * h],
                               d[0][4 * jj + 2 * h + 1]);
    }
  __syncthreads();
  for (int e = t; e < kDotRowTile * kDotSliceCols / 4;
       e += kDotThreads * G) {
    const int r = e / (kDotSliceCols / 4), c = 4 * (e % (kDotSliceCols / 4));
    if (r >= tile_rows) continue;
    float4 sum = *reinterpret_cast<const float4*>(
        part + r * kDotPartStride + c);
#pragma unroll
    for (int gg = 1; gg < G; ++gg) {
      const float4 p = *reinterpret_cast<const float4*>(
          part + (gg * kDotRowTile + r) * kDotPartStride + c);
      sum = make_float4(sum.x + p.x, sum.y + p.y, sum.z + p.z, sum.w + p.w);
    }
    *reinterpret_cast<float4*>(
        y + (tile * kDotRowTile + r) * kDotCols + slice * kDotSliceCols + c) =
        sum;
  }
}

// dot128_kernel's dynamic shared memory: W^T's slice on a 1024-byte
// boundary, then the warpgroups' partial sums.
constexpr int kDotSmem = 1024 + kDotSliceBytes +
                         kDotGroups * kDotRowTile * kDotPartStride * 4;

// K5's first design, kept as the baseline chip_smoke.py times beside the
// one above: true f32 FMA on the CUDA cores, W generated by every block in
// shared memory, one 128-thread block per 16 rows of x.
constexpr int kDotV1Rows = 16;  // rows of x per block
constexpr int kDotV1Smem = (kDotCols * kDotCols + kDotV1Rows * kDotCols) * 4;

__global__ void __launch_bounds__(kDotCols)
dot128_v1_kernel(const float* __restrict__ x, float* __restrict__ y, int k) {
  extern __shared__ __align__(16) float dsm[];
  float* w = dsm;                         // [128][128], w[i * 128 + j]
  float* xs = dsm + kDotCols * kDotCols;  // [kDotV1Rows][128]
  const int t = threadIdx.x;
  for (int e = t; e < kDotCols * kDotCols; e += kDotCols) {
    const int i = e >> 7, j = e & 127;
    w[e] = float((3 * i + 5 * j) % 11 - 5) * 0.125f;
  }
  const long long row0 = (long long)blockIdx.x * kDotV1Rows;
  for (int e = t; e < kDotV1Rows * kDotCols / 4; e += kDotCols) {
    const int r = e / (kDotCols / 4), c4 = e % (kDotCols / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < k) {
      v = reinterpret_cast<const float4*>(x + (row0 + r) * kDotCols)[c4];
    }
    reinterpret_cast<float4*>(xs + r * kDotCols)[c4] = v;
  }
  __syncthreads();
  float acc[kDotV1Rows];
#pragma unroll
  for (int r = 0; r < kDotV1Rows; ++r) acc[r] = 0.f;
  for (int i = 0; i < kDotCols; ++i) {
    const float wi = w[i * kDotCols + t];
#pragma unroll
    for (int r = 0; r < kDotV1Rows; ++r) {
      acc[r] = fmaf(xs[r * kDotCols + i], wi, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kDotV1Rows; ++r) {
    if (row0 + r < k) y[(row0 + r) * kDotCols + t] = acc[r];
  }
}

// ---- K6 ----

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Wt[n][k] = W[k][n] and A0, both [np][np] bf16, zero outside [n][n].
__global__ void dotbench_init_kernel(const float* __restrict__ seed,
                                     __nv_bfloat16* __restrict__ wt,
                                     __nv_bfloat16* __restrict__ a0, int n,
                                     int np) {
  const float s = bf16_round(*seed);
  const long long total = (long long)np * np;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int r = int(e / np), c = int(e % np);
    float wv = 0.f, av = 0.f;
    if (r < n && c < n) {
      // Wt row r is W's column r: W[k = c][n = r].
      wv = float((3 * c + 5 * r) % 11 - 5) * 0.125f;
      av = bf16_round(float((r + c) % 7 - 3) * 0.125f) + s;
    }
    wt[e] = __float2bfloat16_rn(wv);
    a0[e] = __float2bfloat16_rn(av);
  }
}

constexpr int kThreads = 256;

// K6's epilogue: out = bf16(bf16(acc) * inv), out [np][np] bf16.
struct DotbenchStore {
  __nv_bfloat16* out;
  int np;
  float inv;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * np + c) =
        __floats2bfloat162_rn(bf16_round(v0) * inv, bf16_round(v1) * inv);
  }
};

constexpr int kSumBlocks = 1024;

// Pass 1: block b sums elements b*256 + t, stepping by the whole grid, in
// f32, then its threads in a fixed tree.
__global__ void __launch_bounds__(kThreads)
dotbench_sum_partial(const __nv_bfloat16* __restrict__ v, long long count,
                     float* __restrict__ partial) {
  __shared__ float red[kThreads];
  float s = 0.f;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x;
       e < count; e += (long long)gridDim.x * kThreads) {
    s += __bfloat162float(v[e]);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

// Pass 2: one block sums the partials, rounds once to bf16, writes f32.
__global__ void __launch_bounds__(kThreads)
dotbench_sum_final(const float* __restrict__ partial, int n,
                   float* __restrict__ out) {
  __shared__ float red[kThreads];
  float s = 0.f;
  for (int e = threadIdx.x; e < n; e += kThreads) s += partial[e];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = bf16_round(red[0]);
}

// ---- K7 ----

// Row r of the n x bucket output is builtin(input row, r), the input row
// being the one input (broadcast) or row r (scatter). blockIdx.y walks
// the rows, blockIdx.x the 16-byte chunks of a row.
__global__ void fanout_kernel(const uint8_t* __restrict__ in,
                              uint8_t* __restrict__ out, long long n,
                              long long bucket, int scatter, int builtin,
                              int vector) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = blockIdx.y; row < n; row += gridDim.y) {
    const uint8_t* src = in + (scatter ? row * bucket : 0);
    uint8_t* dst = out + row * bucket;
    const uint8_t peer = uint8_t(row & 0xFF);  // the iota converted to ui8
    long long head = 0;
    if (vector) {
      const long long n16 = bucket >> 4;
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      const unsigned add = unsigned(peer) * 0x01010101u;
      for (long long c = tid; c < n16; c += stride) {
        uint4 v = s4[c];
        if (builtin == 1) {
          v.x ^= 0xFFFFFFFFu; v.y ^= 0xFFFFFFFFu;
          v.z ^= 0xFFFFFFFFu; v.w ^= 0xFFFFFFFFu;
        } else if (builtin == 2) {
          v.x = __vadd4(v.x, add); v.y = __vadd4(v.y, add);
          v.z = __vadd4(v.z, add); v.w = __vadd4(v.w, add);
        }
        d4[c] = v;
      }
      head = n16 << 4;
    }
    for (long long j = head + tid; j < bucket; j += stride) {
      const uint8_t b = src[j];
      dst[j] = builtin == 1   ? uint8_t(b ^ 0xFF)
               : builtin == 2 ? uint8_t(b + peer)
                              : b;
    }
  }
}

}  // namespace

extern "C" {

// K4. op: 0 echo (copy), 1 xor255, 2 incr.
int tbus_u8_transform(const void* in, void* out, long long n, int op,
                      void* stream) {
  if (op < 0 || op > 2 || n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == 1) {
    u8_launch<1>(in, out, n, s);
  } else if (op == 2) {
    u8_launch<2>(in, out, n, s);
  } else {
    u8_launch<0>(in, out, n, s);
  }
  return int(cudaGetLastError());
}

// K4's first design (the baseline; same contract).
int tbus_u8_transform_v1(const void* in, void* out, long long n, int op,
                         void* stream) {
  if (op < 0 || op > 2 || n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  const int vector = ((reinterpret_cast<uintptr_t>(in) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long work = vector ? (n >> 4) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)num_sms() * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  u8_transform_v1_kernel<<<unsigned(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, op,
      vector);
  return int(cudaGetLastError());
}

// The floor probes: an empty kernel in K4's launch shape for n bytes
// between 16-byte aligned pointers, and one 16-byte load and store per
// thread over n / 16 vectors (256-thread blocks).
int tbus_k4_floor_empty(long long n, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  floor_empty_kernel<<<u8_blocks(n >> 4, n), kU8Threads, 0,
                       static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

int tbus_k4_floor_copy16(const void* in, void* out, long long n,
                         void* stream) {
  const long long nv = n >> 4;
  if (nv <= 0 || ((reinterpret_cast<uintptr_t>(in) |
                   reinterpret_cast<uintptr_t>(out)) & 15)) {
    return int(cudaErrorInvalidValue);
  }
  floor_copy16_kernel<<<unsigned((nv + kThreads - 1) / kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), nv);
  return int(cudaGetLastError());
}

// Bytes of K5's weight scratch.
long long tbus_dot128_weight_bytes(void) { return kDotWeightBytes; }

// Fills K5's weight scratch (tbus_dot128_weight_bytes, 16-byte aligned):
// W^T in bf16 as dot128_kernel's shared memory holds it.
int tbus_dot128_weight(void* w, void* stream) {
  if (reinterpret_cast<uintptr_t>(w) & 15) return int(cudaErrorInvalidValue);
  dot128_weight_kernel<<<kDotWeightBytes / 2 / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(w));
  return int(cudaGetLastError());
}

// K5. x and y f32[k][128], 16-byte aligned; w the filled weight scratch.
int tbus_dot128(const void* x, void* y, long long k, const void* w,
                void* stream) {
  if (k < 0 || k > 0x7fffffffll ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(w)) & 15)) {
    return int(cudaErrorInvalidValue);
  }
  if (k == 0) return int(cudaSuccess);
  const long long blocks = (k + kDotRowTile - 1) / kDotRowTile * kDotSlices;
  dot128_kernel<<<unsigned(blocks), kDotThreads * kDotGroups, kDotSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const uint8_t*>(w), k);
  return int(cudaGetLastError());
}

// K5's first design (the baseline): x and y f32[k][128], 16-byte aligned.
int tbus_dot128_v1(const void* x, void* y, long long k, void* stream) {
  if (k < 0 || k > 0x7fffffffll ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15)) {
    return int(cudaErrorInvalidValue);
  }
  if (k == 0) return int(cudaSuccess);
  static const cudaError_t attr = cudaFuncSetAttribute(
      dot128_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDotV1Smem);
  if (attr != cudaSuccess) return int(attr);
  const long long blocks = (k + kDotV1Rows - 1) / kDotV1Rows;
  dot128_v1_kernel<<<unsigned(blocks), kDotCols, kDotV1Smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), int(k));
  return int(cudaGetLastError());
}

// Np for dotbench's scratch: n rounded up to a multiple of the shared
// mainloop's tiles (256).
long long tbus_dotbench_padded(long long n) {
  return (n + sm90::kBN - 1) / sm90::kBN * sm90::kBN;
}

// Bytes of f32 partials dotbench's checksum needs.
long long tbus_dotbench_partial_bytes(void) { return kSumBlocks * 4; }

// K6. seed: one f32 on the device. wt, v0, v1: bf16 [np][np] scratch
// (np = tbus_dotbench_padded(n)); partial: tbus_dotbench_partial_bytes();
// out: one f32 on the device. The last matrix is left in v0 when t is
// even, else in v1.
int tbus_dotbench(const void* seed, void* wt, void* v0, void* v1,
                  void* partial, void* out, long long n, long long t,
                  float inv, void* stream) {
  if (n < 1 || t < 0 || n > 65536) return int(cudaErrorInvalidValue);
  const int np = int(tbus_dotbench_padded(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<__nv_bfloat16*>(wt);
  __nv_bfloat16* bufs[2] = {static_cast<__nv_bfloat16*>(v0),
                            static_cast<__nv_bfloat16*>(v1)};
  CUtensorMap v_maps[2], w_map;
  cudaError_t e =
      sm90::encode_kmajor_bf16(&v_maps[0], v0, np, np, sm90::kBM);
  if (e == cudaSuccess) {
    e = sm90::encode_kmajor_bf16(&v_maps[1], v1, np, np, sm90::kBM);
  }
  if (e == cudaSuccess) {
    e = sm90::encode_kmajor_bf16(&w_map, wt, np, np,
                                 sm90::kBN / sm90::kCluster);
  }
  if (e != cudaSuccess) return int(e);
  const long long total = (long long)np * np;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (long long)num_sms() * 8) blocks = (long long)num_sms() * 8;
  dotbench_init_kernel<<<unsigned(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(seed), w, bufs[0], int(n), np);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  for (long long k = 0; k < t; ++k) {
    e = sm90::gemm(v_maps[k & 1], w_map, np, np, np,
                   DotbenchStore{bufs[(k + 1) & 1], np, inv}, s);
    if (e != cudaSuccess) return int(e);
  }
  dotbench_sum_partial<<<kSumBlocks, kThreads, 0, s>>>(
      bufs[t & 1], total, static_cast<float*>(partial));
  dotbench_sum_final<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(partial), kSumBlocks,
      static_cast<float*>(out));
  return int(cudaGetLastError());
}

// K7. in u8[bucket] (broadcast) or u8[n * bucket] (scatter), out
// u8[n * bucket]; builtin: 0 echo, 1 xor255, 2 add_peer_index.
int tbus_fanout(const void* in, void* out, long long n, long long bucket,
                int scatter, int builtin, void* stream) {
  if (builtin < 0 || builtin > 2 || n < 0 || bucket < 0) {
    return int(cudaErrorInvalidValue);
  }
  if (n == 0 || bucket == 0) return int(cudaSuccess);
  const int vector = ((reinterpret_cast<uintptr_t>(in) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
                     bucket % 16 == 0;
  const long long work = vector ? (bucket >> 4) : bucket;
  const long long rows = n < 65535 ? n : 65535;
  long long blocks = (work + kThreads - 1) / kThreads;
  long long cap = (long long)num_sms() * 8 / rows;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  fanout_kernel<<<dim3(unsigned(blocks), unsigned(rows)), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, bucket,
      scatter != 0, builtin, vector);
  return int(cudaGetLastError());
}

}  // extern "C"
