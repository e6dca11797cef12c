// The fan-out step's matrix products, for Hopper: K1 (forward) and K2 (dW).
//
// Replaces the device compute of tbus/parallel/collective.py:186
// make_fanout_step.shard_body: the "service handler" matmul
//
//   y = dot(bf16(x), bf16(w), preferred_element_type=f32)       (:188-189)
//
// and its transpose under value_and_grad (:206), whose jaxpr is
// dot_general(dy: f32, x: bf16, preferred=f32) -> convert bf16 -> f32:
//
//   dW = f32(bf16_rn(bf16(x)^T . dy))        dy stays f32, summed in f32
//
// K1, tbus_matmul_bf16_f32: x [M, K] and w [K, N], each f32 or bf16, are
// rounded to bf16 (round to nearest even), multiplied exactly on the
// tensor cores, summed in f32 and written as f32 [M, N]. Bound: operations.
// 2*M*N*K flops at the card's bf16 tensor-core rate (989 TFLOP/s on an H100
// SXM) against 4*(M*K + K*N + M*N) bytes at 3.35 TB/s; at M = N = K = 4096
// the flops bound is 0.139 ms and the bytes bound 0.060 ms. Design: two
// launches. (1) pack_operands_kernel, memory-bound, rounds each element
// once: xb [Mp, Kp] = bf16(x) in 16-byte chunks, and wtb [Np, Kp] =
// bf16(w)^T through a 64 x 64 shared-memory tile, both zero-padded to the
// shared mainloop's tile (Mp, Np multiples of 256, Kp of 64; the
// zeros add nothing to the sums). (2) gemm_sm90.cuh's TMA + wgmma
// mainloop on xb and wtb, both K-major (blocks paired along M share wtb's
// rows by TMA multicast), with an epilogue that stores f32 y masked to
// (M, N). The caller allocates xb and wtb. Only the order of the
// f32 sum differs from the plain version. A producer that read f32 and
// converted as it filled the ring would save the pack's bytes: later work.
//
// K2, tbus_dw_f32_bf16: dW [K, N] = bf16_rn(sum_m bf16(x[m, k]) * dy[m, n])
// with dy in full f32. A bf16 dy would be another function (the reference
// does not round dy), but dy splits exactly into three bf16 terms,
// dy = hi + mid + lo (gemm_sm90.cuh split3), and each product of two bf16
// values is exact in f32. So dW is exactly one bf16 GEMM with an inner
// dimension of 3M on the tensor cores, summed in f32 and rounded to bf16
// once. Bound: operations, 3 * 2*M*N*K flops at 989 TFLOP/s (bf16 tensor
// cores, H100 SXM): 0.417 ms at 4096^3, against 2.05 ms for the same
// function on the CUDA cores' f32 FMA (67 TFLOP/s), which is what the
// reference's f32 arithmetic would otherwise cost; its bytes (x, dy and dW
// once, f32) take 0.060 ms. Design: two launches. (1) dw_pack_kernel,
// memory-bound, reads x and dy once through 64 x 64 shared-memory tiles and
// writes the GEMM's K-major operands: at [Kp, Mq] = bf16(x)^T and
// bt [Np, 3 Mq] = [lo^T | mid^T | hi^T], zero-padded (Kp, Np to 256, Mq to
// 64: tbus_gemm_padded(K, M, N)); 256 MiB at 4096^3, 0.080 ms at
// 3.35 TB/s. (2) One gemm_sm90.cuh launch, the GEMM's M = K, N = N and
// depth 3 Mq, with A's k coordinate wrapping every Mq (A is read three
// times, never copied), and an epilogue that rounds each f32 sum to bf16
// and stores it as f32, masked to (K, N). The smallest terms come first
// along k: their sums build up while the accumulator is small, so the
// tensor core's f32 additions lose less of them than if hi came first.
// Numerics: the products are exact; the sum differs from the plain
// version's f32 sum by its order and the tensor core's f32 additions
// (held to the same tolerance as a sum in another order), and the split
// is exact except where dy's low bits fall below bf16's least subnormal
// (|dy| < 2^-110), where lo is off by at most 2^-134 per element.
//
// Ragged M, N, K are zero-padded by the packs and masked by the
// epilogues. Interface: plain C, loaded with ctypes. dtype codes: 0 = f32,
// 1 = bf16. Launches on the given stream, does not synchronise, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

// ---- K1 ----

constexpr int kPackThreads = 256;
constexpr int kPackTile = 64;  // w's transpose tile: 64 k x 64 n

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

using sm90::pack2;

// 8 consecutive elements of src (the first `valid` real, the rest zero) as
// 4 bf16x2 words; 16-byte vector loads when whole and aligned.
__device__ __forceinline__ uint4 load8(const float* src, int valid) {
  uint32_t o[4];
  if (valid >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    o[0] = pack2(a.x, a.y); o[1] = pack2(a.z, a.w);
    o[2] = pack2(b.x, b.y); o[3] = pack2(b.z, b.w);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = pack2(2 * i < valid ? src[2 * i] : 0.f,
                   2 * i + 1 < valid ? src[2 * i + 1] : 0.f);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, int valid) {
  if (valid >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    return *reinterpret_cast<const uint4*>(src);
  }
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < valid ? __bfloat16_as_ushort(src[2 * i]) : 0;
    const uint32_t hi =
        2 * i + 1 < valid ? __bfloat16_as_ushort(src[2 * i + 1]) : 0;
    o[i] = lo | (hi << 16);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Blocks [0, x_blocks) write xb [Mp][Kp] = bf16(x), zero-padded, 8 values
// (16 bytes) per thread and step; the rest write wtb [Np][Kp] = bf16(w)^T,
// zero-padded, one 64 x 64 tile each: read along n, written along k.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kPackThreads)
pack_operands_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                     __nv_bfloat16* __restrict__ xb,
                     __nv_bfloat16* __restrict__ wtb, int M, int N, int K,
                     long long Mp, long long Kp, int x_blocks) {
  const int tid = threadIdx.x;
  if (int(blockIdx.x) < x_blocks) {
    const long long per_row = Kp / 8;
    const long long chunks = Mp * per_row;
    const long long stride = (long long)x_blocks * kPackThreads;
    for (long long c = blockIdx.x * (long long)kPackThreads + tid;
         c < chunks; c += stride) {
      const long long r = c / per_row, k0 = (c % per_row) * 8;
      const long long valid = r < M ? K - k0 : 0;
      const uint4 v = valid > 0
                          ? load8(x + r * K + k0, int(valid < 8 ? valid : 8))
                          : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(xb + r * Kp + k0) = v;
    }
    return;
  }
  __shared__ float tile[kPackTile][kPackTile + 1];  // [n][k]
  const long long t = blockIdx.x - x_blocks;
  const long long tiles_k = Kp / kPackTile;
  const long long k0 = (t % tiles_k) * kPackTile;
  const long long n0 = (t / tiles_k) * kPackTile;
  const int j = tid % kPackTile;
#pragma unroll
  for (int it = 0; it < kPackTile * kPackTile / kPackThreads; ++it) {
    const int i = it * (kPackThreads / kPackTile) + tid / kPackTile;
    const long long k = k0 + i, n = n0 + j;
    tile[j][i] = k < K && n < N ? as_float(w[k * N + n]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kPackTile * kPackTile / 8 / kPackThreads; ++h) {
    const int q = tid + h * kPackThreads;
    const int r = q / 8, kc = (q % 8) * 8;
    const float* src = &tile[r][kc];
    *reinterpret_cast<uint4*>(wtb + (n0 + r) * Kp + k0 + kc) = make_uint4(
        pack2(src[0], src[1]), pack2(src[2], src[3]), pack2(src[4], src[5]),
        pack2(src[6], src[7]));
  }
}

// K1's epilogue: f32 y [M][N], masked.
struct StoreF32 {
  float* y;
  int M, N;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    if (r >= M || c >= N) return;
    float* p = y + (long long)r * N + c;
    if (c + 1 < N && (N & 1) == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (c + 1 < N) p[1] = v1;
    }
  }
};

// ---- K2 ----

// K2's epilogue: dW [K][N] = f32(bf16_rn(sum)), masked.
struct StoreBf16Rounded {
  float* dw;
  int K, N;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    StoreF32{dw, K, N}(r, c, __bfloat162float(__float2bfloat16_rn(v0)),
                       __bfloat162float(__float2bfloat16_rn(v1)));
  }
};

// Eight values as four bf16x2 words (each value already a bf16 value,
// so the rounding is exact).
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// Blocks [0, a_tiles) write at [Kp][Mq] = bf16(x)^T, one 64 x 64 tile of
// x each (read along k, written along m); the rest write
// bt [Np][3 Mq] = the exact split of dy^T, one 64 x 64 tile of dy each
// (read along n, written along m), lo in columns [0, Mq), mid in
// [Mq, 2 Mq), hi in [2 Mq, 3 Mq). Padding is zero.
template <typename TX>
__global__ void __launch_bounds__(kPackThreads)
dw_pack_kernel(const TX* __restrict__ x, const float* __restrict__ dy,
               __nv_bfloat16* __restrict__ at, __nv_bfloat16* __restrict__ bt,
               int M, int K, int N, long long Mq, long long a_tiles) {
  __shared__ float tile[kPackTile][kPackTile + 1];  // [m][k or n]
  const int tid = threadIdx.x;
  long long t = blockIdx.x;
  const bool is_a = t < a_tiles;
  if (!is_a) t -= a_tiles;
  const long long tiles_m = Mq / kPackTile;
  const long long m0 = (t % tiles_m) * kPackTile;
  const long long c0 = (t / tiles_m) * kPackTile;
  const int j = tid % kPackTile;
#pragma unroll
  for (int it = 0; it < kPackTile * kPackTile / kPackThreads; ++it) {
    const int i = it * (kPackThreads / kPackTile) + tid / kPackTile;
    const long long m = m0 + i, c = c0 + j;
    float v = 0.f;
    if (m < M) {
      if (is_a && c < K) v = as_float(x[m * K + c]);
      if (!is_a && c < N) v = dy[m * N + c];
    }
    tile[i][j] = v;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kPackTile * kPackTile / 8 / kPackThreads; ++h) {
    const int q = tid + h * kPackThreads;
    const int r = q / 8, mc = (q % 8) * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = tile[mc + e][r];
    if (is_a) {
      *reinterpret_cast<uint4*>(at + (c0 + r) * Mq + m0 + mc) = pack8(v);
      continue;
    }
    float hi[8], mid[8], lo[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sm90::split3(v[e], hi[e], mid[e], lo[e]);
    __nv_bfloat16* row = bt + (c0 + r) * 3 * Mq + m0 + mc;
    *reinterpret_cast<uint4*>(row) = pack8(lo);
    *reinterpret_cast<uint4*>(row + Mq) = pack8(mid);
    *reinterpret_cast<uint4*>(row + 2 * Mq) = pack8(hi);
  }
}

template <typename TX, typename TW>
void launch_pack(const void* x, const void* w, __nv_bfloat16* xb,
                 __nv_bfloat16* wtb, int M, int N, int K, long long Mp,
                 long long Np, long long Kp, cudaStream_t stream) {
  const long long x_chunks = Mp * (Kp / 8);
  long long x_blocks = (x_chunks + kPackThreads - 1) / kPackThreads;
  if (x_blocks > 1024) x_blocks = 1024;  // grid-stride beyond
  const long long w_tiles = (Np / kPackTile) * (Kp / kPackTile);
  pack_operands_kernel<TX, TW>
      <<<unsigned(x_blocks + w_tiles), kPackThreads, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w), xb, wtb, M,
          N, K, Mp, Kp, int(x_blocks));
}

}  // namespace

// K1's scratch shape for x [M, K] and w [K, N]: out = {Mp, Kp, Np}, each
// rounded up to the shared mainloop's tile (sm90::padded).
extern "C" void tbus_gemm_padded(long long m, long long k, long long n,
                                 long long* out) {
  sm90::padded(m, k, n, out);
}

// K1. xb: bf16 [Mp][Kp] and wtb: bf16 [Np][Kp] scratch the caller gives,
// shaped as tbus_gemm_padded says; both 16-byte aligned. Both are written
// in full, padding zeroed.
extern "C" int tbus_matmul_bf16_f32(const void* x, const void* w, void* y,
                                    void* xb, void* wtb, int M, int N, int K,
                                    long long Mp, long long Np, long long Kp,
                                    int x_dtype, int w_dtype, void* stream) {
  if (M < 0 || N < 0 || K < 0 || !sm90::tiles(Mp, Np, Kp) || Mp < M ||
      Np < N || Kp < K) {
    return int(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<__nv_bfloat16*>(xb);
  auto* b = static_cast<__nv_bfloat16*>(wtb);
  if (x_dtype == 0 && w_dtype == 0) {
    launch_pack<float, float>(x, w, a, b, M, N, K, Mp, Np, Kp, s);
  } else if (x_dtype == 0 && w_dtype == 1) {
    launch_pack<float, __nv_bfloat16>(x, w, a, b, M, N, K, Mp, Np, Kp, s);
  } else if (x_dtype == 1 && w_dtype == 0) {
    launch_pack<__nv_bfloat16, float>(x, w, a, b, M, N, K, Mp, Np, Kp, s);
  } else if (x_dtype == 1 && w_dtype == 1) {
    launch_pack<__nv_bfloat16, __nv_bfloat16>(x, w, a, b, M, N, K, Mp, Np,
                                              Kp, s);
  } else {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  CUtensorMap a_map, b_map;
  e = sm90::encode_kmajor_bf16(&a_map, xb, Mp, Kp, sm90::kBM);
  if (e == cudaSuccess) {
    e = sm90::encode_kmajor_bf16(&b_map, wtb, Np, Kp,
                                 sm90::kBN / sm90::kCluster);
  }
  if (e != cudaSuccess) return int(e);
  return int(sm90::gemm(a_map, b_map, Mp, Np, Kp,
                        StoreF32{static_cast<float*>(y), M, N}, s));
}

// K2. at: bf16 [Kp][Mq] and bt: bf16 [Np][3 Mq] scratch the caller gives,
// shaped as tbus_gemm_padded(K, M, N) says ({Kp, Mq, Np}); both 16-byte
// aligned and written in full, padding zeroed. One pack, then one GEMM
// whose k runs over bt's 3 Mq columns while A's wraps over at's Mq.
extern "C" int tbus_dw_f32_bf16(const void* x, const void* dy, void* dw,
                                void* at, void* bt, int M, int K, int N,
                                long long Kp, long long Mq, long long Np,
                                int x_dtype, void* stream) {
  if (M < 0 || K < 0 || N < 0 || !sm90::tiles(Kp, Np, 3 * Mq) || Kp < K ||
      Mq < M || Np < N || Kp % kPackTile != 0 || Np % kPackTile != 0) {
    return int(cudaErrorInvalidValue);
  }
  if (K == 0 || N == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<__nv_bfloat16*>(at);
  auto* b = static_cast<__nv_bfloat16*>(bt);
  const long long tiles_m = Mq / kPackTile;
  const long long a_tiles = tiles_m * (Kp / kPackTile);
  const unsigned blocks = unsigned(a_tiles + tiles_m * (Np / kPackTile));
  if (x_dtype == 0) {
    dw_pack_kernel<float><<<blocks, kPackThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), a, b, M,
        K, N, Mq, a_tiles);
  } else if (x_dtype == 1) {
    dw_pack_kernel<__nv_bfloat16><<<blocks, kPackThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dy),
        a, b, M, K, N, Mq, a_tiles);
  } else {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  CUtensorMap a_map, b_map;
  e = sm90::encode_kmajor_bf16(&a_map, at, Kp, Mq, sm90::kBM);
  if (e == cudaSuccess) {
    e = sm90::encode_kmajor_bf16(&b_map, bt, Np, 3 * Mq,
                                 sm90::kBN / sm90::kCluster);
  }
  if (e != cudaSuccess) return int(e);
  return int(sm90::gemm(a_map, b_map, Kp, Np, 3 * Mq,
                        StoreBf16Rounded{static_cast<float*>(dw), K, N}, s,
                        Mq));
}
