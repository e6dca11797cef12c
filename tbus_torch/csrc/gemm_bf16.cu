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
// with dy in full f32. A bf16 dy on the tensor cores would be another
// function (the reference does not round dy), so K2 runs on the CUDA cores:
// f32 fused multiply-adds, summed over m in order 0..M-1, rounded to bf16
// once in the epilogue. Bound: operations, 2*M*N*K flops at the f32 rate
// (67 TFLOP/s outside the tensor cores): 2.05 ms at 4096^3. Design: the
// classic register-blocked SGEMM: one 256-thread block per 128 x 128 tile
// of dW, each thread an 8 x 8 sub-tile, the m loop staging 8 rows of x and
// dy in shared memory per step (16-byte loads, two buffers: each step's
// global loads are issued before the previous step's sums).
//
// Ragged M, N, K are masked (zero-filled loads, guarded stores). Interface:
// plain C, loaded with ctypes. dtype codes: 0 = f32, 1 = bf16. Launches on
// the given stream, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

constexpr int kThreads = 256;

// ---- K1 ----

constexpr int kPackThreads = 256;
constexpr int kPackTile = 64;  // w's transpose tile: 64 k x 64 n

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Two values as a bf16x2 word, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

constexpr int kTK = 128, kTN = 128, kTM = 8;

__device__ __forceinline__ float bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4 consecutive values from src (the first `valid` real, the rest 0) as
// f32; one 16-byte load when whole and aligned.
__device__ __forceinline__ float4 load4(const float* src, int valid) {
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    return *reinterpret_cast<const float4*>(src);
  }
  return make_float4(valid > 0 ? src[0] : 0.f, valid > 1 ? src[1] : 0.f,
                     valid > 2 ? src[2] : 0.f, valid > 3 ? src[3] : 0.f);
}

// The same, each value rounded to bf16 (x's operand).
__device__ __forceinline__ float4 load4_bf16(const float* src, int valid) {
  const float4 v = load4(src, valid);
  return make_float4(bf16_value(v.x), bf16_value(v.y), bf16_value(v.z),
                     bf16_value(v.w));
}
__device__ __forceinline__ float4 load4_bf16(const __nv_bfloat16* src,
                                             int valid) {
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xFFFF0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xFFFF0000u));
  }
  const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
  return make_float4(bf16_value(valid > 0 ? src[0] : z),
                     bf16_value(valid > 1 ? src[1] : z),
                     bf16_value(valid > 2 ? src[2] : z),
                     bf16_value(valid > 3 ? src[3] : z));
}

// Thread t's share of one m step: row t / 32, columns 4 (t % 32) .. +3 of
// the block's x and dy tiles.
template <typename TX>
__device__ __forceinline__ void load_rows(
    const TX* __restrict__ x, const float* __restrict__ dy, int M, int K,
    int N, int64_t k0, int64_t n0, int m0, int tid, float4& xa, float4& da) {
  const int64_t gm = m0 + (tid >> 5), c = (tid & 31) * 4;
  const bool ok = gm < M;
  const int64_t xr = K - k0 - c, dr = N - n0 - c;
  xa = load4_bf16(x + (ok ? gm * K + k0 + c : 0),
                  ok ? int(xr < 4 ? xr : 4) : 0);
  da = load4(dy + (ok ? gm * N + n0 + c : 0), ok ? int(dr < 4 ? dr : 4) : 0);
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
dw_f32_bf16_kernel(const TX* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ dw, int M, int K, int N) {
  __shared__ __align__(16) float xs[2][kTM][kTK];  // [m][k]
  __shared__ __align__(16) float ds[2][kTM][kTN];  // [m][n]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lm = tid >> 5, lc = (tid & 31) * 4;
  const int64_t k0 = int64_t(blockIdx.y) * kTK;
  const int64_t n0 = int64_t(blockIdx.x) * kTN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 xa, da;
  load_rows(x, dy, M, K, N, k0, n0, 0, tid, xa, da);
  *reinterpret_cast<float4*>(&xs[0][lm][lc]) = xa;
  *reinterpret_cast<float4*>(&ds[0][lm][lc]) = da;
  __syncthreads();
  for (int m0 = 0, cur = 0; m0 < M; m0 += kTM, cur ^= 1) {
    const bool more = m0 + kTM < M;
    // The next step's loads are in flight while this one is summed.
    if (more) load_rows(x, dy, M, K, N, k0, n0, m0 + kTM, tid, xa, da);
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[cur][m][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[cur][m][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ds[cur][m][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ds[cur][m][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      *reinterpret_cast<float4*>(&xs[cur ^ 1][lm][lc]) = xa;
      *reinterpret_cast<float4*>(&ds[cur ^ 1][lm][lc]) = da;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t k = k0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) dw[k * N + n] = bf16_value(acc[i][j]);
    }
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

extern "C" int tbus_dw_f32_bf16(const void* x, const void* dy, void* dw, int M,
                                int K, int N, int x_dtype, void* stream) {
  if (K <= 0 || N <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(unsigned((N + kTN - 1) / kTN), unsigned((K + kTK - 1) / kTK));
  if (x_dtype == 0) {
    dw_f32_bf16_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(dw), M, K, N);
  } else if (x_dtype == 1) {
    dw_f32_bf16_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dy),
        static_cast<float*>(dw), M, K, N);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
