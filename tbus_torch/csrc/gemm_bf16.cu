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
// rounded to bf16 (round to nearest even) as they are loaded, multiplied
// exactly on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sum) and
// written as f32 [M, N]. Bound: operations. 2*M*N*K flops at the card's
// bf16 tensor-core rate (989 TFLOP/s on an H100 SXM) against 4*(M*K + K*N
// + M*N) bytes at 3.35 TB/s; at M = N = K = 4096 the flops bound is 0.139
// ms and the bytes bound 0.060 ms. Design: one 256-thread block per 128 x
// 128 output tile; 8 warps of 64 x 32 each; the K loop stages a 128 x 32
// slice of x and a 32 x 128 slice of w in shared memory, converted to bf16
// on the way in, w stored n-major so that ldmatrix reads both operands'
// fragments directly (rows padded to 80 bytes: conflict-free). Two shared
// buffers: each slice's global loads are issued before the previous
// slice's products and stored after them. No TMA or wgmma yet.
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

namespace {

constexpr int kThreads = 256;

// ---- K1 ----

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLds = kBK + 8;  // bf16 per shared row: 80 bytes

// Two values as a bf16x2 word, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16_rn(0.f);
}

// 16 consecutive elements from src (the first `valid` of them real, the
// rest zero) as 8 bf16x2 words; 16-byte vector loads when whole and
// aligned.
__device__ __forceinline__ void load16(const float* src, int valid,
                                       uint32_t (&out)[8]) {
  if (valid >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      out[2 * i] = pack2(v.x, v.y);
      out[2 * i + 1] = pack2(v.z, v.w);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = pack2(2 * i < valid ? src[2 * i] : 0.f,
                   2 * i + 1 < valid ? src[2 * i + 1] : 0.f);
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, int valid,
                                       uint32_t (&out)[8]) {
  if (valid >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[i];
      out[4 * i] = v.x; out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
    }
    return;
  }
  const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = pack2(2 * i < valid ? src[2 * i] : z,
                   2 * i + 1 < valid ? src[2 * i + 1] : z);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K slice in registers on its way to shared memory: thread t holds 16
// k-values of x row t / 2 and 16 k-values of w column t % 128.
struct Slice {
  uint32_t a[8], b[8];
};

template <typename TX, typename TW>
__device__ __forceinline__ void load_slice(
    const TX* __restrict__ x, const TW* __restrict__ w, int M, int N, int K,
    int64_t row0, int64_t col0, int k0, int tid, Slice& s) {
  const int64_t gr = row0 + (tid >> 1);
  const int ka = k0 + (tid & 1) * 16;
  const int valid = gr < M ? min(16, K - ka) : 0;
  load16(x + (gr < M ? gr * K + ka : 0), valid, s.a);
  const int64_t gn = col0 + (tid & 127);
  const int kb = k0 + (tid >> 7) * 16;
  const TW z = zero_of(TW());
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = kb + 2 * i;
    const bool ok = gn < N;
    s.b[i] = pack2(ok && k < K ? w[int64_t(k) * N + gn] : z,
                   ok && k + 1 < K ? w[int64_t(k + 1) * N + gn] : z);
  }
}

__device__ __forceinline__ void store_slice(
    __nv_bfloat16 (*As)[kLds], __nv_bfloat16 (*Bs)[kLds], int tid,
    const Slice& s) {
  uint4* a = reinterpret_cast<uint4*>(&As[tid >> 1][(tid & 1) * 16]);
  a[0] = make_uint4(s.a[0], s.a[1], s.a[2], s.a[3]);
  a[1] = make_uint4(s.a[4], s.a[5], s.a[6], s.a[7]);
  uint4* b = reinterpret_cast<uint4*>(&Bs[tid & 127][(tid >> 7) * 16]);
  b[0] = make_uint4(s.b[0], s.b[1], s.b[2], s.b[3]);
  b[1] = make_uint4(s.b[4], s.b[5], s.b[6], s.b[7]);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
matmul_bf16_f32_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                       float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM][kLds];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBN][kLds];  // [n][k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int64_t row0 = int64_t(blockIdx.y) * kBM;
  const int64_t col0 = int64_t(blockIdx.x) * kBN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Slice s;
  load_slice(x, w, M, N, K, row0, col0, 0, tid, s);
  store_slice(As[0], Bs[0], tid, s);
  __syncthreads();
  for (int k0 = 0, cur = 0; k0 < K; k0 += kBK, cur ^= 1) {
    const bool more = k0 + kBK < K;
    // The next slice's loads are in flight while this one is multiplied.
    if (more) load_slice(x, w, M, N, K, row0, col0, k0 + kBK, tid, s);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldsm_x4(a[mi], &As[cur][wm + mi * 16 + (lane & 15)]
                          [kk + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t r[4];
        ldsm_x4(r, &Bs[cur][wn + nj * 8 + (lane & 7) + ((lane >> 4) << 3)]
                       [kk + ((lane >> 3) & 1) * 8]);
        b[nj][0] = r[0]; b[nj][1] = r[1];
        b[nj + 1][0] = r[2]; b[nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    if (more) store_slice(As[cur ^ 1], Bs[cur ^ 1], tid, s);
    __syncthreads();
  }

  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int64_t r = row0 + wm + mi * 16 + g;
      const int64_t c = col0 + wn + ni * 8 + t2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int64_t rr = r + 8 * h;
        if (rr >= M) continue;
        if (c < N) y[rr * N + c] = acc[mi][ni][2 * h];
        if (c + 1 < N) y[rr * N + c + 1] = acc[mi][ni][2 * h + 1];
      }
    }
  }
}

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
void launch_matmul(const void* x, const void* w, float* y, int M, int N, int K,
                   cudaStream_t stream) {
  dim3 grid(unsigned((N + kBN - 1) / kBN), unsigned((M + kBM - 1) / kBM));
  matmul_bf16_f32_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), y, M, N, K);
}

}  // namespace

extern "C" int tbus_matmul_bf16_f32(const void* x, const void* w, void* y,
                                    int M, int N, int K, int x_dtype,
                                    int w_dtype, void* stream) {
  if (M <= 0 || N <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
  if (x_dtype == 0 && w_dtype == 0) {
    launch_matmul<float, float>(x, w, out, M, N, K, s);
  } else if (x_dtype == 0 && w_dtype == 1) {
    launch_matmul<float, __nv_bfloat16>(x, w, out, M, N, K, s);
  } else if (x_dtype == 1 && w_dtype == 0) {
    launch_matmul<__nv_bfloat16, float>(x, w, out, M, N, K, s);
  } else if (x_dtype == 1 && w_dtype == 1) {
    launch_matmul<__nv_bfloat16, __nv_bfloat16>(x, w, out, M, N, K, s);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
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
