// The C++ device plane's programs, for Hopper: K4 u8_transform, K5 dot128,
// K6 dotbench and K7 fanout. The CUDA runtime (cuda_backend.cu, driven from the
// dispatch thread of cuda_runtime.cc) launches them from C++; the ctypes
// wrappers in tbus_torch/kernels/device_programs.py launch the same
// functions on PyTorch tensors. Plain C interface; each function launches
// on the given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().
//
// K4, tbus_u8_transform — replaces cpp/tpu/serve_engine.cc:28 step_mlir
// (the serving step, u8[bucket * token_bytes]) and the echo / xor255 /
// incr bodies of cpp/tpu/pjrt_runtime.cc:191 build_mlir (device methods,
// u8[length class]). out[i] = in[i], in[i] ^ 0xFF or in[i] + 1 mod 256.
// Bound: bytes, n read and n written at 3.35 TB/s (0.63 us at 1 MiB,
// 0.16 us at the 256 KiB serving step): launch overhead dominates at these
// sizes. Design: 16-byte loads and stores (per-byte add by __vadd4) over a
// grid-stride loop, a scalar pass for the ragged tail, and an all-scalar
// path when either pointer is not 16-byte aligned. No length prefix (the
// row transform of row_transform.cu has one).
//
// K5, tbus_dot128 — replaces pjrt_runtime.cc:207 dot128: y = x . W for
// x f32[k, 128] (the payload's bytes as little-endian f32) and
// W[i, j] = ((3i + 5j) mod 11 - 5) / 8, at precision HIGHEST, so in true
// f32: fused multiply-adds on the CUDA cores, summed over i = 0..127 in
// order, no TF32. W is generated by every block in shared memory (64 KiB
// of f32), as the reference generates it on the device. Bound: operations,
// 2 * k * 128 * 128 flops at 67 TFLOP/s (1.0 us at k = 2048; the bytes,
// 2 MiB, take 0.63 us). Design: one 128-thread block per 16 rows of x,
// thread j owning output column j; a row of x is read from shared memory
// as a broadcast, W[i, j] once per i for the 16 rows.
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

// ---- K4 ----

__global__ void u8_transform_kernel(const uint8_t* __restrict__ in,
                                    uint8_t* __restrict__ out, long long n,
                                    int op, int vector) {
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

// ---- K5 ----

constexpr int kDotCols = 128;
constexpr int kDotRows = 16;  // rows of x per block
constexpr int kDotSmem = (kDotCols * kDotCols + kDotRows * kDotCols) * 4;

__global__ void __launch_bounds__(kDotCols)
dot128_kernel(const float* __restrict__ x, float* __restrict__ y, int k) {
  extern __shared__ __align__(16) float dsm[];
  float* w = dsm;                         // [128][128], w[i * 128 + j]
  float* xs = dsm + kDotCols * kDotCols;  // [kDotRows][128]
  const int t = threadIdx.x;
  for (int e = t; e < kDotCols * kDotCols; e += kDotCols) {
    const int i = e >> 7, j = e & 127;
    w[e] = float((3 * i + 5 * j) % 11 - 5) * 0.125f;
  }
  const long long row0 = (long long)blockIdx.x * kDotRows;
  for (int e = t; e < kDotRows * kDotCols / 4; e += kDotCols) {
    const int r = e / (kDotCols / 4), c4 = e % (kDotCols / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < k) {
      v = reinterpret_cast<const float4*>(x + (row0 + r) * kDotCols)[c4];
    }
    reinterpret_cast<float4*>(xs + r * kDotCols)[c4] = v;
  }
  __syncthreads();
  float acc[kDotRows];
#pragma unroll
  for (int r = 0; r < kDotRows; ++r) acc[r] = 0.f;
  for (int i = 0; i < kDotCols; ++i) {
    const float wi = w[i * kDotCols + t];
#pragma unroll
    for (int r = 0; r < kDotRows; ++r) {
      acc[r] = fmaf(xs[r * kDotCols + i], wi, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kDotRows; ++r) {
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
  const int vector = ((reinterpret_cast<uintptr_t>(in) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long work = vector ? (n >> 4) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)num_sms() * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  u8_transform_kernel<<<unsigned(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, op,
      vector);
  return int(cudaGetLastError());
}

// K5. x and y f32[k][128], 16-byte aligned.
int tbus_dot128(const void* x, void* y, long long k, void* stream) {
  if (k < 0 || k > 0x7fffffffll ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15)) {
    return int(cudaErrorInvalidValue);
  }
  if (k == 0) return int(cudaSuccess);
  static bool attr_set = false;  // first call per process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dot128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDotSmem);
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  const long long blocks = (k + kDotRows - 1) / kDotRows;
  dot128_kernel<<<unsigned(blocks), kDotCols, kDotSmem,
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
