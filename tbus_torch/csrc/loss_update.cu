// The fan-out step's loss and update, for Hopper: kernels K8a, K8b and K9.
//
// They replace the rest of the device compute of
// tbus/parallel/collective.py:186 make_fanout_step (K1 and K2, the step's
// products, are in gemm_bf16.cu):
//
//   K8a sumsq_kernel (+ sumsq_finish_kernel): the loss jnp.sum(y * y)
//       (:194), an f32 scalar over y f32 [R, N/tp];
//   K8b sumsq_grad_kernel: its gradient under value_and_grad (:206),
//       dy = 2 * (gbar * y), the cotangent gbar read from device memory so
//       that the step never waits on the host;
//   K9  sgd_update_kernel: the update w - 1e-3 * g (:207), which XLA fuses
//       into one multiply-subtract, w1 = fma(-c, g, w) with c = f32(1e-3),
//       rounded once, into a new tensor.
//
// Bound: memory, all three (one to two operations a float). At y, w and g
// f32 [4096, 4096] on an H100 (3.35 TB/s): K8a reads 64 MiB (20.0 us), K8b
// moves 128 MiB (40.1 us), K9 192 MiB (60.1 us).
//
// Rounding. nvcc contracts a * b + c into an FMA by default, so every
// rounding the result depends on is spelled out: K9 is __fmaf_rn; K8b
// rounds gbar * y with __fmul_rn and then doubles it exactly, as the
// reference's gbar*y + gbar*y and torch's autograd of y * y both do.
//
// Design. Each thread handles 16 bytes at a time with float4 loads and
// stores where every pointer of the call sits at the same offset modulo
// 16 bytes: a scalar head up to the first 16-byte boundary, the float4
// body, a scalar tail. Pointers at different offsets take scalar accesses
// throughout. K8a is deterministic: a fixed grid (a function of n only)
// of per-thread f32 sums, reduced by a warp-shuffle tree into one partial
// a block; a second launch of one block sums the partials in index order.
// No float atomics, so the same y gives the same bits on every call. A y
// that takes one block has its sum written by the first launch alone.
//
// Interface: plain C, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K8a's grid: at most one wave of 8 blocks on each of 132 SMs, and no more
// blocks than give each thread 16 values.
constexpr long long kMaxBlocks = 132 * 8;
constexpr long long kPerThread = 16;

// n floats cut into a scalar head [0, head), a float4 body of nvec vectors
// from head, and a scalar tail [tail0, tail0 + ntail).
struct Split {
  long long head, nvec, tail0, ntail;
};

// The split for pointers that all hold n floats. A pointer's offset
// modulo 16 bytes is a whole number of floats (an f32 tensor is 4-byte
// aligned); where the pointers disagree, everything is head.
Split split(long long n, const void* const* ptrs, int count) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(ptrs[0]) % 16;
  bool same = mis % 4 == 0;
  for (int i = 1; i < count; ++i) {
    same = same && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == mis;
  }
  Split s;
  s.head = same ? static_cast<long long>((16 - mis) % 16) / 4 : n;
  if (s.head > n) s.head = n;
  s.nvec = (n - s.head) / 4;
  s.tail0 = s.head + 4 * s.nvec;
  s.ntail = n - s.tail0;
  return s;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The threads an elementwise kernel needs: one for each vector, and at
// least one for each scalar of the head and of the tail.
unsigned elementwise_blocks(const Split& s) {
  long long most = s.nvec;
  if (s.head > most) most = s.head;
  if (s.ntail > most) most = s.ntail;
  return unsigned(cdiv(most, kThreads));
}

// The sum of v over the block, in a fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, o);
    }
  }
  return v;
}

// K8a, first pass: block b writes the sum of squares of its threads'
// share (a grid-stride walk over the split) to dst[b].
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const float* __restrict__ y, float* __restrict__ dst, Split s) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float4* v = reinterpret_cast<const float4*>(y + s.head);
  float acc = 0.0f;
#pragma unroll 4
  for (long long i = t; i < s.nvec; i += stride) {
    const float4 a = __ldg(v + i);
    acc = fmaf(a.x, a.x, acc);
    acc = fmaf(a.y, a.y, acc);
    acc = fmaf(a.z, a.z, acc);
    acc = fmaf(a.w, a.w, acc);
  }
  for (long long i = t; i < s.head; i += stride) acc = fmaf(y[i], y[i], acc);
  for (long long i = t; i < s.ntail; i += stride) {
    const float a = y[s.tail0 + i];
    acc = fmaf(a, a, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) dst[blockIdx.x] = acc;
}

// K8a, second pass: one block sums the first pass's partials in index
// order into *out.
__global__ void __launch_bounds__(kThreads)
sumsq_finish_kernel(const float* __restrict__ partials,
                    float* __restrict__ out, int count) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

__device__ __forceinline__ float grad1(float gb, float y) {
  return 2.0f * __fmul_rn(gb, y);
}

// K8b: dy = 2 * (gbar * y).
__global__ void __launch_bounds__(kThreads)
sumsq_grad_kernel(const float* __restrict__ y, const float* __restrict__ gbar,
                  float* __restrict__ dy, Split s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float gb = __ldg(gbar);
  if (i < s.nvec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(y + s.head) + i);
    reinterpret_cast<float4*>(dy + s.head)[i] = make_float4(
        grad1(gb, a.x), grad1(gb, a.y), grad1(gb, a.z), grad1(gb, a.w));
  }
  if (i < s.head) dy[i] = grad1(gb, y[i]);
  if (i < s.ntail) dy[s.tail0 + i] = grad1(gb, y[s.tail0 + i]);
}

// K9: w1 = fma(-c, g, w), rounded once.
__global__ void __launch_bounds__(kThreads)
sgd_update_kernel(const float* __restrict__ w, const float* __restrict__ g,
                  float* __restrict__ w1, float c, Split s) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < s.nvec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(w + s.head) + i);
    const float4 b = __ldg(reinterpret_cast<const float4*>(g + s.head) + i);
    reinterpret_cast<float4*>(w1 + s.head)[i] = make_float4(
        __fmaf_rn(-c, b.x, a.x), __fmaf_rn(-c, b.y, a.y),
        __fmaf_rn(-c, b.z, a.z), __fmaf_rn(-c, b.w, a.w));
  }
  if (i < s.head) w1[i] = __fmaf_rn(-c, g[i], w[i]);
  if (i < s.ntail) {
    const long long j = s.tail0 + i;
    w1[j] = __fmaf_rn(-c, g[j], w[j]);
  }
}

}  // namespace

// The first pass's grid for n floats: the partials scratch takes this many
// floats.
extern "C" long long tbus_sumsq_blocks(long long n) {
  long long b = cdiv(n, kThreads * kPerThread);
  if (b < 1) b = 1;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

extern "C" int tbus_sumsq(const void* y, void* out, void* partials,
                          long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    cudaMemsetAsync(out, 0, sizeof(float), st);
    return int(cudaGetLastError());
  }
  const long long blocks = tbus_sumsq_blocks(n);
  const void* ptrs[] = {y};
  const Split s = split(n, ptrs, 1);
  float* dst = blocks == 1 ? static_cast<float*>(out)
                           : static_cast<float*>(partials);
  sumsq_kernel<<<unsigned(blocks), kThreads, 0, st>>>(
      static_cast<const float*>(y), dst, s);
  if (blocks > 1) {
    sumsq_finish_kernel<<<1, kThreads, 0, st>>>(
        static_cast<const float*>(partials), static_cast<float*>(out),
        int(blocks));
  }
  return int(cudaGetLastError());
}

extern "C" int tbus_sumsq_grad(const void* y, const void* gbar, void* dy,
                               long long n, void* stream) {
  if (n <= 0) return int(cudaSuccess);
  const void* ptrs[] = {y, dy};
  const Split s = split(n, ptrs, 2);
  sumsq_grad_kernel<<<elementwise_blocks(s), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(gbar),
      static_cast<float*>(dy), s);
  return int(cudaGetLastError());
}

extern "C" int tbus_sgd_update(const void* w, const void* g, void* w1,
                               float c, long long n, void* stream) {
  if (n <= 0) return int(cudaSuccess);
  const void* ptrs[] = {w, g, w1};
  const Split s = split(n, ptrs, 3);
  sgd_update_kernel<<<elementwise_blocks(s), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(g),
      static_cast<float*>(w1), c, s);
  return int(cudaGetLastError());
}
