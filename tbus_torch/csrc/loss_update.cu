// The fan-out step's loss and update, for Hopper: kernels K8a, K8b and K9.
//
// They replace the rest of the device compute of
// tbus/parallel/collective.py:186 make_fanout_step (K1 and K2, the step's
// products, are in gemm_bf16.cu):
//
//   K8a sumsq_kernel: the loss jnp.sum(y * y) (:194), an f32 scalar over
//       y f32 [R, N/tp], in one launch;
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
// throughout.
//
// K8a is one launch and deterministic. A fixed grid (a function of n
// only) takes per-thread f32 sums, reduced by a warp-shuffle tree into
// one partial a block. The cross-block sum is a ticket: each block writes
// its partial to a scratch array and draws a ticket from an integer
// counter (atomicInc's wrap, with release and acquire order); the block
// that draws the last ticket sums the partials in index order (the order
// does not depend on which block came last), and the wrap leaves the
// counter at 0 for the next call, so no memset runs per call. A ticket
// rather than a cooperative grid sync: it needs no cooperative launch
// (whose grid must fit co-resident, and which has a launch path of its
// own), and no block waits for another; only the last block does a
// second, 1,056-float pass. No float atomics, so the same y gives the
// same bits on every call. A y that takes one block has its sum written
// by that block directly. The scratch (counter, then partials) belongs to
// one stream at a time: two launches that run at once must not share it.
//
// K8a's loads are streaming loads that skip L1
// (ld.global.nc.L1::no_allocate), four at a time into four independent
// accumulators, so that more 16-byte loads are in flight per thread; on
// the H100 they measured faster than an __ldg float4 loop with one
// accumulator (PERF.md). The grid walks y from its end to its start: in
// the step, y is written front to back just before K8a, so its end is
// the part most likely still in L2 (PERF.md: 21.2-21.5 us in the step
// against 23.6-24.5 for the same loads walking forward).
//
// K8b and K9 stream: each float is read once and written once, one thread
// a 16-byte vector (__ldg), blocks handed out in order, so the loads in
// flight stay inside a window that moves through the body. K8b's blocks
// walk y from its end, as K8a's do: in the step K8b runs right after K8a,
// whose last loads are y's start (PERF.md: K8a + K8b 0.6 us lower on
// average in the hidden-4096 step than with K8b walking forward). A
// one-wave grid-stride form and a form through 1-D TMA bulk copies were
// both 2-4 us slower at 4096^2 on the H100 (PERF.md).
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

// A 16-byte load through the non-coherent path that leaves L1 alone (y
// is read once).
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// atomicInc(counter, last) with release and acquire order at GPU scope:
// this thread's earlier writes (its block's partial) are visible before
// its ticket, and every write released with an earlier ticket is visible
// after it. It takes the place of a __threadfence() on either side.
__device__ __forceinline__ unsigned draw_ticket(unsigned* counter,
                                                unsigned last) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(counter), "r"(last)
               : "memory");
  return old;
}

__device__ __forceinline__ float sq4(float4 a, float acc) {
  acc = fmaf(a.x, a.x, acc);
  acc = fmaf(a.y, a.y, acc);
  acc = fmaf(a.z, a.z, acc);
  return fmaf(a.w, a.w, acc);
}

// K8a: *out = the sum of y[i]^2 over the split, in one launch. Block b
// sums its threads' share (a grid-stride walk over the body from its last
// vector down, then the head and the tail) into partials[b]; the block
// that draws the last ticket from *counter sums the partials in index
// order. *counter is 0 on entry and is left at 0.
__global__ void __launch_bounds__(kThreads, 8)
sumsq_kernel(const float* __restrict__ y, unsigned* __restrict__ counter,
             float* __restrict__ partials, float* __restrict__ out, Split s) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  // Vector i of the walk is body vector nvec - 1 - i.
  const float4* back =
      reinterpret_cast<const float4*>(y + s.head) + (s.nvec - 1);
  // Four loads in flight a thread, each into its own accumulator, and no
  // one-load remainder loop: a load past the end is skipped and adds 0
  // (at 4096^2 a thread has 15 or 16 vectors).
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float acc = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (long long i = t; i < s.nvec; i += 4 * stride) {
    const float4 x0 = ld_stream(back - i);
    const float4 x1 =
        i + stride < s.nvec ? ld_stream(back - (i + stride)) : zero;
    const float4 x2 =
        i + 2 * stride < s.nvec ? ld_stream(back - (i + 2 * stride)) : zero;
    const float4 x3 =
        i + 3 * stride < s.nvec ? ld_stream(back - (i + 3 * stride)) : zero;
    acc = sq4(x0, acc);
    a1 = sq4(x1, a1);
    a2 = sq4(x2, a2);
    a3 = sq4(x3, a3);
  }
  acc = (acc + a1) + (a2 + a3);
  for (long long i = t; i < s.head; i += stride) acc = fmaf(y[i], y[i], acc);
  for (long long i = t; i < s.ntail; i += stride) {
    const float a = y[s.tail0 + i];
    acc = fmaf(a, a, acc);
  }
  acc = block_sum(acc);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) *out = acc;
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    last = draw_ticket(counter, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();  // the other partials are visible to the whole block
  if (!last) return;
  // Thread i sums partials i, i + 256, ... in that order; the loads are
  // issued together (from L2, where the other blocks wrote), a missing one
  // adds 0.
  constexpr int kEach = int((kMaxBlocks + kThreads - 1) / kThreads);
  float p[kEach];
#pragma unroll
  for (int k = 0; k < kEach; ++k) {
    const unsigned i = threadIdx.x + k * kThreads;
    p[k] = i < gridDim.x ? __ldcg(partials + i) : 0.0f;
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kEach; ++k) sum += p[k];
  sum = block_sum(sum);
  if (threadIdx.x == 0) *out = sum;
}

__device__ __forceinline__ float grad1(float gb, float y) {
  return 2.0f * __fmul_rn(gb, y);
}

// K8b: dy = 2 * (gbar * y), thread t taking the body's t-th vector from
// its end.
__global__ void __launch_bounds__(kThreads)
sumsq_grad_kernel(const float* __restrict__ y, const float* __restrict__ gbar,
                  float* __restrict__ dy, Split s) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float gb = __ldg(gbar);
  if (t < s.nvec) {
    const long long i = s.nvec - 1 - t;
    const float4 a = __ldg(reinterpret_cast<const float4*>(y + s.head) + i);
    reinterpret_cast<float4*>(dy + s.head)[i] = make_float4(
        grad1(gb, a.x), grad1(gb, a.y), grad1(gb, a.z), grad1(gb, a.w));
  }
  if (t < s.head) dy[t] = grad1(gb, y[t]);
  if (t < s.ntail) dy[s.tail0 + t] = grad1(gb, y[s.tail0 + t]);
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

// K8a's grid for n floats: the scratch takes one counter word and one
// partial a block.
extern "C" long long tbus_sumsq_blocks(long long n) {
  long long b = cdiv(n, kThreads * kPerThread);
  if (b < 1) b = 1;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// The words of K8a's scratch, whatever n: the ticket counter, then room
// for the partials of the largest grid.
extern "C" long long tbus_sumsq_scratch_words() { return 1 + kMaxBlocks; }

// scratch: tbus_sumsq_scratch_words() words, zeroed before its first
// call; word 0, the ticket counter, is 0 again after every call.
extern "C" int tbus_sumsq(const void* y, void* out, void* scratch,
                          long long n, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const void* ptrs[] = {y};
  unsigned* counter = static_cast<unsigned*>(scratch);
  sumsq_kernel<<<unsigned(tbus_sumsq_blocks(n)), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), counter,
      reinterpret_cast<float*>(counter + 1), static_cast<float*>(out),
      split(n, ptrs, 1));
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
