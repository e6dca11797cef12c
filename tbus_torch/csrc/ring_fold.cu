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
// so). The first fold starts from m = -inf: a = exp(-inf) = 0 there, never
// NaN, because m' is finite once a row has seen one finite score.
//
// Bound: operations. 4 * lq * lk * d flops (two products), all in f32 on the
// CUDA cores, since the reference computes both products in f32: at 67
// TFLOP/s, 0.513 ms for lq = lk = 8192, d = 128 (bf16 tensor cores would
// make it 0.035 ms, but not in f32). Bytes are small beside that (q, k, v
// and the carry, each once). Design: one 256-thread block per 64 query rows
// and per chunk of up to 128 head-dim columns of o loops over the block's
// lk in tiles of 64 keys, with the online rescale inside the loop, so the
// scores never leave the SM: each tile's k (stored transposed) and v go to
// shared memory, each thread computes a 4 x 4 patch of s from float4
// shared loads, the row max and row sum are reduced across the 16 threads
// of a row group with warp shuffles, p goes to shared memory, and each
// thread updates its 4 rows x D/16 columns of o in registers. The chunk
// width D is 32, 64 or 128 (d padded up with zeros, which adds nothing to
// s and gives columns of o that are never written back). A head dim over
// 128 takes ceil(d / 128) chunks: s sums q k^T over every chunk of d in
// shared memory, so each chunk's block recomputes all of s (at d = 256 the
// kernel does 1.5x the flops of the bound), and its m and l go to separate
// outputs, written by the chunk-0 block, since the other chunks' blocks
// still read the carry's old m. Rows past lq and keys past lk are masked
// (a masked score is -inf).
//
// Interface: plain C, loaded with ctypes. dtype codes: 0 = f32, 1 = bf16;
// any d >= 1. m_out and l_out may alias m and l when d <= 128 and must not
// otherwise. Launches on the given stream, does not synchronise, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64, kBK = 64;
constexpr int kLdq = kBQ + 4, kLdk = kBK + 4;  // padded rows, 16-byte aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int D>
constexpr int smem_floats() {
  return D * kLdq + D * kLdk + kBK * D + kBK * kLdq;
}

// Loads rows [r0g, r0g + rows) of x, columns [c0g, c0g + D), transposed
// into dst [D][ld], zero past the rows' end n and the columns' end d.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_t(float* dst, int ld, const T* x,
                                       int64_t r0g, int64_t n, int c0g,
                                       int d, int tid) {
  for (int i = tid; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[c * ld + r] = (r0g + r < n && c0g + c < d)
                          ? to_f32(x[(r0g + r) * d + c0g + c])
                          : 0.f;
  }
}

// s[4][4] += this thread's patch of Qt^T Kt over D columns.
template <int D>
__device__ __forceinline__ void add_scores(float (&s)[4][4], const float* Qt,
                                           const float* Kt, int r0, int tx) {
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
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

// CHUNKED: d > D, so q and k go through shared memory a chunk of D
// columns at a time and the block's o columns start at blockIdx.y * D.
template <typename T, int D, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
ring_fold_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* m_in,
                 const float* l_in, float* m_out, float* l_out,
                 float* __restrict__ o_io, int lq, int lk, int d,
                 float scale) {
  constexpr int CPT = D / 16;  // o columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [D][kLdq]  q (chunk) transposed
  float* Kt = Qt + D * kLdq;     // [D][kLdk]  k tile (chunk) transposed
  float* Vs = Kt + D * kLdk;     // [kBK][D]   v tile, this block's columns
  float* Pt = Vs + kBK * D;      // [kBK][kLdq] p transposed

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * 4;   // this thread's 4 query rows (local)
  const int c0 = tx * CPT;  // this thread's o columns (in the chunk)
  const int cb = CHUNKED ? int(blockIdx.y) * D : 0;  // first o column
  const int64_t q0 = int64_t(blockIdx.x) * kBQ;

  if constexpr (!CHUNKED) load_t<D, kBQ>(Qt, kLdq, q, q0, lq, 0, d, tid);

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
    __syncthreads();  // Qt written; the last tile's Qt, Kt, Vs, Pt all read
    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
    if constexpr (!CHUNKED) {
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int j = i / D, c = i % D;
        const bool ok = k0 + j < lk && c < d;
        const int64_t g = int64_t(k0 + j) * d + c;
        Kt[c * kLdk + j] = ok ? to_f32(k[g]) : 0.f;
        Vs[j * D + c] = ok ? to_f32(v[g]) : 0.f;
      }
      __syncthreads();
      add_scores<D>(s, Qt, Kt, r0, tx);
    } else {
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int j = i / D, c = i % D;
        Vs[j * D + c] = (k0 + j < lk && cb + c < d)
                            ? to_f32(v[int64_t(k0 + j) * d + cb + c])
                            : 0.f;
      }
      for (int dc = 0; dc < d; dc += D) {
        if (dc > 0) __syncthreads();  // the last chunk's Qt and Kt read
        load_t<D, kBQ>(Qt, kLdq, q, q0, lq, dc, d, tid);
        load_t<D, kBK>(Kt, kLdk, k, k0, lk, dc, d, tid);
        __syncthreads();
        add_scores<D>(s, Qt, Kt, r0, tx);
      }
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
      if constexpr (CPT % 4 == 0) {
#pragma unroll
        for (int e = 0; e < CPT; e += 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(&Vs[j * D + c0 + e]);
          vb[e] = t.x; vb[e + 1] = t.y; vb[e + 2] = t.z; vb[e + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < CPT; e += 2) {
          const float2 t =
              *reinterpret_cast<const float2*>(&Vs[j * D + c0 + e]);
          vb[e] = t.x; vb[e + 1] = t.y;
        }
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
      if (c < d) o_io[r * d + c] = acc[ii][e];
    }
  }
}

template <typename T, int D, bool CHUNKED>
int launch(const void* q, const void* k, const void* v, const float* m,
           const float* l, float* m_out, float* l_out, float* o, int lq,
           int lk, int d, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  // Above 48 KB of dynamic shared memory needs this opt-in, per device.
  const cudaError_t e = cudaFuncSetAttribute(
      ring_fold_kernel<T, D, CHUNKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(unsigned((lq + kBQ - 1) / kBQ), unsigned((d + D - 1) / D));
  ring_fold_kernel<T, D, CHUNKED><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), m, l, m_out, l_out, o, lq, lk, d, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const float* m,
             const float* l, float* m_out, float* l_out, float* o, int lq,
             int lk, int d, float scale, cudaStream_t s) {
  if (d <= 32) {
    return launch<T, 32, false>(q, k, v, m, l, m_out, l_out, o, lq, lk, d,
                                scale, s);
  }
  if (d <= 64) {
    return launch<T, 64, false>(q, k, v, m, l, m_out, l_out, o, lq, lk, d,
                                scale, s);
  }
  if (d <= 128) {
    return launch<T, 128, false>(q, k, v, m, l, m_out, l_out, o, lq, lk, d,
                                 scale, s);
  }
  return launch<T, 128, true>(q, k, v, m, l, m_out, l_out, o, lq, lk, d,
                              scale, s);
}

}  // namespace

extern "C" int tbus_ring_fold(const void* q, const void* k, const void* v,
                              const void* m, const void* l, void* m_out,
                              void* l_out, void* o, int lq, int lk, int d,
                              float scale, int dtype, void* stream) {
  if (lq <= 0 || lk <= 0 || d <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* of = static_cast<float*>(o);
  if (dtype == 0) {
    return launch_d<float>(q, k, v, mf, lf, mo, lo, of, lq, lk, d, scale, s);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(q, k, v, mf, lf, mo, lo, of, lq, lk, d,
                                   scale, s);
  }
  return int(cudaErrorInvalidValue);
}
