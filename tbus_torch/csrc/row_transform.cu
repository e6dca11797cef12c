// Per-peer row transform of a lowered ParallelChannel fan-out, for Hopper.
//
// Replaces tbus/parallel/runtime.py:_row_transform (vmapped over the batch
// by _build_batch). For one mesh position `pos` that serves `rpp` peers,
// every input row u8[L] becomes rpp output rows:
//
//   out[b, r, c] = f(in[b, c], pos * rpp + r)   if 4 <= c < 4 + n_b
//                = in[b, c]                       otherwise
//
// where n_b is the little-endian u32 in bytes 0..3 of row b (read here, on
// the device) and f is the builtin: echo (identity), xor255 (c ^ 0xFF) or
// add_peer_index (c + (peer & 0xFF), mod 256). 4 + n wraps in u32 exactly
// as the reference's jnp.uint32 arithmetic does. The length prefix and the
// padding up to L pass through verbatim so the host can decode lengths.
//
// Bound: memory. The kernel reads B*L bytes and writes B*rpp*L bytes and
// does one or two integer operations per byte, so on an H100 (3.35 TB/s)
// its floor is (B*L + B*rpp*L) / 3.35e12 s. Design: one thread per 16-byte
// chunk of one input row (grid.x over chunks, grid.y over rows); the thread
// loads its chunk once with a 16-byte load, keeps it in registers and
// issues rpp 16-byte stores, one per peer row, so every byte of HBM traffic
// is the minimum the function needs. Neighbouring threads touch
// neighbouring 16-byte words, so loads and stores coalesce. The byte mask
// for the [4, 4+n) window is computed per 32-bit word; chunks wholly inside
// or outside the window (all but at most two per row) take the fast path.
//
// Interface: plain C, loaded with ctypes. L must be a multiple of 16 and
// both pointers 16-byte aligned (the wrapper checks). Launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Builtin : int { kEcho = 0, kXor255 = 1, kAddPeerIndex = 2 };

// Byte-select mask for the 4 bytes of the word starting at column `col`:
// 0xFF in byte j when 4 <= col + j < end.
__device__ __forceinline__ uint32_t window_mask(uint32_t col, uint32_t end) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t c = col + j;
    if (c >= 4u && c < end) m |= 0xFFu << (8 * j);
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
row_transform_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     int64_t L, int rpp, int pos, int builtin) {
  const int64_t b = blockIdx.y;
  const int64_t off = (int64_t(blockIdx.x) * kThreads + threadIdx.x) * 16;
  if (off >= L) return;
  const uint8_t* row = in + b * L;
  const uint32_t n = uint32_t(row[0]) | (uint32_t(row[1]) << 8) |
                     (uint32_t(row[2]) << 16) | (uint32_t(row[3]) << 24);
  const uint32_t end = 4u + n;  // wraps in u32, like the reference

  const uint4 v = *reinterpret_cast<const uint4*>(row + off);
  uint32_t x[4] = {v.x, v.y, v.z, v.w};

  // Chunk columns [off, off + 16); they fit in u32 since L < 2^32.
  const uint32_t lo = uint32_t(off);
  uint32_t m[4];
  const bool all_in = lo >= 4u && lo + 16u <= end && end >= 4u;
  const bool all_out = builtin == kEcho || end <= 4u || lo >= end ||
                       lo + 16u <= 4u;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    m[w] = all_in ? 0xFFFFFFFFu
                  : (all_out ? 0u : window_mask(lo + 4u * w, end));
  }

  uint8_t* dst = out + (b * rpp) * L + off;
  for (int r = 0; r < rpp; ++r, dst += L) {
    uint32_t y[4];
    if (builtin == kXor255) {
#pragma unroll
      for (int w = 0; w < 4; ++w) y[w] = x[w] ^ m[w];
    } else if (builtin == kAddPeerIndex) {
      const uint32_t k = uint32_t(pos * rpp + r) & 0xFFu;
      const uint32_t kk = k * 0x01010101u;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        y[w] = (__vadd4(x[w], kk) & m[w]) | (x[w] & ~m[w]);
      }
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) y[w] = x[w];
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(y[0], y[1], y[2], y[3]);
  }
}

}  // namespace

extern "C" int tbus_row_transform(const void* in, void* out, long long B,
                                  long long L, int rpp, int pos, int builtin,
                                  void* stream) {
  if (B <= 0 || L <= 0 || rpp <= 0) return int(cudaSuccess);
  const long long chunks = L / 16;
  dim3 grid(unsigned((chunks + kThreads - 1) / kThreads), unsigned(B));
  row_transform_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), L, rpp,
      pos, builtin);
  return int(cudaGetLastError());
}
