// The CUDA backend of the port's device runtime (cuda_runtime.cc), built
// with nvcc and loaded by CudaRuntime::Init("cuda") alone. Plain C
// interface (tbus_cuda_backend_*), called from the runtime's one dispatch
// thread.
//
// One stream, opened on the first card. Each program gets its plan once:
// device buffers for its input and output, pinned host staging for both
// (cudaHostAlloc, owned here and reused by every run of the program), and
// for dot128 its bf16 weight scratch (filled once, here), for dotbench
// its padded bf16 scratch. A run is put (H2D of each input
// segment) -> exec (the kernel) -> get (D2H of each output segment) on
// that stream, then a synchronise; the kernels are device_programs.cu's,
// launched from C++ with no Python on the path. A host pointer given to
// put or get is the plan's staging buffer or a range the runtime
// registered with cudaHostRegister (tbus_cuda_backend_host_register), so
// every copy is a true asynchronous DMA. Each launch that the device
// accepts adds one to its kernel's count. Without a card, open fails and
// says so: nothing here runs on the CPU.

#include <cuda_runtime.h>
#include <stdio.h>
#include <string.h>

#include <atomic>

extern "C" {
int tbus_u8_transform(const void* in, void* out, long long n, int op,
                      void* stream);
long long tbus_dot128_weight_bytes(void);
int tbus_dot128_weight(void* w, void* stream);
int tbus_dot128(const void* x, void* y, long long k, const void* w,
                void* stream);
long long tbus_dotbench_padded(long long n);
long long tbus_dotbench_partial_bytes(void);
int tbus_dotbench(const void* seed, void* wt, void* v0, void* v1,
                  void* partial, void* out, long long n, long long t,
                  float inv, void* stream);
int tbus_fanout(const void* in, void* out, long long n, long long bucket,
                int scatter, int builtin, void* stream);
}

namespace {

enum Kernel {
  kU8Transform = 0,
  kDot128 = 1,
  kDotbench = 2,
  kFanout = 3,
  kKernels = 4
};

cudaStream_t g_stream = nullptr;
std::atomic<long long> g_launches[kKernels];

struct Plan {
  int kernel = 0, op = 0, scatter = 0;
  long long len = 0, out_len = 0, n = 0, t = 0, bucket = 0;
  float inv = 0.f;
  void* d_in = nullptr;
  void* d_out = nullptr;
  char* h_in = nullptr;
  char* h_out = nullptr;
  void* wt = nullptr;  // dot128's weight, dotbench's Wt
  void* v0 = nullptr;
  void* v1 = nullptr;
  void* partial = nullptr;
};

bool failed(cudaError_t e, const char* what, char* err, int cap) {
  if (e == cudaSuccess) return false;
  snprintf(err, size_t(cap), "%s: CUDA error %d (%s)", what, int(e),
           cudaGetErrorString(e));
  return true;
}

// bf16(1/N), rounded to nearest even as the device rounds.
float bf16_inverse(long long n) {
  float f = float(1.0 / double(n));
  unsigned u;
  memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  u &= 0xFFFF0000u;
  memcpy(&f, &u, 4);
  return f;
}

void free_plan(Plan* p) {
  cudaFree(p->d_in);
  cudaFree(p->d_out);
  cudaFreeHost(p->h_in);
  cudaFreeHost(p->h_out);
  cudaFree(p->wt);
  cudaFree(p->v0);
  cudaFree(p->v1);
  cudaFree(p->partial);
  delete p;
}

}  // namespace

extern "C" {

// Opens the first card and the backend's stream. Writes the card's name
// (or, on failure, why) into info; returns 0 on success.
int tbus_cuda_backend_open(char* info, int cap) {
  int count = 0;
  cudaError_t e = cudaGetDeviceCount(&count);
  if (e != cudaSuccess || count == 0) {
    snprintf(info, size_t(cap), "no CUDA device: %s",
             e != cudaSuccess ? cudaGetErrorString(e) : "none found");
    return -1;
  }
  if (failed(cudaSetDevice(0), "cudaSetDevice", info, cap)) return -1;
  if (g_stream == nullptr &&
      failed(cudaStreamCreateWithFlags(&g_stream, cudaStreamNonBlocking),
             "cudaStreamCreate", info, cap)) {
    return -1;
  }
  cudaDeviceProp prop;
  if (failed(cudaGetDeviceProperties(&prop, 0), "cudaGetDeviceProperties",
             info, cap)) {
    return -1;
  }
  snprintf(info, size_t(cap), "%s", prop.name);
  return 0;
}

// A program of len bytes in and out_len bytes out (a dotbench<n>x<t>
// takes 4 and gives 4; a fan-out over n peers of bucket-byte rows takes
// bucket, or n * bucket when scatter is set, and gives n * bucket).
void* tbus_cuda_backend_plan(int kernel, int op, long long len,
                             long long out_len, long long n, long long t,
                             long long bucket, int scatter, char* err,
                             int cap) {
  cudaSetDevice(0);
  Plan* p = new Plan;
  p->kernel = kernel;
  p->op = op;
  p->len = len;
  p->out_len = out_len;
  p->n = n;
  p->t = t;
  p->bucket = bucket;
  p->scatter = scatter;
  const size_t in_bytes = size_t(len > 0 ? len : 1);
  const size_t out_bytes = size_t(out_len > 0 ? out_len : 1);
  bool bad =
      failed(cudaMalloc(&p->d_in, in_bytes), "cudaMalloc", err, cap) ||
      failed(cudaMalloc(&p->d_out, out_bytes), "cudaMalloc", err, cap) ||
      failed(cudaHostAlloc(reinterpret_cast<void**>(&p->h_in), in_bytes,
                           cudaHostAllocDefault),
             "cudaHostAlloc", err, cap) ||
      failed(cudaHostAlloc(reinterpret_cast<void**>(&p->h_out), out_bytes,
                           cudaHostAllocDefault),
             "cudaHostAlloc", err, cap);
  if (!bad && kernel == kDotbench) {
    const long long np = tbus_dotbench_padded(n);
    const size_t mat = size_t(np) * size_t(np) * 2;
    p->inv = bf16_inverse(n);
    bad = failed(cudaMalloc(&p->wt, mat), "cudaMalloc", err, cap) ||
          failed(cudaMalloc(&p->v0, mat), "cudaMalloc", err, cap) ||
          failed(cudaMalloc(&p->v1, mat), "cudaMalloc", err, cap) ||
          failed(cudaMalloc(&p->partial,
                            size_t(tbus_dotbench_partial_bytes())),
                 "cudaMalloc", err, cap);
  }
  if (!bad && kernel == kDot128) {
    bad = failed(cudaMalloc(&p->wt, size_t(tbus_dot128_weight_bytes())),
                 "cudaMalloc", err, cap) ||
          failed(cudaError_t(tbus_dot128_weight(p->wt, g_stream)),
                 "dot128 weight", err, cap);
  }
  if (bad) {
    free_plan(p);
    return nullptr;
  }
  return p;
}

char* tbus_cuda_backend_staging(void* plan, int output) {
  Plan* p = static_cast<Plan*>(plan);
  return output ? p->h_out : p->h_in;
}

// Queues the H2D of len bytes from host src to the program's input at
// off. src is pinned: staging or a cudaHostRegister'ed range.
int tbus_cuda_backend_put(void* plan, long long off, const char* src,
                          long long len, char* err, int cap) {
  Plan* p = static_cast<Plan*>(plan);
  if (off < 0 || len < 0 || off + len > p->len) {
    snprintf(err, size_t(cap), "put [%lld, %lld) outside the input", off,
             off + len);
    return -1;
  }
  if (len == 0) return 0;
  return failed(cudaMemcpyAsync(static_cast<char*>(p->d_in) + off, src,
                                size_t(len), cudaMemcpyHostToDevice,
                                g_stream),
                "H2D", err, cap)
             ? -1
             : 0;
}

// Launches the program; with wait, returns once it has finished.
int tbus_cuda_backend_exec(void* plan, int wait, char* err, int cap) {
  Plan* p = static_cast<Plan*>(plan);
  int rc;
  if (p->kernel == kDot128) {
    rc = tbus_dot128(p->d_in, p->d_out, p->len / 512, p->wt, g_stream);
  } else if (p->kernel == kDotbench) {
    rc = tbus_dotbench(p->d_in, p->wt, p->v0, p->v1, p->partial, p->d_out,
                       p->n, p->t, p->inv, g_stream);
  } else if (p->kernel == kFanout) {
    rc = tbus_fanout(p->d_in, p->d_out, p->n, p->bucket, p->scatter, p->op,
                     g_stream);
  } else {
    rc = tbus_u8_transform(p->d_in, p->d_out, p->len, p->op, g_stream);
  }
  if (failed(cudaError_t(rc), "kernel launch", err, cap)) return -1;
  g_launches[p->kernel].fetch_add(1, std::memory_order_relaxed);
  if (wait != 0 &&
      failed(cudaStreamSynchronize(g_stream), "synchronize", err, cap)) {
    return -1;
  }
  return 0;
}

// Queues the D2H of len bytes of the program's output at off into host
// dst (pinned, as for put).
int tbus_cuda_backend_get(void* plan, long long off, long long len,
                          char* dst, char* err, int cap) {
  Plan* p = static_cast<Plan*>(plan);
  if (off < 0 || len < 0 || off + len > p->out_len) {
    snprintf(err, size_t(cap), "get [%lld, %lld) outside the output", off,
             off + len);
    return -1;
  }
  if (len == 0) return 0;
  return failed(cudaMemcpyAsync(dst, static_cast<char*>(p->d_out) + off,
                                size_t(len), cudaMemcpyDeviceToHost,
                                g_stream),
                "D2H", err, cap)
             ? -1
             : 0;
}

int tbus_cuda_backend_sync(void* plan, char* err, int cap) {
  (void)plan;
  return failed(cudaStreamSynchronize(g_stream), "synchronize", err, cap)
             ? -1
             : 0;
}

// Page-locks [base, base + bytes) for the card's DMA. A peer's pool
// region is mapped read-only, which a plain cudaHostRegister refuses; it
// is then registered read-only where the card supports that
// (*read_only = 1: the card may read it, never write it). Returns 0, or
// -1 with err set: the range stays unregistered.
int tbus_cuda_backend_host_register(void* base, long long bytes,
                                    int* read_only, char* err, int cap) {
  cudaSetDevice(0);
  *read_only = 0;
  cudaError_t e = cudaHostRegister(base, size_t(bytes),
                                   cudaHostRegisterDefault);
  if (e == cudaSuccess) return 0;
  cudaGetLastError();  // clear the sticky-free error before retrying
  int ro_ok = 0;
  cudaDeviceGetAttribute(&ro_ok, cudaDevAttrHostRegisterReadOnlySupported,
                         0);
  if (ro_ok != 0) {
    const cudaError_t e2 = cudaHostRegister(base, size_t(bytes),
                                            cudaHostRegisterReadOnly);
    if (e2 == cudaSuccess) {
      *read_only = 1;
      return 0;
    }
    cudaGetLastError();
    snprintf(err, size_t(cap), "cudaHostRegister: %s; read-only: %s",
             cudaGetErrorString(e), cudaGetErrorString(e2));
    return -1;
  }
  snprintf(err, size_t(cap),
           "cudaHostRegister: %s (read-only registration unsupported)",
           cudaGetErrorString(e));
  return -1;
}

void tbus_cuda_backend_host_unregister(void* base) {
  cudaSetDevice(0);
  if (cudaHostUnregister(base) != cudaSuccess) cudaGetLastError();
}

long long tbus_cuda_backend_launches(int kernel) {
  return kernel >= 0 && kernel < kKernels
             ? g_launches[kernel].load(std::memory_order_relaxed)
             : 0;
}

void tbus_cuda_backend_reset_launches(void) {
  for (auto& c : g_launches) c.store(0, std::memory_order_relaxed);
}

}  // extern "C"
