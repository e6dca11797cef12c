#include "cuda_runtime.h"

#include <dlfcn.h>
#include <string.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdlib>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#include "base/logging.h"
#include "base/time.h"
#include "fiber/sync.h"
#include "rpc/controller.h"
#include "rpc/errors.h"
#include "rpc/server.h"

namespace tbus {
namespace cuda {

namespace {

// ---- programs ----

bool parse_dotbench(const std::string& transform, unsigned long* n,
                    unsigned long* t) {
  const char* p = transform.c_str() + 8;
  char* end = nullptr;
  *n = strtoul(p, &end, 10);
  *t = 0;
  if (end != nullptr && *end == 'x') *t = strtoul(end + 1, nullptr, 10);
  return !(*n < 128 || *n > 16384 || *t < 1 || *t > 256);
}

// Round to nearest even at bf16's 8 significant bits, as
// __float2bfloat16_rn does (NaN stays NaN).
float bf16_round(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return f;
  u += 0x7FFFu + ((u >> 16) & 1u);
  u &= 0xFFFF0000u;
  memcpy(&f, &u, 4);
  return f;
}

// dotbench's bf16(1/N).
float dotbench_inverse(unsigned long n) {
  return bf16_round(float(1.0 / double(n)));
}

// Parses `transform` at length `len`; false with the reference's refusal
// text in *why.
bool DescribeProgram(const std::string& transform, size_t len,
                     ProgramDesc* desc, std::string* why) {
  ProgramDesc d;
  d.len = len;
  if (transform == "echo" || transform == "xor255" || transform == "incr") {
    d.kernel = kU8Transform;
    d.op = transform == "echo" ? 0 : transform == "xor255" ? 1 : 2;
  } else if (transform == "dot128") {
    if (len % 512 != 0 || len == 0) {
      *why = "dot128 needs a payload length that is a positive multiple "
             "of 512 (f32[k,128] rows); got " + std::to_string(len);
      return false;
    }
    d.kernel = kDot128;
  } else if (transform.rfind("dotbench", 0) == 0) {
    if (!parse_dotbench(transform, &d.n, &d.t)) {
      *why = "dotbench wants dotbench<N>x<T>, 128<=N<=16384, 1<=T<=256; "
             "got " + transform;
      return false;
    }
    if (len != 4) {
      *why = "dotbench takes a 4-byte f32 seed payload; got length " +
             std::to_string(len);
      return false;
    }
    d.kernel = kDotbench;
  } else {
    *why = "unknown transform " + transform;
    return false;
  }
  *desc = d;
  return true;
}

// ---- the CPU backend: the programs as plain loops ----

struct CpuPlan {
  ProgramDesc desc;
  std::vector<char> in, out;
};

void cpu_u8(CpuPlan& p) {
  const size_t n = p.desc.len;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(p.in.data());
  uint8_t* dst = reinterpret_cast<uint8_t*>(p.out.data());
  for (size_t i = 0; i < n; ++i) {
    dst[i] = p.desc.op == 1 ? uint8_t(src[i] ^ 0xFF)
             : p.desc.op == 2 ? uint8_t(src[i] + 1)
                              : src[i];
  }
}

// y[r, j] = sum_i x[r, i] * W[i, j], fused multiply-adds over i in order
// (the kernel's order, so the CUDA and CPU backends agree bit for bit).
void cpu_dot128(CpuPlan& p) {
  float w[128 * 128];
  for (int i = 0; i < 128; ++i) {
    for (int j = 0; j < 128; ++j) {
      w[i * 128 + j] = float((3 * i + 5 * j) % 11 - 5) * 0.125f;
    }
  }
  const size_t k = p.desc.len / 512;
  std::vector<float> x(k * 128), y(k * 128);
  memcpy(x.data(), p.in.data(), k * 512);
  for (size_t r = 0; r < k; ++r) {
    for (int j = 0; j < 128; ++j) {
      float acc = 0.f;
      for (int i = 0; i < 128; ++i) {
        acc = std::fma(x[r * 128 + i], w[i * 128 + j], acc);
      }
      y[r * 128 + j] = acc;
    }
  }
  memcpy(p.out.data(), y.data(), k * 512);
}

// The chain of dotbench<N>x<T>, each product summed in f32 over k in
// order and rounded once; the checksum summed in f32 row by row.
void cpu_dotbench(CpuPlan& p) {
  const size_t n = p.desc.n;
  float seed;
  memcpy(&seed, p.in.data(), 4);
  const float s = bf16_round(seed);
  std::vector<float> w(n * n), v(n * n), nv(n * n);
  for (size_t i = 0; i < n; ++i) {
    for (size_t j = 0; j < n; ++j) {
      w[i * n + j] = float(long((3 * i + 5 * j) % 11) - 5) * 0.125f;
      v[i * n + j] =
          bf16_round(bf16_round(float(long((i + j) % 7) - 3) * 0.125f) + s);
    }
  }
  const float inv = dotbench_inverse(n);
  std::vector<float> acc(n);
  for (unsigned long step = 0; step < p.desc.t; ++step) {
    for (size_t i = 0; i < n; ++i) {
      std::fill(acc.begin(), acc.end(), 0.f);
      for (size_t k = 0; k < n; ++k) {
        const float a = v[i * n + k];
        const float* wr = &w[k * n];
        for (size_t j = 0; j < n; ++j) acc[j] += a * wr[j];
      }
      for (size_t j = 0; j < n; ++j) {
        nv[i * n + j] = bf16_round(bf16_round(acc[j]) * inv);
      }
    }
    v.swap(nv);
  }
  float sum = 0.f;
  for (size_t e = 0; e < n * n; ++e) sum += v[e];
  const float out = bf16_round(sum);
  memcpy(p.out.data(), &out, 4);
}

class CpuBackend final : public DeviceBackend {
 public:
  const char* platform() const override { return "cpu"; }
  std::string device_name() const override { return "host CPU"; }
  void* NewPlan(const ProgramDesc& desc, std::string*) override {
    auto* p = new CpuPlan;
    p->desc = desc;
    p->in.resize(desc.len);
    p->out.resize(desc.len);
    return p;
  }
  char* Staging(void* plan, bool output) override {
    auto* p = static_cast<CpuPlan*>(plan);
    return output ? p->out.data() : p->in.data();
  }
  int Run(void* plan, std::string*) override {
    // Per-execution latency for lifetime tests (deadline abandonment,
    // the queue bound), as TBUS_PJRT_FAKE_DELAY_US is for the fake.
    const char* delay = getenv("TBUS_TORCH_DEVICE_DELAY_US");
    if (delay != nullptr && atoll(delay) > 0) usleep(useconds_t(atoll(delay)));
    auto* p = static_cast<CpuPlan*>(plan);
    if (p->desc.kernel == kDot128) {
      cpu_dot128(*p);
    } else if (p->desc.kernel == kDotbench) {
      cpu_dotbench(*p);
    } else {
      cpu_u8(*p);
    }
    return 0;
  }
  long long Launches(int) const override { return 0; }
  void ResetLaunches() override {}
};

// ---- the CUDA backend, loaded from cuda_backend.cu's library ----

class CudaBackend final : public DeviceBackend {
 public:
  static std::unique_ptr<CudaBackend> Open(const char* so_path,
                                           std::string* why) {
    if (so_path == nullptr || so_path[0] == '\0') {
      *why = "no CUDA backend library given";
      return nullptr;
    }
    void* h = dlopen(so_path, RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) {
      *why = std::string("dlopen(") + so_path + "): " + dlerror();
      return nullptr;
    }
    std::unique_ptr<CudaBackend> b(new CudaBackend);
    bool ok = true;
    auto sym = [&](const char* name) {
      void* f = dlsym(h, name);
      if (f == nullptr) ok = false;
      return f;
    };
    b->open_ = reinterpret_cast<OpenFn>(sym("tbus_cuda_backend_open"));
    b->plan_ = reinterpret_cast<PlanFn>(sym("tbus_cuda_backend_plan"));
    b->staging_ =
        reinterpret_cast<StagingFn>(sym("tbus_cuda_backend_staging"));
    b->run_ = reinterpret_cast<RunFn>(sym("tbus_cuda_backend_run"));
    b->launches_ =
        reinterpret_cast<LaunchesFn>(sym("tbus_cuda_backend_launches"));
    b->reset_ =
        reinterpret_cast<ResetFn>(sym("tbus_cuda_backend_reset_launches"));
    if (!ok) {
      *why = std::string(so_path) + " lacks the tbus_cuda_backend_* entries";
      return nullptr;
    }
    char info[256] = {0};
    if (b->open_(info, sizeof(info)) != 0) {
      *why = info;
      return nullptr;
    }
    b->device_ = info;
    return b;
  }

  const char* platform() const override { return "cuda"; }
  std::string device_name() const override { return device_; }
  void* NewPlan(const ProgramDesc& d, std::string* why) override {
    char err[256] = {0};
    void* p = plan_(d.kernel, d.op, (long long)d.len, (long long)d.n,
                    (long long)d.t, err, sizeof(err));
    if (p == nullptr) *why = err;
    return p;
  }
  char* Staging(void* plan, bool output) override {
    return staging_(plan, output ? 1 : 0);
  }
  int Run(void* plan, std::string* why) override {
    char err[256] = {0};
    const int rc = run_(plan, err, sizeof(err));
    if (rc != 0) *why = err;
    return rc;
  }
  long long Launches(int kernel) const override { return launches_(kernel); }
  void ResetLaunches() override { reset_(); }

 private:
  using OpenFn = int (*)(char*, int);
  using PlanFn = void* (*)(int, int, long long, long long, long long,
                           char*, int);
  using StagingFn = char* (*)(void*, int);
  using RunFn = int (*)(void*, char*, int);
  using LaunchesFn = long long (*)(int);
  using ResetFn = void (*)();
  OpenFn open_ = nullptr;
  PlanFn plan_ = nullptr;
  StagingFn staging_ = nullptr;
  RunFn run_ = nullptr;
  LaunchesFn launches_ = nullptr;
  ResetFn reset_ = nullptr;
  std::string device_;
};

// ---- the runtime ----

struct Program {
  ProgramDesc desc;
  void* plan = nullptr;
  // Keyed (serving step) programs reply with their whole output;
  // (transform, length) programs with as many bytes as the input had.
  bool whole_output = false;
};

// Caller-aliased output (RunProgramInto): once `abandoned` is set under
// mu, the job never touches the caller's block.
struct AliasGuard {
  std::mutex mu;
  bool abandoned = false;
  size_t produced = 0;
};

struct Job {
  static constexpr int kResolveOnDispatch = -2;
  int handle = -1;
  std::string transform;
  size_t plen = 0;
  IOBuf input;
  char* out_block = nullptr;
  size_t out_cap = 0;
  std::shared_ptr<AliasGuard> guard;
  CudaRuntime::Callback cb;
};

struct Runtime {
  std::unique_ptr<DeviceBackend> backend;
  std::string device;  // what Init was asked for

  mutable std::mutex mu;  // programs + stats; held while a plan is made
  std::vector<Program> programs;
  std::map<std::pair<std::string, size_t>, int> index;
  std::map<std::string, int> key_index;
  CudaStats st;

  // The dispatch thread and its bounded queue.
  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<Job> q;
  bool thread_started = false;
};

Runtime* g_rt = nullptr;  // set once by Init; never destroyed

constexpr size_t kMaxQueue = 128;

// Under rt->mu. Returns the new handle, or -1 with *why.
int add_program(Runtime* rt, const ProgramDesc& desc, bool whole_output,
                std::string* why) {
  Program p;
  p.desc = desc;
  p.whole_output = whole_output;
  p.plan = rt->backend->NewPlan(desc, why);
  if (p.plan == nullptr) return -1;
  rt->programs.push_back(p);
  ++rt->st.plans;
  return int(rt->programs.size()) - 1;
}

// One device round trip, on the dispatch thread.
int execute_job(Runtime* rt, const Program& prog, const Job& job,
                IOBuf* output, std::string* why) {
  const size_t in_len = job.input.size();
  const size_t plen = prog.desc.len;
  if (in_len > plen) {
    *why = "input of " + std::to_string(in_len) +
           " bytes is longer than its program (" + std::to_string(plen) + ")";
    return EREQUEST;
  }
  if (job.out_block != nullptr && job.out_cap < plen) {
    *why = "output block too small";
    return EREQUEST;
  }
  char* in = rt->backend->Staging(prog.plan, false);
  job.input.copy_to(in, in_len);
  if (plen > in_len) memset(in + in_len, 0, plen - in_len);
  if (rt->backend->Run(prog.plan, why) != 0) return EINTERNAL;
  const char* out = rt->backend->Staging(prog.plan, true);
  const size_t expose = prog.whole_output ? plen : in_len;
  if (job.guard != nullptr) {
    std::lock_guard<std::mutex> g(job.guard->mu);
    if (!job.guard->abandoned) {  // else the caller's block may be reused
      memcpy(job.out_block, out, plen);
      job.guard->produced = expose;
    }
  } else {
    output->append(out, expose);
  }
  std::lock_guard<std::mutex> g(rt->mu);
  ++rt->st.executions;
  rt->st.h2d_bytes += (long long)plen;
  rt->st.d2h_bytes += (long long)plen;
  return 0;
}

void dispatch_main() {
  Runtime* rt = g_rt;
  while (true) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(rt->q_mu);
      rt->q_cv.wait(lk, [rt] { return !rt->q.empty(); });
      job = std::move(rt->q.front());
      rt->q.pop_front();
    }
    std::string why;
    if (job.handle == Job::kResolveOnDispatch) {
      job.handle =
          CudaRuntime::Get()->EnsureU8Program(job.transform, job.plen, &why);
    }
    Program prog;
    bool valid = false;
    {
      std::lock_guard<std::mutex> g(rt->mu);
      if (job.handle >= 0 && size_t(job.handle) < rt->programs.size()) {
        prog = rt->programs[size_t(job.handle)];
        valid = true;
      }
    }
    IOBuf out;
    int rc = EREQUEST;
    if (valid) {
      rc = execute_job(rt, prog, job, &out, &why);
    } else if (why.empty()) {
      why = "no such program";
    }
    if (rc != 0) {
      std::lock_guard<std::mutex> g(rt->mu);
      ++rt->st.errors;
    }
    job.cb(rc, std::move(out), why);
  }
}

void EnqueueJob(Runtime* rt, Job j) {
  bool overcrowded = false;
  CudaRuntime::Callback cb = j.cb;  // kept for the overcrowded path
  {
    std::lock_guard<std::mutex> lk(rt->q_mu);
    if (!rt->thread_started) {
      rt->thread_started = true;
      std::thread(dispatch_main).detach();
    }
    if (rt->q.size() >= kMaxQueue) {
      overcrowded = true;
    } else {
      rt->q.push_back(std::move(j));
    }
  }
  if (overcrowded) {
    {
      std::lock_guard<std::mutex> g(rt->mu);
      ++rt->st.overcrowded;
      ++rt->st.errors;
    }
    cb(EOVERCROWDED, IOBuf(), "device queue full");
    return;
  }
  rt->q_cv.notify_one();
}

}  // namespace

int CudaRuntime::Init(const std::string& device, const char* backend_so,
                      std::string* why) {
  static std::mutex init_mu;
  std::lock_guard<std::mutex> g(init_mu);
  if (g_rt != nullptr) {
    if (g_rt->device == device) return 0;
    *why = "the device runtime is already up on " + g_rt->device;
    return -1;
  }
  auto rt = std::make_unique<Runtime>();
  rt->device = device;
  if (device == "cuda") {
    rt->backend = CudaBackend::Open(backend_so, why);
    if (rt->backend == nullptr) return -1;
  } else if (device == "cpu") {
    rt->backend.reset(new CpuBackend);
  } else {
    *why = "unknown device " + device + " (want cuda or cpu)";
    return -1;
  }
  rt->st.available = true;
  rt->st.platform = rt->backend->platform();
  rt->st.device = rt->backend->device_name();
  g_rt = rt.release();
  LOG(INFO) << "cuda runtime: up on " << g_rt->st.platform << " ("
            << g_rt->st.device << ")";
  return 0;
}

CudaRuntime* CudaRuntime::Get() {
  static CudaRuntime instance;  // stateless: all state lives in g_rt
  return g_rt != nullptr ? &instance : nullptr;
}

int CudaRuntime::EnsureU8Program(const std::string& transform, size_t len,
                                 std::string* why) {
  Runtime* rt = g_rt;
  std::string local;
  if (why == nullptr) why = &local;
  if (rt == nullptr) {
    *why = "cuda runtime not initialized";
    return -1;
  }
  std::lock_guard<std::mutex> g(rt->mu);
  auto it = rt->index.find({transform, len});
  if (it != rt->index.end()) return it->second;
  ProgramDesc desc;
  if (!DescribeProgram(transform, len, &desc, why)) return -1;
  const int handle = add_program(rt, desc, false, why);
  if (handle >= 0) rt->index[{transform, len}] = handle;
  return handle;
}

int CudaRuntime::EnsureProgram(const std::string& key,
                               const std::string& transform, size_t n,
                               std::string* why) {
  Runtime* rt = g_rt;
  std::string local;
  if (why == nullptr) why = &local;
  if (rt == nullptr) {
    *why = "cuda runtime not initialized";
    return -1;
  }
  std::lock_guard<std::mutex> g(rt->mu);
  auto it = rt->key_index.find(key);
  if (it != rt->key_index.end()) return it->second;
  ProgramDesc desc;
  if (!DescribeProgram(transform, n, &desc, why)) return -1;
  if (desc.kernel != kU8Transform) {
    *why = "a keyed program must be elementwise; got " + transform;
    return -1;
  }
  const int handle = add_program(rt, desc, true, why);
  if (handle >= 0) rt->key_index[key] = handle;
  return handle;
}

int CudaRuntime::RunU8(int handle, const IOBuf& input, IOBuf* output,
                       int64_t timeout_ms) {
  Runtime* rt = g_rt;
  if (rt == nullptr) return EINTERNAL;
  struct Sync {
    fiber::CountdownEvent done{1};
    std::mutex mu;
    int rc = EINTERNAL;
    IOBuf out;
  };
  auto s = std::make_shared<Sync>();
  Job j;
  j.handle = handle;
  j.input = input;
  j.cb = [s](int rc, IOBuf out, const std::string&) {
    {
      std::lock_guard<std::mutex> g(s->mu);
      s->rc = rc;
      s->out = std::move(out);
    }
    s->done.signal();
  };
  EnqueueJob(rt, std::move(j));
  const int64_t abstime_us =
      timeout_ms > 0 ? monotonic_time_us() + timeout_ms * 1000 : -1;
  if (s->done.wait(abstime_us) != 0) {
    // The job runs on; its late result is dropped (the shared state
    // outlives us both).
    return ERPCTIMEDOUT;
  }
  std::lock_guard<std::mutex> g(s->mu);
  if (s->rc == 0) output->append(std::move(s->out));
  return s->rc;
}

int CudaRuntime::RunProgramInto(int handle, const IOBuf& input,
                                void* out_block, size_t out_cap,
                                size_t* out_len, int64_t timeout_ms) {
  Runtime* rt = g_rt;
  if (rt == nullptr || out_block == nullptr) return EINTERNAL;
  auto guard = std::make_shared<AliasGuard>();
  struct Sync {
    fiber::CountdownEvent done{1};
    std::atomic<int> rc{EINTERNAL};
  };
  auto s = std::make_shared<Sync>();
  Job j;
  j.handle = handle;
  j.input = input;
  j.out_block = static_cast<char*>(out_block);
  j.out_cap = out_cap;
  j.guard = guard;
  j.cb = [s](int rc, IOBuf, const std::string&) {
    s->rc.store(rc, std::memory_order_release);
    s->done.signal();
  };
  EnqueueJob(rt, std::move(j));
  const int64_t abstime_us =
      timeout_ms > 0 ? monotonic_time_us() + timeout_ms * 1000 : -1;
  if (s->done.wait(abstime_us) != 0) {
    // Mark the job abandoned UNDER the guard: once this lands, the
    // dispatch thread drops the late result and never writes the block.
    std::lock_guard<std::mutex> g(guard->mu);
    guard->abandoned = true;
    return ERPCTIMEDOUT;
  }
  const int rc = s->rc.load(std::memory_order_acquire);
  if (rc == 0 && out_len != nullptr) {
    std::lock_guard<std::mutex> g(guard->mu);
    *out_len = guard->produced;
  }
  return rc;
}

void CudaRuntime::SubmitU8Transform(const std::string& transform,
                                    size_t plen, IOBuf input, Callback cb) {
  Runtime* rt = g_rt;
  if (rt == nullptr) {
    cb(EINTERNAL, IOBuf(), "cuda runtime not initialized");
    return;
  }
  Job j;
  j.handle = Job::kResolveOnDispatch;
  j.transform = transform;
  j.plen = plen;
  j.input = std::move(input);
  j.cb = std::move(cb);
  EnqueueJob(rt, std::move(j));
}

CudaStats CudaRuntime::stats() const {
  Runtime* rt = g_rt;
  if (rt == nullptr) return CudaStats();
  std::lock_guard<std::mutex> g(rt->mu);
  CudaStats st = rt->st;
  for (int k = 0; k < kKernels; ++k) st.launches[k] = rt->backend->Launches(k);
  return st;
}

void CudaRuntime::ResetLaunches() {
  Runtime* rt = g_rt;
  if (rt != nullptr) rt->backend->ResetLaunches();
}

size_t DeviceLenClass(size_t n) {
  if (n <= 128) return 128;
  size_t p = 128;
  while (p < n) {
    if (p + p / 2 >= n) return p + p / 2;
    p *= 2;
  }
  return p;
}

int AddDeviceMethod(::tbus::Server* s, const std::string& service,
                    const std::string& method,
                    const std::string& transform) {
  return s->AddMethod(
      service, method,
      [transform](Controller* cntl, const IOBuf& req, IOBuf* resp,
                  std::function<void()> done) {
        CudaRuntime* rt = CudaRuntime::Get();
        if (rt == nullptr) {
          cntl->SetFailed(EINTERNAL, "cuda runtime not initialized");
          done();
          return;
        }
        // dotbench is exact-length (its program takes the 4-byte seed);
        // everything else pads to its length class, so the plan cache
        // stays small. Plan and round trip both run on the dispatch
        // thread: this handler returns at once.
        const size_t plen = transform.rfind("dotbench", 0) == 0
                                ? req.size()
                                : DeviceLenClass(req.size());
        rt->SubmitU8Transform(
            transform, plen, req,
            [cntl, resp, done](int rc, IOBuf out, const std::string& why) {
              if (rc != 0) {
                cntl->SetFailed(rc, why.empty() ? "device execution failed"
                                                : why);
              } else {
                resp->append(std::move(out));
              }
              done();
            });
      });
}

}  // namespace cuda
}  // namespace tbus
