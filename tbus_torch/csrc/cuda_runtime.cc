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
#include <sstream>
#include <thread>
#include <vector>

#include "base/logging.h"
#include "base/time.h"
#include "fiber/sync.h"
#include "rpc/controller.h"
#include "rpc/errors.h"
#include "rpc/server.h"
#include "rpc/transport_hooks.h"
#include "tpu/block_pool.h"
#include "tpu/pjrt_dma.h"

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
  d.out_len = len;
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

// in and out stand for the device's buffers; stage_in and stage_out are
// the host staging buffers. Put only records where a segment comes from:
// the "device" reads it when the program runs, as a DMA engine would, so
// a donated range must stay mapped (pinned) until then.
struct CpuPlan {
  ProgramDesc desc;
  std::vector<char> in, out, stage_in, stage_out;
  struct Segment {
    size_t off;
    const char* src;
    size_t len;
  };
  std::vector<Segment> pending;
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

// K7's loop: row i of the n x bucket output is builtin(input row, i),
// the input row being the one input (broadcast) or row i (scatter).
void cpu_fanout(CpuPlan& p) {
  const ProgramDesc& d = p.desc;
  const uint8_t* in = reinterpret_cast<const uint8_t*>(p.in.data());
  uint8_t* out = reinterpret_cast<uint8_t*>(p.out.data());
  for (size_t i = 0; i < d.n; ++i) {
    const uint8_t* src = d.scatter ? in + i * d.bucket : in;
    uint8_t* dst = out + i * d.bucket;
    const uint8_t add = uint8_t(i & 0xFF);
    for (size_t j = 0; j < d.bucket; ++j) {
      dst[j] = d.op == 1 ? uint8_t(src[j] ^ 0xFF)
               : d.op == 2 ? uint8_t(src[j] + add)
                           : src[j];
    }
  }
}

class CpuBackend final : public DeviceBackend {
 public:
  const char* platform() const override { return "cpu"; }
  std::string device_name() const override { return "host CPU"; }
  void* NewPlan(const ProgramDesc& desc, std::string*) override {
    auto* p = new CpuPlan;
    p->desc = desc;
    p->in.resize(desc.len);
    p->stage_in.resize(desc.len);
    p->out.resize(desc.out_len);
    p->stage_out.resize(desc.out_len);
    return p;
  }
  char* Staging(void* plan, bool output) override {
    auto* p = static_cast<CpuPlan*>(plan);
    return output ? p->stage_out.data() : p->stage_in.data();
  }
  int Put(void* plan, size_t off, const char* src, size_t len,
          std::string*) override {
    static_cast<CpuPlan*>(plan)->pending.push_back({off, src, len});
    return 0;
  }
  int Exec(void* plan, bool, std::string*) override {
    // Per-execution latency for lifetime tests (deadline abandonment,
    // the queue bound, a peer dying mid-execution), as
    // TBUS_PJRT_FAKE_DELAY_US is for the fake. The inputs are read after
    // it, as a device's DMA would read them.
    const char* delay = getenv("TBUS_TORCH_DEVICE_DELAY_US");
    if (delay != nullptr && atoll(delay) > 0) usleep(useconds_t(atoll(delay)));
    auto* p = static_cast<CpuPlan*>(plan);
    for (const CpuPlan::Segment& s : p->pending) {
      memcpy(p->in.data() + s.off, s.src, s.len);
    }
    p->pending.clear();
    if (p->desc.kernel == kDot128) {
      cpu_dot128(*p);
    } else if (p->desc.kernel == kDotbench) {
      cpu_dotbench(*p);
    } else if (p->desc.kernel == kFanout) {
      cpu_fanout(*p);
    } else {
      cpu_u8(*p);
    }
    return 0;
  }
  int Get(void* plan, size_t off, size_t len, char* dst,
          std::string*) override {
    memcpy(dst, static_cast<CpuPlan*>(plan)->out.data() + off, len);
    return 0;
  }
  int Sync(void*, std::string*) override { return 0; }
  // The DMA table is this device's view of host memory, as it is the
  // reference's fake device's: a range the table pinned is reachable.
  bool Covers(const void*, size_t, bool) const override { return true; }
  HostRegisterStats host_register_stats() const override {
    return HostRegisterStats();
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
    b->put_ = reinterpret_cast<CopyInFn>(sym("tbus_cuda_backend_put"));
    b->exec_ = reinterpret_cast<ExecFn>(sym("tbus_cuda_backend_exec"));
    b->get_ = reinterpret_cast<CopyOutFn>(sym("tbus_cuda_backend_get"));
    b->sync_ = reinterpret_cast<SyncFn>(sym("tbus_cuda_backend_sync"));
    b->register_ = reinterpret_cast<RegisterFn>(
        sym("tbus_cuda_backend_host_register"));
    b->unregister_ = reinterpret_cast<UnregisterFn>(
        sym("tbus_cuda_backend_host_unregister"));
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
    void* p = plan_(d.kernel, d.op, (long long)d.len, (long long)d.out_len,
                    (long long)d.n, (long long)d.t, (long long)d.bucket,
                    d.scatter ? 1 : 0, err, sizeof(err));
    if (p == nullptr) *why = err;
    return p;
  }
  char* Staging(void* plan, bool output) override {
    return staging_(plan, output ? 1 : 0);
  }
  int Put(void* plan, size_t off, const char* src, size_t len,
          std::string* why) override {
    char err[256] = {0};
    const int rc = put_(plan, (long long)off, src, (long long)len, err,
                        sizeof(err));
    if (rc != 0) *why = err;
    return rc;
  }
  int Exec(void* plan, bool wait, std::string* why) override {
    char err[256] = {0};
    const int rc = exec_(plan, wait ? 1 : 0, err, sizeof(err));
    if (rc != 0) *why = err;
    return rc;
  }
  int Get(void* plan, size_t off, size_t len, char* dst,
          std::string* why) override {
    char err[256] = {0};
    const int rc = get_(plan, (long long)off, (long long)len, dst, err,
                        sizeof(err));
    if (rc != 0) *why = err;
    return rc;
  }
  int Sync(void* plan, std::string* why) override {
    char err[256] = {0};
    const int rc = sync_(plan, err, sizeof(err));
    if (rc != 0) *why = err;
    return rc;
  }
  bool Covers(const void* p, size_t len, bool write) const override {
    std::lock_guard<std::mutex> g(reg_mu_);
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    auto it = registered_.upper_bound(a);
    if (it == registered_.begin()) return false;
    --it;
    if (a < it->first || a + len > it->first + it->second.bytes) return false;
    return !(write && it->second.read_only);
  }
  HostRegisterStats host_register_stats() const override {
    std::lock_guard<std::mutex> g(reg_mu_);
    HostRegisterStats st = reg_stats_;
    st.ranges = (long long)registered_.size();
    return st;
  }
  long long Launches(int kernel) const override { return launches_(kernel); }
  void ResetLaunches() override { reset_(); }

  // The DMA table's backend (tpu::SetPjrtDmaBackend): page-locks the
  // range for the card with cudaHostRegister, read-only where the range
  // is a peer's read-only mapping and the card supports that. Returns
  // the handle (the base), or nullptr: the range then stays unbound, the
  // table still holds it, and Covers() says no, so every touch of it
  // stages, counted. Runs under the table's lock (and, for a peer region,
  // under the block pool's attach lock): registering a 16 MiB region
  // takes milliseconds, paid once per region, never on the dispatch
  // thread while it holds a job's guard.
  void* Register(void* base, size_t bytes) {
    char err[256] = {0};
    int read_only = 0;
    const int rc = register_(base, (long long)bytes, &read_only, err,
                             sizeof(err));
    std::lock_guard<std::mutex> g(reg_mu_);
    if (rc != 0) {
      ++reg_stats_.failures;
      LOG(WARNING) << "cudaHostRegister of " << bytes
                   << " bytes failed; the range stages: " << err;
      return nullptr;
    }
    registered_[reinterpret_cast<uintptr_t>(base)] = {bytes, read_only != 0};
    reg_stats_.bytes += (long long)bytes;
    if (read_only != 0) ++reg_stats_.read_only;
    return base;
  }
  void Unregister(void* handle) {
    {
      std::lock_guard<std::mutex> g(reg_mu_);
      auto it = registered_.find(reinterpret_cast<uintptr_t>(handle));
      if (it == registered_.end()) return;
      reg_stats_.bytes -= (long long)it->second.bytes;
      if (it->second.read_only) --reg_stats_.read_only;
      registered_.erase(it);
    }
    unregister_(handle);
  }

 private:
  using OpenFn = int (*)(char*, int);
  using PlanFn = void* (*)(int, int, long long, long long, long long,
                           long long, long long, int, char*, int);
  using StagingFn = char* (*)(void*, int);
  using CopyInFn = int (*)(void*, long long, const char*, long long, char*,
                           int);
  using ExecFn = int (*)(void*, int, char*, int);
  using CopyOutFn = int (*)(void*, long long, long long, char*, char*, int);
  using SyncFn = int (*)(void*, char*, int);
  using RegisterFn = int (*)(void*, long long, int*, char*, int);
  using UnregisterFn = void (*)(void*);
  using LaunchesFn = long long (*)(int);
  using ResetFn = void (*)();
  OpenFn open_ = nullptr;
  PlanFn plan_ = nullptr;
  StagingFn staging_ = nullptr;
  CopyInFn put_ = nullptr;
  ExecFn exec_ = nullptr;
  CopyOutFn get_ = nullptr;
  SyncFn sync_ = nullptr;
  RegisterFn register_ = nullptr;
  UnregisterFn unregister_ = nullptr;
  LaunchesFn launches_ = nullptr;
  ResetFn reset_ = nullptr;
  std::string device_;

  struct Range {
    size_t bytes;
    bool read_only;
  };
  mutable std::mutex reg_mu_;
  std::map<uintptr_t, Range> registered_;
  HostRegisterStats reg_stats_;
};

CudaBackend* g_cuda_backend = nullptr;  // set once by Init("cuda")

void* cuda_dma_map(void* base, size_t bytes) {
  return g_cuda_backend != nullptr ? g_cuda_backend->Register(base, bytes)
                                   : nullptr;
}

void cuda_dma_unmap(void* handle) {
  if (g_cuda_backend != nullptr) g_cuda_backend->Unregister(handle);
}

// ---- the runtime ----

struct Program {
  ProgramDesc desc;
  void* plan = nullptr;
  // Keyed (serving step, fan-out) programs reply with their whole output;
  // (transform, length) programs with as many bytes as the input had.
  bool whole_output = false;
};

// Caller-aliased output (RunProgramInto, RunProgramRows): once
// `abandoned` is set under mu, the job never touches the caller's rows.
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
  // One input (stride 0), or input row i at i * stride.
  std::vector<IOBuf> inputs;
  size_t stride = 0;
  // The caller's output rows; none: a fresh pool block for the reply.
  // row_bytes 0: rows[0] takes the whole output and holds out_cap bytes.
  std::vector<char*> rows;
  size_t row_bytes = 0;
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

// The execution's DMA pins, released when it ends (after Sync).
struct Pins {
  std::vector<tpu::PjrtDmaPin> held;
  ~Pins() {
    for (const tpu::PjrtDmaPin& p : held) tpu::PjrtDmaUnpin(p);
  }
  // True when the table pinned [p, p+len) AND the backend can DMA it in
  // place; the pin is then held to the end of the execution.
  bool Take(Runtime* rt, const char* p, size_t len, bool write) {
    tpu::PjrtDmaPin pin;
    if (!tpu::PjrtDmaPinRange(p, len, &pin)) return false;
    if (!rt->backend->Covers(p, len, write)) {
      tpu::PjrtDmaUnpin(pin);
      return false;
    }
    held.push_back(pin);
    return true;
  }
};

void free_pool_block(void* p) { tpu::pool_deallocate(p); }

// One device round trip, on the dispatch thread.
int execute_job(Runtime* rt, const Program& prog, const Job& job,
                IOBuf* output, std::string* why) {
  DeviceBackend* be = rt->backend.get();
  const size_t plen = prog.desc.len;
  const size_t olen = prog.desc.out_len;
  const size_t stride = job.stride != 0 ? job.stride : plen;
  if (job.inputs.empty() || job.inputs.size() * stride > plen) {
    *why = "input rows do not fit the program";
    return EREQUEST;
  }
  for (const IOBuf& in : job.inputs) {
    if (in.size() > stride) {
      *why = "input of " + std::to_string(in.size()) +
             " bytes is longer than its program (" + std::to_string(stride) +
             ")";
      return EREQUEST;
    }
  }
  std::vector<char*> rows = job.rows;
  size_t row_bytes = job.row_bytes;
  if (!rows.empty() && row_bytes == 0) {
    if (job.out_cap < olen) {
      *why = "output block too small";
      return EREQUEST;
    }
    row_bytes = olen;
  }
  if (!rows.empty() && rows.size() * row_bytes != olen) {
    *why = "output rows do not cover the program's output";
    return EREQUEST;
  }
  // The reply's own block, from the pool (registered when the table is
  // armed), taken before any guard is held: a pool that grows registers
  // its new region here.
  char* own = nullptr;
  if (rows.empty()) {
    own = static_cast<char*>(tpu::pool_allocate(olen > 0 ? olen : 1));
    if (own == nullptr) {
      *why = "no memory for the reply";
      return EINTERNAL;
    }
    rows.push_back(own);
    row_bytes = olen;
  }
  auto fail = [&](int rc) {
    if (own != nullptr) tpu::pool_deallocate(own);
    return rc;
  };

  Pins pins;
  std::vector<bool> aliased(rows.size());
  for (size_t r = 0; r < rows.size(); ++r) {
    aliased[r] = pins.Take(rt, rows[r], row_bytes, true);
    tpu::PjrtDmaNoteAlias(aliased[r]);
  }
  // Inputs: a row that is one block of a registered range and fills its
  // stride is donated (read in place, pinned); anything else is copied
  // into the plan's staging buffer, zero-padded, and counted.
  char* stage_in = be->Staging(prog.plan, false);
  bool zero_copy = !job.inputs.empty();
  for (size_t i = 0; i < job.inputs.size(); ++i) {
    const IOBuf& in = job.inputs[i];
    const size_t off = i * stride;
    const size_t len = in.size();
    bool donated = false;
    int rc = 0;
    if (len == stride && in.backing_block_num() == 1) {
      const char* p = in.backing_block(0).data;
      if (pins.Take(rt, p, len, false)) {
        donated = true;
        rc = be->Put(prog.plan, off, p, len, why);
      }
    }
    tpu::PjrtDmaNoteDonation(donated);
    zero_copy = zero_copy && donated;
    if (!donated) {
      in.copy_to(stage_in + off, len);
      if (stride > len) memset(stage_in + off + len, 0, stride - len);
      tpu::PjrtDmaNoteH2dCopy(len);
      rc = be->Put(prog.plan, off, stage_in + off, stride, why);
    }
    if (rc != 0) return fail(EINTERNAL);
  }
  const size_t filled = job.inputs.size() * stride;
  if (filled < plen) {
    memset(stage_in + filled, 0, plen - filled);
    if (be->Put(prog.plan, filled, stage_in + filled, plen - filled, why) !=
        0) {
      return fail(EINTERNAL);
    }
  }
  // With a guard, the program has finished before the guard is taken, so
  // a caller past its deadline waits at most for the copies out.
  if (be->Exec(prog.plan, job.guard != nullptr, why) != 0) {
    return fail(EINTERNAL);
  }
  const size_t expose = prog.whole_output ? olen : job.inputs[0].size();
  char* stage_out = be->Staging(prog.plan, true);
  {
    // The copies into the caller's rows are issued and synchronised under
    // the guard, after checking `abandoned`: a row is never written once
    // its caller got ERPCTIMEDOUT.
    std::unique_lock<std::mutex> gl;
    if (job.guard != nullptr) {
      gl = std::unique_lock<std::mutex>(job.guard->mu);
    }
    const bool abandoned = job.guard != nullptr && job.guard->abandoned;
    for (size_t r = 0; r < rows.size(); ++r) {
      char* dst = !abandoned && aliased[r] ? rows[r]
                                           : stage_out + r * row_bytes;
      if (be->Get(prog.plan, r * row_bytes, row_bytes, dst, why) != 0) {
        return fail(EINTERNAL);
      }
    }
    if (be->Sync(prog.plan, why) != 0) return fail(EINTERNAL);
    if (!abandoned) {
      for (size_t r = 0; r < rows.size(); ++r) {
        if (aliased[r]) continue;
        memcpy(rows[r], stage_out + r * row_bytes, row_bytes);
        tpu::PjrtDmaNoteD2hCopy(row_bytes);
      }
      if (job.guard != nullptr) job.guard->produced = expose;
    }
  }
  if (own != nullptr) output->append_user_data(own, expose, free_pool_block);
  std::lock_guard<std::mutex> g(rt->mu);
  ++rt->st.executions;
  rt->st.h2d_bytes += (long long)plen;
  rt->st.d2h_bytes += (long long)olen;
  if (zero_copy) ++rt->st.zero_copy_h2d;
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
    // The job's inputs (and any view of a peer's region among them) are
    // released before the caller hears back.
    job.inputs.clear();
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

// Enqueues a job whose output lands in the caller's rows and waits for
// it: the guarded form behind RunProgramInto and RunProgramRows.
int RunGuarded(Runtime* rt, Job j, size_t* produced, int64_t timeout_ms) {
  auto guard = std::make_shared<AliasGuard>();
  struct Sync {
    fiber::CountdownEvent done{1};
    std::atomic<int> rc{EINTERNAL};
  };
  auto s = std::make_shared<Sync>();
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
    // dispatch thread drops the late result and never writes the rows.
    std::lock_guard<std::mutex> g(guard->mu);
    guard->abandoned = true;
    return ERPCTIMEDOUT;
  }
  const int rc = s->rc.load(std::memory_order_acquire);
  if (rc == 0 && produced != nullptr) {
    std::lock_guard<std::mutex> g(guard->mu);
    *produced = guard->produced;
  }
  return rc;
}

// The tail of the core's /status page (and of the heap profiler's) while
// this runtime is up: the block pool's line in the reference's format
// (cpp/tpu/tpu_endpoint.cc), then one line for this runtime with the
// keys of the reference's "pjrt:" line, in its order.
std::string DeviceStatusTail() {
  std::ostringstream os;
  const tpu::BlockPoolStats bp = tpu::block_pool_stats();
  os << "block_pool: regions=" << bp.regions
     << " blocks_free=" << bp.blocks_free << "/" << bp.blocks_total;
  for (int i = 0; i < bp.slot_classes; ++i) {
    os << " slot" << (bp.slot_bytes[i] >> 10) << "KiB=" << bp.slot_free[i]
       << "/" << bp.slot_total[i];
  }
  os << "\n";
  const CudaStats st = CudaRuntime::Get()->stats();
  os << "cuda_runtime: platform="
     << (st.platform == "cuda" ? "gpu" : st.platform)
     << " devices=" << st.devices << " compiles=" << st.plans
     << " executions=" << st.executions << " h2d_bytes=" << st.h2d_bytes
     << " d2h_bytes=" << st.d2h_bytes
     << " zero_copy_h2d=" << st.zero_copy_h2d << " errors=" << st.errors
     << "\n";
  return os.str();
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
  CudaBackend* cuda = nullptr;
  if (device == "cuda") {
    std::unique_ptr<CudaBackend> b = CudaBackend::Open(backend_so, why);
    if (b == nullptr) return -1;
    cuda = b.get();
    rt->backend = std::move(b);
  } else if (device == "cpu") {
    rt->backend.reset(new CpuBackend);
  } else {
    *why = "unknown device " + device + " (want cuda or cpu)";
    return -1;
  }
  rt->st.available = true;
  rt->st.platform = rt->backend->platform();
  rt->st.device = rt->backend->device_name();
  rt->st.devices = 1;
  // Installed after the core's RegisterTpuTransport (tbus_init, which the
  // caller runs first), whose own tail would otherwise replace this one.
  g_rt = rt.release();
  g_device_status_fn = &DeviceStatusTail;
  if (cuda != nullptr) {
    // The DMA table's backend: ranges registered before now (the pool's
    // first region, carved by tbus_init) are bound at once.
    g_cuda_backend = cuda;
    tpu::SetPjrtDmaBackend(&cuda_dma_map, &cuda_dma_unmap);
  }
  LOG(INFO) << "cuda runtime: up on " << g_rt->st.platform << " ("
            << g_rt->st.device << "), DMA registration "
            << (tpu::PjrtDmaEnabled() ? "armed" : "off");
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

int CudaRuntime::EnsureFanoutProgram(const std::string& key, int builtin,
                                     size_t n, size_t bucket, bool scatter,
                                     bool* created, std::string* why) {
  Runtime* rt = g_rt;
  std::string local;
  if (why == nullptr) why = &local;
  if (created != nullptr) *created = false;
  if (rt == nullptr) {
    *why = "cuda runtime not initialized";
    return -1;
  }
  if (builtin < 0 || builtin > 2 || n == 0 || bucket == 0) {
    *why = "bad fan-out program";
    return -1;
  }
  std::lock_guard<std::mutex> g(rt->mu);
  auto it = rt->key_index.find(key);
  if (it != rt->key_index.end()) return it->second;
  ProgramDesc desc;
  desc.kernel = kFanout;
  desc.op = builtin;
  desc.n = n;
  desc.bucket = bucket;
  desc.scatter = scatter;
  desc.len = scatter ? n * bucket : bucket;
  desc.out_len = n * bucket;
  const int handle = add_program(rt, desc, true, why);
  if (handle >= 0) {
    rt->key_index[key] = handle;
    if (created != nullptr) *created = true;
  }
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
  j.inputs.push_back(input);
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
  Job j;
  j.handle = handle;
  j.inputs.push_back(input);
  j.rows.push_back(static_cast<char*>(out_block));
  j.out_cap = out_cap;
  return RunGuarded(rt, std::move(j), out_len, timeout_ms);
}

int CudaRuntime::RunProgramRows(int handle, const std::vector<IOBuf>& inputs,
                                size_t stride, char* const* rows,
                                size_t nrows, size_t row_bytes,
                                int64_t timeout_ms) {
  Runtime* rt = g_rt;
  if (rt == nullptr || rows == nullptr || nrows == 0 || row_bytes == 0) {
    return EINTERNAL;
  }
  Job j;
  j.handle = handle;
  j.inputs = inputs;
  j.stride = stride;
  j.rows.assign(rows, rows + nrows);
  j.row_bytes = row_bytes;
  return RunGuarded(rt, std::move(j), nullptr, timeout_ms);
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
  j.inputs.push_back(std::move(input));
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

HostRegisterStats CudaRuntime::host_register_stats() const {
  Runtime* rt = g_rt;
  return rt != nullptr ? rt->backend->host_register_stats()
                       : HostRegisterStats();
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
