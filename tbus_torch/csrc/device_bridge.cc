// The C ABI of libtbus_torch_device.so: the port's device runtime
// (cuda_runtime.cc), its DMA registration, its collective fan-out engine
// (cuda_fanout.cc) and its mounts on a tbus server (device methods,
// generate with its tensor-parallel form, the device stream sink), with
// the device-stream bench's client; reached from tbus_torch/rpc.py with
// ctypes. Built with g++ against the shared core (libtbus.so) with the
// same headers the core was built with.
//
// A server handle here is the core's tbus_server* (capi). That struct is
// private to cpp/capi/capi.cc:104-108, where its first member is the
// Server (`struct tbus_server { Server impl; ServerOptions opts; bool
// has_opts; }`); the bridge reaches the Server through that layout, and
// tests/test_torch_device_runtime.py mounts on a capi server and calls it
// over RPC.

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include "base/endpoint.h"
#include "base/time.h"
#include "cuda_fanout.h"
#include "cuda_runtime.h"
#include "fiber/fiber.h"
#include "fiber/sync.h"
#include "rpc/channel.h"
#include "rpc/controller.h"
#include "rpc/errors.h"
#include "rpc/serve_batch.h"
#include "rpc/server.h"
#include "rpc/stream.h"
#include "serve_engine.h"
#include "tpu/block_pool.h"
#include "tpu/device_registry.h"
#include "tpu/pjrt_dma.h"
#include "tpu/tpu_endpoint.h"

using tbus::cuda::CudaRuntime;

struct tbus_server;  // cpp/capi/tbus_c.h

namespace {

// cpp/capi/capi.cc:104-108: the Server is tbus_server's first member.
struct CapiServerLayout {
  tbus::Server impl;
};

tbus::Server* server_of(tbus_server* s) {
  return &reinterpret_cast<CapiServerLayout*>(s)->impl;
}

char* dup_str(const std::string& s) {
  char* out = static_cast<char*>(malloc(s.size() + 1));
  if (out == nullptr) return nullptr;
  memcpy(out, s.data(), s.size());
  out[s.size()] = '\0';
  return out;
}

void set_err(char* err, int cap, const std::string& why) {
  if (err != nullptr && cap > 0) snprintf(err, size_t(cap), "%s", why.c_str());
}

// Generate mounts live for the process, as capi.cc's serve_schedulers
// do: the stats read them and a stopped server leaves them idle.
struct GenMount {
  std::string name;
  tbus::serve::ServeScheduler* sched;
  std::shared_ptr<tbus::serve::StepEngine> engine;
  // The single-card engine's counts; null for a tensor-parallel mount
  // (fanout_step_stats counts those).
  std::shared_ptr<tbus::cuda::CudaStepEngine> cuda;
};
std::mutex& mounts_mu() {
  static auto* m = new std::mutex;
  return *m;
}
std::vector<GenMount>& mounts() {
  static auto* v = new std::vector<GenMount>;
  return *v;
}

// The DMA table's counters (pjrt_dma.h) with the CUDA backend's record
// of the ranges cudaHostRegister accepted.
std::string dma_stats_json() {
  const tbus::tpu::PjrtDmaStats st = tbus::tpu::pjrt_dma_stats();
  const tbus::cuda::HostRegisterStats hr =
      CudaRuntime::Get() != nullptr ? CudaRuntime::Get()->host_register_stats()
                                    : tbus::cuda::HostRegisterStats();
  char buf[768];
  snprintf(buf, sizeof(buf),
           "{\"enabled\":%s,\"regions\":%zu,\"pins\":%lld,"
           "\"h2d_copy_bytes\":%lld,\"d2h_copy_bytes\":%lld,"
           "\"donation_hits\":%lld,\"donation_misses\":%lld,"
           "\"alias_hits\":%lld,\"alias_misses\":%lld,"
           "\"reg_failures\":%lld,\"deferred_unregisters\":%lld,"
           "\"host_registered\":{\"ranges\":%lld,\"bytes\":%lld,"
           "\"read_only\":%lld,\"failures\":%lld}}",
           st.enabled ? "true" : "false", st.regions, st.pins,
           st.h2d_copy_bytes, st.d2h_copy_bytes, st.donation_hits,
           st.donation_misses, st.alias_hits, st.alias_misses,
           st.reg_failures, st.deferred_unregisters, hr.ranges, hr.bytes,
           hr.read_only, hr.failures);
  return buf;
}

// Stream sink counters (the reference's tbus_stream_sink_* vars are
// private to capi.cc).
std::atomic<long long> g_sink_bytes{0};
std::atomic<long long> g_sink_chunks{0};
std::atomic<long long> g_sink_failures{0};

// The device stream sink (capi.cc:1447 CapiDeviceSink): every chunk runs
// through the runtime (EnsureU8Program + RunU8): the chunk's view, in the
// sender's registered pool region, is donated; the output lands in an
// own pool block (aliased) and is counted, and streamed back when echo
// is set. Without a runtime the stream closes: there is no host path.
struct DeviceSink : public tbus::StreamHandler {
  std::string transform;
  bool echo = false;
  int on_received_messages(tbus::StreamId id, tbus::IOBuf* const messages[],
                           size_t size) override {
    CudaRuntime* rt = CudaRuntime::Get();
    for (size_t i = 0; i < size; ++i) {
      tbus::IOBuf out;
      int rc = tbus::EINTERNAL;
      if (rt != nullptr) {
        const int h = rt->EnsureU8Program(transform, messages[i]->size());
        if (h >= 0) rc = rt->RunU8(h, *messages[i], &out, 30000);
      }
      if (rc != 0) {
        g_sink_failures.fetch_add(1, std::memory_order_relaxed);
        tbus::StreamClose(id);
        return 0;
      }
      g_sink_bytes.fetch_add((long long)out.size(), std::memory_order_relaxed);
      g_sink_chunks.fetch_add(1, std::memory_order_relaxed);
      if (echo) {
        int wrc;
        while ((wrc = tbus::StreamWrite(id, out)) == EAGAIN) {
          if (tbus::StreamWait(id, tbus::monotonic_time_us() +
                                       5 * 1000 * 1000) != 0) {
            return 0;
          }
        }
        if (wrc != 0) return 0;
      }
    }
    return 0;
  }
  void on_closed(tbus::StreamId id) override { tbus::StreamClose(id); }
};

// The link-death drill's in-flight executions (ticket -> result).
struct Drill {
  tbus::fiber::CountdownEvent done{1};
  std::atomic<int> rc{-1};
  std::mutex mu;
  tbus::IOBuf out;
};
std::mutex& drills_mu() {
  static auto* m = new std::mutex;
  return *m;
}
std::vector<std::shared_ptr<Drill>>& drills() {
  static auto* v = new std::vector<std::shared_ptr<Drill>>;
  return *v;
}

}  // namespace

extern "C" {

// device: "cuda" (backend_so: the CUDA backend library) or "cpu".
int tbus_torch_device_init(const char* device, const char* backend_so,
                           char* err, int cap) {
  std::string why;
  const int rc = CudaRuntime::Init(device != nullptr ? device : "", backend_so,
                                   &why);
  if (rc != 0) set_err(err, cap, why);
  return rc;
}

int tbus_torch_device_available(void) {
  return CudaRuntime::Get() != nullptr ? 1 : 0;
}

char* tbus_torch_device_stats_json(void) {
  const tbus::cuda::CudaStats st =
      CudaRuntime::Get() != nullptr ? CudaRuntime::Get()->stats()
                                    : tbus::cuda::CudaStats();
  char buf[1024];
  snprintf(buf, sizeof(buf),
           "{\"available\":%s,\"platform\":\"%s\",\"device\":\"%s\","
           "\"devices\":%d,\"plans\":%ld,\"executions\":%ld,"
           "\"h2d_bytes\":%lld,\"d2h_bytes\":%lld,\"zero_copy_h2d\":%ld,"
           "\"errors\":%ld,\"overcrowded\":%ld,"
           "\"launches\":{\"u8_transform\":%lld,\"dot128\":%lld,"
           "\"dotbench\":%lld,\"fanout\":%lld},\"dma\":",
           st.available ? "true" : "false", st.platform.c_str(),
           st.device.c_str(), st.devices, st.plans, st.executions,
           st.h2d_bytes, st.d2h_bytes, st.zero_copy_h2d, st.errors,
           st.overcrowded,
           st.launches[tbus::cuda::kU8Transform],
           st.launches[tbus::cuda::kDot128],
           st.launches[tbus::cuda::kDotbench],
           st.launches[tbus::cuda::kFanout]);
  return dup_str(std::string(buf) + dma_stats_json() + "}");
}

// Sets every kernel's launch count to 0 (a main-path run reads them from
// there).
void tbus_torch_device_reset_launches(void) {
  if (CudaRuntime::Get() != nullptr) CudaRuntime::Get()->ResetLaunches();
}

int tbus_torch_server_add_device_method(tbus_server* s, const char* service,
                                        const char* method,
                                        const char* transform) {
  if (s == nullptr || service == nullptr || method == nullptr) return -1;
  return tbus::cuda::AddDeviceMethod(
      server_of(s), service, method,
      transform != nullptr && transform[0] != '\0' ? transform : "echo");
}

// cpp/capi/capi.cc:906-950. The step engine is the CUDA one, or, with
// `peers` (a comma list of host:port), the tensor-parallel engine that
// shards every step over them through the collective fan-out backend;
// the peers advertise (service + "Shard", method) under "serve/v1". The
// mount fails (-1) where the engine cannot be made, never serving from
// the host.
int tbus_torch_server_add_generate_method(tbus_server* s, const char* service,
                                          const char* method,
                                          const char* transform,
                                          long long max_batch,
                                          long long token_bytes, int batched,
                                          long long max_queue,
                                          const char* peers) {
  if (s == nullptr || service == nullptr || method == nullptr) return -1;
  const std::string tf =
      transform != nullptr && transform[0] != '\0' ? transform : "incr";
  tbus::serve::ServeOptions opts;
  if (max_batch > 0) opts.max_batch = size_t(max_batch);
  if (token_bytes > 0) opts.token_bytes = size_t(token_bytes);
  if (max_queue > 0) opts.max_queue = size_t(max_queue);
  std::shared_ptr<tbus::serve::StepEngine> engine;
  std::shared_ptr<tbus::cuda::CudaStepEngine> cuda;
  if (peers != nullptr && peers[0] != '\0') {
    std::vector<tbus::EndPoint> eps;
    std::stringstream ss(peers);
    std::string one;
    while (std::getline(ss, one, ',')) {
      tbus::EndPoint ep;
      if (!one.empty() && tbus::str2endpoint(one.c_str(), &ep) == 0) {
        eps.push_back(ep);
      }
    }
    engine = tbus::cuda::NewFanoutStepEngine(
        tf == "xor255" ? "xor255" : "echo", "serve/v1", std::move(eps),
        std::string(service) + "Shard", method, 1000);
  } else {
    cuda = tbus::cuda::NewCudaStepEngine(tf);
    engine = cuda;
  }
  if (engine == nullptr) return -1;
  opts.engine = engine;
  auto* sched = new tbus::serve::ServeScheduler(opts);
  if (sched->Mount(server_of(s), service, method, batched != 0) != 0) {
    delete sched;
    return -1;
  }
  if (batched != 0) sched->Start();
  std::lock_guard<std::mutex> g(mounts_mu());
  mounts().push_back({std::string(service) + "." + method, sched,
                      std::move(engine), std::move(cuda)});
  return 0;
}

// The step engines behind the generate mounts: [{"name", "engine",
// "engine_steps", "engine_failures"}] ("fanout" mounts: name and engine).
char* tbus_torch_serve_engines_json(void) {
  std::lock_guard<std::mutex> g(mounts_mu());
  std::string out = "[";
  for (size_t i = 0; i < mounts().size(); ++i) {
    const GenMount& m = mounts()[i];
    char buf[512];
    if (m.cuda != nullptr) {
      snprintf(buf, sizeof(buf),
               "%s{\"name\":\"%s\",\"engine\":\"%s\","
               "\"engine_steps\":%ld,\"engine_failures\":%ld}",
               i > 0 ? "," : "", m.name.c_str(), m.engine->name(),
               m.cuda->steps(), m.cuda->failures());
    } else {
      snprintf(buf, sizeof(buf), "%s{\"name\":\"%s\",\"engine\":\"%s\"}",
               i > 0 ? "," : "", m.name.c_str(), m.engine->name());
    }
    out += buf;
  }
  out += "]";
  return dup_str(out);
}

// Submits n jobs of `transform` at `len` bytes back to back and waits for
// all: rcs[i] is job i's rc. The queue bound shows here (EOVERCROWDED
// past kMaxQueue queued jobs).
int tbus_torch_device_burst(const char* transform, long long len, int n,
                            int* rcs) {
  CudaRuntime* rt = CudaRuntime::Get();
  if (rt == nullptr || n < 0) return -1;
  struct Burst {
    std::mutex mu;
    std::condition_variable cv;
    int left;
  };
  auto b = std::make_shared<Burst>();
  b->left = n;
  auto out = std::make_shared<std::vector<int>>(size_t(n), 0);
  for (int i = 0; i < n; ++i) {
    tbus::IOBuf in;
    in.append(std::string(size_t(len), '\x5a'));
    rt->SubmitU8Transform(transform, size_t(len), std::move(in),
                          [b, out, i](int rc, tbus::IOBuf, const std::string&) {
                            std::lock_guard<std::mutex> g(b->mu);
                            (*out)[size_t(i)] = rc;
                            if (--b->left == 0) b->cv.notify_all();
                          });
  }
  std::unique_lock<std::mutex> lk(b->mu);
  b->cv.wait(lk, [&] { return b->left == 0; });
  memcpy(rcs, out->data(), size_t(n) * sizeof(int));
  return 0;
}

// ---- DMA registration (cpp/tpu/pjrt_dma.h) and the block pool ----

// Whether the block pool is up: device_enable_dma refuses then, since the
// regions carved before it would be missed.
int tbus_torch_block_pool_enabled(void) {
  return tbus::tpu::block_pool_enabled() ? 1 : 0;
}

char* tbus_torch_dma_stats_json(void) { return dup_str(dma_stats_json()); }

// This process's live cross-process tpu:// client links (the set
// tbus_link_redial walks), each with its negotiated lane count and chain
// capability: [{"socket":id,"lanes":n,"chains":0|1},...].
char* tbus_torch_shm_links_json(void) {
  std::ostringstream os;
  os << "[";
  bool first = true;
  for (const tbus::SocketId sid : tbus::tpu::ShmClientLinks()) {
    int lanes = 0, chains = 0;
    if (tbus::tpu::TpuLinkCaps(sid, &lanes, &chains) != 0) continue;
    os << (first ? "" : ",") << "{\"socket\":" << sid
       << ",\"lanes\":" << lanes << ",\"chains\":" << chains << "}";
    first = false;
  }
  os << "]";
  return dup_str(os.str());
}

// The table's own calls, for the registration and pin drills.
int tbus_torch_dma_register_range(void* base, long long bytes) {
  return tbus::tpu::PjrtDmaRegisterRange(base, size_t(bytes));
}
int tbus_torch_dma_unregister(void* base) {
  return tbus::tpu::PjrtDmaUnregisterBase(base);
}
int tbus_torch_dma_is_registered(const void* p, long long len) {
  return tbus::tpu::PjrtDmaIsRegistered(p, size_t(len)) ? 1 : 0;
}
long long tbus_torch_dma_region_count(void) {
  return (long long)tbus::tpu::PjrtDmaRegionCount();
}

namespace {
std::mutex& pins_mu() {
  static auto* m = new std::mutex;
  return *m;
}
std::vector<tbus::tpu::PjrtDmaPin>& held_pins() {
  static auto* v = new std::vector<tbus::tpu::PjrtDmaPin>;
  return *v;
}
}  // namespace

// Pins [p, p+len): a pin id >= 0, or -1 when the table refuses.
int tbus_torch_dma_pin(const void* p, long long len) {
  tbus::tpu::PjrtDmaPin pin;
  if (!tbus::tpu::PjrtDmaPinRange(p, size_t(len), &pin)) return -1;
  std::lock_guard<std::mutex> g(pins_mu());
  held_pins().push_back(pin);
  return int(held_pins().size()) - 1;
}
void tbus_torch_dma_unpin(int id) {
  tbus::tpu::PjrtDmaPin pin;
  {
    std::lock_guard<std::mutex> g(pins_mu());
    if (id < 0 || size_t(id) >= held_pins().size()) return;
    pin = held_pins()[size_t(id)];
    held_pins()[size_t(id)] = tbus::tpu::PjrtDmaPin();
  }
  tbus::tpu::PjrtDmaUnpin(pin);
}

void* tbus_torch_pool_alloc(long long bytes) {
  return tbus::tpu::pool_allocate(size_t(bytes));
}
void tbus_torch_pool_free(void* p) { tbus::tpu::pool_deallocate(p); }

// One execution of `transform` at len bytes with the input made as
// in_kind says: 0, one pool block holding a copy of data (the donated
// shape); 1, data appended in 4 KiB pieces (several blocks, staged);
// 2, data itself, in place. keyed = 0: RunU8, the reply (a fresh pool
// block) copied into out; keyed = 1: RunProgramInto the caller's block
// out (out_cap bytes). Returns the runtime's rc.
int tbus_torch_device_run_mode(const char* transform, const char* data,
                               long long len, int in_kind, int keyed,
                               void* out, long long out_cap,
                               long long timeout_ms, long long* out_len) {
  CudaRuntime* rt = CudaRuntime::Get();
  if (rt == nullptr || len <= 0) return -1;
  tbus::IOBuf in;
  if (in_kind == 0) {
    char* block = static_cast<char*>(tbus::tpu::pool_allocate(size_t(len)));
    if (block == nullptr) return -1;
    memcpy(block, data, size_t(len));
    in.append_user_data(block, size_t(len),
                        [](void* q) { tbus::tpu::pool_deallocate(q); });
  } else if (in_kind == 1) {
    for (long long off = 0; off < len; off += 4096) {
      in.append(data + off, size_t(std::min<long long>(4096, len - off)));
    }
  } else {
    in.append_user_data(const_cast<char*>(data), size_t(len),
                        [](void*) {});
  }
  if (keyed != 0) {
    const std::string key =
        std::string("run-into:") + transform + ":" + std::to_string(len);
    const int handle = rt->EnsureProgram(key, transform, size_t(len));
    if (handle < 0) return -1;
    size_t got = 0;
    const int rc = rt->RunProgramInto(handle, in, out, size_t(out_cap), &got,
                                      timeout_ms);
    if (out_len != nullptr) *out_len = (long long)got;
    return rc;
  }
  const int handle = rt->EnsureU8Program(transform, size_t(len));
  if (handle < 0) return -1;
  tbus::IOBuf reply;
  const int rc = rt->RunU8(handle, in, &reply, timeout_ms);
  if (rc == 0) {
    const size_t n = std::min(reply.size(), size_t(out_cap));
    reply.copy_to(out, n);
    if (out_len != nullptr) *out_len = (long long)reply.size();
  }
  return rc;
}

// One execution of K7 through the runtime (the engine's program, keyed
// as the engine keys it): data is the whole input (bucket bytes, or
// n * bucket with scatter, shorter inputs zero-padded), out receives the
// n * bucket bytes. Returns the runtime's rc.
int tbus_torch_device_run_fanout(int builtin, long long n, long long bucket,
                                 int scatter, const char* data,
                                 long long len, char* out,
                                 long long out_cap) {
  CudaRuntime* rt = CudaRuntime::Get();
  if (rt == nullptr || n <= 0 || bucket <= 0 || out_cap < n * bucket) {
    return -1;
  }
  const std::string key = "fanout:" +
                          std::string(scatter ? "scatter:" : "bcast:") +
                          std::to_string(builtin) + ":" + std::to_string(n) +
                          ":" + std::to_string(bucket);
  const int handle = rt->EnsureFanoutProgram(key, builtin, size_t(n),
                                             size_t(bucket), scatter != 0);
  if (handle < 0) return -1;
  std::vector<tbus::IOBuf> inputs(1);
  inputs[0].append(data, size_t(len));
  char* rows[1] = {out};
  return rt->RunProgramRows(handle, inputs, 0, rows, 1,
                            size_t(n * bucket));
}

// The link-death drill (pjrt_dma_test.cc:421): calls (service, method)
// on addr, whose reply is bulk bytes in the server's pool, takes the
// reply's first block (a view into the peer's region), copies its bytes
// into in_copy, and submits `transform` of that view to the runtime,
// dropping every other reference to it. Returns a ticket for
// tbus_torch_device_wait, or -1 (-2: the view is not a peer region's).
int tbus_torch_device_submit_peer_view(const char* addr, const char* service,
                                       const char* method,
                                       const char* transform, char* in_copy,
                                       long long cap, long long* len) {
  CudaRuntime* rt = CudaRuntime::Get();
  if (rt == nullptr) return -1;
  tbus::IOBuf view;
  {
    tbus::Channel ch;
    tbus::ChannelOptions opts;
    opts.timeout_ms = 20000;
    opts.max_retry = 0;
    if (ch.Init(addr, &opts) != 0) return -1;
    tbus::Controller cntl;
    tbus::IOBuf req, resp;
    req.append("go");
    ch.CallMethod(service, method, &cntl, req, &resp, nullptr);
    if (cntl.Failed() || resp.empty()) return -1;
    resp.cutn(&view, resp.backing_block(0).size);
  }
  uint64_t tok = 0;
  uint32_t reg = 0;
  if (!tbus::tpu::pool_region_ref_of(view.backing_block(0).data, &tok,
                                     &reg)) {
    return -2;
  }
  tbus::tpu::pool_region_release(tok, reg);
  const size_t n = view.size();
  if ((long long)n > cap) return -1;
  view.copy_to(in_copy, n);
  *len = (long long)n;
  const int h = rt->EnsureU8Program(transform, n);
  if (h < 0) return -1;
  auto d = std::make_shared<Drill>();
  int ticket;
  {
    std::lock_guard<std::mutex> g(drills_mu());
    drills().push_back(d);
    ticket = int(drills().size()) - 1;
  }
  // RunU8 blocks, so it runs on its own thread; the view moves into it
  // and is the only reference left once this returns.
  std::thread([rt, h, d, view = std::move(view)]() mutable {
    tbus::IOBuf out;
    const int rc = rt->RunU8(h, view, &out, 60000);
    view.clear();
    {
      std::lock_guard<std::mutex> g(d->mu);
      d->out = std::move(out);
    }
    d->rc.store(rc, std::memory_order_release);
    d->done.signal();
  }).detach();
  return ticket;
}

// Waits for a drill's execution; its output is copied into out.
int tbus_torch_device_wait(int ticket, long long timeout_ms, char* out,
                           long long cap, long long* out_len) {
  std::shared_ptr<Drill> d;
  {
    std::lock_guard<std::mutex> g(drills_mu());
    if (ticket < 0 || size_t(ticket) >= drills().size()) return -1;
    d = drills()[size_t(ticket)];
  }
  if (d->done.wait(tbus::monotonic_time_us() + timeout_ms * 1000) != 0) {
    return tbus::ERPCTIMEDOUT;
  }
  std::lock_guard<std::mutex> g(d->mu);
  const size_t n = std::min(d->out.size(), size_t(cap));
  d->out.copy_to(out, n);
  *out_len = (long long)d->out.size();
  return d->rc.load(std::memory_order_acquire);
}

// ---- the collective fan-out engine (cuda_fanout.h) ----

int tbus_torch_cuda_fanout_enable(void) {
  return tbus::cuda::EnableCudaFanout();
}
int tbus_torch_cuda_fanout_installed(void) {
  return tbus::cuda::CudaFanoutInstalled() ? 1 : 0;
}
int tbus_torch_cuda_fanout_register(const char* service, const char* method,
                                    const char* builtin,
                                    const char* impl_id) {
  return tbus::cuda::RegisterCudaDeviceMethod(service, method, builtin,
                                              impl_id);
}
int tbus_torch_cuda_fanout_register_echo(const char* service,
                                         const char* method) {
  return tbus::cuda::RegisterCudaDeviceEcho(service, method);
}
long tbus_torch_cuda_fanout_lowered_calls(void) {
  return tbus::cuda::cuda_fanout_stats().lowered_calls;
}
void tbus_torch_cuda_fanout_reset_for_test(void) {
  tbus::cuda::CudaFanoutResetForTest();
}
char* tbus_torch_cuda_fanout_stats_json(void) {
  const tbus::cuda::CudaFanoutStats st = tbus::cuda::cuda_fanout_stats();
  char buf[768];
  snprintf(buf, sizeof(buf),
           "{\"installed\":%s,\"quarantined\":%s,\"lowered_calls\":%ld,"
           "\"scatter_calls\":%ld,\"host_execs\":%ld,\"device_execs\":%ld,"
           "\"cache_hits\":%ld,\"cache_misses\":%ld,"
           "\"divergence_checked\":%ld,\"divergence_mismatch\":%ld,"
           "\"quarantines\":%ld,\"revivals\":%ld,\"repaired_calls\":%ld,"
           "\"advertised_peers\":%zu}",
           st.installed ? "true" : "false", st.quarantined ? "true" : "false",
           st.lowered_calls, st.scatter_calls, st.host_execs,
           st.device_execs, st.cache_hits, st.cache_misses,
           st.divergence_checked, st.divergence_mismatch, st.quarantines,
           st.revivals, st.repaired_calls, tbus::tpu::PeerAdvertCount());
  return dup_str(buf);
}

char* tbus_torch_fanout_step_stats_json(void) {
  const tbus::cuda::FanoutStepStats st = tbus::cuda::fanout_step_stats();
  char buf[128];
  snprintf(buf, sizeof(buf),
           "{\"collective_steps\":%ld,\"fallback_steps\":%ld}",
           st.collective_steps, st.fallback_steps);
  return dup_str(buf);
}

// ---- the device stream sink and its bench (capi.cc:1447-1640) ----

int tbus_torch_server_add_device_stream_sink(tbus_server* s,
                                             const char* service,
                                             const char* method,
                                             const char* transform,
                                             int echo) {
  if (s == nullptr || service == nullptr || method == nullptr) return -1;
  const std::string tf =
      transform != nullptr && transform[0] != '\0' ? transform : "echo";
  return server_of(s)->AddMethod(
      service, method,
      [tf, echo](tbus::Controller* cntl, const tbus::IOBuf&,
                 tbus::IOBuf* resp, std::function<void()> done) {
        auto sink = std::make_shared<DeviceSink>();
        sink->transform = tf;
        sink->echo = echo != 0;
        tbus::StreamOptions opts;
        opts.handler = sink.get();
        opts.shared_handler = sink;  // outlives the consumer fiber
        opts.max_buf_size = 8 * 1024 * 1024;
        tbus::StreamId sid = 0;
        resp->append(tbus::StreamAccept(&sid, *cntl, &opts) == 0
                         ? "stream-ok"
                         : "no-stream");
        done();
      });
}

char* tbus_torch_stream_sink_stats_json(void) {
  char buf[160];
  snprintf(buf, sizeof(buf),
           "{\"bytes\":%lld,\"chunks\":%lld,\"failures\":%lld}",
           g_sink_bytes.load(), g_sink_chunks.load(), g_sink_failures.load());
  return dup_str(buf);
}

// The client half of capi.cc tbus_bench_device_stream over the port's
// runtime: every chunk is produced on the device (one reusable pool
// block, donated, as input; the output a fresh pool block, aliased) and
// written to the sink's stream as is. Goodput counts bytes delivered and
// consumed by the sink (the window fully acked). Returns 0 or an rpc
// error code (err_text says why).
int tbus_torch_bench_device_stream(const char* addr, const char* service,
                                   const char* method, long long total_bytes,
                                   long long chunk_bytes,
                                   const char* transform,
                                   double* out_goodput_mbps,
                                   double* out_gap_p50_us,
                                   double* out_gap_p99_us,
                                   long long* out_chunks, char* err_text) {
  auto fail_text = [err_text](const std::string& what) {
    set_err(err_text, 256, what);
  };
  if (addr == nullptr || total_bytes <= 0) return -1;
  if (chunk_bytes <= 0) chunk_bytes = 1 << 20;
  CudaRuntime* rt = CudaRuntime::Get();
  if (rt == nullptr) {
    fail_text("the device runtime is not up (device_init first)");
    return -1;
  }
  const std::string tf =
      transform != nullptr && transform[0] != '\0' ? transform : "echo";
  std::string why;
  const int handle = rt->EnsureU8Program(tf, size_t(chunk_bytes), &why);
  if (handle < 0) {
    fail_text("device program: " + why);
    return -1;
  }
  const std::string svc =
      service != nullptr && service[0] != '\0' ? service : "DeviceStream";
  const std::string mth =
      method != nullptr && method[0] != '\0' ? method : "Sink";
  tbus::Channel ch;
  tbus::ChannelOptions copts;
  copts.timeout_ms = 20000;
  if (ch.Init(addr, &copts) != 0) return -1;
  tbus::StreamOptions opts;  // write-only: the device sink consumes
  opts.max_buf_size = 8 * 1024 * 1024;
  tbus::StreamId sid = 0;
  tbus::Controller cntl;
  if (tbus::StreamCreate(&sid, cntl, &opts) != 0) return -1;
  tbus::IOBuf req, resp;
  ch.CallMethod(svc, mth, &cntl, req, &resp, nullptr);
  if (cntl.Failed() || resp.to_string() != "stream-ok") {
    fail_text(cntl.Failed() ? cntl.ErrorText() : "sink refused");
    tbus::StreamClose(sid);
    return cntl.ErrorCode() != 0 ? cntl.ErrorCode() : -1;
  }
  char* in_block =
      static_cast<char*>(tbus::tpu::pool_allocate(size_t(chunk_bytes)));
  if (in_block == nullptr) {
    tbus::StreamClose(sid);
    return -1;
  }
  memset(in_block, 'd', size_t(chunk_bytes));
  tbus::IOBuf input;
  input.append_user_data(in_block, size_t(chunk_bytes),
                         [](void* q) { tbus::tpu::pool_deallocate(q); });
  const long long nchunks = (total_bytes + chunk_bytes - 1) / chunk_bytes;
  std::vector<int64_t> gaps;
  gaps.reserve(size_t(std::min<long long>(nchunks, 1 << 20)));
  const int64_t bench_t0 = tbus::monotonic_time_us();
  int64_t last_done = bench_t0;
  for (long long i = 0; i < nchunks; ++i) {
    tbus::IOBuf device_out;
    int rc = rt->RunU8(handle, input, &device_out, 30000);
    if (rc != 0) {
      tbus::StreamClose(sid);
      fail_text("device execution failed");
      return rc;
    }
    const int64_t deadline = tbus::monotonic_time_us() + 30 * 1000 * 1000;
    while ((rc = tbus::StreamWrite(sid, device_out)) == EAGAIN) {
      if (tbus::StreamWait(sid, deadline) != 0) {
        tbus::StreamClose(sid);
        fail_text("stream window stalled");
        return tbus::ERPCTIMEDOUT;
      }
    }
    if (rc != 0) {
      tbus::StreamClose(sid);
      fail_text("stream write failed");
      return rc;
    }
    const int64_t now = tbus::monotonic_time_us();
    if (gaps.size() < (1u << 20)) gaps.push_back(now - last_done);
    last_done = now;
  }
  const int64_t drain_deadline = tbus::monotonic_time_us() + 60 * 1000 * 1000;
  while (tbus::stream_internal::UnackedBytes(sid) > 0 &&
         tbus::monotonic_time_us() < drain_deadline) {
    tbus::fiber_usleep(1000);
  }
  const double secs = double(tbus::monotonic_time_us() - bench_t0) / 1e6;
  tbus::StreamClose(sid);
  std::sort(gaps.begin(), gaps.end());
  if (out_goodput_mbps != nullptr) {
    *out_goodput_mbps = double(nchunks) * double(chunk_bytes) /
                        (secs > 0 ? secs : 1e-9) / 1e6;
  }
  if (out_gap_p50_us != nullptr && !gaps.empty()) {
    *out_gap_p50_us = double(gaps[gaps.size() / 2]);
  }
  if (out_gap_p99_us != nullptr && !gaps.empty()) {
    *out_gap_p99_us = double(gaps[size_t(double(gaps.size()) * 0.99)]);
  }
  if (out_chunks != nullptr) *out_chunks = nchunks;
  return 0;
}

}  // extern "C"
