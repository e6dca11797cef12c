// The C ABI of libtbus_torch_device.so: the port's device runtime
// (cuda_runtime.cc) and its two mounts on a tbus server, reached from
// tbus_torch/rpc.py with ctypes. Built with g++ against the shared core
// (libtbus.so) with the same headers the core was built with.
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

#include <condition_variable>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "cuda_runtime.h"
#include "rpc/serve_batch.h"
#include "rpc/server.h"
#include "serve_engine.h"

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
  std::shared_ptr<tbus::cuda::CudaStepEngine> engine;
};
std::mutex& mounts_mu() {
  static auto* m = new std::mutex;
  return *m;
}
std::vector<GenMount>& mounts() {
  static auto* v = new std::vector<GenMount>;
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
           "\"plans\":%ld,\"executions\":%ld,\"h2d_bytes\":%lld,"
           "\"d2h_bytes\":%lld,\"errors\":%ld,\"overcrowded\":%ld,"
           "\"launches\":{\"u8_transform\":%lld,\"dot128\":%lld,"
           "\"dotbench\":%lld}}",
           st.available ? "true" : "false", st.platform.c_str(),
           st.device.c_str(), st.plans, st.executions, st.h2d_bytes,
           st.d2h_bytes, st.errors, st.overcrowded,
           st.launches[tbus::cuda::kU8Transform],
           st.launches[tbus::cuda::kDot128],
           st.launches[tbus::cuda::kDotbench]);
  return dup_str(buf);
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

// cpp/capi/capi.cc:906-950 without its `peers` branch (the tensor-parallel
// fan-out engine, B4's slice): the step engine is the CUDA one, and the
// mount fails (-1) where it cannot be made, never serving from the host.
int tbus_torch_server_add_generate_method(tbus_server* s, const char* service,
                                          const char* method,
                                          const char* transform,
                                          long long max_batch,
                                          long long token_bytes, int batched,
                                          long long max_queue) {
  if (s == nullptr || service == nullptr || method == nullptr) return -1;
  const std::string tf =
      transform != nullptr && transform[0] != '\0' ? transform : "incr";
  tbus::serve::ServeOptions opts;
  if (max_batch > 0) opts.max_batch = size_t(max_batch);
  if (token_bytes > 0) opts.token_bytes = size_t(token_bytes);
  if (max_queue > 0) opts.max_queue = size_t(max_queue);
  auto engine = tbus::cuda::NewCudaStepEngine(tf);
  if (engine == nullptr) return -1;
  opts.engine = engine;
  auto* sched = new tbus::serve::ServeScheduler(opts);
  if (sched->Mount(server_of(s), service, method, batched != 0) != 0) {
    delete sched;
    return -1;
  }
  if (batched != 0) sched->Start();
  std::lock_guard<std::mutex> g(mounts_mu());
  mounts().push_back(
      {std::string(service) + "." + method, sched, std::move(engine)});
  return 0;
}

// The step engines behind the generate mounts: [{"name", "engine",
// "engine_steps", "engine_failures"}].
char* tbus_torch_serve_engines_json(void) {
  std::lock_guard<std::mutex> g(mounts_mu());
  std::string out = "[";
  for (size_t i = 0; i < mounts().size(); ++i) {
    const GenMount& m = mounts()[i];
    char buf[512];
    snprintf(buf, sizeof(buf),
             "%s{\"name\":\"%s\",\"engine\":\"%s\",\"engine_steps\":%ld,"
             "\"engine_failures\":%ld}",
             i > 0 ? "," : "", m.name.c_str(), m.engine->name(),
             m.engine->steps(), m.engine->failures());
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

// RunProgramInto on a keyed elementwise program of `transform` at len
// bytes: the step engine's call, for the deadline-abandonment test.
int tbus_torch_device_run_into(const char* transform, const char* data,
                               long long len, char* out, long long out_cap,
                               long long timeout_ms, long long* out_len) {
  CudaRuntime* rt = CudaRuntime::Get();
  if (rt == nullptr) return -1;
  const std::string key =
      std::string("run-into:") + transform + ":" + std::to_string(len);
  const int handle = rt->EnsureProgram(key, transform, size_t(len));
  if (handle < 0) return -1;
  tbus::IOBuf in;
  in.append(data, size_t(len));
  size_t got = 0;
  const int rc = rt->RunProgramInto(handle, in, out, size_t(out_cap), &got,
                                    timeout_ms);
  if (out_len != nullptr) *out_len = (long long)got;
  return rc;
}

}  // extern "C"
