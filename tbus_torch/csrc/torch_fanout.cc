// CollectiveFanout backend that lowers ParallelChannel fan-outs onto the
// port's PyTorch runtime (tbus_torch/parallel/runtime.py).
//
// The port's counterpart of PyJaxFanout (cpp/tpu/pyjax_fanout.cc), which
// hard-codes `import tbus.parallel.runtime`. Built by
// tbus_torch/kernels/_build.py with g++ into its own shared library,
// linked to libtbus.so and compiled with the core's flags so IOBuf and the
// other shared types have the same layout. No CUDA here: the device work
// happens in Python, in the callback the runtime hands over.
//
// What it keeps from PyJaxFanout:
// - one detached executor thread runs every lowered call, serially; a
//   fiber never blocks in Python;
// - at most kMaxQueuedJobs queued jobs (CanLower declines past it) and at
//   most kMaxBatch jobs fused into one runtime call;
// - the fuse key (service, method, arity, locality, timeout_ms, payload
//   size), scanned in FIFO order;
// - the RPC deadline: the waiter gives up at it, marks the job abandoned
//   and fails every peer with ERPCTIMEDOUT, so a wedged backend costs the
//   call, never a fiber worker;
// - CanLower reads only C++ state (LocalDeviceImpl + AllPeersAdvertise),
//   never the GIL;
// - selection order native -> torch -> p2p: never displaces an installed
//   backend (the reference's native engine, or the port's own C++ engine,
//   cuda_fanout.cc, which in turn displaces this one).
//
// Into Python: the runtime passes a ctypes callback; ctypes takes the GIL
// when the executor thread calls it. The callback reads the batch through
// the tbus_torch_batch_* accessors, calls broadcast_gather[_batch], and
// writes each peer's response back through them.

#include <atomic>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "base/iobuf.h"
#include "base/logging.h"
#include "base/time.h"
#include "fiber/sync.h"
#include "rpc/errors.h"
#include "rpc/fanout_hooks.h"
#include "tpu/device_registry.h"
#include "tpu/native_fanout.h"
#include "var/reducer.h"

namespace tbus {
namespace torch_port {

// Returns 0 when it ran (jobs it filled are marked with
// tbus_torch_batch_done); nonzero when the runtime call failed.
typedef int (*RunFn)(void* batch);

namespace {

std::atomic<RunFn> g_run{nullptr};
std::atomic<long> g_lowered{0};

struct FanoutJob {
  std::string service, method, payload;
  size_t n_peers = 0;
  bool all_local = true;
  int64_t timeout_ms = 0;
  // results
  std::vector<std::string> responses;
  std::vector<int> errors;
  int rc = -1;
  fiber::CountdownEvent done{1};
  std::atomic<bool> abandoned{false};
};

using Batch = std::vector<std::shared_ptr<FanoutJob>>;

// Leaky heap singletons: the detached executor thread waits on these at
// exit; static instances would be destroyed under it by __cxa_finalize.
std::mutex& q_mu() {
  static auto* m = new std::mutex;
  return *m;
}
std::condition_variable& q_cv() {
  static auto* cv = new std::condition_variable;
  return *cv;
}
std::deque<std::shared_ptr<FanoutJob>>& q() {
  static auto* d = new std::deque<std::shared_ptr<FanoutJob>>;
  return *d;
}
std::atomic<bool> g_executor_started{false};

// Queue bound: with the executor wedged, every further lowered call would
// park a payload copy here. Past it CanLower declines into p2p.
constexpr size_t kMaxQueuedJobs = 64;
// Compatible queued jobs fused into one runtime call (one kernel launch
// per position for the whole batch).
constexpr size_t kMaxBatch = 16;

bool Compatible(const FanoutJob& a, const FanoutJob& b) {
  // timeout_ms is part of the key: the fused call runs under the FIRST
  // job's parameters.
  return a.service == b.service && a.method == b.method &&
         a.n_peers == b.n_peers && a.all_local == b.all_local &&
         a.timeout_ms == b.timeout_ms &&
         a.payload.size() == b.payload.size();
}

void Execute(Batch& batch) {
  RunFn run = g_run.load(std::memory_order_acquire);
  if (run == nullptr) return;  // every job keeps rc = -1
  if (run(&batch) != 0) {
    LOG(ERROR) << "torch fanout: runtime call failed for "
               << batch[0]->service << "." << batch[0]->method;
  }
  long filled = 0;
  for (auto& j : batch) filled += j->rc == 0;
  g_lowered.fetch_add(filled, std::memory_order_relaxed);
}

// Runs every lowered call, serially. Plain pthread: it blocks in Python
// and on the device, which must never happen on a fiber worker.
void executor_main() {
  while (true) {
    Batch batch;
    {
      std::unique_lock<std::mutex> lk(q_mu());
      q_cv().wait(lk, [] { return !q().empty(); });
      std::shared_ptr<FanoutJob> job = std::move(q().front());
      q().pop_front();
      // Drain compatible waiting jobs; the first mismatch stops the scan
      // to preserve FIFO order.
      Batch more;
      while (!q().empty() && more.size() + 1 < kMaxBatch) {
        std::shared_ptr<FanoutJob>& f = q().front();
        if (!Compatible(*f, *job)) break;
        if (f->abandoned.load(std::memory_order_acquire)) {
          // Deadline passed while queued: spend no device work on it.
          f->done.signal();
        } else {
          more.push_back(std::move(f));
        }
        q().pop_front();
      }
      if (job->abandoned.load(std::memory_order_acquire)) {
        job->done.signal();
      } else {
        batch.push_back(std::move(job));
      }
      for (auto& f : more) batch.push_back(std::move(f));
    }
    if (batch.empty()) continue;
    Execute(batch);
    for (auto& j : batch) j->done.signal();
  }
}

void start_executor() {
  bool expected = false;
  if (g_executor_started.compare_exchange_strong(expected, true)) {
    std::thread(executor_main).detach();
  }
}

class TorchFanout final : public CollectiveFanout {
 public:
  bool CanLower(const std::vector<EndPoint>& peers,
                const std::string& service,
                const std::string& method) override {
    if (g_run.load(std::memory_order_acquire) == nullptr) return false;
    if (peers.empty()) return false;
    // Only methods with a registered device implementation lower, and
    // only when every peer's server advertised the SAME implementation
    // during its transport handshake. Reads the C++ mirror, never the GIL.
    const std::string impl = tpu::LocalDeviceImpl(service, method);
    if (impl.empty()) return false;
    {
      std::lock_guard<std::mutex> lk(q_mu());
      if (q().size() >= kMaxQueuedJobs) return false;
    }
    return tpu::AllPeersAdvertise(peers, service, method, impl);
  }

  int BroadcastGather(const std::vector<EndPoint>& peers,
                      const std::string& service, const std::string& method,
                      const IOBuf& request, int64_t timeout_ms,
                      std::vector<IOBuf>* responses,
                      std::vector<int>* errors) override {
    start_executor();
    auto job = std::make_shared<FanoutJob>();
    job->service = service;
    job->method = method;
    job->payload = request.to_string();
    job->n_peers = peers.size();
    job->timeout_ms = timeout_ms;
    for (const EndPoint& p : peers) {
      if (!tpu::PeerIsLocalHost(p)) {
        job->all_local = false;
        break;
      }
    }
    {
      std::lock_guard<std::mutex> lk(q_mu());
      if (q().size() >= kMaxQueuedJobs) {
        // Backed up past the CanLower check (race): fail the peers rather
        // than park another payload copy.
        for (size_t i = 0; i < peers.size(); ++i) {
          (*errors)[i] = EOVERCROWDED;
        }
        return 0;
      }
      q().push_back(job);
    }
    q_cv().notify_one();
    const int64_t abstime_us =
        timeout_ms > 0 ? monotonic_time_us() + timeout_ms * 1000 : -1;
    if (job->done.wait(abstime_us) != 0) {
      // Deadline: abandon the job (the executor drops its results) and
      // fail every peer; the worker pool keeps flowing.
      job->abandoned.store(true, std::memory_order_release);
      for (size_t i = 0; i < peers.size(); ++i) {
        (*errors)[i] = ERPCTIMEDOUT;
      }
      return 0;
    }
    if (job->rc != 0) return -1;
    for (size_t i = 0; i < peers.size(); ++i) {
      (*errors)[i] = job->errors[i];
      if (job->errors[i] == 0) {
        (*responses)[i].append(job->responses[i].data(),
                               job->responses[i].size());
      }
    }
    return 0;
  }
};

FanoutJob* job_at(void* batch, int b) {
  Batch* jobs = static_cast<Batch*>(batch);
  if (b < 0 || size_t(b) >= jobs->size()) return nullptr;
  return (*jobs)[size_t(b)].get();
}

}  // namespace
}  // namespace torch_port
}  // namespace tbus

using tbus::torch_port::FanoutJob;
using tbus::torch_port::job_at;

extern "C" {

// Installs the backend; `run` serves every lowered call from then on.
// Idempotent: a second call keeps the first callback.
int tbus_torch_fanout_enable(tbus::torch_port::RunFn run) {
  using namespace tbus::torch_port;
  static std::mutex mu;
  std::lock_guard<std::mutex> g(mu);
  if (run == nullptr) return -1;
  if (g_run.load(std::memory_order_acquire) != nullptr) return 0;
  g_run.store(run, std::memory_order_release);
  if (!tbus::tpu::NativeFanoutInstalled() &&
      tbus::get_collective_fanout() == nullptr) {
    tbus::set_collective_fanout(std::make_shared<TorchFanout>());
  }
  // Console observability (/vars, /metrics). Leaky: the detached executor
  // may outlive static destruction.
  static auto* lowered_var = new tbus::var::PassiveStatus<long>(
      "tbus_torch_fanout_lowered_calls",
      [] { return g_lowered.load(std::memory_order_relaxed); });
  static auto* queue_var = new tbus::var::PassiveStatus<size_t>(
      "tbus_torch_fanout_executor_queue", [] {
        std::lock_guard<std::mutex> lk(q_mu());
        return q().size();
      });
  (void)lowered_var;
  (void)queue_var;
  return 0;
}

long tbus_torch_fanout_lowered_calls() {
  return tbus::torch_port::g_lowered.load(std::memory_order_relaxed);
}

// ---- batch accessors, valid only inside the run callback ----
int tbus_torch_batch_size(void* batch) {
  return int(static_cast<tbus::torch_port::Batch*>(batch)->size());
}

// Parameters shared by the batch (the fuse key): from its first job.
const char* tbus_torch_batch_service(void* batch) {
  return job_at(batch, 0)->service.c_str();
}
const char* tbus_torch_batch_method(void* batch) {
  return job_at(batch, 0)->method.c_str();
}
long long tbus_torch_batch_n_peers(void* batch) {
  return (long long)job_at(batch, 0)->n_peers;
}
long long tbus_torch_batch_timeout_ms(void* batch) {
  return (long long)job_at(batch, 0)->timeout_ms;
}
int tbus_torch_batch_all_local(void* batch) {
  return job_at(batch, 0)->all_local ? 1 : 0;
}

// Job b's request payload: its length, and *data points at its bytes.
long long tbus_torch_batch_payload(void* batch, int b, const char** data) {
  FanoutJob* job = job_at(batch, b);
  if (job == nullptr) return -1;
  *data = job->payload.data();
  return (long long)job->payload.size();
}

// Sets peer i's response of job b. Returns 0, or -1 on a bad index.
int tbus_torch_batch_set_response(void* batch, int b, long long i,
                                  const char* data, long long len) {
  FanoutJob* job = job_at(batch, b);
  if (job == nullptr || i < 0 || size_t(i) >= job->n_peers || len < 0) {
    return -1;
  }
  job->responses.resize(job->n_peers);
  job->responses[size_t(i)].assign(data, size_t(len));
  return 0;
}

// Marks job b served: every peer's response is set.
int tbus_torch_batch_done(void* batch, int b) {
  FanoutJob* job = job_at(batch, b);
  if (job == nullptr) return -1;
  job->responses.resize(job->n_peers);
  job->errors.assign(job->n_peers, 0);
  job->rc = 0;
  return 0;
}

}  // extern "C"
