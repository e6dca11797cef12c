#include "serve_engine.h"

#include <algorithm>
#include <cerrno>
#include <utility>

#include "cuda_fanout.h"
#include "cuda_runtime.h"
#include "rpc/errors.h"
#include "rpc/fanout_hooks.h"

namespace tbus {
namespace cuda {

namespace {

std::atomic<long> g_collective_steps{0};
std::atomic<long> g_fallback_steps{0};

class FanoutStepEngine final : public serve::StepEngine {
 public:
  FanoutStepEngine(std::vector<EndPoint> peers, std::string service,
                   std::string method, int64_t timeout_ms,
                   std::shared_ptr<serve::StepEngine> fallback)
      : peers_(std::move(peers)),
        service_(std::move(service)),
        method_(std::move(method)),
        timeout_ms_(timeout_ms),
        fallback_(std::move(fallback)) {}

  int RunStep(const IOBuf& in, char* out, size_t rows, size_t bucket_rows,
              size_t token_bytes) override {
    const size_t total = bucket_rows * token_bytes;
    const size_t n = peers_.size();
    auto backend = get_collective_fanout();
    if (backend != nullptr && n > 0 && backend->CanScatter() &&
        backend->CanLower(peers_, service_, method_)) {
      // Peer i computes the i-th contiguous slice of the fused step.
      // Bucketing keeps every shard length stable across steps, so the
      // backend's plan cache serves steady state from hits.
      const size_t shard = (total + n - 1) / n;
      std::vector<IOBuf> requests(n);
      IOBuf rest = in;  // block refs, no byte copy
      for (size_t i = 0; i < n; ++i) {
        const size_t take = std::min(shard, rest.size());
        if (take > 0) rest.cutn(&requests[i], take);
      }
      std::vector<IOBuf> responses(n);
      std::vector<int> errors(n, 0);
      const int rc = backend->ScatterGather(peers_, service_, method_,
                                            requests, timeout_ms_,
                                            &responses, &errors);
      if (rc == 0) {
        bool all_ok = true;
        size_t off = 0;
        for (size_t i = 0; i < n; ++i) {
          if (errors[i] != 0 || responses[i].size() != requests[i].size()) {
            all_ok = false;
            break;
          }
          responses[i].copy_to(out + off, responses[i].size());
          off += responses[i].size();
        }
        if (all_ok && off == total) {
          g_collective_steps.fetch_add(1, std::memory_order_relaxed);
          return 0;
        }
      }
      // A failed lowered step is repaired below, never lost.
    }
    g_fallback_steps.fetch_add(1, std::memory_order_relaxed);
    return fallback_->RunStep(in, out, rows, bucket_rows, token_bytes);
  }
  const char* name() const override { return "fanout"; }

 private:
  const std::vector<EndPoint> peers_;
  const std::string service_;
  const std::string method_;
  const int64_t timeout_ms_;
  const std::shared_ptr<serve::StepEngine> fallback_;
};

}  // namespace

CudaStepEngine::CudaStepEngine(std::string transform, std::string platform)
    : transform_(std::move(transform)), platform_(std::move(platform)) {}

int CudaStepEngine::RunStep(const IOBuf& in, char* out, size_t rows,
                            size_t bucket_rows, size_t token_bytes) {
  (void)rows;
  CudaRuntime* rt = CudaRuntime::Get();
  if (rt == nullptr) return ENODEV;
  const size_t n = bucket_rows * token_bytes;
  // The batch-bucket plan key: growth and shrink inside a bucket rerun
  // the same plan; a new bucket makes its plan once.
  const std::string key =
      "serve-step:" + transform_ + ":" + std::to_string(n);
  const int handle = rt->EnsureProgram(key, transform_, n);
  int rc = EINTERNAL;
  if (handle >= 0) {
    size_t got = 0;
    rc = rt->RunProgramInto(handle, in, out, n, &got, 5000);
    if (rc == 0 && got != n) rc = EINTERNAL;
  }
  (rc == 0 ? steps_ : failures_).fetch_add(1, std::memory_order_relaxed);
  return rc;
}

std::shared_ptr<CudaStepEngine> NewCudaStepEngine(
    const std::string& transform) {
  CudaRuntime* rt = CudaRuntime::Get();
  if (rt == nullptr) return nullptr;
  if (transform != "echo" && transform != "xor255" && transform != "incr") {
    return nullptr;
  }
  return std::make_shared<CudaStepEngine>(transform, rt->stats().platform);
}

std::shared_ptr<serve::StepEngine> NewFanoutStepEngine(
    const std::string& builtin, const std::string& impl_id,
    std::vector<EndPoint> peers, const std::string& service,
    const std::string& method, int64_t timeout_ms) {
  // Only length-preserving builtins whose math is the same on every shard
  // keep tokens verifiable ("add_peer_index" would make a shard's bytes
  // depend on the peer's position).
  if (builtin != "echo" && builtin != "xor255") return nullptr;
  if (peers.empty()) return nullptr;
  auto fallback = NewCudaStepEngine(builtin);
  if (fallback == nullptr) return nullptr;
  RegisterCudaDeviceMethod(service.c_str(), method.c_str(), builtin.c_str(),
                           impl_id.c_str());
  return std::make_shared<FanoutStepEngine>(
      std::move(peers), service, method, timeout_ms > 0 ? timeout_ms : 1000,
      std::move(fallback));
}

FanoutStepStats fanout_step_stats() {
  FanoutStepStats st;
  st.collective_steps = g_collective_steps.load(std::memory_order_relaxed);
  st.fallback_steps = g_fallback_steps.load(std::memory_order_relaxed);
  return st;
}

}  // namespace cuda
}  // namespace tbus
