// The serving plane's step engines on the port's device runtime: the
// counterparts of cpp/tpu/serve_engine.cc's PjrtStepEngine (:46-75) and
// FanoutStepEngine (:74-135).
#pragma once

#include <atomic>
#include <cstdint>
#include <memory>
#include <string>
#include <vector>

#include "base/endpoint.h"
#include "rpc/serve_batch.h"

namespace tbus {
namespace cuda {

// One fused step per batch: u8[bucket_rows * token_bytes] through the
// device runtime's u8 transform, one plan per batch bucket (key
// "serve-step:<transform>:<n>"), run with a 5000 ms deadline.
class CudaStepEngine final : public serve::StepEngine {
 public:
  CudaStepEngine(std::string transform, std::string platform);
  int RunStep(const IOBuf& in, char* out, size_t rows, size_t bucket_rows,
              size_t token_bytes) override;
  // The runtime's platform: "cuda" on a card, "cpu" where the runtime
  // was brought up on the CPU backend.
  const char* name() const override { return platform_.c_str(); }

  long steps() const { return steps_.load(std::memory_order_relaxed); }
  long failures() const { return failures_.load(std::memory_order_relaxed); }

 private:
  const std::string transform_;
  const std::string platform_;
  std::atomic<long> steps_{0};
  std::atomic<long> failures_{0};
};

// nullptr for an unknown transform ("echo" | "xor255" | "incr") or when
// the device runtime is not up. The reference's NewAutoStepEngine (:171)
// then gives way to the host engine; the port does not: the caller's
// mount fails instead.
std::shared_ptr<CudaStepEngine> NewCudaStepEngine(
    const std::string& transform);

// Tensor-parallel serving: each fused step u8[bucket_rows * token_bytes]
// is cut into peers.size() contiguous shards and run as ONE ScatterGather
// through the installed collective fan-out backend (the port's K7 engine,
// cuda_fanout.h), peer i computing shard i. builtin is "echo" or
// "xor255"; the engine registers the client half of (service, method)
// under impl_id, and the peers advertise the same id. A step that cannot
// lower, or whose lowered op fails, is repaired on this card by the
// single-card step engine (K4), counted in fallback_steps; the reference
// repairs on the host. nullptr for another builtin, no peers, or no
// runtime.
std::shared_ptr<serve::StepEngine> NewFanoutStepEngine(
    const std::string& builtin, const std::string& impl_id,
    std::vector<EndPoint> peers, const std::string& service,
    const std::string& method, int64_t timeout_ms);

struct FanoutStepStats {
  long collective_steps = 0;  // steps that ran as one ScatterGather
  long fallback_steps = 0;    // repaired by the single-card engine
};
FanoutStepStats fanout_step_stats();

}  // namespace cuda
}  // namespace tbus
