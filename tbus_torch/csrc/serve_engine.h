// The serving plane's CUDA step engine: the counterpart of
// cpp/tpu/serve_engine.cc's PjrtStepEngine (:46-75).
#pragma once

#include <atomic>
#include <memory>
#include <string>

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

}  // namespace cuda
}  // namespace tbus
