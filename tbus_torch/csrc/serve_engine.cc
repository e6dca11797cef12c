#include "serve_engine.h"

#include <cerrno>
#include <utility>

#include "cuda_runtime.h"
#include "rpc/errors.h"

namespace tbus {
namespace cuda {

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

}  // namespace cuda
}  // namespace tbus
