#include "cuda_fanout.h"

#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <utility>
#include <vector>

#include "base/logging.h"
#include "base/rand.h"
#include "base/time.h"
#include "cuda_runtime.h"
#include "rpc/errors.h"
#include "rpc/fanout_hooks.h"
#include "rpc/fault_injection.h"
#include "tpu/block_pool.h"
#include "tpu/device_registry.h"
#include "tpu/native_fanout.h"
#include "var/flags.h"
#include "var/reducer.h"

namespace tbus {
namespace cuda {

namespace {

// ---- builtins ----
// Byte-twins of the p2p server handlers (tbus_torch.rpc.builtin_handler)
// and of K7's ops: the divergence guard byte-compares the lowered result
// against what real servers answer.
enum class Builtin { kEcho = 0, kXor255 = 1, kAddPeerIndex = 2 };

bool builtin_of(const std::string& name, Builtin* out) {
  if (name == "echo") {
    *out = Builtin::kEcho;
  } else if (name == "xor255") {
    *out = Builtin::kXor255;
  } else if (name == "add_peer_index") {
    *out = Builtin::kAddPeerIndex;
  } else {
    return false;
  }
  return true;
}

std::mutex& mu() {
  static auto* m = new std::mutex;  // leaky: fibers may outlive statics
  return *m;
}

// (service, method) -> builtin; impl ids live in the device registry.
std::map<std::pair<std::string, std::string>, Builtin>& methods() {
  static auto* m = new std::map<std::pair<std::string, std::string>, Builtin>;
  return *m;
}

// ---- plan cache ----
// The device engine's plans are the runtime's K7 programs, cached there
// by shape (EnsureFanoutProgram says whether it made one); the host
// engine has nothing to compile, so only the shapes it has seen are kept,
// for the same hit/miss counts.
std::set<std::string>& host_shapes() {
  static auto* s = new std::set<std::string>;
  return *s;
}

// ---- counters / breaker ----
std::atomic<long> g_lowered{0};
std::atomic<long> g_scatter{0};
std::atomic<long> g_host_execs{0};
std::atomic<long> g_device_execs{0};
std::atomic<long> g_cache_hits{0};
std::atomic<long> g_cache_misses{0};
std::atomic<long> g_div_checked{0};
std::atomic<long> g_div_mismatch{0};
std::atomic<long> g_quarantines{0};
std::atomic<long> g_revivals{0};
std::atomic<long> g_repaired{0};
std::atomic<bool> g_installed{false};

// 0 = healthy; else the monotonic us when a revival probe may run.
std::atomic<int64_t> g_quarantined_until_us{0};
std::atomic<int64_t> g_backoff_ms{0};
std::atomic<bool> g_probe_inflight{false};

std::atomic<int64_t> g_divergence_permille{5};
std::atomic<int64_t> g_quarantine_ms{2000};
constexpr int64_t kMaxBackoffMs = 60 * 1000;

// The pool's largest slot class (cpp/tpu/block_pool.cc:48-50): a gather
// larger than this is split into one pool block per row.
constexpr size_t kLargestSlot = (1u << 20) + 8192;

int64_t env_int64(const char* name, int64_t dflt) {
  const char* v = getenv(name);
  if (v == nullptr || v[0] == '\0') return dflt;
  return strtoll(v, nullptr, 10);
}

void quarantine(bool was_probe) {
  int64_t backoff = g_backoff_ms.load(std::memory_order_relaxed);
  if (was_probe || backoff == 0) {
    backoff = backoff == 0 ? g_quarantine_ms.load(std::memory_order_relaxed)
                           : backoff * 2;
    if (backoff > kMaxBackoffMs) backoff = kMaxBackoffMs;
    g_backoff_ms.store(backoff, std::memory_order_relaxed);
  }
  g_quarantined_until_us.store(monotonic_time_us() + backoff * 1000,
                               std::memory_order_release);
  g_quarantines.fetch_add(1, std::memory_order_relaxed);
}

void revive() {
  g_quarantined_until_us.store(0, std::memory_order_release);
  g_backoff_ms.store(0, std::memory_order_relaxed);
  g_revivals.fetch_add(1, std::memory_order_relaxed);
}

// ---- engine selection ----
// TBUS_FANOUT_MESH=host: the host engine. Otherwise ("auto", "device" or
// unset) the device engine, which needs the runtime up.
enum class Engine { kHost, kDevice };

bool select_engine(Engine* out) {
  const char* mode = getenv("TBUS_FANOUT_MESH");
  if (mode != nullptr && strcmp(mode, "host") == 0) {
    *out = Engine::kHost;
    return true;
  }
  if (CudaRuntime::Get() == nullptr) return false;
  *out = Engine::kDevice;
  return true;
}

// ---- host engine ----
void host_transform(Builtin b, const char* src, char* dst, size_t len,
                    size_t peer) {
  switch (b) {
    case Builtin::kEcho:
      memcpy(dst, src, len);
      break;
    case Builtin::kXor255:
      for (size_t j = 0; j < len; ++j) dst[j] = char(uint8_t(src[j]) ^ 0xFF);
      break;
    case Builtin::kAddPeerIndex:
      for (size_t j = 0; j < len; ++j) {
        dst[j] = char(uint8_t(src[j]) + uint8_t(peer & 0xFF));
      }
      break;
  }
}

// From the request's blocks straight into one gather row.
void host_transform_buf(Builtin b, const IOBuf& src, char* dst,
                        size_t peer) {
  const size_t nb = src.backing_block_num();
  size_t off = 0;
  for (size_t i = 0; i < nb; ++i) {
    const IOBuf::BlockView v = src.backing_block(i);
    host_transform(b, v.data, dst + off, v.size, peer);
    off += v.size;
  }
}

// One pool block shared by several IOBuf slices.
struct GatherRef {
  char* base;
  std::atomic<int> refs;
};
void gather_unref(void*, void* ctx) {
  auto* r = static_cast<GatherRef*>(ctx);
  if (r->refs.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    tpu::pool_deallocate(r->base);
    delete r;
  }
}

void free_pool_block(void* p) { tpu::pool_deallocate(p); }

// Pins every attached peer region behind the request views for the whole
// execution: a peer link dying mid-collective must fail the call, never
// unmap the bytes under the transform or the device's DMA.
class RegionPins {
 public:
  void PinViews(const IOBuf& buf) {
    const size_t nb = buf.backing_block_num();
    for (size_t i = 0; i < nb; ++i) {
      const IOBuf::BlockView v = buf.backing_block(i);
      uint64_t token = 0;
      uint32_t region = 0;
      if (!tpu::pool_region_ref_of(v.data, &token, &region)) continue;
      bool dup = false;
      for (const auto& p : pins_) {
        if (p.first == token && p.second == region) {
          dup = true;
          break;
        }
      }
      if (dup) {
        tpu::pool_region_release(token, region);  // already pinned once
      } else {
        pins_.emplace_back(token, region);
      }
    }
  }
  ~RegionPins() {
    for (const auto& p : pins_) tpu::pool_region_release(p.first, p.second);
  }

 private:
  std::vector<std::pair<uint64_t, uint32_t>> pins_;
};

class CudaFanout final : public CollectiveFanout {
 public:
  bool CanLower(const std::vector<EndPoint>& peers,
                const std::string& service,
                const std::string& method) override {
    if (peers.empty()) return false;
    {
      std::lock_guard<std::mutex> g(mu());
      if (methods().count({service, method}) == 0) return false;
    }
    Engine eng;
    if (!select_engine(&eng)) return false;
    // Breaker: quarantined until the window expires, then exactly one
    // revival probe (always verified against p2p) may pass.
    const int64_t until =
        g_quarantined_until_us.load(std::memory_order_acquire);
    if (until != 0) {
      if (monotonic_time_us() < until) return false;
      bool expected = false;
      if (!g_probe_inflight.compare_exchange_strong(expected, true)) {
        return false;
      }
    }
    const std::string impl = tpu::LocalDeviceImpl(service, method);
    if (impl.empty() || !tpu::AllPeersAdvertise(peers, service, method, impl)) {
      if (until != 0) g_probe_inflight.store(false);
      return false;
    }
    return true;
  }

  bool ShouldVerifyAgainstP2P() override {
    if (g_probe_inflight.load(std::memory_order_acquire)) return true;
    const int64_t pm = g_divergence_permille.load(std::memory_order_relaxed);
    return pm > 0 && int64_t(fast_rand_less_than(1000)) < pm;
  }

  void OnP2PComparison(bool matched) override {
    g_div_checked.fetch_add(1, std::memory_order_relaxed);
    const bool probing = g_probe_inflight.exchange(false);
    if (matched) {
      if (probing) revive();
      return;
    }
    g_div_mismatch.fetch_add(1, std::memory_order_relaxed);
    quarantine(probing);
  }

  void OnComparisonSkipped() override {
    if (g_probe_inflight.exchange(false)) {
      g_quarantined_until_us.store(
          monotonic_time_us() +
              g_backoff_ms.load(std::memory_order_relaxed) * 1000,
          std::memory_order_release);
    }
  }

  void OnLoweredError() override {
    g_repaired.fetch_add(1, std::memory_order_relaxed);
    quarantine(g_probe_inflight.exchange(false));
  }

  bool CanScatter() override { return true; }

  int BroadcastGather(const std::vector<EndPoint>& peers,
                      const std::string& service, const std::string& method,
                      const IOBuf& request, int64_t timeout_ms,
                      std::vector<IOBuf>* responses,
                      std::vector<int>* errors) override {
    return Run(peers, service, method, &request, nullptr, timeout_ms,
               responses, errors);
  }

  int ScatterGather(const std::vector<EndPoint>& peers,
                    const std::string& service, const std::string& method,
                    const std::vector<IOBuf>& requests, int64_t timeout_ms,
                    std::vector<IOBuf>* responses,
                    std::vector<int>* errors) override {
    return Run(peers, service, method, nullptr, &requests, timeout_ms,
               responses, errors);
  }

 private:
  // One lowered op. broadcast: `request` set; scatter: `requests` set.
  int Run(const std::vector<EndPoint>& peers, const std::string& service,
          const std::string& method, const IOBuf* request,
          const std::vector<IOBuf>* requests, int64_t timeout_ms,
          std::vector<IOBuf>* responses, std::vector<int>* errors) {
    const size_t n = peers.size();
    const bool scatter = requests != nullptr;
    Builtin builtin;
    {
      std::lock_guard<std::mutex> g(mu());
      auto it = methods().find({service, method});
      if (it == methods().end()) return -1;
      builtin = it->second;
    }
    Engine eng;
    if (!select_engine(&eng)) return -1;

    // The scatter bucket covers the largest shard, so one program serves
    // the whole partition set.
    size_t max_len = request != nullptr ? request->size() : 0;
    if (scatter) {
      for (const IOBuf& r : *requests) max_len = std::max(max_len, r.size());
    }
    const size_t bucket = DeviceLenClass(max_len);

    const std::string shape =
        std::string(scatter ? "scatter:" : "bcast:") +
        std::to_string(int(builtin)) + ":" + std::to_string(n) + ":" +
        std::to_string(bucket);
    // One plan per shape: the program does not depend on the timeout,
    // and the reference's insert race (two callers planning one shape)
    // is a hit for the one that finds the other's plan.
    int handle = -1;
    bool created = false;
    if (eng == Engine::kDevice) {
      std::string why;
      handle = CudaRuntime::Get()->EnsureFanoutProgram(
          "fanout:" + shape, int(builtin), n, bucket, scatter, &created,
          &why);
      if (handle < 0) {
        LOG(ERROR) << "cuda fanout: no K7 program for " << shape << ": "
                   << why;
        return -1;
      }
    } else {
      std::lock_guard<std::mutex> g(mu());
      created = host_shapes().insert(shape).second;
    }
    (created ? g_cache_misses : g_cache_hits)
        .fetch_add(1, std::memory_order_relaxed);

    RegionPins region_pins;
    if (scatter) {
      for (const IOBuf& r : *requests) region_pins.PinViews(r);
    } else {
      region_pins.PinViews(*request);
    }
    std::vector<size_t> req_len(n, 0);
    if (scatter) {
      for (size_t i = 0; i < n; ++i) req_len[i] = (*requests)[i].size();
    } else {
      req_len.assign(n, request->size());
    }

    // rows[r] holds row_bytes of the gather; row_of[i] / row_off[i] say
    // where peer i's bytes are.
    const size_t total = n * bucket;
    const bool per_row = total > kLargestSlot;
    const size_t row_bytes = per_row ? bucket : total;
    std::vector<char*> rows(per_row ? n : 1, nullptr);
    for (char*& r : rows) {
      r = static_cast<char*>(tpu::pool_allocate(row_bytes));
      if (r == nullptr) {
        for (char* q : rows) {
          if (q != nullptr) tpu::pool_deallocate(q);
        }
        return -1;
      }
    }
    auto free_rows = [&rows] {
      for (char* q : rows) tpu::pool_deallocate(q);
    };

    int rc = 0;
    if (eng == Engine::kHost) {
      for (size_t i = 0; i < n; ++i) {
        const IOBuf& src = scatter ? (*requests)[i] : *request;
        char* dst = per_row ? rows[i] : rows[0] + i * bucket;
        host_transform_buf(builtin, src, dst, i);
      }
      g_host_execs.fetch_add(1, std::memory_order_relaxed);
    } else {
      // The device reads the request views themselves: a row that is one
      // block of a registered range and fills the bucket is donated, and
      // each gather row that is registered pool memory is aliased.
      std::vector<IOBuf> inputs;
      if (scatter) {
        inputs = *requests;
      } else {
        inputs.push_back(*request);
      }
      rc = CudaRuntime::Get()->RunProgramRows(
          handle, inputs, scatter ? bucket : 0, rows.data(),
          rows.size(), row_bytes, timeout_ms);
      if (rc == 0) g_device_execs.fetch_add(1, std::memory_order_relaxed);
    }
    if (rc != 0) {
      // On ERPCTIMEDOUT the runtime never writes the rows after this.
      free_rows();
      LOG(ERROR) << "cuda fanout: lowered execution failed rc=" << rc
                 << " (" << shape << ")";
      return -1;
    }

    // Each peer's response: a zero-copy slice of its row, trimmed to its
    // request's length (the builtins preserve length, as the p2p
    // handlers do).
    if (per_row) {
      for (size_t i = 0; i < n; ++i) {
        IOBuf row;
        row.append_user_data(rows[i], bucket, free_pool_block);
        row.cutn(&(*responses)[i], req_len[i]);
        (*errors)[i] = 0;
      }
    } else {
      IOBuf gather;
      auto* ref = new GatherRef{rows[0], {1}};
      gather.append_user_data(rows[0], total, gather_unref, ref);
      for (size_t i = 0; i < n; ++i) {
        IOBuf row;
        gather.cutn(&row, bucket);
        row.cutn(&(*responses)[i], req_len[i]);
        (*errors)[i] = 0;
      }
    }
    // Fault site for divergence-guard drills: corrupt peer 0's response
    // after the (correct) execution, as a bad lowering would.
    if (fi::fanout_corrupt.Evaluate() && req_len[0] > 0) {
      std::string bytes = (*responses)[0].to_string();
      bytes[0] = char(bytes[0] ^ 0x5A);
      (*responses)[0].clear();
      (*responses)[0].append(bytes);
    }
    g_lowered.fetch_add(1, std::memory_order_relaxed);
    if (scatter) g_scatter.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
};

}  // namespace

int EnableCudaFanout() {
  static std::mutex enable_mu;
  std::lock_guard<std::mutex> g(enable_mu);
  if (g_installed.load(std::memory_order_acquire)) return 0;
  if (tpu::NativeFanoutInstalled()) {
    LOG(ERROR) << "cuda fanout: the reference's native engine is installed";
    return -1;
  }
  g_divergence_permille.store(
      env_int64("TBUS_FANOUT_DIVERGENCE_PERMILLE", 5),
      std::memory_order_relaxed);
  g_quarantine_ms.store(env_int64("TBUS_FANOUT_QUARANTINE_MS", 2000),
                        std::memory_order_relaxed);
  var::flag_register("tbus_fanout_divergence_permille",
                     &g_divergence_permille,
                     "per-mille of lowered fan-outs byte-compared against "
                     "the p2p path (0 disables the divergence guard)",
                     0, 1000);
  var::flag_register("tbus_fanout_quarantine_ms", &g_quarantine_ms,
                     "base quarantine window after a lowering divergence "
                     "or engine error (doubles per failed revival probe)",
                     1, 10 * 60 * 1000);
  // Console observability (/vars, /metrics). Leaky: fibers may read them
  // during static destruction.
  struct Gauge {
    const char* name;
    std::atomic<long>* v;
  };
  static const Gauge kGauges[] = {
      {"tbus_fanout_native_lowered", &g_lowered},
      {"tbus_fanout_native_scatter", &g_scatter},
      {"tbus_fanout_native_cache_hits", &g_cache_hits},
      {"tbus_fanout_native_cache_misses", &g_cache_misses},
      {"tbus_fanout_divergence_checked", &g_div_checked},
      {"tbus_fanout_divergence_mismatch", &g_div_mismatch},
      {"tbus_fanout_quarantines", &g_quarantines},
      {"tbus_fanout_revivals", &g_revivals},
      {"tbus_fanout_repaired", &g_repaired},
  };
  for (const Gauge& gd : kGauges) {
    new var::PassiveStatus<long>(gd.name, [v = gd.v] {
      return v->load(std::memory_order_relaxed);
    });
  }
  new var::PassiveStatus<long>("tbus_fanout_quarantined", [] {
    return g_quarantined_until_us.load(std::memory_order_relaxed) != 0 ? 1L
                                                                       : 0L;
  });
  new var::PassiveStatus<size_t>("tbus_fanout_advertised_peers",
                                 [] { return tpu::PeerAdvertCount(); });
  set_collective_fanout(std::make_shared<CudaFanout>());
  g_installed.store(true, std::memory_order_release);
  LOG(INFO) << "cuda collective fan-out engine enabled (device engine"
            << (CudaRuntime::Get() != nullptr ? " up" : " waits for the "
                                                        "runtime")
            << ")";
  return 0;
}

bool CudaFanoutInstalled() {
  return g_installed.load(std::memory_order_acquire);
}

int RegisterCudaDeviceMethod(const char* service, const char* method,
                             const char* builtin, const char* impl_id) {
  Builtin b;
  if (!builtin_of(builtin, &b)) return -1;
  {
    std::lock_guard<std::mutex> g(mu());
    methods()[{service, method}] = b;
  }
  tpu::SetLocalDeviceImpl(service, method, impl_id);
  return 0;
}

int RegisterCudaDeviceEcho(const char* service, const char* method) {
  const int rc = RegisterCudaDeviceMethod(service, method, "echo", "echo/v1");
  if (rc == 0) tpu::AdvertiseDeviceMethod(service, method, "echo/v1");
  return rc;
}

CudaFanoutStats cuda_fanout_stats() {
  CudaFanoutStats st;
  st.installed = g_installed.load(std::memory_order_relaxed);
  st.quarantined =
      g_quarantined_until_us.load(std::memory_order_relaxed) != 0;
  st.lowered_calls = g_lowered.load(std::memory_order_relaxed);
  st.scatter_calls = g_scatter.load(std::memory_order_relaxed);
  st.host_execs = g_host_execs.load(std::memory_order_relaxed);
  st.device_execs = g_device_execs.load(std::memory_order_relaxed);
  st.cache_hits = g_cache_hits.load(std::memory_order_relaxed);
  st.cache_misses = g_cache_misses.load(std::memory_order_relaxed);
  st.divergence_checked = g_div_checked.load(std::memory_order_relaxed);
  st.divergence_mismatch = g_div_mismatch.load(std::memory_order_relaxed);
  st.quarantines = g_quarantines.load(std::memory_order_relaxed);
  st.revivals = g_revivals.load(std::memory_order_relaxed);
  st.repaired_calls = g_repaired.load(std::memory_order_relaxed);
  return st;
}

void CudaFanoutResetForTest() {
  g_quarantined_until_us.store(0);
  g_backoff_ms.store(0);
  g_probe_inflight.store(false);
  for (std::atomic<long>* c :
       {&g_lowered, &g_scatter, &g_host_execs, &g_device_execs,
        &g_cache_hits, &g_cache_misses, &g_div_checked, &g_div_mismatch,
        &g_quarantines, &g_revivals, &g_repaired}) {
    c->store(0);
  }
}

}  // namespace cuda
}  // namespace tbus
