// The benchmark's load generator, built against the tbus core (libtbus.so)
// into benchmark/_build/ by benchmark/harness/gen.py.
//
// A copy of the core's own loop, tbus_bench_echo_proto (cpp/capi/capi.cc):
// `clients` fibers, each on a channel of its own, calling back to back or on
// a shared issue schedule (the token bucket of upstream rdma_performance's
// client). A client's channel is a plain channel to one address
// (lg_new_channel) or a combo channel, a ParallelChannel over sub-channels
// to several (lg_new_pchan, upstream parallel_echo's client). The copy
// closes what the original leaves open for a yardstick:
// - the payloads are the caller's (seeded), several per client, in turn;
// - every call's latency is kept, a failed or wrong one as a miss (-1);
// - failures and wrong replies are counted and returned, never thresholded;
// - every reply is compared byte for byte with the answer the caller
//   worked out for its request, after its latency has been stamped;
// - a paced call is timed from when it was due, not from when it went out.
//
// Plain C interface (lg_*), bound with ctypes by benchmark/harness/gen.py.

#include <string.h>

#include <algorithm>
#include <atomic>
#include <memory>
#include <string>
#include <vector>

#include "base/iobuf.h"
#include "base/time.h"
#include "fiber/fiber.h"
#include "fiber/sync.h"
#include "rpc/channel.h"
#include "rpc/channel_base.h"
#include "rpc/controller.h"
#include "rpc/parallel_channel.h"

struct lg_ctx;

namespace {

using tbus::Channel;
using tbus::ChannelBase;
using tbus::ChannelOptions;
using tbus::Controller;
using tbus::IOBuf;
using tbus::ParallelChannel;
using tbus::ParallelChannelOptions;

struct Ctx {
  std::vector<std::unique_ptr<ChannelBase>> channels;  // one per client
  std::string service, method;
  int clients = 0, per_client = 0;
  long long timeout_ms = 0;
  const char* payloads = nullptr;  // [clients][per_client][payload_len]
  long long payload_len = 0;
  const char* expected = nullptr;  // [clients][per_client][expected_len]
  long long expected_len = 0;
  std::vector<IOBuf> requests;     // the payloads as IOBufs

  // The last run.
  std::vector<std::vector<int64_t>> lat;  // per client, ns; -1 a miss
  std::atomic<long long> failed{0}, wrong{0};
  int first_error = 0;
  int64_t t_start = 0, t_end = 0;
};

const char* payload_of(const Ctx& c, int client, int k) {
  return c.payloads + (int64_t(client) * c.per_client + k) * c.payload_len;
}

const char* expected_of(const Ctx& c, int client, int k) {
  return c.expected + (int64_t(client) * c.per_client + k) * c.expected_len;
}

bool same_bytes(const IOBuf& got, const char* want, long long len) {
  if (int64_t(got.size()) != len) return false;
  long long off = 0;
  for (size_t i = 0; i < got.backing_block_num(); ++i) {
    const IOBuf::BlockView b = got.backing_block(i);
    if (memcmp(b.data, want + off, b.size) != 0) return false;
    off += int64_t(b.size);
  }
  return true;
}

// One call of client `i` with payload k; returns its outcome: 0 right,
// 1 failed (the code in *code), 2 answered wrong. *t_done is stamped as
// soon as the answer is in, before the reply is compared.
int call_once(Ctx* c, int i, int k, int64_t* t_done, int* code) {
  Controller cntl;
  IOBuf resp;
  c->channels[i]->CallMethod(c->service, c->method, &cntl,
                             c->requests[size_t(i) * c->per_client + k],
                             &resp, nullptr);
  *t_done = tbus::monotonic_time_ns();
  if (cntl.Failed()) {
    *code = cntl.ErrorCode();
    return 1;
  }
  return same_bytes(resp, expected_of(*c, i, k), c->expected_len) ? 0 : 2;
}

// The context without its channels or requests. payloads and expected
// stay the caller's and must outlive the context.
Ctx* new_ctx(const char* service, const char* method, int clients,
             int per_client, long long timeout_ms, const char* payloads,
             long long payload_len, const char* expected,
             long long expected_len) {
  auto* c = new Ctx;
  c->service = service;
  c->method = method;
  c->clients = clients;
  c->per_client = per_client;
  c->timeout_ms = timeout_ms;
  c->payloads = payloads;
  c->payload_len = payload_len;
  c->expected = expected;
  c->expected_len = expected_len;
  return c;
}

// The payloads as IOBufs, once the channels are up. As the original: a
// bulk payload appended whole rides right-sized pool slot blocks, what a
// real attachment append produces.
lg_ctx* with_requests(Ctx* c) {
  c->requests.resize(size_t(c->clients) * c->per_client);
  for (int i = 0; i < c->clients; ++i) {
    for (int k = 0; k < c->per_client; ++k) {
      c->requests[size_t(i) * c->per_client + k].append(
          payload_of(*c, i, k), size_t(c->payload_len));
    }
  }
  return reinterpret_cast<lg_ctx*>(c);
}

std::unique_ptr<Channel> new_sub(const char* addr, long long timeout_ms) {
  ChannelOptions opts;
  opts.timeout_ms = timeout_ms;
  auto ch = std::make_unique<Channel>();
  if (ch->Init(addr, &opts) != 0) return nullptr;
  return ch;
}

}  // namespace

extern "C" {

// `clients` channels to addr, each its own connection (the original's
// pooled configuration). NULL on a channel that does not initialise.
lg_ctx* lg_new_channel(const char* addr, const char* service,
                       const char* method, int clients, int per_client,
                       long long timeout_ms, const char* payloads,
                       long long payload_len, const char* expected,
                       long long expected_len) {
  Ctx* c = new_ctx(service, method, clients, per_client, timeout_ms,
                   payloads, payload_len, expected, expected_len);
  for (int i = 0; i < clients; ++i) {
    std::unique_ptr<Channel> ch = new_sub(addr, timeout_ms);
    if (ch == nullptr) {
      delete c;
      return nullptr;
    }
    c->channels.push_back(std::move(ch));
  }
  return with_requests(c);
}

// `clients` combo channels: each a ParallelChannel (the core's defaults:
// the call fails only if every sub-call fails; the sub-replies merged in
// sub-channel order) over channels of its own to addrs[0..n), with the
// call's deadline as the whole fan-out's. The expected reply is the merged
// one. NULL on a sub-channel that does not initialise.
lg_ctx* lg_new_pchan(const char* const* addrs, int n, const char* service,
                     const char* method, int clients, int per_client,
                     long long timeout_ms, const char* payloads,
                     long long payload_len, const char* expected,
                     long long expected_len) {
  Ctx* c = new_ctx(service, method, clients, per_client, timeout_ms,
                   payloads, payload_len, expected, expected_len);
  ParallelChannelOptions popts;
  popts.timeout_ms = timeout_ms;
  for (int i = 0; i < clients; ++i) {
    auto pchan = std::make_unique<ParallelChannel>();
    pchan->Init(&popts);
    for (int j = 0; j < n; ++j) {
      std::unique_ptr<Channel> ch = new_sub(addrs[j], timeout_ms);
      if (ch == nullptr ||
          pchan->AddChannel(ch.get(), tbus::OWNS_CHANNEL) != 0) {
        delete c;
        return nullptr;
      }
      ch.release();
    }
    c->channels.push_back(std::move(pchan));
  }
  return with_requests(c);
}

// Runs the loop: each client makes `calls` calls (calls > 0), or calls
// until `seconds` have passed since the start (calls <= 0). rate > 0
// paces issue at that many calls a second over all clients, each call
// timed from its slot; rate <= 0 is a closed loop. Returns 0, or -1 if a
// fiber did not start.
int lg_run(lg_ctx* ctx, long long calls, double seconds, double rate) {
  Ctx* c = reinterpret_cast<Ctx*>(ctx);
  c->lat.assign(size_t(c->clients), {});
  c->failed = 0;
  c->wrong = 0;
  c->first_error = 0;
  std::atomic<int> first_error{0};
  const int64_t interval_ns = rate > 0 ? int64_t(1e9 / rate) : 0;
  c->t_start = tbus::monotonic_time_ns();
  const int64_t t_stop = c->t_start + int64_t(seconds * 1e9);
  std::atomic<int64_t> next_slot{c->t_start};
  std::atomic<long long> done_at{c->t_start};
  tbus::fiber::CountdownEvent all_done(c->clients);
  for (int i = 0; i < c->clients; ++i) {
    std::vector<int64_t>* lats = &c->lat[size_t(i)];
    lats->reserve(calls > 0 ? size_t(calls) : size_t(1) << 16);
    const int rc = tbus::fiber_start([&, i, lats] {
      for (long long n = 0;; ++n) {
        if (calls > 0 ? n >= calls
                      : tbus::monotonic_time_ns() >= t_stop) {
          break;
        }
        int64_t t0;
        if (interval_ns > 0) {
          t0 = next_slot.fetch_add(interval_ns, std::memory_order_relaxed);
          if (calls <= 0 && t0 >= t_stop) break;
          const int64_t now = tbus::monotonic_time_ns();
          if (t0 > now) tbus::fiber_usleep((t0 - now) / 1000);
        } else {
          t0 = tbus::monotonic_time_ns();
        }
        int64_t t1 = 0;
        int code = 0;
        const int outcome = call_once(c, i, int(n % c->per_client), &t1,
                                      &code);
        if (outcome == 1) {
          c->failed.fetch_add(1, std::memory_order_relaxed);
          int none = 0;
          first_error.compare_exchange_strong(none, code);
        } else if (outcome == 2) {
          c->wrong.fetch_add(1, std::memory_order_relaxed);
        }
        lats->push_back(outcome == 0 ? t1 - t0 : -1);
        long long seen = done_at.load(std::memory_order_relaxed);
        while (t1 > seen &&
               !done_at.compare_exchange_weak(seen, t1,
                                              std::memory_order_relaxed)) {
        }
      }
      all_done.signal();
    });
    if (rc != 0) {
      all_done.signal(c->clients - i);
      all_done.wait();
      return -1;
    }
  }
  all_done.wait();
  c->t_end = done_at.load();
  c->first_error = first_error.load();
  return 0;
}

// Calls the last run made.
long long lg_calls(lg_ctx* ctx) {
  Ctx* c = reinterpret_cast<Ctx*>(ctx);
  long long n = 0;
  for (const auto& v : c->lat) n += (long long)v.size();
  return n;
}

// Copies the last run's latencies (ns, -1 a miss), client by client in
// issue order, into out[lg_calls()].
void lg_latencies(lg_ctx* ctx, long long* out) {
  Ctx* c = reinterpret_cast<Ctx*>(ctx);
  for (const auto& v : c->lat) out = std::copy(v.begin(), v.end(), out);
}

// The last run's counts and clock: out[0] failed, out[1] wrong, out[2] the
// first failure's error code, out[3] the start and out[4] the last
// completion (CLOCK_MONOTONIC ns).
void lg_summary(lg_ctx* ctx, long long* out) {
  Ctx* c = reinterpret_cast<Ctx*>(ctx);
  out[0] = c->failed.load();
  out[1] = c->wrong.load();
  out[2] = c->first_error;
  out[3] = c->t_start;
  out[4] = c->t_end;
}

void lg_free(lg_ctx* ctx) { delete reinterpret_cast<Ctx*>(ctx); }

}  // extern "C"
