// The port's device runtime: the C++ road to an NVIDIA card.
//
// The counterpart of cpp/tpu/pjrt_runtime.{h,cc} (PjrtRuntime, :57-140):
// the same surface (Init, Get, EnsureU8Program, RunU8, RunProgramInto,
// SubmitU8Transform, stats) and the same rules, with hand-written CUDA
// kernels (device_programs.cu) in place of compiled StableHLO:
//  - one dispatch thread owns the device's work; callers never touch it
//    (a slow device costs calls, never fiber workers);
//  - programs are cached by (transform, length), plus by key for the
//    serving step's plans ("serve-step:<transform>:<n>");
//  - the queue is bounded (kMaxQueue 128): past it a job fails at once
//    with EOVERCROWDED;
//  - a caller whose deadline passes gets ERPCTIMEDOUT and its job is
//    abandoned: the dispatch thread never writes the caller's block after
//    that (RunProgramInto's guard);
//  - input shorter than the program is zero-padded; an elementwise
//    program's reply is cut to the input's length, a keyed program's is
//    its whole output;
//  - a bad dot128 length or dotbench name is refused with the reference's
//    text (pjrt_runtime.cc:215, :265);
//  - DMA registration (cpp/tpu/pjrt_dma.h, the reference's table, armed
//    with tbus_pjrt_enable_dma or TBUS_PJRT_DMA=1 before tbus_init): an
//    input that is one block of a registered range and fills its row of
//    the program is DONATED (the device reads it in place, pinned); an
//    output row that lies in a registered range is ALIASED (the device
//    writes it in place, pinned). Everything else crosses through the
//    plan's staging buffers and is counted by the tbus_pjrt_{h2d,d2h}_
//    copy_bytes tripwires (pjrt_runtime.cc:420-480);
//  - the core's /status page (and the heap profiler's) ends with the
//    block pool's line and this runtime's "cuda_runtime:" line, with the
//    keys of the reference's "pjrt:" line (cpp/tpu/tpu_endpoint.cc:1330),
//    from Init on.
//
// Device work sits behind a small backend interface. Init("cuda") loads
// the CUDA backend (cuda_backend.cu, built with nvcc) and fails where
// there is no card; Init("cpu") runs the programs as plain C++ loops, the
// part the reference's TBUS_PJRT_FAKE device plays (:780). Nothing falls
// back from one to the other. Host <-> device staging goes through
// buffers the backend owns per program (pinned, cudaHostAlloc, on CUDA).
// On CUDA the runtime installs cudaHostRegister / cudaHostUnregister as
// the DMA table's backend (tpu::SetPjrtDmaBackend); the CPU backend, like
// the reference's fake device, takes the table itself as its view of
// host memory.
#pragma once

#include <cstddef>
#include <cstdint>
#include <functional>
#include <string>
#include <vector>

#include "base/iobuf.h"

namespace tbus {

class Server;  // rpc/server.h

namespace cuda {

// The kernels of device_programs.cu, as counted in stats(): K4-K6 and
// K7, the fused fan-out.
enum Kernel {
  kU8Transform = 0,
  kDot128 = 1,
  kDotbench = 2,
  kFanout = 3,
  kKernels = 4
};

struct CudaStats {
  bool available = false;
  std::string platform;  // "cuda" or "cpu"
  std::string device;    // the card's name, or "host CPU"
  int devices = 0;       // devices the runtime drives (one once up)
  long plans = 0;        // programs prepared (the reference's compiles)
  long executions = 0;
  long long h2d_bytes = 0;
  long long d2h_bytes = 0;
  long zero_copy_h2d = 0;  // executions that read every input in place
  long errors = 0;
  long overcrowded = 0;  // jobs refused at the queue bound
  long long launches[kKernels] = {0, 0, 0, 0};  // by the CUDA backend
};

// One device job on the core's stage clock (monotonic_time_ns,
// CLOCK_MONOTONIC: the clock of the rpcz spans' stage stamps), as the
// runtime's record ring keeps it. Stamps come in this order; a job that
// failed before a stamp gets the time it failed there.
struct JobRecord {
  int64_t seq = 0;       // the job's number since Init (0, 1, ...)
  int64_t enq = 0;       // EnqueueJob queued it
  int64_t pick = 0;      // the dispatch thread popped it
  int64_t h2d = 0;       // the first Put issued (plan, pins, donation done)
  int64_t exec = 0;      // Exec issued
  int64_t synced = 0;    // Sync returned: the copies out are done
  int64_t replied = 0;   // the callback returned (a server's done():
                         // the reply written, on the dispatch thread)
  uint64_t trace_id = 0;  // the rpcz server span that queued it; 0 when
  uint64_t span_id = 0;   // rpcz is off or no span was current
  int32_t depth = 0;     // jobs queued ahead of it when it was queued
  int32_t rc = 0;
};
static_assert(sizeof(JobRecord) == 80, "rpc.JOB_DTYPE mirrors this layout");

// The CUDA backend's own record of the ranges cudaHostRegister accepted
// (the DMA table keeps an entry even where the backend refused one).
struct HostRegisterStats {
  long long ranges = 0;          // live registered ranges
  long long bytes = 0;
  long long read_only = 0;       // of which registered read-only
  long long failures = 0;        // ranges left unbound (staged, counted)
};

// What a program computes. K4-K6 map len bytes to len bytes; the fused
// fan-out (K7) maps u8[bucket] (broadcast) or u8[n * bucket] (scatter) to
// u8[n * bucket], row i = builtin(input row, i).
struct ProgramDesc {
  int kernel = kU8Transform;
  int op = 0;      // u8 transform: 0 echo, 1 xor255, 2 incr;
                   // fan-out: 0 echo, 1 xor255, 2 add_peer_index
  size_t len = 0;  // bytes in
  size_t out_len = 0;          // bytes out
  unsigned long n = 0, t = 0;  // dotbench<N>x<T>; fan-out: n peers
  size_t bucket = 0;           // fan-out row bytes
  bool scatter = false;        // fan-out: one input row per peer
};

// The device behind the runtime. Plans are made once per program and
// live as long as the process. One execution is Put (each input segment,
// host -> device), Exec (the program), Get (each output segment, device
// -> host) and Sync; a host pointer handed to Put or Get must stay valid
// until Sync returns. Each returns 0, or a nonzero code with *why set.
class DeviceBackend {
 public:
  virtual ~DeviceBackend() = default;
  virtual const char* platform() const = 0;
  virtual std::string device_name() const = 0;
  virtual void* NewPlan(const ProgramDesc& desc, std::string* why) = 0;
  // The plan's host staging buffers (len and out_len bytes).
  virtual char* Staging(void* plan, bool output) = 0;
  virtual int Put(void* plan, size_t off, const char* src, size_t len,
                  std::string* why) = 0;
  // wait: return only once the program has finished on the device.
  virtual int Exec(void* plan, bool wait, std::string* why) = 0;
  virtual int Get(void* plan, size_t off, size_t len, char* dst,
                  std::string* why) = 0;
  virtual int Sync(void* plan, std::string* why) = 0;
  // Whether the device may DMA [p, p+len) in place (write: as an output)
  // once the DMA table pinned it.
  virtual bool Covers(const void* p, size_t len, bool write) const = 0;
  virtual HostRegisterStats host_register_stats() const = 0;
  virtual long long Launches(int kernel) const = 0;
  virtual void ResetLaunches() = 0;
};

class CudaRuntime {
 public:
  // device "cuda": loads the CUDA backend from backend_so and opens the
  // first card (fails, with *why, where there is none). device "cpu":
  // the plain C++ backend. Idempotent once up (a second Init with
  // another device fails). Returns 0 on success.
  static int Init(const std::string& device, const char* backend_so,
                  std::string* why);

  // nullptr until Init succeeded.
  static CudaRuntime* Get();

  // Prepares (cached) the u8[len] -> u8[len] program `transform` ("echo",
  // "xor255", "incr", "dot128", "dotbench<N>x<T>"). Returns a handle >= 0,
  // or -1 with the refusal in *why.
  int EnsureU8Program(const std::string& transform, size_t len,
                      std::string* why = nullptr);

  // Prepares (cached by `key`) the elementwise program `transform` at
  // exactly n bytes whose reply is its whole output: the serving step's
  // plans (the counterpart of EnsureProgramMlir).
  int EnsureProgram(const std::string& key, const std::string& transform,
                    size_t n, std::string* why = nullptr);

  // Prepares (cached by `key`) K7, the fused fan-out over n peers of
  // bucket-byte rows (builtin 0 echo, 1 xor255, 2 add_peer_index): the
  // counterpart of native_fanout.cc:166 fanout_mlir. Its reply is its
  // whole output, n * bucket bytes. *created (when given) says whether
  // this call made the program.
  int EnsureFanoutProgram(const std::string& key, int builtin, size_t n,
                          size_t bucket, bool scatter,
                          bool* created = nullptr,
                          std::string* why = nullptr);

  // Queue H2D -> kernel -> D2H and wait up to timeout_ms (<= 0: no
  // deadline). Appends the reply to *output: a fresh pool block, exposed
  // zero-copy (aliased when the block is registered). Returns 0,
  // ERPCTIMEDOUT past the deadline (the job is abandoned, its late result
  // dropped), or another rpc error code.
  int RunU8(int handle, const IOBuf& input, IOBuf* output,
            int64_t timeout_ms = 120000);

  // The same, with the program's whole output written into the caller's
  // block (out_cap must cover it; *out_len reports the length). On
  // ERPCTIMEDOUT the job is abandoned and never touches out_block after
  // this call returns.
  int RunProgramInto(int handle, const IOBuf& input, void* out_block,
                     size_t out_cap, size_t* out_len,
                     int64_t timeout_ms = 120000);

  // The fan-out form: input row i (inputs[i], at most `stride` bytes,
  // zero-padded) lands at i * stride of the program's input (stride 0:
  // inputs[0] is the whole input), and output row r (row_bytes each) is
  // written into rows[r]. Each row is donated or aliased on its own. The
  // abandon rule is RunProgramInto's.
  int RunProgramRows(int handle, const std::vector<IOBuf>& inputs,
                     size_t stride, char* const* rows, size_t nrows,
                     size_t row_bytes, int64_t timeout_ms = 120000);

  // Async form for server handlers: resolves (transform, plen) to a
  // program ON the dispatch thread, then runs it; cb runs there with the
  // rc, the reply and, on failure, the reason.
  using Callback = std::function<void(int rc, IOBuf out,
                                      const std::string& why)>;
  void SubmitU8Transform(const std::string& transform, size_t plen,
                         IOBuf input, Callback cb);

  CudaStats stats() const;
  HostRegisterStats host_register_stats() const;
  void ResetLaunches();

  // The job timeline, always on; the dispatch thread is its only writer.
  // stages_json(): cumulative since Init, log-linear histograms (16
  // buckets an octave, 64 ns to 2^36 ns, sparse [bucket, count] pairs,
  // every bucket's lower bound given once) of the hops queue (pick -
  // enq), host_prep (h2d - pick), device (synced - h2d), reply (replied
  // - synced) and job (replied - enq); the queue depth found at enqueue;
  // busy_ns (the sum of replied - pick); jobs over 5 ms by their largest
  // hop.
  std::string stages_json() const;
  // Copies the ring's records that overlap [since_ns, until_ns] (enq <=
  // until_ns, replied >= since_ns), oldest first, at most cap of them;
  // returns how many. The ring keeps the newest kJobRing jobs.
  static constexpr size_t kJobRing = 131072;
  size_t CopyJobs(int64_t since_ns, int64_t until_ns, JobRecord* out,
                  size_t cap) const;
};

// Mounts (service, method) on `s` with a handler that round-trips the
// payload through the device: pad to DeviceLenClass (dotbench takes its
// payload at its exact length), run `transform` on the dispatch thread,
// reply from its callback (the handler returns at once). The counterpart
// of pjrt_runtime.cc:1195 AddDeviceMethod. Returns AddMethod's result;
// the runtime is needed only once a request arrives.
int AddDeviceMethod(::tbus::Server* s, const std::string& service,
                    const std::string& method, const std::string& transform);

// Length class of a device-method payload: powers of two with 1.5x
// half-steps from 128 (the port's copy of pjrt_runtime.cc:1185).
size_t DeviceLenClass(size_t n);

}  // namespace cuda
}  // namespace tbus
