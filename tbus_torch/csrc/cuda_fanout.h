// The port's native collective fan-out: a CollectiveFanout with no Python
// on the hot path, the counterpart of cpp/tpu/native_fanout.{h,cc}.
//
// A ParallelChannel / PartitionChannel call whose every peer advertised
// the method's device implementation is answered by ONE execution of K7
// (device_programs.cu, tbus_fanout) on the port's device runtime
// (cuda_runtime.h): u8[bucket] -> u8[n * bucket] for a broadcast,
// u8[n * bucket] -> u8[n * bucket] for a scatter, with row i =
// builtin(row, i). The reference's rules are kept:
//  - eligibility: a registered builtin for (service, method), a local
//    device impl id, and every peer advertising the same id in its tpu://
//    handshake (device_registry.h);
//  - one plan per (engine, broadcast or scatter, builtin, n, bucket),
//    with hit/miss counts; an insert race counts as a hit. The device
//    engine's plans are the runtime's K7 programs themselves. A
//    difference: the reference's key also holds timeout_ms, which the
//    program does not depend on;
//  - the divergence guard (tbus_fanout_divergence_permille, default 5)
//    and the breaker (tbus_fanout_quarantine_ms, default 2000, doubling up
//    to 60 s, one revival probe at a time);
//  - the fanout_corrupt fault site, applied after a correct execution;
//  - the request views' peer regions pinned for the whole execution;
//  - responses as refcounted zero-copy slices of the gather, trimmed to
//    each request's length.
//
// Engines: "device" runs K7 through the runtime; "host" is the
// reference's host transform and runs only under TBUS_FANOUT_MESH=host.
// Without a runtime CanLower says no and the call goes p2p (the
// reference's rule for its device engine). A deliberate difference: the
// reference's "auto" takes the host engine when every peer is on this
// host; here "auto" means the device, whatever the peers' locality.
//
// Output rows: the gather is one pool block when it fits the pool's
// largest slot class, else one pool block per peer row, so that each
// row's device-to-host copy lands in registered memory (the reference
// allocates one block, which past 1 MiB + 8 KiB is malloc'd and stages).
//
// Selection order: this engine -> the torch bridge -> p2p. Enabling it
// displaces an installed torch backend; it refuses to install beside the
// reference's engine (NativeFanoutInstalled), whose flag and gauge names
// it shares.
#pragma once

#include <string>

namespace tbus {
namespace cuda {

// Installs the engine. Returns 0 (also when already installed), -1 when
// the reference's native engine is installed in this process.
int EnableCudaFanout();
bool CudaFanoutInstalled();

// Registers builtin ("echo", "xor255", "add_peer_index") for (service,
// method) under impl_id and mirrors it into the device registry. Returns
// 0; -1 for an unknown builtin.
int RegisterCudaDeviceMethod(const char* service, const char* method,
                             const char* builtin, const char* impl_id);
// Identity echo under "echo/v1", registered AND advertised.
int RegisterCudaDeviceEcho(const char* service, const char* method);

struct CudaFanoutStats {
  bool installed = false;
  bool quarantined = false;
  long lowered_calls = 0;  // broadcast + scatter
  long scatter_calls = 0;
  long host_execs = 0;     // host-engine executions
  long device_execs = 0;   // K7 executions through the runtime
  long cache_hits = 0;
  long cache_misses = 0;
  long divergence_checked = 0;
  long divergence_mismatch = 0;
  long quarantines = 0;
  long revivals = 0;
  long repaired_calls = 0;
};
CudaFanoutStats cuda_fanout_stats();

// Clears the breaker and zeroes the counters (drills start from a known
// state).
void CudaFanoutResetForTest();

}  // namespace cuda
}  // namespace tbus
