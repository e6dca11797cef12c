"""Pythonic wrappers over the native tbus core, for the PyTorch port.

The port's own subset of tbus/rpc.py: servers, channels, the
ParallelChannel and the PartitionChannel whose all-tpu:// fan-outs lower
onto the card, either through the C++ engine :func:`enable_native_fanout`
installs (tbus_torch/csrc/cuda_fanout.cc: one K7 execution per call, no
Python on the path) or through the Python executor
:func:`enable_torch_fanout` installs (tbus_torch/csrc/torch_fanout.cc);
token streams, the serving bench and its stats; the C++ device plane
(tbus_torch/csrc/cuda_runtime.cc): :func:`device_init`, DMA registration
of the block pool (:func:`device_enable_dma`), ``Server.add_device_method``,
``Server.add_generate_method`` (with ``peers``, tensor-parallel) and
``Server.add_device_stream_sink`` with :func:`bench_device_stream`, whose
device work runs on the runtime's own dispatch thread; the core's C++
load generators (:func:`bench_echo`, :func:`bench_echo_overload`,
:func:`bench_stream`), the tpu:// per-stage timing (:func:`stage_stats`,
:func:`timeline_dump`), rpcz spans and mesh-wide tracing, the transport
counters; the core's flags, variables and fault sites; and its ops
planes: the channel options (protocols, connection types, compression,
cluster mode) with :class:`GrpcStub`, the flight recorder and wait
profiler, the SLO plane, the autotune controller, the cache tier with
record and replay, and the fleet metrics sink. Server handlers
registered from Python run inside fibers on the native worker fleet;
ctypes re-acquires the GIL per callback.

On the protobuf-free core (``_native.core_flavor()``) what needs
libprotobuf fails with the core's own message; nothing takes another
path in its place.
"""

from __future__ import annotations

import ctypes
import json
import contextlib
import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from tbus_torch import _native


class RpcError(Exception):
    def __init__(self, code: int, text: str):
        super().__init__(f"rpc error {code}: {text}")
        self.code = code
        self.text = text


def init(nworkers: int = 0) -> None:
    _native.lib().tbus_init(nworkers)


def _take_str(p: Optional[int]) -> str:
    """A malloc'd C string from the core or a bridge, freed here."""
    if not p:
        return ""
    try:
        return ctypes.string_at(p).decode()
    finally:
        _native.lib().tbus_buf_free(ctypes.cast(p, ctypes.c_char_p))


def _native_str(symbol: str) -> str:
    """The text a core function returns (malloc'd), freed here."""
    L = _native.lib()
    L.tbus_init(0)
    return _take_str(getattr(L, symbol)())


def _symbol(name: str) -> ctypes.CDLL:
    """The core, initialised, once it is known to export `name` (a
    prebuilt core named by TBUS_LIB may predate it)."""
    L = _native.lib()
    L.tbus_init(0)
    if not _native.has_symbol(L, name):
        raise RuntimeError(f"prebuilt libtbus predates {name}")
    return L


def _json_of(symbol: str, *args):
    """The JSON a core function returns (malloc'd), parsed."""
    return json.loads(_take_str(getattr(_symbol(symbol), symbol)(*args)))


def _report(p: Optional[int], err) -> dict:
    """A core drill's or bench's malloc'd JSON report, or RpcError with
    its error text when it returned none."""
    if not p:
        raise RpcError(-1, err.value.decode(errors="replace"))
    return json.loads(_take_str(p))


# ---- the device runtime (tbus_torch/csrc/cuda_runtime.cc) ----

def _device_bridge() -> ctypes.CDLL:
    from tbus_torch.kernels import _build

    return _build.device_bridge_lib()


def device_init(device: str = "cuda") -> None:
    """Brings up the port's C++ device runtime, once per process: "cuda"
    builds the kernels and the CUDA backend and opens the first card;
    "cpu" runs the same programs as plain C++ loops, and only when asked.
    Raises RuntimeError when the runtime cannot come up (no card for
    "cuda"); nothing falls back from one device to the other."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = None
    if device == "cuda":
        from tbus_torch.kernels import _build

        backend = _build.cuda_backend().encode()
    # The core first: its transport carves the block pool's first region
    # (bound to the device by the runtime) and installs its /status tail
    # once, which the runtime's own tail then replaces.
    _native.lib().tbus_init(0)
    err = ctypes.create_string_buffer(512)
    if _device_bridge().tbus_torch_device_init(
            device.encode(), backend, err, len(err)) != 0:
        raise RuntimeError(f"device runtime on {device}: "
                           f"{err.value.decode(errors='replace')}")


def device_available() -> bool:
    """Whether the device runtime is up in this process."""
    return _device_bridge().tbus_torch_device_available() == 1


def device_stats() -> dict:
    """The device runtime's counters: platform, device, devices, plans,
    executions, h2d/d2h bytes, zero_copy_h2d (executions that read every
    input in place), errors, overcrowded jobs, each kernel's launches (on
    the CUDA backend) and the DMA block (device_dma_stats). The core's
    /status page carries them too, on its "cuda_runtime:" line.

    "stages" is the job timeline, cumulative since device_init (None
    without the runtime), so the difference of two readings is exactly
    the jobs between them: "jobs" (records written), "ring_capacity",
    "bucket_lo_ns" (each histogram bucket's lower bound; a bucket ends
    where the next begins, the last is open), "hops" (queue = pick - enq,
    host_prep = h2d - pick, device = synced - h2d, reply = replied -
    synced, job = replied - enq: each {"count", "sum_ns", "buckets":
    [[bucket, count], ...]}), "depth" ([[jobs queued ahead, count],
    ...]), "busy_ns" (the dispatch thread's sum of replied - pick),
    "slow_jobs" (jobs over "over_ns" by the hop that took most of them).
    JOB_DTYPE names the stamps."""
    return json.loads(_take_str(
        _device_bridge().tbus_torch_device_stats_json()))


# One record of the device runtime's job ring (cuda_runtime.h JobRecord):
# its stamps are monotonic_time_ns (CLOCK_MONOTONIC), the clock of the
# rpcz spans' stage stamps; trace_id and span_id are the rpcz server span
# that queued the job (0 with rpcz off).
JOB_DTYPE = [("seq", "<i8"), ("enq", "<i8"), ("pick", "<i8"), ("h2d", "<i8"),
             ("exec", "<i8"), ("synced", "<i8"), ("replied", "<i8"),
             ("trace_id", "<u8"), ("span_id", "<u8"), ("depth", "<i4"),
             ("rc", "<i4")]


def device_jobs(since_ns: int = 0, until_ns: int = 2**63 - 1):
    """The device runtime's records of the jobs that overlap [since_ns,
    until_ns] on CLOCK_MONOTONIC (time.monotonic_ns()), oldest first, as
    a NumPy structured array of JOB_DTYPE: every job the dispatch thread
    ran (refused ones excepted), the newest ring_capacity of them kept.
    Raises RuntimeError without the runtime."""
    import numpy as np

    B = _device_bridge()
    size = ctypes.c_int(0)
    cap = B.tbus_torch_device_job_ring(ctypes.byref(size))
    dtype = np.dtype(JOB_DTYPE)
    if size.value != dtype.itemsize:
        raise RuntimeError(f"job record of {size.value} bytes, JOB_DTYPE "
                           f"{dtype.itemsize}")
    out = np.zeros(cap, dtype=dtype)
    n = B.tbus_torch_device_jobs(int(since_ns), int(until_ns),
                                 out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("device_jobs: the device runtime is not up")
    return out[:n].copy()


def reset_device_launches() -> None:
    """Sets the runtime's per-kernel launch counts to 0."""
    _device_bridge().tbus_torch_device_reset_launches()


def device_enable_dma() -> None:
    """Arms DMA registration of the block pool's regions (the reference's
    table, cpp/tpu/pjrt_dma.h): the device then reads donated request
    blocks in place and writes outputs straight into registered pool
    blocks; on the card the runtime binds each region with
    cudaHostRegister. Call it BEFORE the first init(), Server or Channel
    (or export TBUS_PJRT_DMA=1): it raises once the block pool is up,
    since the regions carved before it would be missed."""
    B = _device_bridge()
    if B.tbus_torch_block_pool_enabled():
        raise RuntimeError("device_enable_dma: the block pool is already up "
                           "(arm DMA before the first init/Server/Channel, "
                           "or export TBUS_PJRT_DMA=1)")
    if _native.lib().tbus_pjrt_enable_dma() != 0:
        raise RuntimeError("device_enable_dma failed")


def device_dma_stats() -> dict:
    """The DMA table's counters: registered regions, live pins, the
    staging tripwires h2d_copy_bytes / d2h_copy_bytes (bytes that crossed
    through a staging copy; a donation- and alias-clean run adds none),
    donation and alias hits and misses, refused registrations, deferred
    unregisters, and host_registered: the ranges the CUDA backend bound
    with cudaHostRegister (read-only ones, and failures, which stage)."""
    return json.loads(_take_str(_device_bridge().tbus_torch_dma_stats_json()))


def device_registered_regions() -> int:
    """Pool and peer regions currently DMA-registered with the device
    runtime (the reference's tbus_pjrt_registered_regions gauge)."""
    return int(_device_bridge().tbus_torch_dma_region_count())


def pjrt_h2d_copy_bytes() -> int:
    """The tbus_pjrt_h2d_copy_bytes tripwire (staged input bytes)."""
    return int(device_dma_stats()["h2d_copy_bytes"])


def pjrt_d2h_copy_bytes() -> int:
    """The tbus_pjrt_d2h_copy_bytes tripwire (staged output bytes)."""
    return int(device_dma_stats()["d2h_copy_bytes"])


def bench_device_stream(addr: str, total_bytes: int = 1 << 30,
                        chunk_bytes: int = 1 << 20,
                        transform: str = "echo",
                        service: str = "DeviceStream",
                        method: str = "Sink") -> dict:
    """Device-stream bench (device -> stream -> device): every chunk is
    produced on the device through the runtime (one reusable pool block
    donated as input, the output a fresh pool block, aliased) and written
    to a device stream sink (Server.add_device_stream_sink), which feeds
    it through its own device. Needs device_init first. Goodput counts
    bytes the sink consumed; gaps are between chunk completions."""
    B = _device_bridge()
    goodput, p50, p99 = (ctypes.c_double(), ctypes.c_double(),
                         ctypes.c_double())
    chunks = ctypes.c_longlong()
    err = ctypes.create_string_buffer(256)
    rc = B.tbus_torch_bench_device_stream(
        addr.encode(), service.encode(), method.encode(), total_bytes,
        chunk_bytes, transform.encode(), ctypes.byref(goodput),
        ctypes.byref(p50), ctypes.byref(p99), ctypes.byref(chunks), err)
    if rc != 0:
        raise RpcError(rc, "bench_device_stream failed: "
                       + err.value.decode(errors="replace"))
    return {"goodput_MBps": goodput.value, "gap_p50_us": p50.value,
            "gap_p99_us": p99.value, "chunks": chunks.value}


def stream_sink_stats() -> dict:
    """Bytes and chunks the device stream sinks of this process ran
    through the device, and chunks that failed (their stream closed)."""
    return json.loads(_take_str(
        _device_bridge().tbus_torch_stream_sink_stats_json()))


# ---- the C++ collective fan-out engine (tbus_torch/csrc/cuda_fanout.cc) ----

def enable_native_fanout() -> bool:
    """Installs the port's C++ collective fan-out engine: an eligible
    ParallelChannel/PartitionChannel call runs as ONE execution of K7 on
    the device runtime (device_init first; without it calls go p2p), with
    no Python on the path; TBUS_FANOUT_MESH=host takes the host engine
    instead. Selection order: this engine -> torch -> p2p (it displaces
    an installed torch backend). False where the reference's engine is
    already installed in this process."""
    return _device_bridge().tbus_torch_cuda_fanout_enable() == 0


def native_fanout_lowered_calls() -> int:
    """Calls the C++ engine has served (broadcast + scatter)."""
    return int(_device_bridge().tbus_torch_cuda_fanout_lowered_calls())


def register_native_device_method(service: str, method: str, builtin: str,
                                  impl_id: str) -> bool:
    """Client half of the lowering contract for the C++ engine: builtin
    ("echo", "xor255", "add_peer_index") for the method under impl_id;
    every peer must advertise the same id (advertise_device_method)."""
    _native.lib()
    return _device_bridge().tbus_torch_cuda_fanout_register(
        service.encode(), method.encode(), builtin.encode(),
        impl_id.encode()) == 0


def register_native_device_echo(service: str, method: str) -> bool:
    """Identity echo under "echo/v1", registered AND advertised."""
    _native.lib()
    return _device_bridge().tbus_torch_cuda_fanout_register_echo(
        service.encode(), method.encode()) == 0


def native_fanout_stats() -> dict:
    """The C++ engine's counters: lowered and scatter calls, host_execs
    (host engine) and device_execs (K7 executions), plan-cache hits and
    misses, divergence checks and mismatches, quarantines, revivals,
    p2p repairs, and the peers whose adverts this process holds."""
    return json.loads(_take_str(
        _device_bridge().tbus_torch_cuda_fanout_stats_json()))


def fanout_step_stats() -> dict:
    """Tensor-parallel serving: steps that ran as one ScatterGather
    (collective_steps) and steps repaired on the single-card engine
    (fallback_steps)."""
    return json.loads(_take_str(
        _device_bridge().tbus_torch_fanout_step_stats_json()))


# ---- the core's flags, variables and fault sites ----

def flag_set(name: str, value) -> None:
    """Sets a runtime-reloadable flag (e.g. tbus_fanout_divergence_permille;
    string flags take str values)."""
    L = _native.lib()
    L.tbus_init(0)
    text = value if isinstance(value, str) else str(int(value))
    if L.tbus_flag_set(name.encode(), text.encode()) != 0:
        raise ValueError(f"unknown flag or value out of range: {name!r}")


def var_value(name: str) -> str:
    """Current text of one exposed variable; empty when absent."""
    L = _native.lib()
    L.tbus_init(0)
    return _take_str(L.tbus_var_value(name.encode()))


def fi_set(site: str, permille: int, budget: int = -1, arg: int = 0) -> None:
    """Arms fault site `site` at permille/1000 (budget bounds the
    injections, -1 unlimited); permille 0 disarms."""
    L = _native.lib()
    L.tbus_init(0)
    if L.tbus_fi_set(site.encode(), permille, budget, arg) != 0:
        raise ValueError(f"unknown fault site or bad permille: {site!r}")


def fi_disable_all() -> None:
    L = _native.lib()
    L.tbus_init(0)
    L.tbus_fi_disable_all()


def fi_set_seed(seed: int) -> None:
    """Sets the replay seed: every site's decisions are a pure function of
    (seed, site, draw index). Rewinds all draw counters."""
    L = _native.lib()
    L.tbus_init(0)
    L.tbus_fi_set_seed(seed)


def fi_injected(site: str) -> int:
    """Faults injected at `site` so far (-1: unknown site)."""
    return _native.lib().tbus_fi_injected(site.encode())


def fi_probe(site: str, n: int) -> bytes:
    """Evaluates `site` n times and returns the 0/1 decision bytes (same
    seed and schedule, same bytes)."""
    L = _native.lib()
    out = (ctypes.c_ubyte * n)()
    if L.tbus_fi_probe(site.encode(), n, out) != 0:
        raise ValueError(f"unknown fault site: {site!r}")
    return bytes(out)


def fi_dump() -> str:
    """The /faults console page body (every site's arm state and counts)."""
    return _native_str("tbus_fi_dump")


def flag_get(name: str) -> int:
    """Current value of a runtime-reloadable flag."""
    L = _native.lib()
    L.tbus_init(0)
    out = ctypes.c_longlong(0)
    if L.tbus_flag_get(name.encode(), ctypes.byref(out)) != 0:
        raise ValueError(f"unknown flag: {name!r}")
    return out.value


def flag_domains() -> list:
    """Declared tunable domains: [{name, value, min, max, step, log,
    ladder}, ...]."""
    return json.loads(_native_str("tbus_flag_domain_json"))


def connections_dump() -> str:
    """Live-socket snapshot (the /connections page body; '[tpu]' marks
    native-transport sockets)."""
    return _native_str("tbus_connections_dump")


def budget_breakdown(echo_bytes: bytes) -> dict:
    """Decodes raw budget-echo bytes (response meta field 20) into the
    nested per-hop breakdown: {"hop", "queue_us", "handler_us",
    "total_us", "budget_us", "children": [{"callee", "observed_us",
    "echo": {...} | None}, ...]}. Raises ValueError on malformed
    bytes."""
    L = _native.lib()
    out = json.loads(_take_str(
        L.tbus_budget_breakdown_json(echo_bytes, len(echo_bytes))))
    if out is None:
        raise ValueError("malformed or empty budget echo")
    return out


# ---- the core's C++ load generators (no Python on their loops) ----

def bench_echo(addr: str, payload: int = 1 << 20, concurrency: int = 8,
               duration_ms: int = 2000, qps: float = 0.0,
               protocol: str = "", service: str = "",
               method: str = "") -> dict:
    """The core's echo load loop: `concurrency` fibers, each on its own
    connection, issue back-to-back calls of `payload` bytes for
    duration_ms; qps > 0 paces issue with a token bucket. protocol picks
    the client wire ("tbus_std" default, "http", "h2", "grpc", "thrift",
    "nshead"); service/method override the default EchoService.Echo
    target (a device method, say). Returns qps, MBps (one direction) and
    p50/p99/p999 latency in us over the successful calls."""
    L = _native.lib()
    L.tbus_init(0)
    out = [ctypes.c_double() for _ in range(5)]
    refs = [ctypes.byref(v) for v in out]
    if _native.has_symbol(L, "tbus_bench_echo_proto"):
        rc = L.tbus_bench_echo_proto(
            addr.encode(), protocol.encode(), service.encode(),
            method.encode(), payload, concurrency, duration_ms, qps, *refs)
    elif protocol or service or method:
        raise RuntimeError(
            "this libtbus.so predates tbus_bench_echo_proto; rebuild it "
            "to use protocol/service/method")
    else:
        rc = L.tbus_bench_echo_ex(addr.encode(), payload, concurrency,
                                  duration_ms, qps, *refs)
    if rc != 0:
        raise RuntimeError(f"bench_echo failed: {rc}")
    return dict(zip(("qps", "MBps", "p50_us", "p99_us", "p999_us"),
                    (v.value for v in out)))


def bench_echo_overload(addr: str, service: str = "", method: str = "",
                        payload: int = 64, concurrency: int = 16,
                        duration_ms: int = 2000, qps: float = 0.0,
                        timeout_ms: int = 100) -> dict:
    """The core's overload loop: offered load past capacity on purpose,
    every request carrying timeout_ms as its wire deadline, no retries.
    Returns goodput qps and p50/p99 over the successes, and the failure
    split: shed (server-side ELIMIT + EDEADLINEPASSED), timedout (client
    deadline), other."""
    L = _native.lib()
    L.tbus_init(0)
    dbl = [ctypes.c_double() for _ in range(3)]
    cnt = [ctypes.c_longlong() for _ in range(4)]
    rc = L.tbus_bench_echo_overload(
        addr.encode(), service.encode(), method.encode(), payload,
        concurrency, duration_ms, qps, timeout_ms,
        *[ctypes.byref(v) for v in dbl], *[ctypes.byref(v) for v in cnt])
    if rc != 0:
        raise RuntimeError(f"bench_echo_overload failed: {rc}")
    keys = ("goodput_qps", "p50_us", "p99_us", "ok", "shed", "timedout",
            "other")
    return dict(zip(keys, [v.value for v in dbl + cnt]))


def bench_stream(addr: str, total_bytes: int = 1 << 30,
                 chunk_bytes: int = 1 << 20, service: str = "StreamService",
                 method: str = "Sink") -> dict:
    """The core's stream loop: streams total_bytes in chunk_bytes chunks
    to a stream-sink method (Server.add_stream_sink), waits until the
    sink consumed everything, and reports goodput (MB/s) and the
    inter-chunk-completion gap percentiles (us)."""
    L = _native.lib()
    L.tbus_init(0)
    dbl = [ctypes.c_double() for _ in range(3)]
    chunks = ctypes.c_longlong()
    err = ctypes.create_string_buffer(256)
    rc = L.tbus_bench_stream(
        addr.encode(), service.encode(), method.encode(), total_bytes,
        chunk_bytes, *[ctypes.byref(v) for v in dbl], ctypes.byref(chunks),
        err)
    if rc != 0:
        raise RpcError(rc, "bench_stream failed: "
                       + err.value.decode(errors="replace"))
    return {"goodput_MBps": dbl[0].value, "gap_p50_us": dbl[1].value,
            "gap_p99_us": dbl[2].value, "chunks": chunks.value}


# ---- per-stage timing and tracing ----

def rpcz_enable(on: bool = True) -> None:
    """Toggles rpcz span tracing (costs an allocation per RPC)."""
    L = _native.lib()
    L.tbus_init(0)
    L.tbus_rpcz_enable(1 if on else 0)


def rpcz_dump() -> str:
    """Text dump of recent spans (newest first)."""
    return _native_str("tbus_rpcz_dump")


def rpcz_dump_json() -> list:
    """Recent spans as dicts (ids in hex; stage-clock stamps in ns under
    "stages"; annotations as [offset_us, text] pairs)."""
    text = _native_str("tbus_rpcz_dump_json")
    return json.loads(text) if text else []


def stage_stats() -> dict:
    """Per-stage percentile stats of the tpu:// fast path's decomposition:
    {"tbus_shm_stage_<hop>": {"count": N, "p50_ns": ..., "p99_ns": ...,
    ...}, ...} (ns). A TCP call leaves it untouched."""
    text = _native_str("tbus_stage_stats_json")
    return json.loads(text) if text else {}


def timeline_dump() -> str:
    """The /timeline page body: the per-stage percentile table and the
    slowest staged spans as waterfalls."""
    return _native_str("tbus_timeline_dump")


def trace_set_collector(addr: str) -> None:
    """Points this process's span exporter at a TraceSink collector
    ("host:port"; "" disables): completed rpcz spans batch out over an
    ordinary channel, head-sampled at tbus_trace_export_permille, slow
    and failed traces always. Children inherit $TBUS_TRACE_COLLECTOR."""
    L = _native.lib()
    L.tbus_init(0)
    if L.tbus_trace_set_collector(addr.encode()) != 0:
        raise RuntimeError("trace_set_collector failed")


def trace_flush() -> int:
    """Ships all queued spans to the collector now; returns the spans
    shipped, -1 when no collector is set."""
    L = _native.lib()
    L.tbus_init(0)
    return L.tbus_trace_flush()


def trace_query(trace_id_hex: str) -> list:
    """Spans of one trace collected by this process's TraceSink, each
    with its origin "process"; empty when it holds none."""
    L = _native.lib()
    L.tbus_init(0)
    text = _take_str(L.tbus_trace_query_json(trace_id_hex.encode()))
    return json.loads(text) if text else []


def trace_perfetto() -> dict:
    """The merged mesh timeline (collected and local spans) as Perfetto
    trace-event JSON, one track per process."""
    text = _native_str("tbus_trace_perfetto_json")
    return json.loads(text) if text else {}


def trace_stats() -> dict:
    """Exporter and collector counters: exported, dropped, batches,
    send_fail, sink_spans, tail_kept, store_evicted, store_traces,
    store_bytes."""
    text = _native_str("tbus_trace_stats_json")
    return json.loads(text) if text else {}


# ---- transport counters ----

def shm_lanes() -> int:
    """The shm descriptor-ring lane count advertised to new tpu://
    handshakes (the clamped tbus_shm_lanes flag; 0 = one lane)."""
    L = _native.lib()
    L.tbus_init(0)
    return int(L.tbus_shm_lanes())


def shm_zero_copy_frames() -> int:
    """Frames the shm fabric shipped as zero-copy descriptors of exported
    pool blocks."""
    L = _native.lib()
    L.tbus_init(0)
    return int(L.tbus_shm_zero_copy_frames())


def shm_payload_copy_bytes() -> int:
    """Payload-copy tripwire of the shm plane: bytes of chain-grain
    (>= 16 KiB) exportable fragments that paid an arena copy."""
    L = _native.lib()
    L.tbus_init(0)
    return int(L.tbus_shm_payload_copy_bytes())


def fd_loops() -> int:
    """The fd event-loop count of the TCP path (SO_REUSEPORT acceptor
    shards and worker-polled epoll loops; $TBUS_DISPATCHERS at first
    socket use)."""
    L = _native.lib()
    L.tbus_init(0)
    return int(L.tbus_fd_loops())


def fd_rtc_max_bytes() -> int:
    """The run-to-completion byte cap for fd input events (0: off)."""
    L = _native.lib()
    L.tbus_init(0)
    return int(L.tbus_fd_rtc_max_bytes())


# ---- the flight recorder: wait profiler, flight ring, triggers ----

def wait_profiler_enable(on: bool = True) -> None:
    """Turns the off-CPU wait profiler on or off: the sites where fibers
    park on a butex are sampled through a collector budget and summed per
    backtrace, classed lock, io, timer or deadline (the /wait page)."""
    _symbol("tbus_wait_profiler_enable").tbus_wait_profiler_enable(
        1 if on else 0)


def wait_profile_dump() -> str:
    """The wait-site report, hottest first and classed (the /wait page
    body)."""
    return _take_str(_symbol("tbus_wait_profile_dump")
                     .tbus_wait_profile_dump())


def wait_profile_stats() -> dict:
    """{"enabled", "sites", "samples", "total_wait_us", "classes":
    {"lock": us, ...}}."""
    return _json_of("tbus_wait_profile_stats")


def wait_profile_reset() -> None:
    """Zeroes every wait site's counters (the sites stay)."""
    _symbol("tbus_wait_profile_reset").tbus_wait_profile_reset()


def flight_ring(max_records: int = 256) -> list:
    """The newest call completions of the always-on flight ring, newest
    first: [{"t_us", "method", "peer", "err", "lat_us", "trace_id"},
    ...]; empty while the ring is off (tbus_recorder_max_bytes=0)."""
    return _json_of("tbus_flight_ring_json", int(max_records))


def recorder_arm(triggers: str = "") -> int:
    """Arms the anomaly watchdog with a ';'-separated trigger spec (""
    for the defaults): p99:<var>:ratio=<x>[,min_us=<n>],
    rate:<var>:per_s=<x>, slo:<name>:burn=<x>, divergence. Returns the
    armed rule count; ValueError on a bad spec (nothing is armed)."""
    n = _symbol("tbus_recorder_arm").tbus_recorder_arm(triggers.encode())
    if n < 0:
        raise ValueError(f"bad trigger spec: {triggers!r}")
    return n


def recorder_disarm() -> None:
    _symbol("tbus_recorder_disarm").tbus_recorder_disarm()


def recorder_capture(reason: str = "manual", profile_seconds: int = 0) -> int:
    """Captures a bundle now (the frozen flight ring, a trace boost, the
    CPU and wait profiles when profile_seconds > 0, which it then blocks,
    the variables, a scheduler snapshot, the SLO state). Returns the
    bundle id."""
    return int(_symbol("tbus_recorder_capture").tbus_recorder_capture(
        reason.encode(), int(profile_seconds)))


def recorder_bundles(detail: bool = False) -> dict:
    """The /debug/bundles store: {"bundles": [{id, t_us, reason, bytes,
    sections{...}}, ...]}; detail=True inlines the sections' text."""
    return _json_of("tbus_recorder_bundles_json", 1 if detail else 0)


def recorder_bundle_text(bundle_id: int) -> str:
    """One bundle rendered whole ("" for an unknown id)."""
    return _take_str(_symbol("tbus_recorder_bundle_text")
                     .tbus_recorder_bundle_text(int(bundle_id)))


def recorder_stats() -> dict:
    """{"armed", "rules", "fired", "bundles", "store_bytes",
    "ring_records", "wait_sites", "wait_samples", "boosts"}."""
    return _json_of("tbus_recorder_stats")


# ---- the SLO plane: objectives and burn rates ----

def slo_status() -> dict:
    """The SLO registry: {"slos": [{name, burn_fast, burn_slow, burning,
    exemplars: [...]}, ...], "fast_ms", "slow_ms"}. Objectives are
    declared with flag_set("tbus_slo_spec",
    "Name[@peer]:p99_us=N,avail=permille;..."); an exemplar carries its
    trace id and, when the call carried a budget echo, its waterfall."""
    return _json_of("tbus_slo_json")


def slo_text() -> str:
    """The /slo page body (burn state and exemplar waterfalls)."""
    return _take_str(_symbol("tbus_slo_text").tbus_slo_text())


def slo_fleet() -> dict:
    """The sink's burn rollup (/fleet/slo): this process's objectives
    against the burn gauges every reporting node pushed."""
    return _json_of("tbus_slo_fleet_json")


def slo_burn(name: str, fast: bool = True) -> float:
    """The named SLO's burn rate over its fast or slow window (1.0 spends
    the objective exactly as declared); KeyError when it is not
    declared."""
    pm = _symbol("tbus_slo_burn_permille").tbus_slo_burn_permille(
        name.encode(), 1 if fast else 0)
    if pm < 0:
        raise KeyError(f"SLO not declared: {name!r}")
    return pm / 1000.0


# ---- the autotune controller ----

def autotune_enable() -> None:
    """Starts (or resumes) the self-tuning controller fiber: a guarded
    hill-climb over the tunable flags (flag_domains), one at a time,
    keeping a significant gain and reverting otherwise, freezing a flag
    that keeps losing, and rolling the vector back to the last good one
    when the objective collapses or errors and sheds spike. Children
    inherit it through $TBUS_AUTOTUNE=1."""
    _symbol("tbus_autotune_enable").tbus_autotune_enable()


def autotune_disable() -> None:
    """Pauses the controller in place (the flags stay where its walk
    left them)."""
    _symbol("tbus_autotune_disable").tbus_autotune_disable()


def autotune_stats() -> dict:
    """The controller's state: enabled, steps, keeps, reverts, rollbacks,
    external aborts, frozen flags, the last objective rate, and the
    current and last good flag vectors."""
    return _json_of("tbus_autotune_stats_json")


def autotune_last_good() -> dict:
    """The last good flag vector ({flag: value}) a rollback restores."""
    return _json_of("tbus_autotune_last_good_json")


# ---- the fleet metrics plane ----

def metrics_set_collector(addr: str) -> None:
    """Points this process's metrics exporter at a MetricsSink
    ("host:port"; "" turns it off): a fiber then pushes a snapshot of
    every variable each tbus_metrics_export_interval_ms. Children inherit
    $TBUS_METRICS_COLLECTOR."""
    L = _symbol("tbus_metrics_set_collector")
    if L.tbus_metrics_set_collector(addr.encode()) != 0:
        raise RuntimeError("metrics_set_collector failed")


def metrics_flush() -> int:
    """Builds a snapshot now and ships what is queued. Returns the frames
    shipped; -1 when no collector is set."""
    return _symbol("tbus_metrics_flush").tbus_metrics_flush()


def fleet_query() -> dict:
    """This process's sink view of the fleet (/fleet?format=json): nodes
    with their identity (version, start time, flag-vector hash), rollups
    (counter sums, percentiles merged from the pooled samples), each
    node's window history and the watchdog's outliers."""
    text = _native_str("tbus_fleet_query_json")
    return json.loads(text) if text else {}


def metrics_stats() -> dict:
    """Exporter and sink counters: exported, dropped, send_fail, bytes,
    sink_snapshots, sink_rows, nodes, outliers, outlier_flags,
    outlier_clears."""
    text = _native_str("tbus_metrics_stats_json")
    return json.loads(text) if text else {}


def metrics_sink_reset() -> None:
    """Drops every node from this process's sink."""
    _symbol("tbus_metrics_sink_reset").tbus_metrics_sink_reset()


# ---- the cache tier, record and replay ----

def cache_stats() -> dict:
    """The cache tier's counters over every store of this process (hits,
    misses, sets, evictions, expired, shed_full, bytes, entries and the
    hit rate; a client reads a remote store through Cache.Stats)."""
    text = _native_str("tbus_cache_stats_json")
    return json.loads(text) if text else {}


def rpc_dump_enable(path: str, interval: int = 1) -> None:
    """Samples about 1/interval of the requests this process serves into
    `path` (rpc_dump recordio: meta "service\\nmethod\\n", the request's
    bytes as body), the corpus replay reads."""
    L = _symbol("tbus_rpc_dump_enable")
    if L.tbus_rpc_dump_enable(path.encode(), int(interval)) != 0:
        raise RuntimeError(f"rpc_dump_enable failed for {path!r}")


def rpc_dump_disable() -> None:
    _symbol("tbus_rpc_dump_disable").tbus_rpc_dump_disable()


def cache_corpus_write(path: str, seed: int = 1, n: int = 1000,
                       key_space: int = 64, value_bytes: int = 4096,
                       set_permille: int = 100) -> int:
    """Writes a cache workload corpus (rpc_dump recordio) from `seed`:
    skewed keys over `key_space`, set_permille/1000 SETs. One seed gives
    one file byte for byte. Returns the records written."""
    n_written = _symbol("tbus_cache_corpus_write").tbus_cache_corpus_write(
        path.encode(), int(seed), int(n), int(key_space), int(value_bytes),
        int(set_permille))
    if n_written < 0:
        raise RuntimeError(f"corpus write failed for {path!r}")
    return n_written


def replay(path: str, addr: str, lb: str = "", qps: float = 0,
           concurrency: int = 4, loops: int = 1,
           verify: bool = False) -> dict:
    """Plays an rpc_dump corpus at `qps` (0: a closed loop) against
    `addr` (an endpoint, or a naming URL with `lb`; cache records derive
    their request code from their key, so they shard as live traffic).
    verify=True also proves the corpus re-frames byte for byte and that
    echo replies equal their requests. A truncated last record is counted
    (stats["truncated"]), not an error. Returns the stats (records,
    played, ok, failed, hits, misses, p50_us, p99_us, qps,
    round_trip_ok)."""
    L = _symbol("tbus_replay_run")
    err = ctypes.create_string_buffer(256)
    return _report(L.tbus_replay_run(
        path.encode(), addr.encode(), lb.encode(), float(qps),
        int(concurrency), int(loops), 1 if verify else 0, err), err)


def cache_reshard_drill(from_nodes: int = 2, to_nodes: int = 4,
                        keys: int = 64, value_bytes: int = 4096) -> dict:
    """The live-reshard drill: `to_nodes` cache shards in this process,
    `from_nodes` of them published through file:// naming, `keys` values
    loaded through a c_hash channel, the membership swapped to all of
    them, and every key read again with read repair, each RPC on a
    ledger. report["ok"] == 1: no key lost, every outcome definite."""
    L = _symbol("tbus_cache_drill")
    err = ctypes.create_string_buffer(256)
    return _report(L.tbus_cache_drill(int(from_nodes), int(to_nodes),
                                      int(keys), int(value_bytes), err), err)


def bench_cache(addr: str, value_bytes: int = 262144, key_space: int = 96,
                set_permille: int = 0, concurrency: int = 8,
                duration_ms: int = 2000, seed: int = 1) -> dict:
    """The core's keyed cache bench: preloads `key_space` values, then
    `concurrency` fibers issue a skewed GET/SET mix back to back for
    duration_ms. Returns {"qps", "get_mbps" (GET payload goodput),
    "hit_rate", "p50_us", "p99_us", counts}."""
    L = _symbol("tbus_bench_cache")
    err = ctypes.create_string_buffer(256)
    return _report(L.tbus_bench_cache(
        addr.encode(), int(value_bytes), int(key_space), int(set_permille),
        int(concurrency), int(duration_ms), int(seed), err), err)


# ---- the fleet drills and live reconfiguration (cpp/rpc/fleet.cc) ----

# The port's fleet node, the launch contract of fleet_drill and
# fleet_roll (the process prints its port on stdout, then parks until
# the supervisor kills it). TBUS_LIB names the supervisor's own core, so
# a node neither builds nor looks for one. The node arms its metrics
# exporter only after one loopback call with an hour's timeout has
# started the core's timer thread: the thread can miss the wakeup of the
# first timer it is given (cpp/fiber/timer_thread.cc reads its futex word
# after dropping its lock), and an exporter whose first sleep is missed
# never reports, so the supervisor gives up on the node (ROADMAP C). A
# missed hour-long timer is harmless: the exporter's earlier one wakes
# the thread.
#
# A node unblocks SIGPROF first: it inherits the mask of the supervisor's
# thread, which blocks it for the drill (_sigprof_blocked).
FLEET_NODE = r"""
import os
import signal
import sys
import time
signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGPROF})
sys.path.insert(0, %(root)r)
os.environ["TBUS_LIB"] = %(lib)r
collector = os.environ.pop("TBUS_METRICS_COLLECTOR", "")
import tbus_torch
tbus_torch.init()
warm = tbus_torch.Server()
warm.add_echo()
tbus_torch.Channel(f"127.0.0.1:{warm.start(0)}", 3600000).call(
    "EchoService", "Echo", b"")
warm.stop()
time.sleep(0.02)
tbus_torch.metrics_set_collector(collector)
raise SystemExit(tbus_torch.fleet_node_run())
"""


def fleet_node_argv() -> list:
    """The argv of one port fleet node (FLEET_NODE in this interpreter,
    on the core this process loaded), for fleet_drill and fleet_roll."""
    return [sys.executable, "-c", FLEET_NODE % {
        "root": os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "lib": _native.lib()._name}]


def fleet_node_run() -> int:
    """Runs THIS process as a canonical fleet node (Fleet.Echo,
    Fleet.Chunks stream sink, Ctl.Fi remote fault control): prints the
    bound port on stdout, then parks until the supervisor kills it. The
    metrics exporter arms itself from $TBUS_METRICS_COLLECTOR. Only
    returns (nonzero) on startup failure."""
    return _symbol("tbus_fleet_node_run").tbus_fleet_node_run()


@contextlib.contextmanager
def _sigprof_blocked():
    """SIGPROF blocked on this thread. A drill's supervisor sleeps out
    each phase on the calling thread in a nanosleep that the core does not
    resume after a signal (cpp/fiber/scheduler.cc fiber_usleep off a
    fiber), and the drill's own SLO leg starts the core's CPU profiler:
    a SIGPROF delivered to this thread ended a phase at once, with no call
    in it (ROADMAP C)."""
    old = signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGPROF})
    try:
        yield
    finally:
        signal.pthread_sigmask(signal.SIG_SETMASK, old)


def fleet_drill(node_argv, nodes: int = 6, phase_ms: int = 1200,
                seed: int = 1) -> dict:
    """The fleet soak-and-elasticity chaos drill: fork/execs `nodes`
    node processes from `node_argv` (each must print its port on stdout,
    e.g. fleet_node_argv()), publishes membership through file:// naming
    with atomic rename-swap, drives mixed echo + stream + fan-out load,
    and executes the seeded chaos plan (1 SIGKILL, 1 SIGSTOP
    gray-failure hang, 1 revival, 1 live reshard). Returns the report
    dict: phases, per-call ledger (zero silently-lost calls), merged
    /fleet p99 vs bound, rebalance timings, reshard convergence;
    report["ok"] == 1 when every invariant held."""
    L = _symbol("tbus_fleet_drill")
    err = ctypes.create_string_buffer(256)
    with _sigprof_blocked():
        p = L.tbus_fleet_drill("\x1f".join(node_argv).encode(), int(nodes),
                               int(phase_ms), int(seed), err)
    return _report(p, err)


def link_redial(timeout_ms: int = 2000) -> int:
    """Redials every live cross-process tpu:// client link with this
    process's CURRENT tbus_shm_lanes / tbus_shm_ext_chains flags (set
    them first via flag_set): each link quiesces at a unit boundary,
    renegotiates caps over its still-open TCP fd and swaps shm segments
    live; in-flight calls complete, none fail. Returns the number of
    links renegotiated."""
    return _symbol("tbus_link_redial").tbus_link_redial(int(timeout_ms))


def fleet_roll(node_argv, nodes: int = 4, phase_ms: int = 1200,
               upgrade_flags: str = None) -> dict:
    """Rolling fleet upgrade drill: starts `nodes` processes from
    `node_argv` (the fleet_drill launch contract: each prints its port
    on stdout), drives mixed load, then rolls every node in sequence:
    drain RPC, wait-quiesced via pushed gauges, respawn with
    `upgrade_flags` ("name=value,..." applied through TBUS_NODE_FLAGS;
    None keeps the default lanes/chains downgrade), republish, holding a
    capability-skew window mid-roll. Returns the report dict: per-node
    drain/respawn/republish latencies, flag-hash divergence evidence,
    and the zero-lost + zero-failed call ledger; report["ok"] == 1 when
    every invariant held."""
    L = _symbol("tbus_fleet_roll")
    err = ctypes.create_string_buffer(256)
    flags = upgrade_flags.encode() if upgrade_flags is not None else None
    with _sigprof_blocked():
        p = L.tbus_fleet_roll("\x1f".join(node_argv).encode(), int(nodes),
                              int(phase_ms), flags, err)
    return _report(p, err)


def shm_links() -> list:
    """This process's live cross-process tpu:// client links (the set
    link_redial walks), each with the caps its last handshake or redial
    negotiated: [{"socket", "lanes", "chains"}]."""
    return json.loads(_take_str(_device_bridge().tbus_torch_shm_links_json()))


def redial_counters() -> dict:
    """The core's redial counters: attempts, renegotiated, fallbacks."""
    return {k: int(var_value(f"tbus_redial_{k}") or 0)
            for k in ("attempts", "renegotiated", "fallbacks")}


def wait_redials_settled(before=None, quiet_s: float = 0.05,
                         timeout_s: float = 15.0):
    """Waits for the redial walker that a tbus_shm_lanes or
    tbus_shm_ext_chains change starts on every live link: until it has
    attempted since `before` (a redial_counters(); None asks for no new
    attempt), every attempt renegotiated or fell back, and no counter
    moved for quiet_s. A link_redial while the walker runs collides with
    it and counts 0. Returns the counters and the time.perf_counter()
    they last moved at; raises after timeout_s."""
    end = time.monotonic() + timeout_s
    last, since = None, time.perf_counter()
    while time.monotonic() < end:
        c = redial_counters()
        if c != last:
            last, since = c, time.perf_counter()
        elif ((before is None or c["attempts"] > before["attempts"])
              and c["attempts"] == c["renegotiated"] + c["fallbacks"]
              and time.perf_counter() - since >= quiet_s):
            return c, since
        time.sleep(0.002)
    raise RpcError(-1, f"redial walker unsettled: {before} -> {last}")


# ---- the torch collective fan-out backend ----

# The bridge's run callback: int run(void* batch).
_RUN_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
_enable_lock = threading.Lock()
_run_cb = None  # keepalive: the bridge holds this pointer for good


def _bridge() -> ctypes.CDLL:
    from tbus_torch.kernels import _build

    return _build.fanout_bridge_lib()


def _run_batch(batch: int) -> int:
    """Serves one executor batch (runs on the bridge's executor thread,
    under the GIL): reads the queued calls, runs them through the runtime,
    writes every peer's response back."""
    from tbus_torch.parallel import runtime

    B = _bridge()
    try:
        size = B.tbus_torch_batch_size(batch)
        service = B.tbus_torch_batch_service(batch).decode()
        method = B.tbus_torch_batch_method(batch).decode()
        n_peers = B.tbus_torch_batch_n_peers(batch)
        timeout_ms = B.tbus_torch_batch_timeout_ms(batch)
        all_local = bool(B.tbus_torch_batch_all_local(batch))
        payloads = []
        for b in range(size):
            data = ctypes.c_void_p()
            n = B.tbus_torch_batch_payload(batch, b, ctypes.byref(data))
            payloads.append(ctypes.string_at(data.value, n) if n > 0
                            else b"")
        if size == 1:
            results = [runtime.broadcast_gather(
                service, method, payloads[0], n_peers, timeout_ms,
                all_local)]
        else:
            results = runtime.broadcast_gather_batch(
                service, method, payloads, n_peers, timeout_ms, all_local)
        for b, per_peer in enumerate(results):
            if len(per_peer) != n_peers:
                continue  # bad arity: the job stays failed
            for i, r in enumerate(per_peer):
                B.tbus_torch_batch_set_response(batch, b, i, r, len(r))
            B.tbus_torch_batch_done(batch, b)
        return 0
    except Exception:  # the executor must keep serving: report, fail jobs
        traceback.print_exc()
        return -1


def enable_torch_fanout() -> bool:
    """Installs the PyTorch collective backend for ParallelChannel fan-out
    (builds the bridge on first use). Selection order native -> torch ->
    p2p: an installed native backend is never displaced."""
    from tbus_torch.parallel import runtime

    global _run_cb
    bridge = _bridge()
    runtime.sync_native()  # methods registered before the core loaded
    with _enable_lock:
        if _run_cb is None:
            _run_cb = _RUN_FN(_run_batch)
    return bridge.tbus_torch_fanout_enable(_run_cb) == 0


def torch_lowered_calls() -> int:
    """Calls the torch backend has served (a fused batch counts each)."""
    return _bridge().tbus_torch_fanout_lowered_calls()


def register_device_echo(service: str, method: str) -> bool:
    """Marks a method as device-lowerable with identity (echo) semantics
    AND advertises it (for processes that are both client and servers).
    Only registered methods lower; unregistered ones always take the p2p
    path (the collective never contacts the remote servers)."""
    if not register_device_method(service, method, "echo", "echo/v1"):
        return False
    advertise_device_method(service, method, "echo/v1")
    return True


def register_device_method(service: str, method: str, builtin: str,
                           impl_id: str) -> bool:
    """CLIENT half of the lowering contract: registers a named builtin
    device transform ("echo", "xor255", "add_peer_index" — see
    tbus_torch.parallel.runtime.BUILTINS) for the method under `impl_id`.
    Lowering additionally requires every peer's server to have advertised
    the same impl id (advertise_device_method) during its transport
    handshake — a mismatched peer forces the p2p path."""
    from tbus_torch.parallel import runtime

    _native.lib()  # loaded first, so the registration reaches CanLower
    try:
        runtime.register_builtin(service, method, builtin, impl_id)
    except KeyError:
        return False
    return True


def advertise_device_method(service: str, method: str,
                            impl_id: str) -> None:
    """SERVER half: declare that this process's servers implement the
    method with device twin `impl_id`. Call BEFORE starting servers (the
    advertisement rides the tpu:// transport handshake)."""
    _native.lib().tbus_advertise_device_method(
        service.encode(), method.encode(), impl_id.encode())


# Server-handler twins of runtime.BUILTINS: handlers a server can mount so
# its p2p behavior is byte-identical to the lowered device transform.
def builtin_handler(builtin: str, peer_index: int = 0):
    if builtin == "echo":
        return lambda body: body
    if builtin == "xor255":
        return lambda body: bytes(b ^ 0xFF for b in body)
    if builtin == "add_peer_index":
        return lambda body: bytes((b + peer_index) & 0xFF for b in body)
    raise KeyError(f"unknown builtin {builtin!r}")


class ParallelChannel:
    """Fan one call out to N sub-channels; all-tpu:// fan-outs lower to a
    single device execution when the torch backend is enabled."""

    def __init__(self, fail_limit: int = 0) -> None:
        self._L = _native.lib()
        self._L.tbus_init(0)
        self._h = self._L.tbus_pchan_new(fail_limit)

    def add(self, addr: str) -> None:
        if self._L.tbus_pchan_add(self._h, addr.encode()) != 0:
            raise RuntimeError(f"pchan add failed: {addr}")

    @property
    def collective_eligible(self) -> bool:
        return bool(self._L.tbus_pchan_eligible(self._h))

    def call(self, service: str, method: str, payload: bytes,
             timeout_ms: int = 10000) -> bytes:
        out = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        rc = self._L.tbus_pchan_call(
            self._h, service.encode(), method.encode(), payload,
            len(payload), timeout_ms, ctypes.byref(out),
            ctypes.byref(out_len))
        if rc != 0:
            raise RpcError(rc, "parallel call failed")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._L.tbus_buf_free(ctypes.cast(out, ctypes.c_char_p))

    def __del__(self):
        try:
            self._L.tbus_pchan_free(self._h)
        except Exception:
            pass


class PartitionChannel:
    """Sharded scatter-gather over a partitioned fleet ("N/M" tags in the
    naming data). With slice_mapper=True partition i serves the i-th 1/N
    slice of the request and the responses re-concatenate in index
    order; when every partition resolves to one advertised tpu:// peer
    the scatter lowers onto the collective backend (the C++ engine's
    scatter form), else p2p."""

    def __init__(self, num_partitions: int, naming_url: str,
                 lb_name: str = "rr", fail_limit: int = 0,
                 slice_mapper: bool = True) -> None:
        self._L = _native.lib()
        self._L.tbus_init(0)
        self._h = self._L.tbus_partchan_new(
            num_partitions, naming_url.encode(), lb_name.encode(),
            fail_limit, 1 if slice_mapper else 0)
        if not self._h:
            raise RuntimeError(f"partition channel init failed: {naming_url}")

    @property
    def collective_eligible(self) -> bool:
        return bool(self._L.tbus_partchan_eligible(self._h))

    def call(self, service: str, method: str, payload: bytes,
             timeout_ms: int = 10000) -> bytes:
        out = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        rc = self._L.tbus_partchan_call(
            self._h, service.encode(), method.encode(), payload,
            len(payload), timeout_ms, ctypes.byref(out),
            ctypes.byref(out_len))
        if rc != 0:
            raise RpcError(rc, "partition call failed")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._L.tbus_buf_free(ctypes.cast(out, ctypes.c_char_p))

    def __del__(self):
        try:
            self._L.tbus_partchan_free(self._h)
        except Exception:
            pass


class Server:
    """A tbus RPC server bound to a TCP port (0 = ephemeral)."""

    def __init__(self) -> None:
        self._L = _native.lib()
        self._L.tbus_init(0)
        self._h = self._L.tbus_server_new()
        self._callbacks = []  # keepalive for CFUNCTYPE thunks
        self._running = False

    def add_echo(self, service: str = "EchoService",
                 method: str = "Echo") -> None:
        rc = self._L.tbus_server_add_echo(
            self._h, service.encode(), method.encode())
        if rc != 0:
            raise RuntimeError(f"add_echo failed: {rc}")

    def add_sleep(self, service: str, method: str, sleep_us: int) -> None:
        """Mounts a native slow handler: it sleeps sleep_us on its fiber
        and answers "ok" (the slow backend of overload drills)."""
        rc = self._L.tbus_server_add_sleep(
            self._h, service.encode(), method.encode(), sleep_us)
        if rc != 0:
            raise RuntimeError(f"add_sleep failed: {rc}")

    def add_cache(self) -> None:
        """Mounts the cache tier (Cache.Get/Set/Del/Stats) over this
        process's default store: values live in pool blocks, a GET shares
        them into the reply without a copy, TTL and LRU eviction under
        the reloadable tbus_cache_max_bytes, ECACHEFULL (2009) when
        full."""
        rc = _symbol("tbus_server_add_cache").tbus_server_add_cache(self._h)
        if rc != 0:
            raise RuntimeError(f"add_cache failed: {rc}")

    def add_method(self, service: str, method: str,
                   fn: Callable[[bytes], bytes]) -> None:
        L = self._L

        @_native.HANDLER_FN
        def thunk(_user, req, req_len, resp_ctx):
            try:
                body = ctypes.string_at(req, req_len) if req_len else b""
                out = fn(body)
                if out:
                    L.tbus_response_append(resp_ctx, out, len(out))
            except RpcError as e:
                L.tbus_response_set_error(resp_ctx, e.code, e.text.encode())
            except Exception as e:  # handler bug -> internal error
                L.tbus_response_set_error(resp_ctx, 2001, str(e).encode())

        self._callbacks.append(thunk)
        rc = L.tbus_server_add_method(
            self._h, service.encode(), method.encode(), thunk, None)
        if rc != 0:
            raise RuntimeError(f"add_method failed: {rc}")

    def add_stream_sink(self, service: str = "StreamService",
                        method: str = "Sink", echo: bool = False) -> None:
        """Mounts a native stream sink: every offered stream is accepted
        and its chunks consumed (echo=True echoes them back), counted in
        tbus_stream_sink_bytes/_chunks. The server half of bench_stream."""
        rc = self._L.tbus_server_add_stream_sink(
            self._h, service.encode(), method.encode(), 1 if echo else 0)
        if rc != 0:
            raise RuntimeError(f"add_stream_sink failed: {rc}")

    def add_stream_method(self, service: str, method: str,
                          fn: Callable) -> None:
        """Like add_method, but fn(body, accept) also receives an
        `accept(max_buf_size=0, echo=False) -> Stream` callable that
        accepts the request's offered stream (None without one)."""
        L = self._L

        @_native.HANDLER_FN
        def thunk(_user, req, req_len, resp_ctx):
            try:
                body = ctypes.string_at(req, req_len) if req_len else b""

                def accept(max_buf_size: int = 0, echo: bool = False):
                    sid = L.tbus_stream_accept(
                        resp_ctx, max_buf_size, 1 if echo else 0)
                    return Stream(sid) if sid else None

                out = fn(body, accept)
                if out:
                    L.tbus_response_append(resp_ctx, out, len(out))
            except RpcError as e:
                L.tbus_response_set_error(resp_ctx, e.code, e.text.encode())
            except Exception as e:  # handler bug -> internal error
                L.tbus_response_set_error(resp_ctx, 2001, str(e).encode())

        self._callbacks.append(thunk)
        rc = L.tbus_server_add_method(
            self._h, service.encode(), method.encode(), thunk, None)
        if rc != 0:
            raise RuntimeError(f"add_stream_method failed: {rc}")

    def enable_ssl(self, cert_pem_path: str, key_pem_path: str) -> None:
        """TLS on the shared port (sniffed beside plaintext; ALPN
        negotiates h2/http1.1). Call before start()."""
        self._L.tbus_server_enable_ssl(
            self._h, cert_pem_path.encode(), key_pem_path.encode())

    def usercode_in_pthread(self) -> None:
        """Runs this server's handlers on dedicated pthreads instead of
        fiber workers (call before start()); needed by Python handlers
        that block, e.g. on a nested synchronous RPC."""
        self._L.tbus_server_usercode_in_pthread(self._h)

    def enable_trace_sink(self) -> None:
        """Mounts the builtin TraceSink span collector (call before
        start()): peers whose tbus_trace_collector names this server ship
        their rpcz spans here, stitched by trace id (trace_query)."""
        if self._L.tbus_server_enable_trace_sink(self._h) != 0:
            raise RuntimeError("enable_trace_sink failed (already started?)")

    def enable_metrics_sink(self) -> None:
        """Mounts the builtin MetricsSink (call before start()): peers
        whose tbus_metrics_collector names this server push periodic
        snapshots of their variables here (counter deltas and raw latency
        samples), rolled up into merged percentiles at /fleet
        (fleet_query)."""
        L = _symbol("tbus_server_enable_metrics_sink")
        if L.tbus_server_enable_metrics_sink(self._h) != 0:
            raise RuntimeError(
                "enable_metrics_sink failed (already started?)")

    def set_concurrency_limiter(self, service: str, method: str,
                                spec: str) -> None:
        """Per-method admission policy: "unlimited", "constant:N", "auto"
        or "timeout:<budget_ms>"; a malformed spec raises ValueError with
        the parser's message."""
        err = ctypes.create_string_buffer(256)
        rc = self._L.tbus_server_set_limiter_ex(
            self._h, service.encode(), method.encode(), spec.encode(), err)
        if rc != 0:
            raise ValueError("set_concurrency_limiter failed: "
                             f"{err.value.decode(errors='replace')}")

    def add_device_method(self, service: str, method: str,
                          transform: str = "echo") -> None:
        """Mounts a handler whose payload round-trips through the device
        via the port's C++ runtime (device_init first; it is needed once
        a request arrives). transform: "echo" (the bytes still cross the
        device), "xor255", "incr", "dot128" (f32[k,128] . W) or
        "dotbench<N>x<T>" (4-byte f32 seed -> 4-byte checksum)."""
        rc = _device_bridge().tbus_torch_server_add_device_method(
            self._h, service.encode(), method.encode(), transform.encode())
        if rc != 0:
            raise RuntimeError(f"add_device_method failed: {rc}")

    def add_generate_method(self, service: str = "GenService",
                            method: str = "Generate",
                            transform: str = "incr", max_batch: int = 64,
                            token_bytes: int = 4096, batched: bool = True,
                            max_queue: int = 1024, peers: str = "") -> None:
        """Mounts a continuous-batching generate method (cpp/rpc/
        serve_batch.h) whose every fused step runs through the device
        runtime's step engine: requests carry u32le ntokens + a prompt and
        an offered stream; tokens stream back per step (the transform
        applied to the prompt-seeded state each step). batched=False
        mounts the per-request baseline. peers (a comma list of
        host:port) shards every step over that mesh partition through the
        collective fan-out backend (tensor-parallel serving; transform
        echo or xor255, anything else serves as echo): the peers advertise
        (service + "Shard", method) under "serve/v1" and must have
        completed a tpu:// handshake with this process; a step that cannot
        lower is repaired on this card (fanout_step_stats). Raises when
        the step engine cannot be made (runtime not up, unknown
        transform): it never serves from the host engine instead."""
        rc = _device_bridge().tbus_torch_server_add_generate_method(
            self._h, service.encode(), method.encode(), transform.encode(),
            max_batch, token_bytes, 1 if batched else 0, max_queue,
            peers.encode())
        if rc != 0:
            raise RuntimeError(
                f"add_generate_method failed: {rc} (is the device runtime "
                f"up, and is {transform!r} echo, xor255 or incr?)")

    def add_device_stream_sink(self, service: str = "DeviceStream",
                               method: str = "Sink",
                               transform: str = "echo",
                               echo: bool = False) -> None:
        """Mounts a device stream sink: every chunk received on the
        offered stream runs through the device runtime (transform echo,
        xor255 or incr; the chunk's view in the sender's registered pool
        region is donated, the output lands in an own pool block) and is
        counted (stream_sink_stats), and streamed back with echo. The
        server half of bench_device_stream. Without a runtime the stream
        closes; there is no host path."""
        rc = _device_bridge().tbus_torch_server_add_device_stream_sink(
            self._h, service.encode(), method.encode(), transform.encode(),
            1 if echo else 0)
        if rc != 0:
            raise RuntimeError(f"add_device_stream_sink failed: {rc}")

    def start(self, port: int = 0) -> int:
        rc = self._L.tbus_server_start(self._h, port)
        if rc != 0:
            raise RuntimeError(f"server start failed: {rc}")
        self._running = True
        return self.port

    @property
    def port(self) -> int:
        return self._L.tbus_server_port(self._h)

    def stop(self) -> None:
        if self._running:
            self._L.tbus_server_stop(self._h)
            self._running = False

    def drain(self, deadline_ms: int = 10000) -> int:
        """Graceful drain: new work bounces with the retryable ELOGOFF and
        /health answers "draining", while what is in flight completes
        under deadline_ms; stragglers are then force-closed. The server
        runs on until stop(). Returns the force-closed streams (0: a
        clean drain)."""
        return self._L.tbus_server_drain(self._h, int(deadline_ms))

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __del__(self) -> None:
        try:
            self.stop()
            self._L.tbus_server_free(self._h)
        except Exception:
            pass


class Channel:
    """Client stub for one target address ("host:port", "tpu://...",
    "list://a:p,b:p" or another naming URL with lb=...).

    protocol: "tbus_std" (default), "http", "h2" or "grpc"; connection:
    "single" (multiplexed, default), "pooled" (exclusive per call) or
    "short"; compress: 0 none, 1 gzip, 2 zlib; lb: the load balancer
    that turns on cluster mode ("rr", "wrr", "random", "c_hash", "la")."""

    def __init__(self, addr: str, timeout_ms: int = 500,
                 max_retry: int = 3, protocol: str = "",
                 connection: str = "", compress: int = 0,
                 lb: str = "") -> None:
        self._L = _native.lib()
        self._L.tbus_init(0)
        self._h = self._L.tbus_channel_new2(
            addr.encode(), timeout_ms, max_retry, protocol.encode(),
            connection.encode(), compress, lb.encode())
        if not self._h:
            raise RuntimeError(f"channel init failed for {addr!r}")

    def call(self, service: str, method: str, request: bytes,
             timeout_ms: int = 0) -> bytes:
        """One synchronous RPC. timeout_ms > 0 overrides the channel's
        default deadline for this call only."""
        resp = ctypes.c_void_p()
        resp_len = ctypes.c_size_t()
        err = ctypes.create_string_buffer(256)
        rc = self._L.tbus_call2(
            self._h, service.encode(), method.encode(), request,
            len(request), timeout_ms, ctypes.byref(resp),
            ctypes.byref(resp_len), err)
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        try:
            return ctypes.string_at(resp.value, resp_len.value) \
                if resp_len.value else b""
        finally:
            self._L.tbus_buf_free(ctypes.cast(resp, ctypes.c_char_p))

    def cache_set(self, key: str, value: bytes, ttl_ms: int = 0) -> None:
        """Keyed SET against a cache server (Server.add_cache); the
        request code is the key's stable hash, so c_hash channels shard.
        Raises RpcError on failure: ECACHEFULL (2009) when the store's
        budget is spent (a definite shed, never a silent drop)."""
        L = _symbol("tbus_cache_set")
        err = ctypes.create_string_buffer(256)
        rc = L.tbus_cache_set(self._h, key.encode(), value, len(value),
                              int(ttl_ms), err)
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))

    def cache_get(self, key: str):
        """Keyed GET: the value on a hit, None on a definite miss;
        RpcError when the call fails. The server replies with the
        resident pool blocks, without a copy."""
        L = _symbol("tbus_cache_get")
        out = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        err = ctypes.create_string_buffer(256)
        rc = L.tbus_cache_get(self._h, key.encode(), ctypes.byref(out),
                              ctypes.byref(out_len), err)
        if rc == 1:
            return None
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        try:
            return ctypes.string_at(out.value, out_len.value) \
                if out_len.value else b""
        finally:
            L.tbus_buf_free(ctypes.cast(out, ctypes.c_char_p))

    def cache_del(self, key: str) -> bool:
        """Keyed DELETE: True if the key existed."""
        rc = _symbol("tbus_cache_del").tbus_cache_del(self._h, key.encode())
        if rc in (0, 1):
            return rc == 0
        raise RpcError(rc, "cache del failed")

    def call_progressive(self, service: str, method: str, request: bytes,
                         timeout_ms: int = 30000) -> list:
        """One RPC whose response body is taken as it arrives: on h2 a
        piece per DATA frame, elsewhere the buffered body as one piece.
        Returns the pieces (bytes)."""
        pieces = []

        @_native.PIECE_FN
        def on_piece(_user, data, n):
            pieces.append(ctypes.string_at(data, n) if n else b"")

        err = ctypes.create_string_buffer(256)
        rc = self._L.tbus_call_progressive(
            self._h, service.encode(), method.encode(), request,
            len(request), timeout_ms, on_piece, None, err)
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        return pieces

    def __del__(self) -> None:
        try:
            self._L.tbus_channel_free(self._h)
        except Exception:
            pass


class GrpcStub:
    """A gRPC-style stub over a grpc Channel, shaped like
    grpc.Channel.unary_unary:

        stub = tbus_torch.GrpcStub("127.0.0.1:8000")
        echo = stub.unary_unary("/example.EchoService/Echo")
        reply_bytes = echo(request_bytes)

    request_serializer / response_deserializer (protobuf's
    SerializeToString / FromString, say) carry typed messages."""

    def __init__(self, addr: str, timeout_ms: int = 10000) -> None:
        self._ch = Channel(addr, timeout_ms=timeout_ms, protocol="grpc")

    def unary_unary(self, method_path: str, request_serializer=None,
                    response_deserializer=None):
        service, _, method = method_path.strip("/").rpartition("/")
        if not service or not method:
            raise ValueError(f"bad gRPC method path {method_path!r}")

        def call(request, timeout=None):
            payload = (request_serializer(request)
                       if request_serializer else request)
            # A grpc timeout is in seconds: this call's deadline.
            timeout_ms = int(timeout * 1000) if timeout else 0
            resp = self._ch.call(service, method, payload,
                                 timeout_ms=timeout_ms)
            return (response_deserializer(resp)
                    if response_deserializer else resp)

        return call


class Stream:
    """One half of an ordered, flow-controlled chunk stream (rpc/stream.h).

    Client side: Stream.create(channel, service, method) offers a stream
    alongside the RPC. write() blocks through window backpressure up to
    its timeout; read() pops buffered inbound chunks."""

    def __init__(self, sid: int) -> None:
        self._L = _native.lib()
        self._sid = sid
        self._closed = False

    @classmethod
    def create(cls, channel: Channel, service: str, method: str,
               request: bytes = b"", max_buf_size: int = 0) -> "Stream":
        L = _native.lib()
        err = ctypes.create_string_buffer(256)
        sid = L.tbus_stream_create(
            channel._h, service.encode(), method.encode(), request,
            len(request), max_buf_size, err)
        if not sid:
            raise RpcError(-1, "stream create failed: "
                           + err.value.decode(errors="replace"))
        return cls(sid)

    @property
    def id(self) -> int:
        return self._sid

    def write(self, chunk: bytes, timeout_ms: int = 10000) -> None:
        rc = self._L.tbus_stream_write(self._sid, chunk, len(chunk),
                                       timeout_ms)
        if rc != 0:
            raise RpcError(rc, f"stream write failed: {rc}")

    def read(self, timeout_ms: int = 10000) -> Optional[bytes]:
        """Next inbound chunk; None once the stream closed and drained."""
        out = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        rc = self._L.tbus_stream_read(self._sid, ctypes.byref(out),
                                      ctypes.byref(out_len), timeout_ms)
        if rc == 0:
            try:
                return ctypes.string_at(out.value, out_len.value) \
                    if out_len.value else b""
            finally:
                self._L.tbus_buf_free(ctypes.cast(out, ctypes.c_char_p))
        if rc == 2005:  # ECLOSE: closed and drained
            return None
        raise RpcError(rc, f"stream read failed: {rc}")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._L.tbus_stream_close(self._sid)

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


def bench_serve(addr: str, service: str = "GenService",
                method: str = "Generate", concurrency: int = 8,
                duration_ms: int = 2000, ntokens: int = 16,
                token_bytes: int = 4096, qps: float = 0,
                timeout_ms: int = 1000) -> dict:
    """Native serving bench: `concurrency` fibers issue generate calls
    (each consuming `ntokens` streamed tokens) for duration_ms; qps > 0
    paces the offered load. Reports token throughput, completed-sequence
    goodput, client-observed TTFT and inter-token gap percentiles (us),
    and the ok/shed/timedout/other split."""
    L = _native.lib()
    L.tbus_init(0)
    dbl = [ctypes.c_double() for _ in range(6)]
    cnt = [ctypes.c_longlong() for _ in range(4)]
    err = ctypes.create_string_buffer(256)
    rc = L.tbus_bench_serve(
        addr.encode(), service.encode(), method.encode(), concurrency,
        duration_ms, ntokens, token_bytes, qps, timeout_ms,
        *[ctypes.byref(v) for v in dbl], *[ctypes.byref(v) for v in cnt],
        err)
    if rc != 0:
        raise RpcError(rc, "bench_serve failed: "
                       + err.value.decode(errors="replace"))
    keys = ("token_qps", "seq_qps", "ttft_p50_us", "ttft_p99_us",
            "gap_p50_us", "gap_p99_us", "ok", "shed", "timedout", "other")
    return dict(zip(keys, [v.value for v in dbl + cnt]))


def serve_stats() -> list:
    """Per-mounted-scheduler serving stats (admitted/completed/steps/
    tokens/shed taxonomy/plan hits and misses/batch occupancy); a
    scheduler mounted by Server.add_generate_method also names its step
    engine ("cuda", or "cpu" on the CPU backend) with its steps and
    failures."""
    stats = json.loads(_take_str(_native.lib().tbus_serve_stats_json())
                       or "[]")
    from tbus_torch.kernels import _build

    bridge = _build._loaded.get("torch_device")
    if bridge is not None:
        engines = {e["name"]: e for e in json.loads(
            _take_str(bridge.tbus_torch_serve_engines_json()))}
        for st in stats:
            st.update({k: v for k, v in engines.get(st["name"], {}).items()
                       if k != "name"})
    return stats
