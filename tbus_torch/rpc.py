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
counters; and the core's flags, variables and fault sites. Server
handlers registered from Python run inside fibers on the native worker
fleet; ctypes re-acquires the GIL per callback.

On the protobuf-free core (``_native.core_flavor()``) what needs
libprotobuf fails with the core's own message; nothing takes another
path in its place.
"""

from __future__ import annotations

import ctypes
import json
import threading
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
    err = ctypes.create_string_buffer(512)
    if _device_bridge().tbus_torch_device_init(
            device.encode(), backend, err, len(err)) != 0:
        raise RuntimeError(f"device runtime on {device}: "
                           f"{err.value.decode(errors='replace')}")


def device_available() -> bool:
    """Whether the device runtime is up in this process."""
    return _device_bridge().tbus_torch_device_available() == 1


def device_stats() -> dict:
    """The device runtime's counters: platform, device, plans, executions,
    h2d/d2h bytes, errors, overcrowded jobs, each kernel's launches (on
    the CUDA backend) and the DMA block (device_dma_stats)."""
    return json.loads(_take_str(
        _device_bridge().tbus_torch_device_stats_json()))


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
    """Client stub for one target address ("host:port", "tpu://..."),
    with the core's default protocol and connection type."""

    def __init__(self, addr: str, timeout_ms: int = 500,
                 max_retry: int = 3) -> None:
        self._L = _native.lib()
        self._L.tbus_init(0)
        self._h = self._L.tbus_channel_new2(
            addr.encode(), timeout_ms, max_retry, b"", b"", 0, b"")
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
