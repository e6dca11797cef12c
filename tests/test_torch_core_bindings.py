"""The port's bindings of the shared core's load generators, per-stage
timing, tracing, transport counters, fault injection and flags
(tbus_torch.rpc) against the JAX package's (tbus.rpc).

Both packages load the same core in this process (one handle, one global
state: rpcz on or off, the fault seed and sites, the trace collector), so
each test sets that state back. Every function and method gives the
reference's signature; called through both packages it gives the same
result keys, and the same values where the result is deterministic
(flags, tunable domains, fault decisions under one seed, a fixed budget
echo). The load generators run for 200 ms against a port Server in this
process, and over tpu:// against a port echo server in a child process
(in one process tpu:// takes the in-process fabric, which has no stage
clock).
"""

import inspect
import os
import select
import subprocess
import sys

import pytest

import tbus.rpc as ref
import tbus_torch as tt
import tbus_torch.rpc as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FUNCTIONS = [
    "bench_echo", "bench_echo_overload", "bench_stream", "stage_stats",
    "timeline_dump", "rpcz_enable", "rpcz_dump", "rpcz_dump_json",
    "trace_set_collector", "trace_flush", "trace_query", "trace_perfetto",
    "trace_stats", "connections_dump", "budget_breakdown", "shm_lanes",
    "shm_zero_copy_frames", "shm_payload_copy_bytes", "fd_loops",
    "fd_rtc_max_bytes", "fi_set_seed", "fi_injected", "fi_probe", "fi_dump",
    "flag_get", "flag_domains",
]
METHODS = [("Server", m) for m in (
    "add_sleep", "add_stream_sink", "add_stream_method", "enable_ssl",
    "drain", "usercode_in_pthread", "enable_trace_sink",
    "set_concurrency_limiter")] + [("Channel", "call_progressive")]

# A port echo server in its own process, for cross-process tpu:// legs.
_CHILD = r"""
import sys, time
sys.path.insert(0, %(root)r)
from tbus_torch import rpc
rpc.init()
s = rpc.Server()
s.add_echo()
print(s.start(0), flush=True)
time.sleep(60)
"""


def _varint(v):
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(num, value):
    if isinstance(value, int):
        return _varint(num << 3) + _varint(value)
    return _varint(num << 3 | 2) + _varint(len(value)) + value


# One hop that called one child hop, as a server's budget echo carries it
# (cpp/rpc/slo.cc budget_decode).
_LEAF = (_field(1, b"Down.Get") + _field(2, 3) + _field(3, 40)
         + _field(4, 45))
_ECHO = (_field(1, b"Front.Call") + _field(2, 5) + _field(3, 120)
         + _field(4, 130) + _field(5, 1000)
         + _field(6, _field(1, b"Down.Get") + _field(2, 60)
                  + _field(3, _LEAF)))


@pytest.fixture(scope="module")
def server():
    port.init()
    s = port.Server()
    s.add_echo()
    s.add_sleep("SlowSvc", "Sleep", 2000)
    s.add_stream_sink()
    streams = []  # keepalive: a collected Stream closes its stream

    def open_stream(body, accept):
        streams.append(accept(echo=True))
        return b"accepted" if streams[-1] else b"none"

    s.add_stream_method("StreamSvc", "Open", open_stream)
    s.enable_trace_sink()
    s.set_concurrency_limiter("SlowSvc", "Sleep", "constant:4")
    addr = f"127.0.0.1:{s.start(0)}"
    yield addr
    s.stop()


@pytest.fixture(scope="module")
def child():
    proc = subprocess.Popen([sys.executable, "-c", _CHILD % {"root": ROOT}],
                            stdout=subprocess.PIPE, text=True)
    try:
        if not select.select([proc.stdout], [], [], 120)[0]:
            raise RuntimeError("the child echo server did not start in 120 s")
        yield f"tpu://127.0.0.1:{int(proc.stdout.readline())}"
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_one_core_in_both_packages():
    assert port._native.lib()._handle == ref._native.lib()._handle


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_signature_and_export(name):
    assert (inspect.signature(getattr(port, name))
            == inspect.signature(getattr(ref, name)))
    assert getattr(tt, name) is getattr(port, name)


@pytest.mark.parametrize("cls,name", METHODS)
def test_method_signature(cls, name):
    assert (inspect.signature(getattr(getattr(port, cls), name))
            == inspect.signature(getattr(getattr(ref, cls), name)))


def test_flags_and_domains_equal():
    for name in ("tbus_shm_spin_us", "tbus_shm_lanes",
                 "socket_max_write_queue_bytes"):
        assert port.flag_get(name) == ref.flag_get(name)
    for mod in (port, ref):
        with pytest.raises(ValueError):
            mod.flag_get("no_such_flag")
    assert port.flag_domains() == ref.flag_domains()


def test_fault_decisions_equal_under_one_seed():
    site = "parse_error"
    try:
        got = {}
        for mod in (ref, port):
            mod.fi_disable_all()
            mod.fi_set_seed(7)
            mod.fi_set(site, 500)
            before = mod.fi_injected(site)  # counts since the core started
            probe = mod.fi_probe(site, 64)
            got[mod] = (probe, mod.fi_injected(site) - before)
            assert f"{site} permille=500 budget=-1 draws=64" in mod.fi_dump()
            mod.fi_disable_all()
        assert got[port] == got[ref]
        assert 0 < sum(got[port][0]) == got[port][1] < 64
        assert port.fi_injected("no_such_site") == -1
        with pytest.raises(ValueError):
            port.fi_probe("no_such_site", 1)
    finally:
        port.fi_disable_all()
        port.fi_set_seed(1)


def test_budget_breakdown_equal():
    got = port.budget_breakdown(_ECHO)
    assert got == ref.budget_breakdown(_ECHO)
    assert got["hop"] == "Front.Call" and got["budget_us"] == 1000
    assert got["children"][0]["echo"]["handler_us"] == 40
    for mod in (port, ref):
        with pytest.raises(ValueError):
            mod.budget_breakdown(b"\x01\x02")


def test_bench_echo_keys_and_order(server):
    results = [mod.bench_echo(server, 4096, 2, 200) for mod in (port, ref)]
    assert results[0].keys() == results[1].keys()
    for r in results:
        assert r["qps"] > 0 and r["p50_us"] <= r["p99_us"] <= r["p999_us"]


def test_bench_echo_targets_a_method(server):
    r = port.bench_echo(server, 64, 1, 200, service="SlowSvc",
                        method="Sleep")
    assert r["qps"] > 0 and r["p50_us"] >= 2000  # the handler sleeps 2 ms


def test_bench_echo_overload_keys(server):
    results = [mod.bench_echo_overload(server, "SlowSvc", "Sleep", 64, 16,
                                       200, 0.0, 100) for mod in (port, ref)]
    assert results[0].keys() == results[1].keys()
    for r in results:
        assert r["ok"] > 0 and r["shed"] > 0  # 16 callers, limiter 4
        assert r["p50_us"] <= r["p99_us"]


def test_bench_stream_keys(server):
    results = [mod.bench_stream(server, 8 << 20, 1 << 20)
               for mod in (port, ref)]
    assert results[0].keys() == results[1].keys()
    for r in results:
        assert r["chunks"] == 8 and r["goodput_MBps"] > 0
        assert r["gap_p50_us"] <= r["gap_p99_us"]


def test_stage_stats_after_tpu_calls(child):
    r = port.bench_echo(child, 4096, 1, 200)
    assert r["qps"] > 0 and r["p50_us"] <= r["p99_us"]
    got, want = port.stage_stats(), ref.stage_stats()
    assert got.keys() == want.keys()
    hop = got["tbus_shm_stage_ring_to_pickup"]
    assert hop.keys() == want["tbus_shm_stage_ring_to_pickup"].keys()
    assert hop["count"] > 0 and hop["p50_ns"] <= hop["p99_ns"]
    assert port.timeline_dump().startswith("stage-clock timeline")
    assert port.shm_zero_copy_frames() == ref.shm_zero_copy_frames()
    assert port.shm_payload_copy_bytes() == ref.shm_payload_copy_bytes()
    ch = port.Channel(child, timeout_ms=3000)
    assert ch.call("EchoService", "Echo", b"live") == b"live"
    assert "[tpu]" in port.connections_dump()


def test_transport_counters_equal():
    assert port.shm_lanes() == ref.shm_lanes()
    assert port.fd_loops() == ref.fd_loops() > 0
    assert port.fd_rtc_max_bytes() == ref.fd_rtc_max_bytes()


def test_rpcz_spans(server):
    ch = port.Channel(server, timeout_ms=3000)
    try:
        port.rpcz_enable(True)
        assert ch.call("EchoService", "Echo", b"span") == b"span"
        spans = port.rpcz_dump_json()
        assert spans and spans[0].keys() == ref.rpcz_dump_json()[0].keys()
        assert "EchoService.Echo" in port.rpcz_dump()
    finally:
        port.rpcz_enable(False)


def test_trace_export(server):
    ch = port.Channel(server, timeout_ms=3000)
    try:
        assert port.trace_flush() == ref.trace_flush() == -1  # none set
        port.rpcz_enable(True)
        port.trace_set_collector(server)
        assert ch.call("EchoService", "Echo", b"trace") == b"trace"
        assert port.trace_flush() >= 0
        assert port.trace_stats().keys() == ref.trace_stats().keys()
        assert port.trace_perfetto().keys() == ref.trace_perfetto().keys()
        trace_id = port.rpcz_dump_json()[0]["trace_id"]
        assert port.trace_query(trace_id) == ref.trace_query(trace_id)
    finally:
        port.trace_set_collector("")
        port.rpcz_enable(False)


def test_call_progressive_and_stream_method(server):
    pieces = [mod.Channel(server, timeout_ms=3000).call_progressive(
        "EchoService", "Echo", b"piece" * 100) for mod in (port, ref)]
    assert pieces[0] == pieces[1] == [b"piece" * 100]
    ch = port.Channel(server, timeout_ms=3000)
    with port.Stream.create(ch, "StreamSvc", "Open") as st:
        st.write(b"chunk")
        assert st.read(timeout_ms=3000) == b"chunk"  # echoed back


def test_sleep_and_limiter_errors(server):
    ch = port.Channel(server, timeout_ms=3000)
    assert ch.call("SlowSvc", "Sleep", b"") == b"ok"
    errors = []
    for srv in (port.Server(), ref.Server()):
        srv.add_sleep("SlowSvc", "Sleep", 10)
        with pytest.raises(ValueError) as e:
            srv.set_concurrency_limiter("SlowSvc", "Sleep", "bogus:x")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_pthread_usercode_serves_a_nested_call(server):
    s = port.Server()
    s.usercode_in_pthread()
    inner = port.Channel(server, timeout_ms=3000)
    s.add_method("Nest", "Call",
                 lambda body: inner.call("EchoService", "Echo", body))
    ch = port.Channel(f"127.0.0.1:{s.start(0)}", timeout_ms=3000)
    try:
        assert ch.call("Nest", "Call", b"nested") == b"nested"
    finally:
        s.stop()


def test_drain_then_stop():
    s = port.Server()
    s.add_echo()
    addr = f"127.0.0.1:{s.start(0)}"
    ch = port.Channel(addr, timeout_ms=3000, max_retry=0)
    assert ch.call("EchoService", "Echo", b"before") == b"before"
    assert s.drain(500) == 0  # nothing in flight: a clean drain
    with pytest.raises(port.RpcError):
        port.Channel(addr, timeout_ms=500, max_retry=0).call(
            "EchoService", "Echo", b"after")
    s.stop()


def test_ssl_without_its_files_fails_to_start_in_both(tmp_path):
    missing = str(tmp_path / "none.pem")
    for mod in (port, ref):
        s = mod.Server()
        s.add_echo()
        s.enable_ssl(missing, missing)
        with pytest.raises(RuntimeError):
            s.start(0)
