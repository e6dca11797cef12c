"""The port's bindings of the shared core's ops planes (tbus_torch.rpc)
against the JAX package's (tbus.rpc): the channel options and GrpcStub,
the flight recorder and wait profiler, the SLO plane, the autotune
controller, the cache tier with record and replay, and the fleet metrics
sink.

Both packages load the same core in this process, so the recorder's
rules, the wait profiler's switch, tbus_slo_spec, the autotune
controller, the metrics collector and sink, and rpc_dump's file are one
state: every test that moves one sets it back. Every function and method
gives the reference's signature, and called through both packages the
same result keys, and the same values where the result is deterministic.
test_autotune_bindings, test_fleet_metrics_bindings, test_cache_bindings
and test_flight_recorder_bindings are the twins of tests/test_bindings.py's
tests of those names, through tbus_torch against a port server.
"""

import inspect
import os
import time

import pytest

import tbus.rpc as ref
import tbus_torch as tt
import tbus_torch.rpc as port

FUNCTIONS = [
    "wait_profiler_enable", "wait_profile_dump", "wait_profile_stats",
    "wait_profile_reset", "flight_ring", "recorder_arm", "recorder_disarm",
    "recorder_capture", "recorder_bundles", "recorder_bundle_text",
    "recorder_stats", "slo_status", "slo_text", "slo_fleet", "slo_burn",
    "autotune_enable", "autotune_disable", "autotune_stats",
    "autotune_last_good", "cache_stats", "rpc_dump_enable",
    "rpc_dump_disable", "cache_corpus_write", "replay",
    "cache_reshard_drill", "bench_cache", "metrics_set_collector",
    "metrics_flush", "fleet_query", "metrics_stats", "metrics_sink_reset",
]
METHODS = [("Channel", m) for m in (
    "__init__", "cache_set", "cache_get", "cache_del")] + [
    ("Server", "add_cache"), ("Server", "enable_metrics_sink"),
    ("GrpcStub", "__init__"), ("GrpcStub", "unary_unary")]


@pytest.fixture(scope="module")
def server():
    """A port server with the echo and the cache tier (mounted before
    start, as the reference)."""
    port.init()
    s = port.Server()
    s.add_echo()
    s.add_cache()
    addr = f"127.0.0.1:{s.start(0)}"
    yield addr
    s.stop()


@pytest.fixture
def restored_flags():
    """Every tunable flag (the autotune controller's walk) set back."""
    before = {d["name"]: d["value"] for d in port.flag_domains()}
    yield before
    port.autotune_disable()
    for name, value in before.items():
        port.flag_set(name, value)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_signature_and_export(name):
    assert (inspect.signature(getattr(port, name))
            == inspect.signature(getattr(ref, name)))
    assert getattr(tt, name) is getattr(port, name)


@pytest.mark.parametrize("cls,name", METHODS)
def test_method_signature(cls, name):
    assert (inspect.signature(getattr(getattr(port, cls), name))
            == inspect.signature(getattr(getattr(ref, cls), name)))
    assert getattr(tt, cls) is getattr(port, cls)


def test_grpc_stub_bad_path_raises_in_both(server):
    for mod in (port, ref):
        stub = mod.GrpcStub(server)
        for bad in ("NoSlash", "/OnlyService/", "//"):
            with pytest.raises(ValueError):
                stub.unary_unary(bad)


def test_recorder_arm_counts_and_errors_equal():
    specs = ["rate:tbus_metrics_exported:per_s=1000000",
             "p99:rpc_server_EchoService.Echo:ratio=3,min_us=500;divergence",
             "slo:EchoService.Echo:burn=2;rate:tbus_metrics_exported:per_s=5"]
    try:
        for spec in specs:
            n = port.recorder_arm(spec)
            port.recorder_disarm()
            assert n == ref.recorder_arm(spec) > 0, spec
            ref.recorder_disarm()
        for mod in (port, ref):
            with pytest.raises(ValueError):
                mod.recorder_arm("p99:nope")
            assert mod.recorder_stats()["armed"] == 0
    finally:
        port.recorder_disarm()


def test_slo_names_and_undeclared_burn_equal():
    spec = "EchoService.Echo:p99_us=5000,avail=999;Cache.Get:p50_us=900"
    try:
        for mod in (port, ref):
            with pytest.raises(KeyError):
                mod.slo_burn("NoSuch.Method")
        port.flag_set("tbus_slo_spec", spec)
        names = [s["name"] for s in port.slo_status()["slos"]]
        assert names == [s["name"] for s in ref.slo_status()["slos"]]
        assert names == ["EchoService.Echo", "Cache.Get"]
        assert port.slo_status().keys() == ref.slo_status().keys()
        assert port.slo_fleet().keys() == ref.slo_fleet().keys()
        assert port.slo_burn("Cache.Get", fast=False) == ref.slo_burn(
            "Cache.Get", fast=False)
        assert "EchoService.Echo" in port.slo_text()
    finally:
        port.flag_set("tbus_slo_spec", "")
    assert port.slo_status()["slos"] == []


def test_cache_corpus_byte_identical_across_packages(tmp_path):
    paths = [str(tmp_path / f"{name}.rec") for name in ("port", "ref")]
    counts = [mod.cache_corpus_write(p, seed=11, n=200, key_space=16,
                                     value_bytes=700, set_permille=300)
              for mod, p in zip((port, ref), paths)]
    assert counts == [200, 200]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(RuntimeError):
        port.cache_corpus_write(str(tmp_path / "no" / "dir.rec"))


def test_wait_profile_keys_and_dump_equal(server):
    ch = port.Channel(server, timeout_ms=10000)
    try:
        for mod in (port, ref):
            mod.wait_profiler_enable(True)
            assert mod.wait_profile_dump().startswith("collector: ")
        for _ in range(8):
            assert ch.call("EchoService", "Echo", b"park") == b"park"
        assert port.wait_profile_stats().keys() == ref.wait_profile_stats(
        ).keys()
        assert port.wait_profile_stats()["samples"] > 0
    finally:
        port.wait_profiler_enable(False)
    assert ref.wait_profile_stats()["enabled"] == 0
    port.wait_profile_reset()  # off, so no park lands after it
    assert ref.wait_profile_stats()["samples"] == 0


def test_result_keys_equal(server, tmp_path):
    ch = port.Channel(server, timeout_ms=10000)
    for _ in range(4):
        assert ch.call("EchoService", "Echo", b"keys") == b"keys"
    for name in ("recorder_stats", "recorder_bundles", "autotune_stats",
                 "autotune_last_good", "cache_stats", "metrics_stats",
                 "fleet_query", "slo_status", "slo_fleet"):
        assert (getattr(port, name)().keys()
                == getattr(ref, name)().keys()), name
    rings = [mod.flight_ring(8) for mod in (port, ref)]
    assert rings[0] and rings[0][0].keys() == rings[1][0].keys()
    corpus = str(tmp_path / "c.rec")
    port.cache_corpus_write(corpus, seed=3, n=20, key_space=4,
                            value_bytes=64)
    reports = [mod.replay(corpus, server, concurrency=1)
               for mod in (port, ref)]
    assert reports[0].keys() == reports[1].keys()
    assert reports[0]["records"] == reports[1]["records"] == 20
    benches = [mod.bench_cache(server, 4096, 8, 100, 2, 200)
               for mod in (port, ref)]
    assert benches[0].keys() == benches[1].keys()
    assert benches[0]["qps"] > 0
    for mod in (port, ref):
        with pytest.raises(mod.RpcError):
            mod.replay(str(tmp_path / "missing.rec"), server)


def test_cache_reshard_drill_keys_equal():
    got = port.cache_reshard_drill(keys=16, value_bytes=512)
    assert got["ok"] == 1, got
    assert got.keys() == ref.cache_reshard_drill(keys=16,
                                                 value_bytes=512).keys()


def test_channel_options_reach_the_core(server):
    for mod in (port, ref):
        with pytest.raises(RuntimeError):
            mod.Channel(f"list://{server}", lb="no-such-balancer")
    ch = port.Channel(server, timeout_ms=10000, protocol="http",
                      connection="pooled")
    assert ch.call("EchoService", "Echo", b"opts") == b"opts"
    # The options arrive whole: the core refuses compression on http with
    # its own message, in both packages.
    errors = []
    for mod in (port, ref):
        with pytest.raises(mod.RpcError) as e:
            mod.Channel(server, timeout_ms=10000, protocol="http",
                        compress=1).call("EchoService", "Echo", b"gz")
        errors.append(e.value.text)
    assert errors[0] == errors[1] and "compression" in errors[0]


def test_autotune_bindings(server, restored_flags):
    """Twin of tests/test_bindings.py's autotune test: the tunable
    domains and their ladders, out-of-domain flag_set refused, and the
    controller's lifecycle (enable, stats, last good, disable)."""
    domains = tt.flag_domains()
    names = {d["name"] for d in domains}
    assert {"tbus_shm_spin_us", "tbus_shm_rtc_max_bytes",
            "tbus_shm_chain_min_ext_bytes", "tbus_fd_rtc_max_bytes"} <= names
    for d in domains:
        assert d["min"] <= d["max"]
        assert d["ladder"][0] == d["min"] and d["ladder"][-1] == d["max"]
        assert d["ladder"] == sorted(d["ladder"])
        assert d["min"] <= d["value"] <= d["max"]
    spin0 = tt.flag_get("tbus_shm_spin_us")
    for bad in ("999999999", "-1", "junk", "1e4", "12x"):
        with pytest.raises(ValueError):
            tt.flag_set("tbus_shm_spin_us", bad)
    assert tt.flag_get("tbus_shm_spin_us") == spin0
    tt.autotune_enable()
    try:
        st = tt.autotune_stats()
        assert st["enabled"] == 1
        for k in ("steps", "keeps", "reverts", "rollbacks", "frozen",
                  "vector", "last_good"):
            assert k in st
        assert isinstance(tt.autotune_last_good(), dict)
        assert int(tt.var_value("tbus_autotune_running") or 0) == 1
    finally:
        tt.autotune_disable()
    assert tt.autotune_stats()["enabled"] == 0
    ch = tt.Channel(server, timeout_ms=10000)
    assert ch.call("EchoService", "Echo", b"autotuned") == b"autotuned"


def test_fleet_metrics_bindings():
    """Twin of tests/test_bindings.py's fleet metrics test: a port server
    hosts the MetricsSink, this process exports to it, and two flushes
    land one node with its identity, counter rollups and merged
    percentiles."""
    tt.metrics_sink_reset()
    s = tt.Server()
    s.enable_metrics_sink()
    s.add_echo("FleetSvc", "Echo")
    sink = s.start(0)
    try:
        tt.metrics_set_collector(f"127.0.0.1:{sink}")
        ch = tt.Channel(f"127.0.0.1:{sink}", timeout_ms=10000)
        for _ in range(50):
            assert ch.call("FleetSvc", "Echo", b"fleet") == b"fleet"
        assert tt.metrics_flush() > 0
        tt.metrics_flush()
        fleet = tt.fleet_query()
        assert len(fleet["nodes"]) == 1
        node = fleet["nodes"][0]
        for key in ("id", "version", "flag_hash", "start_unix_s", "seq",
                    "snapshots", "outlier", "svc_p99_us"):
            assert key in node, node
        assert node["outlier"] == 0 and node["snapshots"] >= 2
        assert "tbus_metrics_exported" in fleet["rollups"]["counters"]
        lat = fleet["rollups"]["latency"]["rpc_server_FleetSvc.Echo"]
        assert lat["samples"] >= 50
        assert lat["merged_p50"] <= lat["merged_p99"] <= lat["merged_p999"]
        assert lat["node_p99"][node["id"]] >= lat["merged_p50"]
        st = tt.metrics_stats()
        for key in ("exported", "dropped", "send_fail", "sink_snapshots",
                    "nodes", "outliers", "outlier_flags"):
            assert key in st
        assert st["exported"] >= 2 and st["nodes"] == 1
        tt.metrics_set_collector("")
        assert tt.metrics_flush() == -1
        assert ch.call("FleetSvc", "Echo", b"still") == b"still"
    finally:
        tt.metrics_set_collector("")
        tt.metrics_sink_reset()
        s.stop()


def test_cache_bindings(server, tmp_path):
    """Twin of tests/test_bindings.py's cache test: set, get and del
    byte for byte (a miss is None), TTL expiry, cache_stats, a seeded
    corpus twice byte for byte, and replay(verify=True) against the
    server."""
    ch = tt.Channel(server, timeout_ms=10000)
    blob = bytes(range(256)) * 1024  # 256 KiB, every byte value
    ch.cache_set("py-key", blob)
    assert ch.cache_get("py-key") == blob
    assert ch.cache_get("absent") is None
    assert ch.cache_del("py-key") is True
    assert ch.cache_del("py-key") is False
    assert ch.cache_get("py-key") is None
    ch.cache_set("brief", b"v", ttl_ms=80)
    assert ch.cache_get("brief") == b"v"
    time.sleep(0.15)
    assert ch.cache_get("brief") is None  # expired
    st = tt.cache_stats()
    assert st["stores"] >= 1 and "max_bytes" in st, st
    agg = st["agg"]
    for key in ("hits", "misses", "sets", "expired", "evictions",
                "shed_full", "bytes", "entries"):
        assert key in agg, st
    assert agg["hits"] >= 2 and agg["misses"] >= 3 and agg["sets"] >= 2
    p1, p2 = str(tmp_path / "a.rec"), str(tmp_path / "b.rec")
    n1 = tt.cache_corpus_write(p1, seed=11, n=120, key_space=8,
                               value_bytes=512, set_permille=250)
    n2 = tt.cache_corpus_write(p2, seed=11, n=120, key_space=8,
                               value_bytes=512, set_permille=250)
    assert n1 == n2 == 120
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    rep = tt.replay(p1, server, concurrency=2, verify=True)
    assert rep["records"] == 120 and rep["round_trip_ok"] == 1
    assert rep["failed"] == 0 and rep["hits"] + rep["misses"] > 0


def test_rpc_dump_records_served_requests(server, tmp_path):
    path = str(tmp_path / "dump.rec")
    tt.rpc_dump_enable(path, 1)
    try:
        ch = tt.Channel(server, timeout_ms=10000)
        for i in range(10):
            assert ch.call("EchoService", "Echo", b"d%d" % i) == b"d%d" % i
    finally:
        tt.rpc_dump_disable()
    assert os.path.getsize(path) > 0
    rep = tt.replay(path, server, concurrency=1, verify=True)
    assert rep["records"] == 10 and rep["ok"] == 10
    assert rep["failed"] == 0 and rep["round_trip_ok"] == 1
    with pytest.raises(RuntimeError):
        tt.rpc_dump_enable(path, 0)  # interval 0 is refused


def test_flight_recorder_bindings(server):
    """Twin of tests/test_bindings.py's flight recorder test: calls land
    in the ring, the wait profiler's switch and stats, a manual capture
    with every section but the profiles' payload, and a definite arm and
    disarm (a bad spec raises and arms nothing)."""
    ch = tt.Channel(server)
    rec0 = tt.recorder_stats()["ring_records"]
    for _ in range(32):
        assert ch.call("EchoService", "Echo", b"ring") == b"ring"
    assert tt.recorder_stats()["ring_records"] >= rec0 + 32
    ring = tt.flight_ring(max_records=64)
    assert ring
    for key in ("t_us", "method", "peer", "err", "lat_us", "trace_id"):
        assert key in ring[0], ring[0]
    assert any(r["method"] == "EchoService.Echo" for r in ring)
    tt.wait_profiler_enable(True)
    try:
        for _ in range(16):
            ch.call("EchoService", "Echo", b"wait")
        ws = tt.wait_profile_stats()
        assert ws["enabled"] == 1
        assert "total_wait_us" in ws and "classes" in ws
        assert tt.wait_profile_dump().startswith("collector: ")
    finally:
        tt.wait_profiler_enable(False)
    assert tt.wait_profile_stats()["enabled"] == 0
    boost = tt.flag_get("tbus_recorder_boost_ms")
    tt.flag_set("tbus_recorder_boost_ms", "0")
    try:
        bid = tt.recorder_capture("bindings probe", profile_seconds=0)
    finally:
        tt.flag_set("tbus_recorder_boost_ms", boost)
    assert bid > 0
    mine = [b for b in tt.recorder_bundles(detail=False)["bundles"]
            if b["id"] == bid]
    assert mine and mine[0]["reason"] == "bindings probe"
    sections = mine[0]["sections"]
    assert set(sections) == {"ring", "cpu", "wait", "vars", "sched", "slo"}
    assert sections["vars"] > 0 and sections["sched"] > 0
    text = tt.recorder_bundle_text(bid)
    assert f"bundle {bid}" in text and "bindings probe" in text
    assert tt.recorder_bundle_text(10 ** 12) == ""
    try:
        assert tt.recorder_arm(
            "rate:tbus_metrics_exported:per_s=1000000") == 1
        assert tt.recorder_stats()["armed"] == 1
        with pytest.raises(ValueError):
            tt.recorder_arm("p99:nope")
        assert tt.recorder_stats()["armed"] == 1
    finally:
        tt.recorder_disarm()
    assert tt.recorder_stats()["armed"] == 0


def test_servers_and_cache_calls_cross_the_packages():
    """Each package's Server.add_cache / enable_metrics_sink and
    Channel.cache_* against the other's server, with equal results."""
    servers = []
    for mod in (port, ref):
        s = mod.Server()
        s.add_cache()
        s.enable_metrics_sink()
        servers.append((s, f"127.0.0.1:{s.start(0)}"))
    try:
        results = []
        for mod, (_, addr) in zip((port, ref), reversed(servers)):
            ch = mod.Channel(addr, timeout_ms=10000)
            ch.cache_set("cross", b"\x00value\xff", ttl_ms=10000)
            results.append((ch.cache_get("cross"), ch.cache_get("nope"),
                            ch.cache_del("cross"), ch.cache_del("cross")))
        assert results[0] == results[1] == (b"\x00value\xff", None, True,
                                            False)
    finally:
        for s, _ in servers:
            s.stop()


def test_rpc_dump_files_equal_across_packages(server, tmp_path):
    ch = port.Channel(server, timeout_ms=10000)
    paths = []
    for mod in (port, ref):
        paths.append(str(tmp_path / f"{mod.__name__}.rec"))
        mod.rpc_dump_enable(paths[-1], 1)
        try:
            for i in range(6):
                assert ch.call("EchoService", "Echo", b"r%d" % i) == b"r%d" % i
        finally:
            mod.rpc_dump_disable()
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and got


def test_recorder_capture_and_text_equal_across_packages():
    boost = port.flag_get("tbus_recorder_boost_ms")
    port.flag_set("tbus_recorder_boost_ms", 0)
    try:
        ids = [mod.recorder_capture(f"probe {mod.__name__}", 0)
               for mod in (port, ref)]
    finally:
        port.flag_set("tbus_recorder_boost_ms", boost)
    assert ids[1] > ids[0]  # one store in one core
    for mod, bid in zip((ref, port), ids):  # each reads the other's
        assert f"bundle {bid}" in mod.recorder_bundle_text(bid)
    assert port.slo_text().splitlines()[0] == ref.slo_text().splitlines()[0]
    for mod in (port, ref):
        mod.wait_profile_reset()
        assert mod.wait_profile_stats()["samples"] == 0


def test_autotune_and_collector_switches_equal(restored_flags):
    for mod in (port, ref):
        mod.autotune_enable()
        assert ref.autotune_stats()["enabled"] == 1
        mod.autotune_disable()
        assert port.autotune_stats()["enabled"] == 0
        mod.metrics_set_collector("")
        assert mod.metrics_flush() == -1
        mod.metrics_sink_reset()
        assert port.fleet_query().get("nodes", []) == []
