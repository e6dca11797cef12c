"""The slice as a whole: the core's ops planes around a device method,
the port against the reference.

One child runs a port device server on the CPU runtime
(device_init("cpu"), K4's plain version through the runtime); the other
runs the reference's on its fake PJRT device (TBUS_PJRT_FAKE=1), as
tests/test_torch_native_fanout.py runs it. Each server mounts Xor and
Echo as device methods, the cache tier and the metrics sink; each
process records the requests it serves (rpc_dump_enable(path, 1)),
declares an SLO on DevService.Xor and exports its metrics to its own
sink. Each child sends itself the same Xor and Echo calls (numpy seed 0;
4 KiB and 64 KiB) over tbus_std, http, h2 and grpc, reports, and keeps
its server up until this process has replayed each corpus against the
other side's server.

The replies equal each other and K4's plain version; the two corpora
(rpc_dump records the tbus_std calls) are byte-identical and replay alike
on either server; the SLO names, the exemplar waterfalls' shape and the
flight rings' methods are equal; and the port's /status carries its
runtime's device line with the keys of the reference's "pjrt:" line.
"""

import hashlib
import json
import os
import re
import select
import subprocess
import sys
import time

import numpy as np
import pytest

import tbus_torch.rpc as port_rpc
from tbus_torch.kernels import device_programs as dp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 300  # a child's whole life, the bridge's build included
SIZES = (4096, 65536)
WIRES = ("tbus_std", "http", "h2", "grpc")
TRANSFORMS = {"Xor": "xor255", "Echo": "echo"}

_CHILD = r"""
import hashlib, json, re, sys, urllib.request
sys.path.insert(0, %(root)r)
import numpy as np
%(setup)s
t.init()
t.flag_set("tbus_slo_spec", "DevService.Xor:p99_us=100000,avail=990")
s = t.Server()
for m, tf in %(transforms)r.items():
    s.add_device_method("DevService", m, tf)
s.add_cache()
s.enable_metrics_sink()
port = s.start(0)
t.metrics_set_collector(f"127.0.0.1:{port}")
t.rpc_dump_enable(sys.argv[1], 1)
rng = np.random.default_rng(0)
bodies = {n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
          for n in %(sizes)r}
replies = {}
for wire in %(wires)r:
    ch = t.Channel(f"127.0.0.1:{port}", timeout_ms=15000, protocol=wire)
    for m in %(transforms)r:
        for n, body in bodies.items():
            replies[f"{wire}/{m}/{n}"] = hashlib.sha256(
                ch.call("DevService", m, body)).hexdigest()
t.rpc_dump_disable()
assert t.metrics_flush() > 0
t.metrics_flush()
t.metrics_set_collector("")
lat = t.fleet_query()["rollups"]["latency"]["rpc_server_DevService.Xor"]
slo = t.slo_status()["slos"]
status = urllib.request.urlopen(f"http://127.0.0.1:{port}/status",
                                timeout=10).read().decode()
status_tail = [x for x in status.splitlines()
               if x.startswith(("block_pool:", "pjrt:", "cuda_runtime:"))]
print("RESULT " + json.dumps({
    "port": port, "replies": replies,
    "slo_names": [x["name"] for x in slo],
    "exemplar_keys": sorted({k for x in slo for e in x["exemplars"]
                             for k in e}),
    "waterfalls": sorted({re.sub(r"\d+", "N", e["waterfall"])
                          for x in slo for e in x["exemplars"]}),
    "ring_methods": sorted({r["method"] for r in t.flight_ring(256)}),
    "xor_samples": lat["samples"],
    "xor_merged": [lat["merged_p50"], lat["merged_p99"],
                   lat["merged_p999"]],
    "status_tail": status_tail}), flush=True)
sys.stdin.read()  # serves until the test closes stdin
s.stop()
t.flag_set("tbus_slo_spec", "")
%(epilogue)s
print("CHILD-OK", flush=True)
"""

_PORT_SETUP = """import tbus_torch as t
t.device_init("cpu")"""
_PORT_EPILOGUE = """leaked = sorted(m for m in sys.modules
                if m in ("jax", "tbus") or m.startswith(("jax.", "tbus.")))
assert not leaked, leaked"""
_REF_SETUP = """import tbus as t
assert t.pjrt_init()"""


class _Side:
    """One child: its server's address, its corpus and its report."""

    def __init__(self, name, setup, epilogue, env, corpus):
        source = _CHILD % {"root": ROOT, "setup": setup,
                           "epilogue": epilogue, "transforms": TRANSFORMS,
                           "sizes": SIZES, "wires": WIRES}
        self.name, self.corpus = name, corpus
        self.proc = subprocess.Popen(
            [sys.executable, "-c", source, corpus], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, **env))
        self.deadline = time.monotonic() + DEADLINE_S
        self.result = None

    def read_result(self):
        while self.result is None:
            left = self.deadline - time.monotonic()
            if left <= 0 or not select.select([self.proc.stdout], [], [],
                                              left)[0]:
                raise AssertionError(f"{self.name} child: no report in "
                                     f"{DEADLINE_S} s")
            line = self.proc.stdout.readline()
            if not line:
                raise AssertionError(f"{self.name} child ended: "
                                     f"{self.proc.stderr.read()[-4000:]}")
            if line.startswith("RESULT "):
                self.result = json.loads(line[len("RESULT "):])
        return self.result

    @property
    def addr(self):
        return f"127.0.0.1:{self.result['port']}"

    def finish(self):
        """Ends the child; its output, and whether it ended cleanly."""
        try:
            out, err = self.proc.communicate(
                "", timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, err = self.proc.communicate()
        return self.proc.returncode == 0 and "CHILD-OK" in out, err


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ops_device")
    port = _Side("port", _PORT_SETUP, _PORT_EPILOGUE,
                 {"TBUS_FANOUT_MESH": "host"}, str(tmp / "port.rec"))
    ref = _Side("reference", _REF_SETUP, "",
                {"TBUS_PJRT_FAKE": "1", "JAX_PLATFORMS": "cpu"},
                str(tmp / "ref.rec"))
    try:
        port.read_result()
        ref.read_result()
        yield port, ref
    finally:
        ended = [side.finish() for side in (port, ref)]
    for side, (ok, err) in zip((port, ref), ended):
        assert ok, f"{side.name} child failed: {err[-4000:]}"


def _device_line(line):
    """A /status device line as (label, {key: value})."""
    label, _, rest = line.partition(": ")
    return label, dict(tok.split("=") for tok in rest.split())


def test_replies_equal_each_other_and_the_plain_version(sides):
    port, ref = sides
    assert port.result["replies"] == ref.result["replies"]
    rng = np.random.default_rng(0)
    bodies = {n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in SIZES}
    for key, digest in port.result["replies"].items():
        _, method, n = key.split("/")
        want = dp.device_method_reference(TRANSFORMS[method],
                                          bodies[int(n)])
        assert digest == hashlib.sha256(want).hexdigest(), key
    assert len(port.result["replies"]) == len(WIRES) * 2 * len(SIZES)


def test_rpc_dump_corpora_byte_identical(sides):
    port, ref = sides
    with open(port.corpus, "rb") as a, open(ref.corpus, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and len(got) > 4 * 4096


def test_replay_of_each_corpus_on_the_other_server(sides):
    port, ref = sides
    reports = [port_rpc.replay(port.corpus, ref.addr, concurrency=1,
                               verify=True),
               port_rpc.replay(ref.corpus, port.addr, concurrency=1,
                               verify=True)]
    keys = ("records", "ok", "failed")
    assert [reports[0][k] for k in keys] == [reports[1][k] for k in keys]
    # The tbus_std calls: Xor and Echo at each size, every one served.
    assert reports[0]["records"] == reports[0]["ok"] == 2 * len(SIZES)
    assert reports[0]["failed"] == 0
    assert reports[0]["round_trip_ok"] == reports[1]["round_trip_ok"] == 1


def test_slo_and_flight_ring_equal(sides):
    port, ref = sides
    for key in ("slo_names", "exemplar_keys", "waterfalls", "ring_methods"):
        assert port.result[key] == ref.result[key], key
    assert port.result["slo_names"] == ["DevService.Xor"]
    assert port.result["waterfalls"] and all(
        "DevService.Xor[queue Nus, self Nus]" in w
        for w in port.result["waterfalls"])
    assert {"DevService.Xor", "DevService.Echo"} <= set(
        port.result["ring_methods"])


def test_metrics_sink_rolls_up_the_device_method(sides):
    port, ref = sides
    for side in (port, ref):
        assert side.result["xor_samples"] >= len(WIRES) * len(SIZES)
        p50, p99, p999 = side.result["xor_merged"]
        assert p50 <= p99 <= p999


def test_status_device_line_has_the_reference_keys(sides):
    """The port's /status names its runtime and its counts, with the
    keys of the reference's "pjrt:" line in their order, after the block
    pool's line in the reference's own format (tests/test_zero_copy.py
    parses it)."""
    port, ref = sides
    lines = port.result["status_tail"]
    ref_lines = ref.result["status_tail"]
    assert len(lines) == 2 and lines[1].startswith("cuda_runtime: "), lines
    assert len(ref_lines) == 2 and ref_lines[1].startswith("pjrt: "), \
        ref_lines
    pool_label, pool = _device_line(lines[0])
    ref_pool_label, ref_pool = _device_line(ref_lines[0])
    assert pool_label == ref_pool_label == "block_pool"
    assert list(pool) == list(ref_pool)
    assert list(pool)[:2] == ["regions", "blocks_free"] and all(
        re.fullmatch(r"slot\d+KiB", k) for k in list(pool)[2:])
    assert len(pool) > 2
    for kv in (pool, ref_pool):
        assert re.fullmatch(r"\d+", kv["regions"]), kv
        assert all(re.fullmatch(r"\d+/\d+", v)
                   for k, v in kv.items() if k != "regions"), kv
    label, got = _device_line(lines[1])
    ref_label, want = _device_line(ref_lines[1])
    assert (label, ref_label) == ("cuda_runtime", "pjrt")
    assert list(got) == list(want)
    assert got["platform"] == "cpu" and got["devices"] == "1"
    calls = len(WIRES) * 2 * len(SIZES)
    assert int(got["executions"]) >= calls
    assert int(want["executions"]) >= calls
    assert int(got["errors"]) == int(want["errors"]) == 0
