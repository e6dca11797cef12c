"""The port's C++ collective fan-out engine (tbus_torch/csrc/cuda_fanout.cc)
on the CPU backend of the device runtime (device_init("cpu")): twins of
tests/test_native_fanout.py:38 (lowering byte-identical to p2p), :58
(partition scatter-gather lowers) and :74 (the divergence guard).

The lowered bytes are also held against the reference's own engine: a
child runs tbus with its fake PJRT device (TBUS_PJRT_FAKE=1,
TBUS_FANOUT_MESH=device), which executes fanout_mlir itself
(pjrt_runtime.cc:599-631), on the same requests from the same numpy seed.

The collective backend and the runtime are one per process, so every case
runs in a child; the port's children end by asserting that neither jax
nor the JAX package was imported.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_EPILOGUE = r"""
leaked = sorted(m for m in sys.modules
                if m in ("jax", "tbus") or m.startswith(("jax.", "tbus.")))
assert not leaked, leaked
print("CHILD-OK", flush=True)
"""

# The fleet and the requests, the same for the port and the reference:
# `t` is the package (tbus_torch or tbus). Four tpu:// servers whose
# handlers are the builtins' p2p twins; payloads from one numpy seed
# (4096 bytes fill their bucket; 5000 pad to 6144; the partition body is
# ragged: 4 shards of unequal length).
_FLEET = r"""
import hashlib, json, os, sys, time
sys.path.insert(0, %(root)r)
import numpy as np
METHODS = {"Echo": ("echo", "echo/v1"), "Xor": ("xor255", "xor255/v1"),
           "Add": ("add_peer_index", "add/v1")}
t.init()
for m, (b, impl) in METHODS.items():
    t.advertise_device_method("NFanSvc", m, impl)
servers, ports = [], []
for i in range(4):
    s = t.Server()
    s.add_echo("NFanSvc", "Echo")
    s.add_method("NFanSvc", "Xor", t.builtin_handler("xor255"))
    s.add_method("NFanSvc", "Add", t.builtin_handler("add_peer_index", i))
    ports.append(s.start(0))
    servers.append(s)
pchan = t.ParallelChannel()
for p in ports:
    pchan.add(f"tpu://127.0.0.1:{p}")
assert pchan.collective_eligible
rng = np.random.default_rng(2024)
bodies = {"4096": rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
          "5000": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()}
part_body = rng.integers(0, 256, 4 * 1000 + 3, dtype=np.uint8).tobytes()
url = "list://" + ",".join(f"tpu://127.0.0.1:{p} {i}/4"
                           for i, p in enumerate(ports))
part = t.PartitionChannel(4, url)
assert part.collective_eligible
p2p = {f"{m}/{k}": pchan.call("NFanSvc", m, b, 15000)
       for m in METHODS for k, b in bodies.items()}
p2p.update({f"part/{m}": part.call("NFanSvc", m, part_body, 15000)
            for m in METHODS})
"""

# Lowers the same calls and prints their digests.
_LOWER = r"""
lowered = {f"{m}/{k}": pchan.call("NFanSvc", m, b, 15000)
           for m in METHODS for k, b in bodies.items()}
lowered.update({f"part/{m}": part.call("NFanSvc", m, part_body, 15000)
                for m in METHODS})
for key, want in p2p.items():
    assert lowered[key] == want, key  # byte for byte
print("DIGESTS " + json.dumps({k: hashlib.sha256(v).hexdigest()
                               for k, v in sorted(lowered.items())}),
      flush=True)
"""

PORT_LOWER_CHILD = r"""
import tbus_torch as t
from tbus_torch import rpc
""" + _FLEET + r"""
t.device_init("cpu")
assert t.enable_native_fanout()
for m, (b, impl) in METHODS.items():
    assert t.register_native_device_method("NFanSvc", m, b, impl)
before = t.native_fanout_stats()
""" + _LOWER + r"""
st = t.native_fanout_stats()
n = len(METHODS) * (len(bodies) + 1)
assert st["lowered_calls"] - before["lowered_calls"] == n, st
assert st["scatter_calls"] - before["scatter_calls"] == len(METHODS), st
assert st["device_execs"] == st["lowered_calls"] and st["host_execs"] == 0
assert st["installed"] and not st["quarantined"], st
assert st["advertised_peers"] >= 4, st
assert rpc.device_stats()["executions"] == n
for s in servers:
    s.stop()
"""

REFERENCE_LOWER_CHILD = r"""
import tbus as t
""" + _FLEET + r"""
assert t.pjrt_init()
assert t.enable_native_fanout()
for m, (b, impl) in METHODS.items():
    assert t.register_native_device_method("NFanSvc", m, b, impl)
""" + _LOWER + r"""
st = t.native_fanout_stats()
assert st["pjrt_execs"] == len(METHODS) * (len(bodies) + 1), st
for s in servers:
    s.stop()
print("CHILD-OK", flush=True)
"""


def _run(source, env=None, timeout=300):
    proc = subprocess.run(
        [sys.executable, "-c", source], capture_output=True, text=True,
        timeout=timeout, env=dict(os.environ, **(env or {})))
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
    return proc.stdout


def _port(body, env=None):
    return _run(body % {"root": ROOT} + _EPILOGUE, env)


def _digests(out):
    line = [x for x in out.splitlines() if x.startswith("DIGESTS ")][0]
    return json.loads(line[len("DIGESTS "):])


def test_lowering_byte_identical_to_p2p_and_to_the_reference():
    port = _digests(_port(PORT_LOWER_CHILD))
    ref = _digests(_run(REFERENCE_LOWER_CHILD % {"root": ROOT}, {
        "TBUS_PJRT_FAKE": "1", "TBUS_FANOUT_MESH": "device",
        "JAX_PLATFORMS": "cpu"}))
    assert len(port) == 9
    assert port == ref


GUARD_CHILD = r"""
import tbus_torch as t
""" + _FLEET + r"""
t.device_init("cpu")
assert t.enable_native_fanout()
assert t.register_native_device_echo("NFanSvc", "Echo")
body = b"guard-me"
assert pchan.call("NFanSvc", "Echo", body, 15000) == body * 4  # warm
t.flag_set("tbus_fanout_quarantine_ms", 150)
t.flag_set("tbus_fanout_divergence_permille", 1000)
try:
    # One corrupted lowered result: the sampled compare serves the p2p
    # bytes (the caller never sees the corruption) and quarantines.
    t.fi_set("fanout_corrupt", 1000, budget=1)
    assert pchan.call("NFanSvc", "Echo", body, 15000) == body * 4
    st = t.native_fanout_stats()
    assert st["divergence_mismatch"] == 1 and st["quarantines"] == 1, st
    assert st["quarantined"], st
    assert t.var_value("tbus_fanout_quarantined") == "1"
finally:
    t.flag_set("tbus_fanout_divergence_permille", 0)
    t.fi_disable_all()
# Quarantined: the call goes p2p, still correct.
low = t.native_fanout_lowered_calls()
assert pchan.call("NFanSvc", "Echo", body, 15000) == body * 4
assert t.native_fanout_lowered_calls() == low
# Past the window one probe is admitted, verified against p2p, and a
# clean one revives the engine.
time.sleep(0.3)
assert pchan.call("NFanSvc", "Echo", body, 15000) == body * 4
st = t.native_fanout_stats()
assert st["revivals"] == 1 and not st["quarantined"], st
assert st["divergence_checked"] == 2 and st["divergence_mismatch"] == 1, st
assert pchan.call("NFanSvc", "Echo", body, 15000) == body * 4
assert t.native_fanout_lowered_calls() == low + 2
for s in servers:
    s.stop()
"""


def test_divergence_guard_quarantines_and_revives():
    _port(GUARD_CHILD)


CACHE_CHILD = r"""
import tbus_torch as t
from tbus_torch import rpc
""" + _FLEET + r"""
t.device_init("cpu")
assert t.enable_native_fanout()
assert t.register_native_device_echo("NFanSvc", "Echo")
for size in (100, 100, 100, 5000, 5000, 5000):
    b = bytes(range(256)) * (size // 256) + bytes(size %% 256)
    assert pchan.call("NFanSvc", "Echo", b, 15000) == b * 4
st = t.native_fanout_stats()
# Buckets 128 and 6144: one plan each, every later call a hit.
assert st["cache_misses"] == 2 and st["cache_hits"] == 4, st
assert rpc.device_stats()["plans"] == 2
for s in servers:
    s.stop()
"""


def test_plan_cache_hits_and_misses_across_two_buckets():
    _port(CACHE_CHILD)


NO_RUNTIME_CHILD = r"""
import tbus_torch as t
from tbus_torch import rpc
""" + _FLEET + r"""
# No runtime: the engine installs, CanLower says no, calls go p2p.
assert not rpc.device_available()
assert t.enable_native_fanout()
assert t.register_native_device_echo("NFanSvc", "Echo")
b = bodies["4096"]
assert pchan.call("NFanSvc", "Echo", b, 15000) == b * 4
st = t.native_fanout_stats()
assert st["installed"] and st["lowered_calls"] == 0, st
# Once the runtime is up the same call lowers.
t.device_init("cpu")
assert pchan.call("NFanSvc", "Echo", b, 15000) == b * 4
assert t.native_fanout_lowered_calls() == 1
for s in servers:
    s.stop()
"""


def test_no_runtime_means_no_lowering():
    _port(NO_RUNTIME_CHILD)


ORDER_CHILD = r"""
import tbus_torch as t
""" + _FLEET + r"""
t.device_init("cpu")
# TBUS_FANOUT_MESH=host: the torch bridge's runtime and the C++ engine
# both take their host kind.
os.environ["TBUS_FANOUT_MESH"] = "host"
# The torch bridge first; the C++ engine displaces it, and enabling the
# torch bridge again does not take the calls back.
assert t.enable_torch_fanout()
assert t.register_device_echo("NFanSvc", "Echo")
b = bodies["5000"]
assert pchan.call("NFanSvc", "Echo", b, 15000) == b * 4
assert t.torch_lowered_calls() == 1
assert t.enable_native_fanout()
assert t.register_native_device_echo("NFanSvc", "Echo")
assert t.enable_torch_fanout()
assert pchan.call("NFanSvc", "Echo", b, 15000) == b * 4
assert t.torch_lowered_calls() == 1 and t.native_fanout_lowered_calls() == 1
# Without it, the device engine: the same bytes, counted apart.
del os.environ["TBUS_FANOUT_MESH"]
assert t.register_native_device_method("NFanSvc", "Add", "add_peer_index",
                                       "add/v1")
assert pchan.call("NFanSvc", "Add", b, 15000) == p2p["Add/5000"]
st = t.native_fanout_stats()
assert st["host_execs"] == 1 and st["device_execs"] == 1, st
for s in servers:
    s.stop()
"""


def test_selection_order_and_the_host_engine():
    _port(ORDER_CHILD)
