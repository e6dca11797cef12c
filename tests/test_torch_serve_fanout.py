"""Tensor-parallel serving on the port (Server.add_generate_method with
peers): a twin of cpp/tests/serve_batch_test.cc:474-505, held against the
reference's own FanoutStepEngine on the same prompt.

A generate mount whose peers are two shard servers runs every fused step
as one ScatterGather through the C++ fan-out engine (K7 on the CPU
backend here): the tokens are the xor255 rule's byte for byte, shard
boundaries invisible, and collective_steps counts each step. A mount
over a peer that never advertised cannot lower: its steps are repaired
on this device's single-card step engine (K4), counted in
fallback_steps, with the same bytes.

The reference runs the same mounts in a child of tbus on its fake PJRT
device (TBUS_PJRT_FAKE=1, TBUS_FANOUT_MESH=device, enable_native_fanout):
its token streams, its steps and its collective/fallback step counts
(tpu::fanout_step_stats, read through the core's exported symbol) must
equal the port's. The runtime and the collective backend are one per
process, so each side runs in a child; the port's ends by asserting that
neither jax nor the JAX package was imported.
"""

import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The shards, the mounts and the streams, the same for the port and the
# reference: `t` is the package, `step_stats()` its collective/fallback
# step counts. Prints the result as one RESULT line.
_SERVE = r"""
import json, struct, sys, time
TB = 128
# The shards: each advertises GenServiceShard.Generate under serve/v1 and
# answers p2p with the same transform (the divergence guard's twin).
t.advertise_device_method("GenServiceShard", "Generate", "serve/v1")
shards, ports = [], []
for _ in range(2):
    s = t.Server()
    s.add_method("GenServiceShard", "Generate", t.builtin_handler("xor255"))
    ports.append(s.start(0))
    shards.append(s)
adverts0 = t.native_fanout_stats()["advertised_peers"]
# The tpu:// handshakes carry the adverts; the links (and with them the
# adverts) live as long as these channels.
hs_chans = [t.Channel(f"tpu://127.0.0.1:{p}", timeout_ms=5000)
            for p in ports]
for ch in hs_chans:
    ch.call("GenServiceShard", "Generate", b"hs")
for _ in range(3000):
    if t.native_fanout_stats()["advertised_peers"] >= adverts0 + 2:
        break
    time.sleep(0.001)
assert t.native_fanout_stats()["advertised_peers"] >= adverts0 + 2
assert t.enable_native_fanout()
peers = ",".join(f"127.0.0.1:{p}" for p in ports)
gen = t.Server()
gen.add_generate_method("GenService", "Generate", "xor255", max_batch=4,
                        token_bytes=TB, peers=peers)
gen.add_generate_method("GenServiceNone", "Generate", "xor255", max_batch=4,
                        token_bytes=TB, peers="127.0.0.1:1")
port = gen.start(0)

def tokens(service, prompt, ntokens):
    ch = t.Channel(f"127.0.0.1:{port}", timeout_ms=30000)
    out = []
    with t.Stream.create(ch, service, "Generate",
                         struct.pack("<I", ntokens) + prompt) as st:
        for _ in range(ntokens):
            out.append(st.read(timeout_ms=30000))
        assert st.read(timeout_ms=30000) is None
    return out

prompt = bytes(ord("a") + i %% 23 for i in range(40))
st0 = step_stats()
lowered = tokens("GenService", prompt, 6)
st1 = step_stats()
# The repair: a peer that never advertised.
repaired = tokens("GenServiceNone", prompt, 3)
st2 = step_stats()
serve = {s["name"]: s for s in t.serve_stats()}
result = {
    "lowered": [x.hex() for x in lowered],
    "repaired": [x.hex() for x in repaired],
    "collective_steps": [st1[0] - st0[0], st2[0] - st1[0]],
    "fallback_steps": [st1[1] - st0[1], st2[1] - st1[1]],
    "steps": [serve[f"{m}.Generate"]["steps"]
              for m in ("GenService", "GenServiceNone")],
    "tokens": [serve[f"{m}.Generate"]["tokens"]
               for m in ("GenService", "GenServiceNone")],
}
print("RESULT " + json.dumps(result), flush=True)
gen.stop()
for s in shards:
    s.stop()
"""

PORT_CHILD = r"""
import sys
sys.path.insert(0, %(root)r)
import numpy as np
import tbus_torch as t
t.init()
t.device_init("cpu")

def step_stats():
    st = t.fanout_step_stats()
    return st["collective_steps"], st["fallback_steps"]
""" + _SERVE + r"""
def truth(prompt, ntokens):
    state = np.frombuffer((prompt * TB)[:TB], dtype=np.uint8)
    out = []
    for _ in range(ntokens):
        state = state ^ 0xFF
        out.append(state.tobytes())
    return out

assert lowered == truth(prompt, 6)
assert repaired == truth(prompt, 3)  # the same bytes, counted
assert serve["GenService.Generate"]["engine"] == "fanout"
assert result["steps"][0] == 6 and result["collective_steps"] == [6, 0], \
    result
assert result["fallback_steps"] == [0, 3], result
nf = t.native_fanout_stats()
assert nf["scatter_calls"] == 6 and nf["device_execs"] == 6, nf
assert t.device_stats()["executions"] == 6 + 3
leaked = sorted(m for m in sys.modules
                if m in ("jax", "tbus") or m.startswith(("jax.", "tbus.")))
assert not leaked, leaked
print("CHILD-OK", flush=True)
"""

REFERENCE_CHILD = r"""
import ctypes, sys
sys.path.insert(0, %(root)r)
import tbus as t
from tbus import _native
t.init()
assert t.pjrt_init()

class _StepStats(ctypes.Structure):  # tpu::FanoutStepStats
    _fields_ = [("collective_steps", ctypes.c_long),
                ("fallback_steps", ctypes.c_long)]

_fss = getattr(_native.lib(), "_ZN4tbus3tpu17fanout_step_statsEv")
_fss.restype = _StepStats
_fss.argtypes = []

def step_stats():
    st = _fss()
    return st.collective_steps, st.fallback_steps
""" + _SERVE + r"""
assert t.native_fanout_stats()["pjrt_execs"] >= 6
print("CHILD-OK", flush=True)
"""


def _run(source, env=None):
    proc = subprocess.run(
        [sys.executable, "-c", source % {"root": ROOT}], capture_output=True,
        text=True, timeout=180, env=dict(os.environ, **(env or {})))
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[0][len("RESULT "):])


@functools.lru_cache(maxsize=None)
def _port_result():
    return _run(PORT_CHILD)


def test_tensor_parallel_steps_lower_and_repair():
    res = _port_result()
    assert res["collective_steps"] == [6, 0]
    assert res["fallback_steps"] == [0, 3]


def test_tensor_parallel_serving_matches_the_reference():
    ref = _run(REFERENCE_CHILD, {"TBUS_PJRT_FAKE": "1",
                                 "TBUS_FANOUT_MESH": "device",
                                 "JAX_PLATFORMS": "cpu"})
    assert _port_result() == ref
