"""The port's device runtime (tbus_torch/csrc/cuda_runtime.cc) and its two
server mounts, on the CPU backend.

The CPU backend runs the same programs as plain C++ loops and is brought
up only when asked (device_init("cpu")), as the reference's fake PJRT
device is. Held here, against the reference's rules (pjrt_runtime.cc,
serve_engine.cc):
- a bad dot128 length or dotbench name is refused with the reference's
  text (:215, :265);
- the queue bound (kMaxQueue 128) fails jobs with EOVERCROWDED;
- a caller past its deadline gets ERPCTIMEDOUT and its block is never
  written after that;
- generate streams are byte-exact against the documented rule (state =
  the prompt repeated to token_bytes, the transform once per step), with
  one plan per batch bucket, all steps on the runtime's engine;
- a generate mount without the runtime, or with an unknown transform,
  fails instead of serving from the host engine.

The runtime is one per process, so each test runs in a child, which ends
by asserting that neither jax nor the JAX package was imported.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import os, struct, sys, threading, time
sys.path.insert(0, %(root)r)
import numpy as np
import tbus_torch as tt
from tbus_torch import rpc
tt.init()
"""

_EPILOGUE = r"""
leaked = sorted(m for m in sys.modules
                if m in ("jax", "tbus") or m.startswith(("jax.", "tbus.")))
assert not leaked, leaked
print("CHILD-OK", flush=True)
"""


def _run_child(body, env=None, timeout=600):
    proc = subprocess.run(
        [sys.executable, "-c",
         _PRELUDE % {"root": ROOT} + body + _EPILOGUE],
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, **(env or {})))
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])


REFUSALS_CHILD = r"""
tt.device_init("cpu")
s = tt.Server()
for name in ("dot128", "dotbench64x2", "dotbench128x0", "dotbench16385x1",
             "dotbenchfoo", "dotbench128x2", "nope"):
    s.add_device_method("Dev", name, name)
ch = tt.Channel(f"127.0.0.1:{s.start(0)}", timeout_ms=30000)

def refusal(method, payload):
    try:
        ch.call("Dev", method, payload)
    except tt.RpcError as e:
        return e.code, e.text
    raise AssertionError(f"{method} answered {len(payload)} bytes")

# dot128 pads to the length class first: 100 -> 128, 600 -> 768.
for n, plen in ((0, 128), (100, 128), (600, 768)):
    assert refusal("dot128", b"\0" * n) == (1003, (
        "dot128 needs a payload length that is a positive multiple of 512 "
        f"(f32[k,128] rows); got {plen}")), n
for name in ("dotbench64x2", "dotbench128x0", "dotbench16385x1",
             "dotbenchfoo"):
    assert refusal(name, b"\0" * 4) == (1003, (
        "dotbench wants dotbench<N>x<T>, 128<=N<=16384, 1<=T<=256; got "
        + name)), name
assert refusal("dotbench128x2", b"\0" * 5) == (
    1003, "dotbench takes a 4-byte f32 seed payload; got length 5")
assert refusal("nope", b"x") == (1003, "unknown transform nope")
# Accepted lengths still serve: 1000 bytes pad to 1024 = two f32 rows.
assert len(ch.call("Dev", "dot128", b"\0" * 1000)) == 1000
st = rpc.device_stats()
assert st["platform"] == "cpu" and st["errors"] == 9, st
assert st["launches"] == {"u8_transform": 0, "dot128": 0, "dotbench": 0,
                         "fanout": 0}
s.stop()
"""


def test_bad_programs_are_refused_with_the_reference_text():
    _run_child(REFUSALS_CHILD)


LIFETIME_CHILD = r"""
tt.device_init("cpu")
B = rpc._device_bridge()
import ctypes
# Every execution takes 20 ms: one job runs, 128 wait, the rest bounce
# (a few more may fit if the dispatch thread finishes jobs meanwhile).
os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "20000"
n = 200
rcs = (ctypes.c_int * n)()
assert B.tbus_torch_device_burst(b"echo", 256, n, rcs) == 0
rcs = list(rcs)
over = rcs.count(1011)  # EOVERCROWDED
assert over + rcs.count(0) == n, rcs
assert rcs[:128] == [0] * 128 and over >= 1, (rcs.count(0), over)
assert rpc.device_stats()["overcrowded"] == over

# Deadline: the job takes 300 ms, the caller waits 30; the caller's block
# must not be written after ERPCTIMEDOUT.
os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "300000"
data = bytes(range(256)) * 16
out = ctypes.create_string_buffer(b"\xaa" * len(data), len(data))
got = ctypes.c_longlong(-1)
rc = B.tbus_torch_device_run_mode(b"xor255", data, len(data), 1, 1, out,
                                  len(data), 30, ctypes.byref(got))
assert rc == 1008, rc  # ERPCTIMEDOUT
time.sleep(0.6)  # the abandoned job has finished by now
assert out.raw == b"\xaa" * len(data)
os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "0"
rc = B.tbus_torch_device_run_mode(b"xor255", data, len(data), 1, 1, out,
                                  len(data), 5000, ctypes.byref(got))
assert rc == 0 and got.value == len(data)
assert out.raw == bytes(b ^ 0xFF for b in data)
"""


def test_queue_bound_and_deadline_abandonment():
    _run_child(LIFETIME_CHILD)


GENERATE_CHILD = r"""
tt.device_init("cpu")
s = tt.Server()
for tf, method in (("echo", "GenEcho"), ("xor255", "GenXor"),
                   ("incr", "GenIncr")):
    s.add_generate_method("GenService", method, tf, max_batch=8,
                          token_bytes=128)
port = s.start(0)

def truth(tf, prompt, ntokens):
    state = np.frombuffer((prompt * 128)[:128], dtype=np.uint8)
    out = []
    for _ in range(ntokens):
        if tf == "xor255":
            state = state ^ 0xFF
        elif tf == "incr":
            state = state + np.uint8(1)
        out.append(state.tobytes())
    return out

errors = []

def one(tf, method, i):
    try:
        ch = tt.Channel(f"127.0.0.1:{port}", timeout_ms=30000)
        prompt = f"p{i}-{tf}".encode()
        ntokens = 5 + 3 * i
        req = struct.pack("<I", ntokens) + prompt
        with tt.Stream.create(ch, "GenService", method, req) as st:
            for k, want in enumerate(truth(tf, prompt, ntokens)):
                assert st.read(timeout_ms=30000) == want, (tf, i, k)
            assert st.read(timeout_ms=30000) is None  # a clean end
    except Exception as e:
        errors.append(e)

mounts = (("echo", "GenEcho"), ("xor255", "GenXor"), ("incr", "GenIncr"))
threads = [threading.Thread(target=one, args=(tf, m, i))
           for tf, m in mounts for i in range(3)]
for th in threads:
    th.start()
for th in threads:
    th.join()
assert not errors, errors
stats = {st["name"]: st for st in tt.serve_stats()}
misses = 0
for tf, method in mounts:
    st = stats[f"GenService.{method}"]
    # Every step ran on the runtime's engine; one plan per batch bucket
    # (1, 2 or 4 rows for 3 streams), every later step at it a hit.
    assert st["engine"] == "cpu" and st["engine_failures"] == 0, st
    assert st["engine_steps"] == st["steps"] > 0, st
    assert st["completed"] == 3 and st["tokens"] == 5 + 8 + 11, st
    assert 1 <= st["plan_misses"] <= 3, st
    assert st["plan_hits"] + st["plan_misses"] == st["steps"], st
    misses += st["plan_misses"]
# The runtime made exactly one plan per (transform, bucket) key.
assert rpc.device_stats()["plans"] == misses
# A streamless generate is refused (tokens need somewhere to go).
try:
    tt.Channel(f"127.0.0.1:{port}").call(
        "GenService", "GenIncr", struct.pack("<I", 2) + b"x")
    raise AssertionError("a streamless generate was served")
except tt.RpcError:
    pass
r = tt.bench_serve(f"127.0.0.1:{port}", "GenService", "GenIncr",
                   concurrency=2, duration_ms=300, ntokens=4,
                   token_bytes=128)
assert r["ok"] > 0 and r["other"] == 0 and r["token_qps"] > 0, r
s.stop()
"""


def test_generate_streams_are_byte_exact_with_bucket_plans():
    _run_child(GENERATE_CHILD)


NO_RUNTIME_CHILD = r"""
s = tt.Server()
assert not rpc.device_available()
# No runtime: the generate mount fails; nothing serves from the host.
try:
    s.add_generate_method("GenService", "Generate", "incr")
    raise AssertionError("mounted without a device runtime")
except RuntimeError:
    pass
# A device method mounts (the runtime is needed once a request arrives)
# and fails its calls until then.
s.add_device_method("Dev", "Echo", "echo")
port = s.start(0)
try:
    tt.Channel(f"127.0.0.1:{port}").call("Dev", "Echo", b"abc")
    raise AssertionError("served without a device runtime")
except tt.RpcError as e:
    assert e.code == 2001 and "not initialized" in e.text, e
# "cuda" raises here (no nvcc, or no card); "cpu" then comes up, and the
# runtime refuses to switch devices afterwards.
try:
    tt.device_init("cuda")
    raise AssertionError("device_init('cuda') came up without a card")
except RuntimeError:
    pass
assert not rpc.device_available()
tt.device_init("cpu")
assert rpc.device_available()
assert tt.Channel(f"127.0.0.1:{port}").call("Dev", "Echo", b"abc") == b"abc"
s2 = tt.Server()
try:
    s2.add_generate_method("GenService", "Bogus", "bogus")
    raise AssertionError("mounted an unknown transform")
except RuntimeError:
    pass
assert [st["name"] for st in tt.serve_stats()] == []
s.stop()
"""


def test_mounts_fail_without_runtime_and_never_fall_back():
    _run_child(NO_RUNTIME_CHILD)
