"""Live ParallelChannel lowering through the port's torch fan-out backend.

Twins of the JAX backend's tests in test_collectives.py: lowering equals
p2p byte for byte, a mismatched peer forces p2p, a restarted peer's stale
advert stops lowering, the deadline fails the call and not the worker,
and queued calls fuse into one execution.

The collective fan-out backend is one global per process, so every test
runs in a child process (as MISMATCH_CHILD does in test_collectives.py):
installing the torch backend in a pytest worker would reroute later JAX
tests in that worker. The children run the host kind (the CPU, through
the kernel's plain version), and each ends by asserting that neither jax
nor the JAX package was imported.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import os, sys, time
sys.path.insert(0, %(root)r)
import tbus_torch as tt
from tbus_torch.parallel import runtime
"""

_EPILOGUE = r"""
leaked = sorted(m for m in sys.modules
                if m in ("jax", "tbus") or m.startswith(("jax.", "tbus.")))
assert not leaked, leaked
print("CHILD-OK", flush=True)
"""


def _run_child(body, timeout=90):
    env = dict(os.environ, TBUS_FANOUT_MESH="host")
    proc = subprocess.run(
        [sys.executable, "-c",
         _PRELUDE % {"root": ROOT} + body + _EPILOGUE],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])


LOWERS_CHILD = r"""
tt.init()
tt.advertise_device_method("EchoService", "Echo", "echo/v1")
tt.advertise_device_method("EchoService", "Xor", "xor255/v1")
tt.advertise_device_method("EchoService", "Add", "add_peer_index/v1")
servers = []
pchan = tt.ParallelChannel()
n = 8
for i in range(n):
    s = tt.Server()
    s.add_echo()
    s.add_method("EchoService", "Xor", tt.builtin_handler("xor255"))
    s.add_method("EchoService", "Add",
                 tt.builtin_handler("add_peer_index", i))
    servers.append(s)
    pchan.add(f"tpu://127.0.0.1:{s.start(0)}")
assert pchan.collective_eligible
payload = b"pchan-collective-bytes"
p2p = pchan.call("EchoService", "Echo", payload)
assert p2p == payload * n
assert tt.enable_torch_fanout()
# Enabling alone must NOT reroute: only registered device methods lower.
before = tt.torch_lowered_calls()
assert pchan.call("EchoService", "Echo", payload) == p2p
assert tt.torch_lowered_calls() == before
assert tt.register_device_echo("EchoService", "Echo")
assert pchan.call("EchoService", "Echo", payload) == p2p
assert tt.torch_lowered_calls() > before
big = os.urandom(1 << 20)
p2p_big = pchan.call("EchoService", "Echo", big, 30000)
assert tt.torch_lowered_calls() > before + 1
assert p2p_big == big * n
# Non-identity builtins: lowered == p2p byte for byte.
for method, builtin in (("Xor", "xor255"), ("Add", "add_peer_index")):
    body = os.urandom(4096)
    want = pchan.call("EchoService", method, body)
    before = tt.torch_lowered_calls()
    assert tt.register_device_method("EchoService", method, builtin,
                                     builtin + "/v1")
    assert pchan.call("EchoService", method, body) == want
    assert tt.torch_lowered_calls() > before
    assert runtime.lowered_calls == tt.torch_lowered_calls()
assert not tt.register_device_method("EchoService", "Nope", "nope", "v1")
for s in servers:
    s.stop()
"""


def test_parallel_channel_lowers_through_torch_backend():
    _run_child(LOWERS_CHILD)


MISMATCH_CHILD = r"""
import subprocess
peer = subprocess.Popen([sys.executable, "-c", '''
import sys, time
sys.path.insert(0, %(root)r)
import tbus_torch as tt
tt.init()
tt.advertise_device_method("EchoService", "Echo", "other-impl/v9")
s = tt.Server()
s.add_echo()
print(s.start(0), flush=True)
time.sleep(120)
'''], stdout=subprocess.PIPE, text=True)
try:
    peer_port = int(peer.stdout.readline())
    tt.init()
    tt.advertise_device_method("EchoService", "Echo", "echo/v1")
    assert tt.enable_torch_fanout()
    assert tt.register_device_echo("EchoService", "Echo")
    local = tt.Server()
    local.add_echo()
    pchan = tt.ParallelChannel()
    pchan.add(f"tpu://127.0.0.1:{local.start(0)}")
    pchan.add(f"tpu://127.0.0.1:{peer_port}")
    before = tt.torch_lowered_calls()
    # Right either way (both servers echo), but NOT from the lowered path.
    assert pchan.call("EchoService", "Echo", b"mismatch-guard") == (
        b"mismatch-guard" * 2)
    assert tt.torch_lowered_calls() == before
    assert runtime.lowered_calls == 0
    local.stop()
finally:
    peer.kill()
    peer.wait()
"""


def test_mismatched_peer_forces_p2p():
    _run_child(MISMATCH_CHILD % {"root": ROOT})


DEADLINE_CHILD = r"""
tt.init()
tt.advertise_device_method("SlowSvc", "Echo", "echo/v1")
servers = []
pchan = tt.ParallelChannel()
for _ in range(2):
    s = tt.Server()
    s.add_method("SlowSvc", "Echo", lambda b: b)
    s.add_echo()
    port = s.start(0)
    servers.append(s)
    pchan.add(f"tpu://127.0.0.1:{port}")
assert tt.enable_torch_fanout()
assert tt.register_device_method("SlowSvc", "Echo", "echo", "echo/v1")
# The first call dials the peers (their adverts ride the handshake); the
# second lowers, so the delayed call below meets the torch backend.
for _ in range(2):
    assert pchan.call("SlowSvc", "Echo", b"warm") == b"warm" * 2
assert tt.torch_lowered_calls() == 1
runtime._test_delay_ms = 1500
t0 = time.monotonic()
try:
    pchan.call("SlowSvc", "Echo", b"payload", 200)
    raise AssertionError("a wedged backend must fail the call")
except tt.RpcError:
    pass
elapsed = time.monotonic() - t0
assert elapsed < 1.2, f"deadline ignored: took {elapsed:.2f}s"
# The scheduler is healthy while the abandoned job still runs.
ch = tt.Channel(f"tpu://127.0.0.1:{port}", timeout_ms=3000)
assert ch.call("EchoService", "Echo", b"alive") == b"alive"
runtime._test_delay_ms = 0
for s in servers:
    s.stop()
"""


def test_lowered_deadline_fails_call_not_worker():
    _run_child(DEADLINE_CHILD)


BATCH_CHILD = r"""
tt.init()
import concurrent.futures
tt.advertise_device_method("EchoService", "Echo", "echo/v1")
servers = []
pchan = tt.ParallelChannel()
n = 8
for _ in range(n):
    s = tt.Server()
    s.add_echo()
    servers.append(s)
    pchan.add(f"tpu://127.0.0.1:{s.start(0)}")
assert tt.enable_torch_fanout()
assert tt.register_device_echo("EchoService", "Echo")
assert pchan.call("EchoService", "Echo", b"warm") == b"warm" * n
# Stall the executor so concurrent calls pile into its queue; the drain
# then fuses them.
runtime._test_delay_ms = 300
payloads = [b"batched-%%02d" %% i for i in range(8)]
before = tt.torch_lowered_calls()
launches_before = runtime.batch_launches
with concurrent.futures.ThreadPoolExecutor(8) as ex:
    results = list(ex.map(
        lambda p: pchan.call("EchoService", "Echo", p, 60000), payloads))
for p, r in zip(payloads, results):
    assert r == p * n, (p, r[:64])
assert tt.torch_lowered_calls() - before == len(payloads)
assert runtime.batch_launches > launches_before
runtime._test_delay_ms = 0
for s in servers:
    s.stop()
"""


def test_concurrent_fanouts_batch_into_one_execution():
    _run_child(BATCH_CHILD % {})


SYNC_CHILD = r"""
from tbus_torch import _native
# Registered while the C++ core is not loaded: the runtime's table only.
runtime.register_builtin("EchoService", "Echo", "echo", "echo/v1")
assert _native.loaded() is None
tt.init()
tt.advertise_device_method("EchoService", "Echo", "echo/v1")
servers = []
pchan = tt.ParallelChannel()
for _ in range(2):
    s = tt.Server()
    s.add_echo()
    servers.append(s)
    pchan.add(f"tpu://127.0.0.1:{s.start(0)}")
assert pchan.call("EchoService", "Echo", b"dial") == b"dial" * 2
# Enabling mirrors the earlier registration into the C++ lowering check.
assert tt.enable_torch_fanout()
assert pchan.call("EchoService", "Echo", b"synced") == b"synced" * 2
assert tt.torch_lowered_calls() == 1
for s in servers:
    s.stop()
"""


def test_registration_before_core_loads_lowers_after_enable():
    _run_child(SYNC_CHILD)


RESTART_CHILD = r"""
import subprocess
PEER = '''
import sys, time
sys.path.insert(0, %(root)r)
import tbus_torch as tt
tt.init()
tt.advertise_device_method("EchoService", "Echo", %%r)
s = tt.Server()
s.add_echo()
print(s.start(%%d), flush=True)
time.sleep(120)
'''


def spawn(impl, port=0):
    child = subprocess.Popen([sys.executable, "-c", PEER %% (impl, port)],
                             stdout=subprocess.PIPE, text=True)
    return child, int(child.stdout.readline())


tt.init()
tt.advertise_device_method("EchoService", "Echo", "echo/v1")
assert tt.enable_torch_fanout()
assert tt.register_device_echo("EchoService", "Echo")
child, port = spawn("echo/v1")
try:
    local = tt.Server()
    local.add_echo()
    pchan = tt.ParallelChannel()
    pchan.add(f"tpu://127.0.0.1:{local.start(0)}")
    pchan.add(f"tpu://127.0.0.1:{port}")
    payload = b"restart-guard"
    assert pchan.call("EchoService", "Echo", payload) == payload * 2
    before = tt.torch_lowered_calls()
    assert pchan.call("EchoService", "Echo", payload) == payload * 2
    assert tt.torch_lowered_calls() > before, "should lower (all match)"
    # The peer comes back on the same port running other code. Death is
    # observed asynchronously, so a call in the stale window may still
    # lower; the fan-out must converge to p2p and stay there.
    child.kill()
    child.wait()
    child, port2 = spawn("other-impl/v9", port)
    assert port2 == port
    deadline = time.monotonic() + 20
    converged = False
    while time.monotonic() < deadline:
        before = tt.torch_lowered_calls()
        try:
            r = pchan.call("EchoService", "Echo", payload, 2000)
        except tt.RpcError:
            time.sleep(0.2)  # redial window
            continue
        assert r == payload * 2
        if tt.torch_lowered_calls() == before:
            converged = True
            break
        time.sleep(0.2)
    assert converged, "fan-out never fell back to p2p after restart"
    before = tt.torch_lowered_calls()
    for _ in range(3):
        assert pchan.call("EchoService", "Echo", payload, 2000) == (
            payload * 2)
    assert tt.torch_lowered_calls() == before, (
        "re-lowered against a peer advertising a different impl")
    local.stop()
finally:
    child.kill()
    child.wait()
"""


def test_peer_restart_invalidates_adverts():
    _run_child(RESTART_CHILD % {"root": ROOT})
