"""The port's fleet drills (tbus_torch.fleet_drill, fleet_roll,
link_redial, fleet_node_run) against the JAX package's (tbus.rpc).

Both packages reach the shared core's supervisor (cpp/rpc/fleet.cc). Every
drill forks and execs the port's own node (tbus_torch.rpc.FLEET_NODE, which
imports tbus_torch and never tbus), the reference's supervisor too: the
reference's node arms its metrics exporter on its first timer, which the
core's timer thread can lose. Every drill and roll runs in a child process
in a new session, under a deadline (tests/_drills.py). The drill's and the
roll's invariants are tests/test_fleet.py's own: its smoke tests run with
their tbus replaced by the port's drills.

The live redial runs in this process against a port device server in a
child (device_init("cpu"): Xor goes through K4's plain version), with
calls streaming from a thread while tbus_shm_lanes changes.
"""

import ast
import inspect
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import tbus.rpc as ref
import tbus_torch as tt
import tbus_torch.parallel
import tbus_torch.rpc as port
import test_fleet
from _drills import DEADLINE_S, ROOT, Drill, in_children

FUNCTIONS = [("fleet_node_run", "fleet_node_run"),
             ("fleet_drill", "fleet_drill"),
             ("link_redial", "link_redial"),
             ("fleet_roll", "fleet_roll"),
             ("device_registered_regions", "pjrt_registered_regions")]

# The port's names for the reference's JAX- and PJRT-named ones; every
# other public name of tbus/ has a counterpart of the same name.
RENAMES = {
    "enable_jax_fanout": "enable_torch_fanout",
    "jax_lowered_calls": "torch_lowered_calls",
    "pjrt_available": "device_available",
    "pjrt_dma_stats": "device_dma_stats",
    "pjrt_enable_dma": "device_enable_dma",
    "pjrt_init": "device_init",
    "pjrt_registered_regions": "device_registered_regions",
    "pjrt_stats": "device_stats",
}

# A prelude: a SIGPROF every 50 ms at the thread that runs the drill, the
# signal of the core's CPU profiler, which the drill's own SLO leg starts.
_SIGPROF_STORM = r"""
import signal, threading, time
signal.signal(signal.SIGPROF, lambda *_: None)
_drilling = threading.get_ident()
def _storm():
    while True:
        signal.pthread_kill(_drilling, signal.SIGPROF)
        time.sleep(0.05)
threading.Thread(target=_storm, daemon=True).start()
"""


@pytest.mark.parametrize("name,ref_name", FUNCTIONS)
def test_function_signature_and_export(name, ref_name):
    assert (inspect.signature(getattr(port, name))
            == inspect.signature(getattr(ref, ref_name)))
    assert getattr(tt, name) is getattr(port, name)


def _public_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for a in node.names if not a.name.startswith("_"))


@pytest.mark.parametrize("init,mine", [
    ("tbus/__init__.py", tt),
    ("tbus/parallel/__init__.py", tbus_torch.parallel)], ids=["tbus",
                                                           "parallel"])
def test_every_public_name_has_a_counterpart(init, mine):
    names = _public_imports(os.path.join(ROOT, init))
    assert names
    missing = [n for n in names if not hasattr(mine, RENAMES.get(n, n))]
    assert missing == []
    if init == "tbus/__init__.py":  # the map holds no stale entry
        assert set(RENAMES) <= set(names)


def _port_drills(monkeypatch, prelude=""):
    """tests/test_fleet.py with its tbus.fleet_drill and tbus.fleet_roll
    replaced by the port's, each run in a child on the port's core after
    `prelude`; its tests are then called with the port's nodes
    (fleet_node_argv) as their fleet_env. fleet_node_argv builds or loads
    the core before any deadline runs, waiting out any build in progress,
    so the child builds nothing (ROADMAP C2)."""
    argv = port.fleet_node_argv()
    monkeypatch.setattr(test_fleet, "tbus", in_children(
        "tbus_torch", port._native.lib()._name, prelude))
    return argv


def test_fleet_drill_smoke(monkeypatch):
    """tests/test_fleet.py's test_fleet_drill_smoke on the port's
    supervisor and the port's nodes: 4 nodes, 700 ms, seed 7."""
    test_fleet.test_fleet_drill_smoke(_port_drills(monkeypatch))


def _keys(r):
    """The report's keys at every level _check_invariants reads."""
    return {
        "report": sorted(r), "ledger": sorted(r["ledger"]),
        "kinds": {k: sorted(v) for k, v in r["ledger"]["kinds"].items()},
        "phases": [(p["name"], sorted(p)) for p in r["phases"]],
        "rebalance_ms": sorted(r["rebalance_ms"]),
        "reshard": sorted(r["reshard"]), "plan": sorted(r["plan"])}


def test_fleet_drill_plan_equals_the_references():
    """The chaos plan is a pure function of the seed in both packages: the
    port's plan at seed 99 is the reference supervisor's (tbus.fleet_drill,
    on the port's nodes), seed 100's differs, and the reports carry the
    same keys."""
    argv, lib = port.fleet_node_argv(), port._native.lib()._name
    drills = [Drill(package, "fleet_drill", argv, lib, nodes=4, phase_ms=400,
                    seed=seed)
              for package, seed in (("tbus_torch", 99), ("tbus", 99),
                                    ("tbus_torch", 100))]
    r1, r_ref, r3 = [d.report() for d in drills]
    assert r1["plan"] == r_ref["plan"]
    assert (r3["plan"]["kill"], r3["plan"]["hang"]) != \
        (r1["plan"]["kill"], r1["plan"]["hang"]) or \
        r3["plan"]["reshard_to"] != r1["plan"]["reshard_to"]
    assert _keys(r1) == _keys(r_ref)


def test_fleet_rolling_upgrade_smoke(monkeypatch):
    """tests/test_fleet.py's test_fleet_rolling_upgrade_smoke on the
    port's supervisor and nodes: 3 nodes drained, respawned with skewed
    capability flags and republished in sequence, zero lost and zero
    failed calls."""
    test_fleet.test_fleet_rolling_upgrade_smoke(_port_drills(monkeypatch))


@pytest.mark.parametrize("reference_test", [
    "test_fleet_drill_smoke", "test_fleet_rolling_upgrade_smoke"])
def test_drills_outlast_sigprof(monkeypatch, reference_test):
    """tests/test_fleet.py's smoke tests with a SIGPROF every 50 ms at
    the thread in the port's drill: every phase still carries calls (the
    core ends a phase at once when a signal reaches that thread)."""
    getattr(test_fleet, reference_test)(
        _port_drills(monkeypatch, prelude=_SIGPROF_STORM))


# ---- the live redial ----

_SERVER_CHILD = r"""
import sys
sys.path.insert(0, %(root)r)
import tbus_torch as t
t.device_init("cpu")
s = t.Server()
s.add_device_method("DevService", "Xor", "xor255")
print(s.start(0), flush=True)
sys.stdin.read()  # serves until the test closes stdin
s.stop()
"""


@pytest.fixture
def device_server():
    """A port device server in a child, advertising the most lanes, so
    this process's flags alone decide what a redial negotiates."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVER_CHILD % {"root": ROOT}],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, TBUS_SHM_LANES="4", TBUS_FANOUT_MESH="host"))
    try:
        line = proc.stdout.readline()
        assert line.strip().isdigit(), f"server child: {line!r}"
        yield f"tpu://127.0.0.1:{int(line)}"
    finally:
        proc.stdin.close()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


@pytest.fixture
def restored_flags():
    """Every tunable flag set back, the walker it starts left settled."""
    before = {d["name"]: d["value"] for d in port.flag_domains()}
    yield before
    for name, value in before.items():
        port.flag_set(name, value)
    time.sleep(0.2)
    port.wait_redials_settled()


def test_link_redial_under_traffic(device_server, restored_flags):
    """A lane change and link_redial(2000) on a live cross-process tpu://
    link while Xor calls stream from a thread: at least one link
    renegotiated, the new lane count on the link, every call answered
    byte-equal to K4's plain version."""
    ch = port.Channel(device_server, timeout_ms=10000)
    body = np.random.default_rng(7).integers(0, 256, 4096,
                                             dtype=np.uint8).tobytes()
    truth = (np.frombuffer(body, np.uint8) ^ 255).tobytes()
    assert ch.call("DevService", "Xor", body) == truth
    links = port.shm_links()
    assert links, "no cross-process tpu:// link after a call"
    target = 4 if links[0]["lanes"] != 4 else 2
    stats = {"ok": 0, "bad": 0, "failed": 0}
    stop = threading.Event()

    def stream():
        while not stop.is_set():
            try:
                good = ch.call("DevService", "Xor", body) == truth
            except port.RpcError:
                stats["failed"] += 1
            else:
                stats["ok" if good else "bad"] += 1

    streamer = threading.Thread(target=stream)
    streamer.start()
    try:
        time.sleep(0.3)
        before = port.redial_counters()
        port.flag_set("tbus_shm_lanes", target)
        port.wait_redials_settled(before)
        ok_before = stats["ok"]
        renegotiated = port.link_redial(2000)
        time.sleep(0.3)
        ok_after = stats["ok"]
    finally:
        stop.set()
        streamer.join(timeout=30)
    assert not streamer.is_alive()
    assert renegotiated >= 1
    assert ok_after > ok_before  # calls flowed across the redial
    assert stats["failed"] == 0 and stats["bad"] == 0, stats
    assert {link["lanes"] for link in port.shm_links()} == {target}
    assert ch.call("DevService", "Xor", body) == truth


def test_link_redial_without_links_is_zero():
    """A process with no live cross-process tpu:// link renegotiates
    nothing."""
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r); "
         "import tbus_torch as t; t.init(); print(t.link_redial(2000))"
         % ROOT], capture_output=True, text=True, timeout=DEADLINE_S)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split() == ["0"]
