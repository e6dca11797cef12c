"""The port's fleet drills (tbus_torch.fleet_drill, fleet_roll,
link_redial, fleet_node_run) against the JAX package's (tbus.rpc).

Both packages reach the shared core's supervisor (cpp/rpc/fleet.cc). Every
drill forks and execs the port's own node (tbus_torch.rpc.FLEET_NODE, which
imports tbus_torch and never tbus), the reference's supervisor too: the
reference's node arms its metrics exporter on its first timer, which the
core's timer thread can lose. Every drill and roll runs in a child process
in a new session, under its own deadline: on expiry the child's whole
process group (the supervisor and its nodes) is killed and the test fails
with the child's stderr, and after every child the test checks that no
process of its group outlived it. The drill's and the roll's invariants are
tests/test_fleet.py's own: its smoke tests run with their tbus replaced by
the port's drills.

The live redial runs in this process against a port device server in a
child (device_init("cpu"): Xor goes through K4's plain version), with
calls streaming from a thread while tbus_shm_lanes changes.
"""

import ast
import inspect
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import tbus.rpc as ref
import tbus_torch as tt
import tbus_torch.parallel
import tbus_torch.rpc as port
import test_fleet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90

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

# One drill or roll in a child, on the port's nodes: the report on one line.
_DRILL_CHILD = r"""
import json, sys
sys.path.insert(0, %(root)r)
import %(package)s as t
%(prelude)s
r = t.%(fn)s(%(argv)r, **%(kwargs)r)
print("REPORT " + json.dumps(r), flush=True)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in %(foreign)r)
assert not leaked, leaked
"""
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
# What a child of each side must not have imported.
_FOREIGN = {"tbus_torch": ("jax", "tbus"), "tbus": ("tbus_torch",)}


def _group_alive(pgid):
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


class _Drill:
    """A drill or roll running in a child process, in its own session."""

    def __init__(self, package, fn, *, prelude="", **kwargs):
        # Any build of the core in progress is waited out here, before the
        # deadline runs, and the child loads the core this process loaded
        # (TBUS_LIB): the reference's loader would build beside another
        # build, or open a half-written core (ROADMAP C).
        argv = port.fleet_node_argv()
        source = _DRILL_CHILD % {"root": ROOT, "package": package, "fn": fn,
                                 "prelude": prelude, "argv": argv,
                                 "kwargs": kwargs,
                                 "foreign": _FOREIGN[package]}
        self.what = f"{package}.{fn}({kwargs})"
        self.proc = subprocess.Popen(
            [sys.executable, "-c", source], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True,
            env=dict(os.environ, TBUS_LIB=port._native.lib()._name))
        self.deadline = time.monotonic() + DEADLINE_S

    def report(self):
        """The child's report; fails the test at the deadline (the whole
        group killed) or when a process of its group outlives it."""
        try:
            out, err = self.proc.communicate(
                timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            _, err = self.proc.communicate()
            raise AssertionError(f"{self.what}: no report in {DEADLINE_S} "
                                 f"s; stderr: {err[-4000:]}")
        finally:
            leftover = time.monotonic() + 10
            while _group_alive(self.proc.pid) and time.monotonic() < leftover:
                time.sleep(0.1)
            outlived = _group_alive(self.proc.pid)
            if outlived:
                os.killpg(self.proc.pid, signal.SIGKILL)
        assert not outlived, f"{self.what}: a node outlived its drill"
        lines = [x for x in out.splitlines() if x.startswith("REPORT ")]
        assert self.proc.returncode == 0 and len(lines) == 1, (
            f"{self.what}: exit {self.proc.returncode}; stderr: "
            f"{err[-4000:]}")
        return json.loads(lines[0][len("REPORT "):])


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
    replaced by the port's, each run in a child on the port's nodes after
    `prelude`."""
    monkeypatch.setattr(test_fleet, "tbus", types.SimpleNamespace(**{
        fn: lambda _argv, fn=fn, **kwargs: _Drill(
            "tbus_torch", fn, prelude=prelude, **kwargs).report()
        for fn in ("fleet_drill", "fleet_roll")}))


def test_fleet_drill_smoke(monkeypatch):
    """tests/test_fleet.py's test_fleet_drill_smoke on the port's
    supervisor and the port's nodes: 4 nodes, 700 ms, seed 7."""
    _port_drills(monkeypatch)
    test_fleet.test_fleet_drill_smoke(None)


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
    drills = [_Drill(package, "fleet_drill", nodes=4, phase_ms=400,
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
    _port_drills(monkeypatch)
    test_fleet.test_fleet_rolling_upgrade_smoke(None)


@pytest.mark.parametrize("reference_test", [
    "test_fleet_drill_smoke", "test_fleet_rolling_upgrade_smoke"])
def test_drills_outlast_sigprof(monkeypatch, reference_test):
    """tests/test_fleet.py's smoke tests with a SIGPROF every 50 ms at
    the thread in the port's drill: every phase still carries calls (the
    core ends a phase at once when a signal reaches that thread)."""
    _port_drills(monkeypatch, prelude=_SIGPROF_STORM)
    getattr(test_fleet, reference_test)(None)


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
