"""The drill helper (tests/_drills.py) on stand-in children: a child that
never reports fails its test at the deadline with its stderr and leaves no
process of its group alive; a child that reports once passes; a child that
fails, leaves a process behind or imports the other side fails the test.

The children import tbus_torch (no torch, no core loaded) and replace its
fleet_drill and fleet_roll in the prelude, so nothing here drills.
"""

import time

import pytest

from _drills import Drill, group_alive, in_children

# Stand-in drills: which was called, with what, on which core.
_FAKE = r"""
import os
def _fake(fn):
    return lambda argv, **kwargs: {"fn": fn, "argv": argv, "kwargs": kwargs,
                                   "lib": os.environ.get("TBUS_LIB")}
t.fleet_drill, t.fleet_roll = _fake("fleet_drill"), _fake("fleet_roll")
"""
# A child that never reports, with a grandchild in its group.
_ASLEEP = r"""
import subprocess, sys, time
subprocess.Popen([sys.executable, "-c", "import time; time.sleep(3600)"])
print("asleep", file=sys.stderr, flush=True)
time.sleep(3600)
"""
# A stand-in drill that leaves a process of its group running.
_LEAVES_ONE = _FAKE + r"""
import subprocess, sys
subprocess.Popen([sys.executable, "-c", "import time; time.sleep(3600)"],
                 stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
"""
LIB = "/no/libtbus.so"


def _gone(pgid, within_s=5):
    """Whether the group is gone, waiting a little for the reaper."""
    end = time.monotonic() + within_s
    while group_alive(pgid) and time.monotonic() < end:
        time.sleep(0.05)
    return not group_alive(pgid)


def test_a_child_that_never_reports_fails_at_its_deadline():
    start = time.monotonic()
    drill = Drill("tbus_torch", "fleet_drill", ["node"], LIB,
                  prelude=_ASLEEP, deadline=2, nodes=4)
    with pytest.raises(AssertionError) as failed:
        drill.report()
    assert time.monotonic() - start < 2 + 10
    message = str(failed.value)
    assert "tbus_torch.fleet_drill({'nodes': 4}): no report in 2 s" \
        in message
    assert "asleep" in message  # the child's stderr
    assert _gone(drill.proc.pid)


def test_a_child_that_reports_once_passes():
    drill = Drill("tbus_torch", "fleet_roll", ["node", "-c", "x"], LIB,
                  prelude=_FAKE, deadline=60, nodes=3, phase_ms=400)
    assert drill.report() == {"fn": "fleet_roll", "argv": ["node", "-c", "x"],
                              "kwargs": {"nodes": 3, "phase_ms": 400},
                              "lib": LIB}
    assert drill.proc.returncode == 0
    assert not group_alive(drill.proc.pid)


def test_a_process_that_outlives_its_drill_fails_the_test():
    drill = Drill("tbus_torch", "fleet_drill", [], LIB, prelude=_LEAVES_ONE)
    with pytest.raises(AssertionError, match="a node outlived its drill"):
        drill.report()
    assert _gone(drill.proc.pid)


def test_a_child_that_fails_fails_with_its_stderr():
    drill = Drill("tbus_torch", "fleet_drill", [], LIB, prelude=_FAKE
                  + "t.fleet_drill = lambda *a, **k: 1 / 0\n")
    with pytest.raises(AssertionError, match=r"(?s)exit 1; stderr: .*"
                       r"ZeroDivisionError"):
        drill.report()


@pytest.mark.parametrize("other", ["tbus", "jax"])
def test_a_port_child_that_imports_the_other_side_fails(other):
    # A stand-in module of that name, so that the child imports nothing
    # heavy.
    prelude = (_FAKE + f"sys.modules[{other + '.stub'!r}] = "
               f"type(sys)({other!r})\n")
    drill = Drill("tbus_torch", "fleet_drill", [], LIB, prelude=prelude)
    with pytest.raises(AssertionError,
                       match=f"(?s)exit 1; stderr: .*{other}"):
        drill.report()


@pytest.mark.parametrize("fn", ["fleet_drill", "fleet_roll"])
def test_in_children_runs_each_call_as_its_drill(fn):
    drills = in_children("tbus_torch", "/core.so", _FAKE)
    report = getattr(drills, fn)(["n"], nodes=3, seed=7)
    assert report == {"fn": fn, "argv": ["n"],
                      "kwargs": {"nodes": 3, "seed": 7}, "lib": "/core.so"}
