"""Fleet drills and rolls in child processes, each under a deadline.

The core's timer thread can lose a wakeup and leave a drill's supervisor
waiting forever (ROADMAP C1). So the port's fleet tests never run a drill
in their own process: the drill runs in a child in a new session, and at
the deadline the child's whole process group (the supervisor and its nodes)
is killed and the test fails with the child's stderr. After every child the
test checks that no process of its group outlived it. A hang then costs the
one test, never the run.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90

# One drill or roll in a child: the report on one line.
_CHILD = r"""
import json, sys
sys.path.insert(0, %(root)r)
import %(package)s as t
%(prelude)s
r = t.%(fn)s(%(argv)r, **%(kwargs)r)
print("REPORT " + json.dumps(r), flush=True)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in %(foreign)r)
assert not leaked, leaked
"""
# What a child of each side must not have imported.
_FOREIGN = {"tbus_torch": ("jax", "tbus"), "tbus": ("tbus_torch",)}


def group_alive(pgid):
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


class Drill:
    """`package`.`fn`(argv, **kwargs) running in a child process in its
    own session, on the core at `lib` (TBUS_LIB), after the source
    `prelude`."""

    def __init__(self, package, fn, argv, lib, *, prelude="",
                 deadline=DEADLINE_S, **kwargs):
        source = _CHILD % {"root": ROOT, "package": package, "fn": fn,
                           "prelude": prelude, "argv": argv,
                           "kwargs": kwargs, "foreign": _FOREIGN[package]}
        self.what = f"{package}.{fn}({kwargs})"
        self.proc = subprocess.Popen(
            [sys.executable, "-c", source], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True,
            env=dict(os.environ, TBUS_LIB=lib))
        self.deadline_s = deadline
        self.deadline = time.monotonic() + deadline

    def report(self):
        """The child's report; fails the test at the deadline (the whole
        group killed) or when a process of its group outlives it."""
        try:
            out, err = self.proc.communicate(
                timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            _, err = self.proc.communicate()
            raise AssertionError(f"{self.what}: no report in "
                                 f"{self.deadline_s} s; stderr: "
                                 f"{err[-4000:]}")
        finally:
            leftover = time.monotonic() + 10
            while (group_alive(self.proc.pid)
                   and time.monotonic() < leftover):
                time.sleep(0.1)
            outlived = group_alive(self.proc.pid)
            if outlived:
                os.killpg(self.proc.pid, signal.SIGKILL)
        assert not outlived, f"{self.what}: a node outlived its drill"
        lines = [x for x in out.splitlines() if x.startswith("REPORT ")]
        assert self.proc.returncode == 0 and len(lines) == 1, (
            f"{self.what}: exit {self.proc.returncode}; stderr: "
            f"{err[-4000:]}")
        return json.loads(lines[0][len("REPORT "):])


def in_children(package, lib, prelude=""):
    """`package`'s fleet_drill and fleet_roll, called as the package's own
    (the nodes' argv, then keywords), each run as a Drill on the core at
    `lib`; each returns the child's report."""
    def run(fn):
        return lambda argv, **kwargs: Drill(
            package, fn, argv, lib, prelude=prelude, **kwargs).report()
    return types.SimpleNamespace(fleet_drill=run("fleet_drill"),
                                 fleet_roll=run("fleet_roll"))
