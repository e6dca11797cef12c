"""Pytest hooks for every session run from the repo's root: a hard time
limit on each test, and, under xdist, the JAX package's core built once
before the workers start.

A test that calls into the core can hang inside a ctypes call (ROADMAP C1).
Past TEST_LIMIT_S faulthandler's watchdog, a C thread that runs while the
main thread is blocked, writes every thread's stack to stderr and ends the
process: under xdist the test fails and a new worker takes the tests still
pending, so a hang costs that test, not the run.
"""

import faulthandler
import os
import subprocess

import pytest

# Every test's hard limit in seconds, its fixtures' setup and teardown
# included: a few times the slowest unmarked test.
TEST_LIMIT_S = 300

_watchdog_out = None  # the process's own stderr, outside pytest's capture


def pytest_configure(config):
    global _watchdog_out
    _watchdog_out = os.fdopen(os.dup(2), "w")
    if (getattr(config.option, "dist", "no") != "no"
            and not hasattr(config, "workerinput")):
        _build_reference_core()


def _build_reference_core():
    """Builds the JAX package's core (cpp/build/libtbus.so) once, in the
    xdist controller before any worker starts. Its loader guards the build
    with a lock that holds within one process only, so on a fresh tree
    workers building at once relink the library under each other's feet
    (ROADMAP C2). A build that fails is left for the tests' own fixtures
    to report."""
    from tbus import _native
    try:
        _native.build()
    except (OSError, subprocess.CalledProcessError):
        pass


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """Under `--dist loadfile`, xdist's own scheduler with two changes to
    what it hands back of a worker that died. xdist hands back every file
    the worker was given, whole:
    - the test it died in: a new worker would start with the test that
      hung, hang as long, and so on until xdist stops replacing workers.
      It is marked done, and fails once.
    - the files it had finished: a new worker given one first is sent no
      test, so it never reports a result, and xdist waits for it forever.
      They are not handed back."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class NoRerunOfACrash(LoadFileScheduling):
        def remove_node(self, node):
            work = self.assigned_work.get(node, {})
            crashed = None
            for unit in work.values():
                crashed = next((i for i, done in unit.items() if not done),
                               None)
                if crashed:
                    unit[crashed] = True
                    break
            for scope in [s for s, unit in work.items() if all(unit.values())]:
                del work[scope]
            super().remove_node(node)
            return crashed

    return NoRerunOfACrash(config, log)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    faulthandler.dump_traceback_later(TEST_LIMIT_S, exit=True,
                                      file=_watchdog_out)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
