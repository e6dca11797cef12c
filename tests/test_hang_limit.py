"""The suite's hang limit (the repo root's conftest.py): it is armed in
every session run from the root, and under `--dist loadfile` the test an
xdist worker died in (its watchdog fired at TEST_LIMIT_S) fails once and is
not run again, while the rest of its file goes to a new worker. Driven here
on xdist's own scheduler with stand-in workers.
"""

import importlib.util
import os
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOOKS = os.path.join(ROOT, "conftest.py")
_spec = importlib.util.spec_from_file_location("root_conftest", HOOKS)
hooks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(hooks)

COLLECTION = ["tests/a.py::t1", "tests/a.py::t2", "tests/a.py::t3",
              "tests/b.py::t1", "tests/b.py::t2"]


class _Worker:
    def __init__(self, name):
        self.gateway = types.SimpleNamespace(id=name)
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indexes):
        self.sent += indexes

    def shutdown(self):
        self.shutting_down = True


def _config(dist="loadfile", workers=2):
    values = {"dist": dist, "tx": [f"{workers}*popen"]}
    return types.SimpleNamespace(
        getvalue=values.__getitem__,
        option=types.SimpleNamespace(loadscopereorder=False))


def _join(sched, name):
    worker = _Worker(name)
    sched.add_node(worker)
    sched.add_node_collection(worker, COLLECTION)
    return worker


def _started(sched):
    """Two workers, one file each: gw0 a.py, gw1 b.py."""
    workers = [_join(sched, "gw0"), _join(sched, "gw1")]
    sched.schedule()
    return workers


def test_the_limit_is_armed_in_this_session(pytestconfig):
    """pytest took the root's hooks for this run of tests/."""
    assert HOOKS in [getattr(p, "__file__", None)
                     for p in pytestconfig.pluginmanager.get_plugins()]
    assert hooks.TEST_LIMIT_S <= 300


def test_the_test_a_worker_died_in_is_not_run_again():
    """xdist's own scheduler would hand the dead worker's file back with
    the test it died in still pending (t2 and t3 to the new worker), and
    the new worker would hang in it again."""
    sched = hooks.pytest_xdist_make_scheduler(_config(), None)
    gw0, _ = _started(sched)
    assert gw0.sent == [0, 1, 2]
    sched.mark_test_complete(gw0, 0)
    assert sched.remove_node(gw0) == "tests/a.py::t2"  # died in t2
    gw2 = _join(sched, "gw2")
    sched.schedule()
    assert gw2.sent == [2]  # t3 only


def test_a_dead_worker_s_finished_files_are_not_handed_out_again():
    """A worker that finished a.py and died in b.py::t1: the new worker is
    sent b.py::t2. xdist's own scheduler would hand a.py back too, and a
    new worker given it first would be sent no test and wait forever."""
    sched = hooks.pytest_xdist_make_scheduler(_config(workers=1), None)
    gw0 = _join(sched, "gw0")
    sched.schedule()
    for index in (0, 1, 2):
        sched.mark_test_complete(gw0, index)
    assert gw0.sent == [0, 1, 2, 3, 4]  # b.py followed a.py
    assert sched.remove_node(gw0) == "tests/b.py::t1"
    gw1 = _join(sched, "gw1")
    sched.schedule()
    assert gw1.sent == [4]
    sched.mark_test_complete(gw1, 4)
    assert sched.tests_finished


def test_a_death_in_a_files_last_test_hands_nothing_back():
    sched = hooks.pytest_xdist_make_scheduler(_config(), None)
    gw0, _ = _started(sched)
    sched.mark_test_complete(gw0, 0)
    sched.mark_test_complete(gw0, 1)
    assert sched.remove_node(gw0) == "tests/a.py::t3"
    assert not sched.workqueue


def test_a_worker_that_finished_names_no_test():
    sched = hooks.pytest_xdist_make_scheduler(_config(), None)
    _, gw1 = _started(sched)
    sched.mark_test_complete(gw1, 3)
    sched.mark_test_complete(gw1, 4)
    assert sched.remove_node(gw1) is None


def test_other_distributions_keep_xdists_scheduler():
    assert hooks.pytest_xdist_make_scheduler(_config("load"), None) \
        is None
