"""A deployment comes as files: a copy of BENCHMARK.json and benchmark/
gains upstream parallel_echo's fan-out deployment (its configuration
naming the fanout_in_process layout, its traffic mix, and one entry each
appended to the copy's configs and workloads) and nothing else, and the
cell runs through run.py's own entry on the CPU backend of the device
runtime: a sound run is correct and lowers every call onto the fan-out
engine; the configuration's control and each of its faults are not
correct. No file that was in the copy is edited, by the addition or by
the runs.

Once the repository holds the deployment's files and entries itself, the
copy already has them: the test adds only what is absent, and then runs
the deployment as the repository states it."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SEED = 2**31 + 23
CELL = "parallel_echo.echo_1m.c8"

CONFIG = {
    "name": "parallel_echo",
    "source": "https://github.com/apache/brpc/tree/master/example/"
              "parallel_echo_c++",
    "deployment": "One process holds the card, serves EchoService.Echo on "
                  "8 tpu:// servers and calls them, each client over a "
                  "ParallelChannel to all 8, lowered onto the port's "
                  "collective fan-out engine.",
    "layout": "fanout_in_process",
    "servers": 8,
    "transport": "tpu://",
    "dma_registration": True,
    "service": "EchoService",
    "methods": {"Echo": {"transform": "echo"}},
    "impl_id": "echo/v1",
    "guarantee": {"Echo": "echo_fanout8"},
    "guarantees": "Every call is answered once, within its deadline, "
                  "byte-exact: the 8 servers' echoes merged in sub-channel "
                  "order, as the point-to-point fan-out would merge them.",
    "control": {"methods": {"Echo": {"transform": "xor255"}}},
    "faults": {
        "answer_altered": {"methods": {"Echo": {
            "transform": "add_peer_index"}}},
        "sub_channel_left_out": {"servers": 4},
    },
}
MIX = {"method": "Echo", "clients": 8, "payload_bytes": 1048576,
       "payloads_per_client": 4, "rate": 0, "warmup_calls_per_client": 32,
       "timeout_ms": 5000, "client_workers": 4}
CONFIG_ENTRY = {"name": "parallel_echo", "source": CONFIG["source"],
                "file": "benchmark/configs/parallel_echo.json",
                "reduced": [],
                "why": "an 8-way ParallelChannel fan-out of 1 MiB echoes, "
                       "lowered to one fan-out kernel execution a call"}
WORKLOAD_ENTRY = {"name": CELL, "config": "parallel_echo",
                  "traffic": "echo_1m.c8", "chips": 1,
                  "why": "1 MiB echoes to 8 servers, 8 clients closed loop: "
                         "the fan-out engine, its kernel and the gather of "
                         "8 MiB replies"}


def _digests(tree):
    out = {}
    for d, dirs, names in os.walk(tree):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, tree)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The copy, with the deployment added by new files and appended
    entries; (root, digests of the copy before the addition, the files
    added, the entries appended)."""
    root = str(tmp_path_factory.mktemp("files_only"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__",
                                                  ".pytest_cache"))
    # The generator's build, shared: it is keyed by its source and core.
    os.makedirs(os.path.join(BENCH, "_build"), exist_ok=True)
    os.symlink(os.path.join(BENCH, "_build"),
               os.path.join(root, "benchmark", "_build"))
    before = _digests(root)
    added = []
    for rel, obj in (("benchmark/configs/parallel_echo.json", CONFIG),
                     ("benchmark/workloads/echo_1m.c8.json", MIX)):
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump(obj, f, indent=2)
            added.append(rel)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    appended = {}
    for group, entry in (("configs", CONFIG_ENTRY),
                         ("workloads", WORKLOAD_ENTRY)):
        if entry["name"] not in {x["name"] for x in bench[group]}:
            bench[group].append(entry)
            appended[group] = entry
    if appended:
        with open(path, "w") as f:
            json.dump(bench, f, indent=2)
    return root, before, added, appended


def _run(root, plant=None):
    code = f"""
import sys
sys.path[:0] = [{os.path.join(root, "benchmark")!r}, {root!r}]
sys.path.append({ROOT!r})  # the program, which the copy does not hold
import run
sys.exit(run.main(["--workload", {CELL!r}, "--seed", "{SEED}",
                   "--seconds", "1", "--trace", "0"], device="cpu",
                  plant={plant!r}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_added_deployment_is_correct(tree):
    line = _run(tree[0])
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["detail"]["layout"] == "fanout_in_process"
    fan = line["detail"]["counters"]["fanout"]
    # Every call of the window lowered, each one execution of the kernel.
    assert fan["lowered_calls"] >= line["attempted"] > 0, fan
    assert fan["device_execs"] == fan["lowered_calls"], fan
    assert {"goodput_GBps", "rtt_p50_us", "setup_s"} <= set(line["metrics"])


def test_its_control_and_each_fault_are_not_correct(tree):
    with open(os.path.join(tree[0], "benchmark", "configs",
                           "parallel_echo.json")) as f:
        config = json.load(f)
    plants = {"control": config["control"], **config["faults"]}
    assert len(plants) >= 2
    for fault, plant in plants.items():
        line = _run(tree[0], plant)
        assert not line["correct"], (fault, line["checks"])
        assert line["failed"] > 0, fault


def test_no_file_of_the_copy_was_edited(tree):
    root, before, added, appended = tree
    after = _digests(root)
    assert set(after) == set(before) | set(added)
    for rel, digest in before.items():
        if rel != "BENCHMARK.json":
            assert after[rel] == digest, rel
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        want = json.load(f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        got = json.load(f)
    for group, entry in appended.items():
        want[group].append(entry)
    assert got == want
