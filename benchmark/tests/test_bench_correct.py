"""How `correct` is decided, driven through whole runs on the CPU backend
of the device runtime (the harness's look for a card skipped).

- Each cell of BENCHMARK.json, run by run.py's own entry, comes out
  correct, with its checks last on the result line and on standard error.
- Every configuration under benchmark/configs/ (those a cell does not use
  yet too), brought up by the layout it names, with the first traffic mix
  that calls one of its methods: a sound run is correct; the control
  (the configuration's "control": one of its guarantees broken) and
  every fault the deployment can have (its "faults": a reply returned
  unchanged, an answer altered where it is produced) are not.
On the card, the cuda-marked test runs each cell's command."""

import glob
import json
import os
import subprocess
import sys

import pytest

from harness import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
BENCHMARK = spec.benchmark()
SEED = 2**31 + 11


def _line(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _layout(config):
    return spec.load_json(os.path.join(BENCH, "configs",
                                       f"{config}.json"))["layout"]


def _deployments():
    """(config name, traffic name) for each configuration file and the
    first traffic mix that calls one of its methods."""
    mixes = sorted(glob.glob(os.path.join(spec.WORKLOADS_DIR, "*.json")))
    for path in sorted(glob.glob(os.path.join(BENCH, "configs", "*.json"))):
        config = spec.load_json(path)
        traffic = next(os.path.basename(m)[:-5] for m in mixes
                       if spec.load_json(m)["method"] in config["methods"])
        yield config["name"], traffic


def _run_deployment(config, traffic, plant=None):
    bench = {"configs": [{"name": config,
                          "file": f"benchmark/configs/{config}.json"}],
             "workloads": [{"name": "cpu", "config": config,
                            "traffic": traffic, "chips": 1}],
             "end_to_end": BENCHMARK["end_to_end"], "per_layer": []}
    return _line(f"""
import json, sys, time
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
from harness.cell import run_cell
from harness.spec import Cell
cell = Cell({bench!r}, "cpu")
print(json.dumps(run_cell(cell, {SEED}, 1, False, time.monotonic(),
                          device="cpu", plant={plant!r})))
""")


def _plants():
    for config, traffic in _deployments():
        c = spec.load_json(os.path.join(BENCH, "configs", f"{config}.json"))
        yield config, traffic, "control", c["control"]
        for name, plant in c["faults"].items():
            yield config, traffic, name, plant


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_each_cell_is_correct_through_its_entry(cell):
    line = _line(f"""
import sys
sys.path.insert(0, {BENCH!r})
import run
sys.exit(run.main(["--workload", {cell!r}, "--seed", "{SEED}",
                   "--seconds", "1", "--trace", "0"], device="cpu"))
""")
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("config,traffic", list(_deployments()))
def test_a_sound_run_of_each_deployment_is_correct(config, traffic):
    line = _run_deployment(config, traffic)
    assert line["detail"]["layout"] == _layout(config)
    assert line["correct"], line["checks"]
    assert line["checks"]["wrong_replies"]["value"] == 0


@pytest.mark.parametrize("config,traffic,fault,plant", list(_plants()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_the_control_and_each_fault_are_not_correct(config, traffic, fault,
                                                    plant):
    line = _run_deployment(config, traffic, plant)
    assert line["detail"]["layout"] == _layout(config)
    assert not line["correct"], (fault, line["checks"])
    assert line["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_on_the_card(cuda_card, cell):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483001", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
