"""Finds what a cell is made of, by name: its entry in BENCHMARK.json, its
configuration's file, the layout that file names, its traffic mix's file
and each per-layer metric's reader (the reference's rules are found by
harness/reference.py). Nothing here knows a cell, a configuration, a
layout or a metric by name, so a cell, a deployment, a traffic mix or a
metric is added by adding files."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from typing import Callable, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
WORKLOADS_DIR = os.path.join(BENCH_DIR, "workloads")
METRICS_DIR = os.path.join(BENCH_DIR, "metrics")
LAYOUTS_DIR = os.path.join(BENCH_DIR, "layouts")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One entry of BENCHMARK.json's workloads, with the files it names and
    the metrics it reports."""

    def __init__(self, bench: dict, name: str, root: str = ROOT) -> None:
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (there "
                           f"are: {', '.join(sorted(cells))})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        self.layout = layout(self.config["layout"])
        self.traffic = load_json(traffic_file(self.entry["traffic"]))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def traffic_file(traffic: str) -> str:
    return os.path.join(WORKLOADS_DIR, f"{traffic}.json")


def _module(kind: str, path: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def layouts() -> List[str]:
    return sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(LAYOUTS_DIR, "*.py")))


def layout(name: str) -> type:
    """benchmark/layouts/<name>.py's Layout: the class that brings a
    configuration of that layout up. Layout(config, mix, seed, seconds,
    device) opens the device runtime, serves the configuration's methods,
    builds the generator's channels and warms them up (its `ready`);
    `call_bytes` is the request and reply bytes of one right call;
    counters() gives the layout's own blocks of program counters, read
    around the window with the others; window() runs the measured window
    and returns a gen.Result; close() ends what it started, after which
    `stage_client` (the client side's stage_stats()), `forbidden`
    (forbidden modules of its other processes) and `segments` (the
    transport's shared-memory segments its processes mapped) are set."""
    path = os.path.join(LAYOUTS_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no layout {name!r} in benchmark/layouts (there "
                       f"are: {', '.join(layouts())})")
    return _module("layout", path, name).Layout


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """benchmark/metrics/<metric>.py's read(run): the metric's value from
    one traced run's readings, or None where it finds nothing to read."""
    return _module("metric", os.path.join(METRICS_DIR, f"{metric}.py"),
                   metric).read
