"""One run of one cell: bring the deployment up by the layout its
configuration names (benchmark/layouts/), warm it, measure the window,
read the per-layer metrics, and decide `correct`.
"""

from __future__ import annotations

import copy
import subprocess
import threading
import time
from typing import Callable, Optional

import numpy as np

from harness import gen, guard, stats, traffic as traffic_mod
from harness.spec import Cell, reader
from harness.trace import DeviceTrace, breakdown, busy_s


def merge(base: dict, over: Optional[dict]) -> dict:
    """base with `over`'s keys put in, nested dicts key by key."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def _counters() -> dict:
    from tbus_torch import rpc

    return {"device": rpc.device_stats(), "dma": rpc.device_dma_stats(),
            "stage": rpc.stage_stats()}


def _memory_used(device: str) -> int:
    if device != "cuda":
        return 0
    import torch

    free, total = torch.cuda.mem_get_info(0)
    return int(total - free)


def _timed_window(deploy, trace: Optional[DeviceTrace], seconds: float
                  ) -> gen.Result:
    """Runs the window in a thread; with a trace, profiles a slice of it
    from here: from a quarter of the window (at most 1 s) in, for half of
    it (at most 2 s)."""
    out: dict = {}

    def run() -> None:
        try:
            out["result"] = deploy.window()
        except BaseException as e:  # re-raised below, in this thread
            out["error"] = e

    th = threading.Thread(target=run)
    th.start()
    if trace is not None:
        time.sleep(min(1.0, seconds / 4))
        trace.start()
        time.sleep(min(2.0, seconds / 2))
        trace.stop()
    th.join()
    if "error" in out:
        raise out["error"]
    return out["result"]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda",
             plant: Optional[dict] = None) -> dict:
    """One run of `cell`: its result line as a dict (correct, attempted,
    failed, metrics, device, breakdown with a trace, checks last). t0 is
    the process's start on the monotonic clock; `plant` is put into the
    configuration's deployment keys (never its guarantee or its layout):
    the faults and the control of benchmark/tests and
    benchmark/control.py."""
    config = merge(cell.config, plant)
    config["guarantee"] = cell.config["guarantee"]
    config["layout"] = cell.config["layout"]
    mix = cell.traffic
    traffic_mod.check(mix)
    if trace and device == "cuda":
        DeviceTrace.prime()
    deploy = cell.layout(config, mix, seed, seconds, device)
    try:
        mem = _memory_used(device)
        own = deploy.counters()
        before = {**_counters(), **own}
        dev_trace = DeviceTrace() if trace else None
        res = _timed_window(deploy, dev_trace, seconds)
        after = {**_counters(), **deploy.counters()}
        mem = max(mem, _memory_used(device))
    finally:
        deploy.close()
    leaked = guard.leaked_segments(deploy.segments)
    forbidden = guard.forbidden_modules() + deploy.forbidden

    window_s = (res.t_end_ns - res.t_start_ns) / 1e9
    rtt = stats.rtt_us(res.latencies_ns, mix["timeout_ms"])
    readings = {
        "cell": cell.entry, "config": config, "traffic": mix,
        "calls": {"attempted": res.attempted,
                  "completed": res.attempted - res.failed, "ok": res.ok,
                  "window_s": window_s, "rtt_us": rtt},
        "before": before, "after": after,
        "stage_client": deploy.stage_client,
        "trace": dev_trace,
    }
    if trace:
        metrics = _per_layer(cell, readings)
    else:
        metrics = _end_to_end(cell, res.ok, rtt, deploy.call_bytes,
                              window_s, res.t_start_ns / 1e9 - t0)
    # An exact comparison of the window's replies against the answers the
    # reference owes them, so each limit is 0 (PERF.md §2).
    checks = {
        "failed_calls": {"value": res.failed, "limit": 0},
        "wrong_replies": {"value": res.wrong, "limit": 0},
        "replies_compared": {"value": res.compared, "at_least": 1},
    }
    correct = res.compared >= 1 and res.failed == 0 and res.wrong == 0
    line = {"correct": correct, "attempted": res.attempted,
            "failed": res.failed + res.wrong, "metrics": metrics,
            "device": _device(device, cell.chips, mem)}
    if trace:
        line["device"]["busy_s"] = busy_s(dev_trace.ops)
        line["device"]["window_s"] = dev_trace.window_s
        line["breakdown"] = breakdown(dev_trace.ops)
    line["detail"] = {"layout": config["layout"], "ready": deploy.ready,
                      "first_error": res.first_error,
                      "leaked": leaked, "forbidden": forbidden,
                      "counters": _window_counts(before, after, own),
                      "rtt_us": {f"p{q:g}": stats.percentile(rtt, q)
                                 for q in (50, 90, 95, 99, 99.9)}
                      if len(rtt) else {}}
    line["card"] = _card(device)
    line["checks"] = checks
    return line


def _window_counts(before: dict, after: dict, blocks: dict) -> dict:
    """The rise over the window of each whole-number counter of the
    layout's own blocks."""
    return {b: {k: after[b][k] - before[b][k] for k, v in after[b].items()
                if isinstance(v, int) and not isinstance(v, bool)}
            for b in blocks}


def _card(device: str) -> str:
    """The card's name and power limit, written beside every number."""
    if device != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


def _device(device: str, chips: int, mem: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": mem}


def _end_to_end(cell: Cell, ok: int, rtt: np.ndarray, call_bytes: int,
                window_s: float, setup_s: float) -> dict:
    values: dict = {
        # The request and the reply of each right call, as the layout
        # counts them.
        "goodput_GBps": stats.goodput_gbps(ok, call_bytes, window_s),
        "rtt_p50_us": stats.percentile(rtt, 50),
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def _per_layer(cell: Cell, readings: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def say_checks(line: dict, write: Callable[[str], None]) -> None:
    for name, c in line["checks"].items():
        bound = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['at_least']}")
        write(f"check {name}: {c['value']} ({bound})")
