"""One run of one cell: bring the deployment up (this process, which
holds the card, serves the configuration's device methods over tpu://; a
client process, harness/client.py, runs the load generator against it),
warm it, measure the window, read the per-layer metrics, and decide
`correct`.
"""

from __future__ import annotations

import base64
import copy
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np

from harness import gen, guard, stats, traffic as traffic_mod
from harness.spec import BENCH_DIR, ROOT, Cell, reader
from harness.trace import DeviceTrace, breakdown, busy_s

CLIENT = os.path.join(BENCH_DIR, "harness", "client.py")


def merge(base: dict, over: Optional[dict]) -> dict:
    """base with `over`'s keys put in, nested dicts key by key."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class ClientServer:
    """The configuration's server here, the generator in a client
    process."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 seconds: float) -> None:
        import tbus_torch as tt

        self.server = tt.Server()
        for method, spec in config["methods"].items():
            self.server.add_device_method(config["service"], method,
                                          spec["transform"])
        port = self.server.start(0)
        self.proc = subprocess.Popen(
            [sys.executable, CLIENT], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, cwd=ROOT)
        self._send(json.dumps({
            "addr": f"tpu://127.0.0.1:{port}", "service": config["service"],
            "traffic": mix, "seed": seed, "seconds": seconds,
            "rule": config["guarantee"][mix["method"]]}))
        self.ready = self._read("ready")["ready"]
        self.stage_client: dict = {}
        self.forbidden: list = []
        self.segments: set = set()

    def _send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def _read(self, key: str) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the client process ended before {key!r} "
                               f"(exit {self.proc.wait()})")
        return json.loads(line)

    def window(self) -> gen.Result:
        self._send("go")
        out = self._read("window")
        w = out["window"]
        self.stage_client = out["stage_stats"]
        self.forbidden = out["forbidden"]
        self.segments = set(out["segments"]) | guard.own_segments()
        lat = np.frombuffer(base64.b64decode(out["latencies"]),
                            dtype=np.int64)
        return gen.Result(lat, w["failed"], w["wrong"], w["first_error"],
                          w["t_start_ns"], w["t_end_ns"])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.server.stop()


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
    configuration's deployment keys (never its guarantee): the faults and
    the control of benchmark/tests and benchmark/control.py."""
    import tbus_torch as tt

    config = merge(cell.config, plant)
    config["guarantee"] = cell.config["guarantee"]
    mix = cell.traffic
    traffic_mod.check(mix)
    if trace and device == "cuda":
        DeviceTrace.prime()
    if config.get("dma_registration"):
        tt.device_enable_dma()
    tt.init(0)
    tt.device_init(device)
    deploy = ClientServer(config, mix, seed, seconds)
    try:
        mem = _memory_used(device)
        before = _counters()
        dev_trace = DeviceTrace() if trace else None
        res = _timed_window(deploy, dev_trace, seconds)
        after = _counters()
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
        metrics = _end_to_end(cell, res.ok, rtt, mix, window_s,
                              res.t_start_ns / 1e9 - t0)
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
    line["detail"] = {"ready": deploy.ready, "first_error": res.first_error,
                      "leaked": leaked, "forbidden": forbidden,
                      "rtt_us": {f"p{q:g}": stats.percentile(rtt, q)
                                 for q in (50, 90, 95, 99, 99.9)}
                      if len(rtt) else {}}
    line["card"] = _card(device)
    line["checks"] = checks
    return line


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


def _end_to_end(cell: Cell, ok: int, rtt: np.ndarray, mix: dict,
                window_s: float, setup_s: float) -> dict:
    values: dict = {
        # Request and reply: the reply is the request's size.
        "goodput_GBps": stats.goodput_gbps(ok, 2 * mix["payload_bytes"],
                                           window_s),
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
