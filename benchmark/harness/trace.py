"""The device trace of a traced run: torch.profiler over a slice of the
window in the process that holds the card, reduced to the device's busy
time, each device operation's intervals, and the breakdown the result line
carries. The profiler's CUPTI tracing sees every kernel and copy of the
process, those the device runtime launches from C++ too.

The reduction follows chip_smoke.py's _device_profile (device-side events
only, kernels and copies, so nothing is counted twice), over intervals
rather than totals, so that overlapping operations count once in the busy
time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

Interval = Tuple[str, float, float]  # (name, start_us, end_us)


class DeviceTrace:
    """Profiles the card from start() to stop(); then `ops` holds every
    device operation as (name, start_us, end_us) and `window_s` the
    slice's length on the host's clock."""

    def __init__(self) -> None:
        self.ops: List[Interval] = []
        self.window_s = 0.0
        self._prof = None
        self._t0 = 0.0

    @staticmethod
    def prime() -> None:
        """One empty profiling session. It has to come before the device
        runtime opens the card: a profiler first started after that
        records none of the runtime's kernels and copies (seen on an
        H100)."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            pass

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.monotonic()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.monotonic() - self._t0
        self._prof.__exit__(None, None, None)
        self.ops = sorted(
            ((e.name, float(e.time_range.start), float(e.time_range.end))
             for e in self._prof.events()
             if e.device_type == DeviceType.CUDA
             and e.time_range.end > e.time_range.start),
            key=lambda op: op[1])
        self._prof = None


def merged(ops: List[Interval]) -> List[Tuple[float, float, str]]:
    """The union of the ops' intervals, in order, each with the name of
    the op that opened it."""
    out: List[Tuple[float, float, str]] = []
    for name, s, e in sorted(ops, key=lambda op: op[1]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e, out[-1][2])
        else:
            out.append((s, e, name))
    return out


def busy_s(ops: List[Interval]) -> float:
    return sum(e - s for s, e, _ in merged(ops)) / 1e6


def op_seconds(ops: List[Interval]) -> Dict[str, float]:
    total: Dict[str, float] = defaultdict(float)
    for name, s, e in ops:
        total[name] += (e - s) / 1e6
    return dict(total)


def kernel_mean_s(ops: List[Interval], kernel: str) -> Tuple[float, int]:
    """Mean seconds a launch and launches of the kernels whose names hold
    `kernel` as a whole word of their C++ name."""
    times = [(e - s) / 1e6 for name, s, e in ops if _named(name, kernel)]
    return (sum(times) / len(times), len(times)) if times else (0.0, 0)


def _named(name: str, kernel: str) -> bool:
    i = name.find(kernel)
    if i < 0:
        return False
    before = name[i - 1] if i > 0 else " "
    after = name[i + len(kernel)] if i + len(kernel) < len(name) else " "
    return not (before.isalnum() or before == "_") and \
        not (after.isalnum() or after == "_")


def breakdown(ops: List[Interval], top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the device waited for: the operation that ended each gap."""
    gaps: Dict[str, float] = defaultdict(float)
    spans = merged(ops)
    for (_, end, _), (start, _, name) in zip(spans, spans[1:]):
        gaps[f"idle before {name}"] += (start - end) / 1e6
    by_time = sorted(op_seconds(ops).items(), key=lambda kv: -kv[1])[:top]
    by_gap = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in by_time],
            "idle_gaps": [[n, s] for n, s in by_gap]}
