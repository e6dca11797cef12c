"""The device runtime's job timeline, as the per-layer metrics of the
server dispatch, device runtime and device layers read it.

The program keeps two records (tbus_torch/csrc/cuda_runtime.cc; README's
device_stats entry):
- device_stats()["stages"]: histograms of each job's hops (queue,
  host_prep, device, reply, job), cumulative since the runtime came up, so
  `after - before` around the window is exactly the window's jobs; the
  dispatch thread's busy time;
- device_jobs(): a ring of per-job records, six stamps each on
  CLOCK_MONOTONIC (enq, pick, h2d, exec, synced, replied).

A tree without them (an older program) gives None here, never an error.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from harness.trace import merged

HOPS = ("queue", "host_prep", "device", "reply", "job")


# ---- the histograms ----

def stages(reading: dict) -> Optional[dict]:
    """The "stages" block of one _counters() reading, or None."""
    return (reading.get("device") or {}).get("stages")


def hop_delta(before: dict, after: dict, hop: str) -> Dict[int, int]:
    """The hop's bucket counts added between two "stages" blocks."""
    was = {b: n for b, n in before["hops"][hop]["buckets"]}
    out = {}
    for b, n in after["hops"][hop]["buckets"]:
        d = n - was.get(b, 0)
        if d > 0:
            out[b] = d
    return out


def bucket_percentile(delta: Dict[int, int], lo: Sequence[int],
                      q: float) -> Optional[float]:
    """The nearest-rank q-th percentile, in ns, of the durations counted
    in `delta`: the middle of the bucket that holds it (the last bucket,
    open above, by its lower bound). A bucket is at most 1/16 of its lower
    bound wide, so this lies within 3.2% of the exact value."""
    total = sum(delta.values())
    if total == 0:
        return None
    rank = max(1, math.ceil(q / 100.0 * total))
    seen = 0
    for b in sorted(delta):
        seen += delta[b]
        if seen >= rank:
            return (lo[b] + lo[b + 1]) / 2.0 if b + 1 < len(lo) else \
                float(lo[b])
    return None


def window_stages(run: dict) -> Optional[Tuple[dict, dict]]:
    """(before, after) "stages" blocks around the window, or None where
    the program keeps none or ran no job in the window."""
    before, after = stages(run["before"]), stages(run["after"])
    if not before or not after or after["jobs"] <= before["jobs"]:
        return None
    return before, after


def hop_percentile_us(run: dict, hop: str, q: float) -> Optional[float]:
    """The hop's q-th percentile over the window's jobs, in us."""
    both = window_stages(run)
    if both is None:
        return None
    before, after = both
    ns = bucket_percentile(hop_delta(before, after, hop),
                           after["bucket_lo_ns"], q)
    return None if ns is None else ns / 1e3


# ---- the dispatch thread's state over the traced slice ----

def no_job_seconds(jobs: np.ndarray, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] (monotonic ns) in which the dispatch thread
    held no job: outside every [pick, replied]."""
    held = merged([("", max(float(a), lo), min(float(b), hi))
                   for a, b in zip(jobs["pick"], jobs["replied"])
                   if b > lo and a < hi])
    return ((hi - lo) - sum(b - a for a, b, _ in held)) / 1e9


def covers(jobs: np.ndarray, lo: float) -> bool:
    """Whether `jobs` hold every job the dispatch thread ran from `lo` on:
    their seq numbers run without a gap, from the thread's first job or
    from one it picked by `lo`. The ring keeps the newest jobs only, and a
    read drops a record overwritten while it was copied; the time of a job
    lost either way would count as no job held."""
    if len(jobs) == 0:
        return False
    seq = jobs["seq"]
    if np.any(np.diff(seq) != 1):
        return False
    return bool(seq[0] == 0 or jobs["pick"][0] <= lo)


def slice_jobs(margin_ns: float = 1e9, since_ns: float = 0,
               until_ns: float = 2**63 - 1) -> Optional[np.ndarray]:
    """The program's job records that overlap [since - margin, until +
    margin], or None where the program keeps none."""
    from tbus_torch import rpc

    read = getattr(rpc, "device_jobs", None)
    if read is None:
        return None
    try:
        return read(int(max(0, since_ns - margin_ns)),
                    int(min(2**63 - 1, until_ns + margin_ns)))
    except RuntimeError:
        return None

