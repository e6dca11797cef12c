"""The arithmetic of the end-to-end metrics, over every call of a window.

A call that failed or answered wrong is a miss: it counts as taking the
call's whole deadline, which is slower than any limit the benchmark sets.
"""

from __future__ import annotations

import math

import numpy as np


def rtt_us(latencies_ns: np.ndarray, deadline_ms: float) -> np.ndarray:
    """Each call's round trip in us, a miss (-1) as the deadline."""
    lat = np.asarray(latencies_ns, dtype=np.float64) / 1e3
    return np.where(lat < 0, deadline_ms * 1e3, lat)


def percentile(values_us: np.ndarray, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value that at least
    q% of the sample lies at or below."""
    if len(values_us) == 0:
        raise ValueError("no calls")
    ordered = np.sort(values_us)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return float(ordered[rank - 1])


def goodput_gbps(calls_ok: int, bytes_per_call: int, window_s: float) -> float:
    """Payload bytes of the calls answered right, request and reply
    together, over the window, in GB/s (1e9 bytes)."""
    return calls_ok * bytes_per_call / window_s / 1e9
