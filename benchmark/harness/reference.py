"""The plain reference: the answer each request is owed, worked out in
NumPy from the request bytes alone, by the rule the configuration states
as its guarantee. It imports nothing of the program and takes nothing the
program made.

Rules (a method's "guarantee" in the configuration's file):
- echo: the request itself;
- xor255: every byte of the request xor 0xFF.
"""

from __future__ import annotations

import numpy as np

RULES = ("echo", "xor255")


def reply(rule: str, request: np.ndarray) -> np.ndarray:
    """The bytes (uint8) owed for `request` (uint8, 1-d)."""
    if rule not in RULES:
        raise ValueError(f"no reference rule {rule!r}")
    request = np.asarray(request, dtype=np.uint8)
    return request ^ np.uint8(0xFF) if rule == "xor255" else request.copy()


def replies(rule: str, requests: np.ndarray) -> np.ndarray:
    """reply() of every request of a [clients, k, n] block, as
    [clients, k, n]."""
    c, k, n = requests.shape
    out = [reply(rule, requests[i, j]) for i in range(c) for j in range(k)]
    return np.stack(out).reshape(c, k, n)
