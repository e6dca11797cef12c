"""The plain reference: the answer each request is owed, worked out in
NumPy from the request bytes alone, by the rule the configuration states
as its guarantee. It imports nothing of the program and takes nothing the
program made.

A rule is a file of its own, benchmark/references/<rule>.py, holding
`reply(request: uint8[n]) -> uint8[m]` (m may differ from n) and
EXAMPLES, hand-worked pairs of request and reply that the tests hold it
to; a method's "guarantee" in the configuration's file names it.
"""

from __future__ import annotations

import glob
import importlib.util
import os
from typing import Callable, List

import numpy as np

RULES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "references")


def known() -> List[str]:
    return sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(RULES_DIR, "*.py")))


def module(name: str):
    """The rule's file, loaded, found by name."""
    path = os.path.join(RULES_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no reference rule {name!r} (there are: "
                         f"{', '.join(known())})")
    spec = importlib.util.spec_from_file_location(
        "bench_rule_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rule(name: str) -> Callable[[np.ndarray], np.ndarray]:
    """The rule's reply function."""
    return module(name).reply


def reply(name: str, request: np.ndarray) -> np.ndarray:
    """The bytes (uint8, 1-d) owed for `request` (uint8, 1-d)."""
    return np.asarray(rule(name)(np.asarray(request, dtype=np.uint8)),
                      dtype=np.uint8)


def replies(name: str, requests: np.ndarray) -> np.ndarray:
    """reply() of every request of a [clients, k, n] block, as
    [clients, k, m]."""
    c, k, _ = requests.shape
    fn = rule(name)
    out = [np.asarray(fn(requests[i, j]), dtype=np.uint8)
           for i in range(c) for j in range(k)]
    return np.stack(out).reshape(c, k, -1)


def reply_bytes(name: str, n: int) -> int:
    """The length of the reply owed for a request of n bytes."""
    return len(reply(name, np.zeros(n, dtype=np.uint8)))
