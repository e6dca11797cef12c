"""The one generator of the benchmark's inputs: a traffic mix's file of
parameters and a seed give every client's request payloads.

A mix's keys (benchmark/workloads/<traffic>.json):
- method: the configuration's method the calls go to;
- clients: callers, each on its own fiber (and its own channel, where the
  deployment has one channel per client);
- payload_bytes: the size of every request;
- payloads_per_client: distinct seeded payloads each client sends in turn;
- rate: calls a second over all clients, on a shared schedule; 0 is a
  closed loop (each client calls again as soon as its call returns);
- warmup_calls_per_client: calls each client makes in set-up, before the
  window, with the window's payloads;
- timeout_ms: each call's deadline;
- client_workers: the fiber workers of the process that runs the load
  generator (0: the core's default, one a core).
"""

from __future__ import annotations

import numpy as np

KEYS = ("method", "clients", "payload_bytes", "payloads_per_client", "rate",
        "warmup_calls_per_client", "timeout_ms", "client_workers")


def check(traffic: dict) -> None:
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic mix lacks {', '.join(missing)}")
    for k in KEYS[1:]:
        if traffic[k] < 0 or (k not in ("rate", "client_workers")
                               and traffic[k] == 0):
            raise ValueError(f"traffic mix: {k} = {traffic[k]}")


def rng_of(seed: int) -> np.random.Generator:
    """The run's random stream: any whole number is a seed (a negative one
    or one past 64 bits is taken modulo 2**64)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def payloads(traffic: dict, seed: int) -> np.ndarray:
    """uint8 [clients, payloads_per_client, payload_bytes], from the seed
    alone: every seed gives the same sizes and counts, other bytes."""
    check(traffic)
    shape = (traffic["clients"], traffic["payloads_per_client"],
             traffic["payload_bytes"])
    raw = rng_of(seed).bytes(int(np.prod(shape)))
    return np.frombuffer(raw, dtype=np.uint8).reshape(shape)
