"""What a run checks about itself besides its answers: that it loaded
nothing of JAX or of the JAX package, and that the tpu:// transport's
shared-memory segments that its ended client process mapped are gone."""

from __future__ import annotations

import os
import sys
from typing import List, Set

# Compared with each loaded module's top-level name, whole: the port,
# tbus_torch, is not the JAX package, tbus.
FORBIDDEN = ("jax", "jaxlib", "flax", "tbus")
SHM_DIR = "/dev/shm"
# The core's segment names (cpp/tpu/block_pool.cc, shm_fabric.cc).
SHM_PREFIXES = ("tbus_pool_", "tbus_ici_", "tbus_nfy_")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def shm_segments() -> Set[str]:
    try:
        return {n for n in os.listdir(SHM_DIR) if n.startswith(SHM_PREFIXES)}
    except FileNotFoundError:
        return set()


def own_segments() -> Set[str]:
    """The transport's segments this process has mapped."""
    out = set()
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.rstrip("\n").split(maxsplit=5)[-1]
            name = os.path.basename(path.split(" (deleted)")[0])
            if path.startswith(SHM_DIR + "/") and \
                    name.startswith(SHM_PREFIXES):
                out.add(name)
    return out


def leaked_segments(mapped: Set[str]) -> List[str]:
    """Of the segments this run's processes mapped, those still in
    /dev/shm that this process no longer maps: its own are unlinked when
    it exits (the core's atexit), so what is left was the ended client's.
    A segment of another process on the machine is never in `mapped`."""
    return sorted((mapped & shm_segments()) - own_segments())
