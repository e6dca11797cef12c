"""Single-host process-group bring-up and a local multi-process launcher.

The single-host part of tbus/parallel/distributed.py for the port: where
the reference joins JAX's distributed runtime, the port joins a
``torch.distributed`` process group, NCCL on CUDA and gloo on the CPU.
The multi-host ``global_mesh`` is not ported yet.

    from tbus_torch.parallel import distributed
    distributed.init(rank, world, "/path/to/store", "nccl")
    ...
    distributed.shutdown()

:func:`launch_local` runs an n-process gloo (or NCCL) job on this host,
the port's twin of the reference's ``launch_local``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from typing import Any, List, Union

import torch
import torch.distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BACKENDS = ("nccl", "gloo")


def backend_for(device: str) -> str:
    """The process-group backend for a device type: NCCL for CUDA, gloo for
    the CPU."""
    if device == "cuda":
        return "nccl"
    if device == "cpu":
        return "gloo"
    raise ValueError(f"unknown device {device!r} (cuda or cpu)")


def init(rank: int, world: int, store: Union[str, dist.Store],
         backend: str = "nccl") -> None:
    """Joins (or forms) a `world`-process group as `rank`.

    `store` is a path for a FileStore shared by the job's processes, or a
    Store. With NCCL, process `rank` drives the card rank % device_count;
    NCCL without CUDA raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA and none is "
                               "available (gloo runs on the CPU)")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if isinstance(store, str):
        store = dist.FileStore(store, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)


def init_single(device: str = "cuda") -> None:
    """A one-process group for `device` (in-process store)."""
    init(0, 1, dist.HashStore(), backend_for(device))


def shutdown() -> None:
    """Leaves the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


_PREAMBLE = """\
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from tbus_torch.parallel import distributed
rank, world = int(sys.argv[1]), int(sys.argv[2])
_out_path = sys.argv[4]
distributed.init(rank, world, sys.argv[3], {backend!r})
result = None
"""

_POSTAMBLE = """
with open(_out_path, "w") as _f:
    json.dump(result, _f)
distributed.shutdown()
"""


def _tail(path: str, n: int = 4000) -> str:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - n))
        return f.read().decode(errors="replace")


def launch_local(body: str, num_processes: int = 2, backend: str = "gloo",
                 timeout_s: float = 180.0) -> List[Any]:
    """Runs a `num_processes`-process job on this host and returns every
    process's result, index = rank.

    `body` is Python source that each child executes after it joined the
    group (:func:`init`, through a FileStore in a fresh temporary
    directory, so concurrent launches never meet). It sees `rank`, `world`
    and `torch`, and assigns its JSON-serialisable outcome to `result`.
    Each child is a fresh interpreter (``python -c``), so it imports only
    what the body imports.

    Children are killed on timeout or as soon as one fails; a nonzero exit
    raises RuntimeError carrying that child's output tail."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    code = (_PREAMBLE.format(root=_REPO, backend=backend)
            + textwrap.dedent(body) + _POSTAMBLE)
    with tempfile.TemporaryDirectory(prefix="tbus_torch_launch_") as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"result{r}.json")
                for r in range(num_processes)]
        logs = [os.path.join(tmp, f"log{r}.txt")
                for r in range(num_processes)]
        procs: List[subprocess.Popen] = []
        try:
            for r in range(num_processes):
                with open(logs[r], "wb") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", code, str(r),
                         str(num_processes), store, outs[r]],
                        stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.returncode not in (None, 0)]
                if failed:
                    r = failed[0]
                    raise RuntimeError(
                        f"launch_local: rank {r} exited with "
                        f"{procs[r].returncode}:\n{_tail(logs[r])}")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"launch_local: timed out after {timeout_s} s; rank "
                        f"0's output:\n{_tail(logs[0])}")
                time.sleep(0.02)
            for r, p in enumerate(procs):
                if p.returncode != 0:
                    raise RuntimeError(
                        f"launch_local: rank {r} exited with "
                        f"{p.returncode}:\n{_tail(logs[r])}")
            results = []
            for path in outs:
                with open(path) as f:
                    results.append(json.load(f))
            return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
