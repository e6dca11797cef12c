"""Multi-host bring-up: the process group, the global mesh, and a local
multi-process launcher.

The port of tbus/parallel/distributed.py. Where the reference joins JAX's
distributed runtime through a coordinator, the port joins a
``torch.distributed`` process group through a TCPStore that process 0
hosts at the coordinator's address: NCCL on CUDA, gloo on the CPU.

Usage on each host of an N-process job (one process per card):

    from tbus_torch.parallel import distributed
    distributed.init(coordinator="host0:9999", num_processes=N,
                     process_id=i)
    mesh = distributed.global_mesh(("dp", "tp"))
    # the collectives of tbus_torch.parallel.collective over `mesh` now
    # span every host's cards; the inner axis stays within a host
    # (NVLink), the outer crosses hosts.
    ...
    distributed.shutdown()

:func:`init_store` joins through a Store the caller made (a FileStore
path, say), and :func:`launch_local` runs an n-process gloo (or NCCL)
job on this host, the port's twin of the reference's ``launch_local``.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BACKENDS = ("nccl", "gloo")

# The host this process counts as in global_mesh; launch_local's children
# get a simulated one (host_keys), every other process its hostname.
_host_key: Optional[str] = None


def backend_for(device: str) -> str:
    """The process-group backend for a device type: NCCL for CUDA, gloo for
    the CPU."""
    if device == "cuda":
        return "nccl"
    if device == "cpu":
        return "gloo"
    raise ValueError(f"unknown device {device!r} (cuda or cpu)")


def init_store(rank: int, world: int, store: Union[str, dist.Store],
               backend: str = "nccl") -> None:
    """Joins (or forms) a `world`-process group as `rank` through `store`:
    a path for a FileStore shared by the job's processes, or a Store.
    With NCCL, process `rank` drives the card rank % device_count; NCCL
    without CUDA raises."""
    _check_backend(backend)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if isinstance(store, str):
        store = dist.FileStore(store, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs CUDA and none is "
                           "available (pass backend='gloo' for the CPU)")


def init(coordinator: str, num_processes: int, process_id: int,
         local_device_ids: Optional[Sequence[int]] = None,
         backend: Optional[str] = None) -> None:
    """Joins (or forms) the multi-host job, the reference's form.

    `coordinator` is "host:port" of a TCPStore that process 0 hosts and
    the others reach. `backend` defaults to NCCL, which needs a card and
    raises without one; gloo runs on the CPU. `local_device_ids` names the
    one card this process drives (default: process_id % device_count);
    the CPU ignores it.

    Deliberate difference: with num_processes <= 1 the reference forms
    nothing, while the port forms a one-rank group on the caller's device
    (an in-process store; the coordinator is not contacted), since a
    DeviceMesh needs a process group."""
    backend = backend or "nccl"
    _check_backend(backend)
    if backend == "nccl":
        ids = list(local_device_ids or [])
        if len(ids) > 1:
            raise ValueError(f"local_device_ids {ids}: one process drives "
                             "one card")
        torch.cuda.set_device(ids[0] if ids else
                              process_id % torch.cuda.device_count())
    if num_processes <= 1:
        store: dist.Store = dist.HashStore()
        num_processes, process_id = 1, 0
    else:
        host, _, port = coordinator.rpartition(":")
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes)


def init_single(device: str = "cuda") -> None:
    """A one-process group for `device` (in-process store)."""
    init_store(0, 1, dist.HashStore(), backend_for(device))


def host_key() -> str:
    """The host this process runs on, as global_mesh groups ranks."""
    return _host_key or socket.gethostname()


def _host_keys() -> List[str]:
    """Every rank's host_key(), index = rank, gathered over gloo (a
    transient CPU group where the job runs on NCCL, so nothing of it goes
    through a card)."""
    n = dist.get_world_size()
    if n == 1:
        return [host_key()]
    keys: List[Any] = [None] * n
    if dist.get_backend() == "gloo":
        dist.all_gather_object(keys, host_key())
        return keys
    cpu = dist.new_group(backend="gloo")
    try:
        dist.all_gather_object(keys, host_key(), group=cpu)
    finally:
        dist.destroy_process_group(cpu)
    return keys


def global_mesh(axis_names: Tuple[str, ...] = ("dp", "tp"),
                axis_sizes: Optional[Tuple[int, ...]] = None) -> DeviceMesh:
    """DeviceMesh over EVERY rank of the process group, with the
    reference's rules. Ranks are grouped by host first (hosts in the
    order of their lowest rank, ranks ascending within one), so each
    inner row is host-contiguous. One axis gives (n,); two give
    (hosts, ranks per host), the last axis within a host (NVLink) and
    the first across hosts; more axes need axis_sizes. A product of
    sizes other than the world size raises ValueError. Every rank must
    call it (it gathers the host keys). A rank's coordinate on an axis
    is its rank in that axis's group, which torch orders by global
    rank."""
    n = dist.get_world_size()
    if axis_sizes is None and len(axis_names) > 2:
        raise ValueError("pass axis_sizes explicitly for >2 mesh axes")
    if axis_sizes is not None and math.prod(axis_sizes) != n:
        raise ValueError(f"axis_sizes {tuple(axis_sizes)} != {n} ranks")
    keys = _host_keys()
    first = {}
    for r, k in enumerate(keys):
        first.setdefault(k, r)
    ranks = sorted(range(n), key=lambda r: (first[keys[r]], r))
    if axis_sizes is None:
        per_host = {keys.count(k) for k in first}
        if len(axis_names) == 1:
            axis_sizes = (n,)
        elif len(per_host) == 1:
            local = per_host.pop()
            axis_sizes = (max(1, n // local), min(n, local))
        else:
            raise ValueError(f"hosts hold unequal rank counts "
                             f"{sorted(per_host)}: pass axis_sizes")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(axis_sizes)
    return DeviceMesh(device, layout, mesh_dim_names=tuple(axis_names))


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
distributed._host_key = sys.argv[5] or None
distributed.init_store(rank, world, sys.argv[3], {backend!r})
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
                 timeout_s: float = 180.0,
                 host_keys: Optional[Sequence[str]] = None) -> List[Any]:
    """Runs a `num_processes`-process job on this host and returns every
    process's result, index = rank.

    `body` is Python source that each child executes after it joined the
    group (:func:`init_store`, through a FileStore in a fresh temporary
    directory, so concurrent launches never meet). It sees `rank`, `world`
    and `torch`, and assigns its JSON-serialisable outcome to `result`.
    Each child is a fresh interpreter (``python -c``), so it imports only
    what the body imports. `host_keys` (one per rank) simulates hosts:
    child r counts as on host host_keys[r] in :func:`global_mesh`.

    Children are killed on timeout or as soon as one fails; a nonzero exit
    raises RuntimeError carrying that child's output tail."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    keys = list(host_keys) if host_keys is not None else [""] * num_processes
    if len(keys) != num_processes:
        raise ValueError(f"{len(keys)} host keys for {num_processes} "
                         "processes")
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
                         str(num_processes), store, outs[r], keys[r]],
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
