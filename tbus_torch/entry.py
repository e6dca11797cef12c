"""Entry points of the port: the twin of __graft_entry__.py.

entry(device) -> (step, args): the fan-out step
(tbus_torch.parallel.collective.make_fanout_step) on a (dp, tp) mesh of
every rank of the process group, and this rank's arguments at the
reference's shapes. Without a process group it forms a one-rank group.

dryrun_multichip(n, device): n ranks run the full fan-out step, then ring
attention over an n-position ring, then (rpc=True) a live ParallelChannel
fan-out lowered through the torch backend.

Deliberate differences from the reference: the port is SPMD per process,
so a step takes and returns this rank's shards; and where the reference
re-executes on a virtual CPU mesh when it has fewer devices than asked,
the port runs on the CPU only when the caller passes device="cpu" (n gloo
ranks), and device="cuda" with fewer cards than n raises.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tbus_torch.parallel import collective, distributed, params

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _check_device(device: str) -> None:
    distributed.backend_for(device)  # raises on an unknown device
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' needs an NVIDIA card and none is "
                           "available; pass device='cpu' to run on the CPU")


def make_inputs(dp: int, tp: int, hidden: int = 16, rows: int = 4
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The step's full inputs: w f32[hidden, hidden * tp] * 0.02 and x
    f32[rows * dp, hidden], drawn from np.random.default_rng(0). The
    defaults are the reference's shapes (__graft_entry__.py:_make)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((hidden, hidden * tp), dtype=np.float32)
         * np.float32(0.02))
    x = rng.standard_normal((rows * dp, hidden), dtype=np.float32)
    return w, x


def _make(mesh: DeviceMesh, hidden: int = 16, rows: int = 4
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """The step and this rank's (w shard, x shard) of make_inputs."""
    w, x = make_inputs(mesh["dp"].size(), mesh["tp"].size(), hidden, rows)
    return collective.make_fanout_step(mesh), (
        params.shard_from_jax(w, mesh), params.local_rows(x, mesh, "dp"))


def entry(device: str = "cuda"
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """(step, (w_shard, x_shard)) for this rank, on `device`."""
    _check_device(device)
    if not dist.is_initialized():
        distributed.init_single(device)
    world = dist.get_world_size()
    return _make(collective.default_mesh(world, device))


def _dryrun_rank(world: int, device: str) -> Dict[str, Any]:
    """One rank's part of dryrun_multichip (runs inside launch_local)."""
    step, (w, x) = _make(collective.default_mesh(world, device))
    loss, w1 = step(w, x)
    if w1.shape != w.shape or not torch.isfinite(loss):
        raise AssertionError(f"fan-out step: w1 {tuple(w1.shape)} for "
                             f"{tuple(w.shape)}, loss {float(loss)}")

    # Sequence parallelism: ring attention over all ranks.
    ring = init_device_mesh(device, (world,), mesh_dim_names=("sp",))
    attn = collective.make_ring_attention(ring, "sp")
    seq, dim = world * 8, 16
    rng = np.random.default_rng(1)
    q, k, v = (params.local_rows(
        rng.standard_normal((seq, dim), dtype=np.float32), ring, "sp")
        for _ in range(3))
    out = attn(q, k, v)
    if tuple(out.shape) != (8, dim) or not torch.isfinite(out).all():
        raise AssertionError(f"ring attention: {tuple(out.shape)}")
    return {"rank": dist.get_rank(), "loss": float(loss),
            "w1_shape": list(w1.shape), "attn_shape": list(out.shape),
            "w1": w1.tolist(), "attn": out.tolist(),
            "ring_rotations": collective.ring_rotations}


_RPC_LEG = r"""
import sys
sys.path.insert(0, {root!r})
import tbus_torch as tt

n = {n}
tt.init()
# Advertise before any client connects: adverts ride the handshake.
tt.advertise_device_method("EchoService", "Echo", "echo/v1")
servers = []
pchan = tt.ParallelChannel()
for _ in range(n):
    s = tt.Server()
    s.add_echo()
    servers.append(s)
    pchan.add(f"tpu://127.0.0.1:{{s.start(0)}}")
assert pchan.collective_eligible
payload = b"dryrun-multichip"
assert pchan.call("EchoService", "Echo", payload) == payload * n
assert tt.enable_torch_fanout(), "torch fan-out backend failed to enable"
assert tt.register_device_echo("EchoService", "Echo")
before = tt.torch_lowered_calls()
assert pchan.call("EchoService", "Echo", payload) == payload * n
assert tt.torch_lowered_calls() > before, "fan-out was not lowered"
for s in servers:
    s.stop()
print("RPC-LEG-OK", flush=True)
"""


def _rpc_leg(n: int, device: str, timeout_s: float) -> None:
    """The live lowered fan-out, in a child process: the fan-out backend
    is one per process, and installing it here would reroute the caller's
    later calls."""
    env = dict(os.environ,
               TBUS_FANOUT_MESH="host" if device == "cpu" else "device")
    proc = subprocess.run(
        [sys.executable, "-c", _RPC_LEG.format(root=_REPO, n=n)],
        capture_output=True, text=True, timeout=timeout_s, env=env)
    if proc.returncode != 0 or "RPC-LEG-OK" not in proc.stdout:
        raise RuntimeError(f"dryrun RPC leg failed ({proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def dryrun_multichip(n_devices: int, device: str = "cuda", rpc: bool = True,
                     timeout_s: float = 300.0) -> List[Dict[str, Any]]:
    """Runs the fan-out step and ring attention on n ranks (n gloo
    processes on the CPU, or n NCCL processes on n cards), then, with
    `rpc`, the live lowered fan-out over n servers. Returns each rank's
    summary."""
    _check_device(device)
    if device == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on cuda needs {n_devices} cards "
            f"and this host has {torch.cuda.device_count()}; pass "
            f"device='cpu' for {n_devices} gloo ranks")
    body = ("from tbus_torch import entry\n"
            f"result = entry._dryrun_rank(world, {device!r})\n")
    results = distributed.launch_local(
        body, n_devices, distributed.backend_for(device), timeout_s)
    if rpc:
        _rpc_leg(n_devices, device, timeout_s)
    return results
