"""Carries the fan-out step's parameters between the reference and the port.

The reference's step takes the full w f32[K, N] sharded on the tp axis by
its shard_map; the port's step takes each rank's shard. The one parameter
is w; x is data, sharded on dp by :func:`local_rows`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from tbus_torch.parallel.collective import gather_merge


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of `mesh` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _block(n: int, mesh: DeviceMesh, axis: str):
    size = mesh[axis].size()
    if n % size:
        raise ValueError(f"{n} does not split evenly over {axis} ({size})")
    j, width = mesh.get_local_rank(axis), n // size
    return slice(j * width, (j + 1) * width)


def shard_from_jax(w: np.ndarray, mesh: DeviceMesh,
                   axis: str = "tp") -> torch.Tensor:
    """This rank's columns of the reference's full w [K, N] (as numpy):
    w[:, j*N/tp : (j+1)*N/tp] for tp index j, on the mesh's device."""
    cols = np.ascontiguousarray(w[:, _block(w.shape[1], mesh, axis)])
    return torch.from_numpy(cols).to(mesh_device(mesh))


def local_rows(a: np.ndarray, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This rank's block of rows of data sharded on `axis` (the reference's
    PartitionSpec(axis, None)), on the mesh's device."""
    rows = np.ascontiguousarray(a[_block(a.shape[0], mesh, axis)])
    return torch.from_numpy(rows).to(mesh_device(mesh))


def gather_to_numpy(w_shard: torch.Tensor, mesh: DeviceMesh,
                    axis: str = "tp") -> np.ndarray:
    """The full w [K, N] from every tp rank's shard, on every rank."""
    full = gather_merge(w_shard.T.contiguous(), mesh.get_group(axis)).T
    return full.cpu().numpy()
