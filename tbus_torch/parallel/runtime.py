"""Execution runtime for the lowered combo-channel fan-out, on CUDA.

The port of tbus/parallel/runtime.py. The C++ CollectiveFanout bridge
(tbus_torch/csrc/torch_fanout.cc) calls :func:`broadcast_gather` or
:func:`broadcast_gather_batch` on its executor thread; the payload goes to
every mesh position, each position computes its peers' rows with the
row-transform kernel on its own device, and the rows are gathered back to
the host in the reference's ``[B, positions * rows_per_pos, L]`` layout.

Positions are ``min(n_peers, torch.cuda.device_count())`` CUDA devices,
each serving ``rows_per_pos = ceil(n_peers / positions)`` peers.

Mesh kinds (``TBUS_FANOUT_MESH`` or the ``mesh`` argument, which wins):

- ``auto`` (default) and ``device``: CUDA. Unlike the reference, ``auto``
  does not send host-local peers to a CPU mesh: the reference did so for
  a TPU tunnel's per-dispatch cost, which a local card does not have. A
  device call on a machine without CUDA raises; it never drops to the CPU.
- ``host``: the CPU, through the kernel's plain version, only when the
  caller asks for it, over :data:`HOST_POSITIONS` positions (the
  reference's host mesh size), so the gathered layout matches it.

Semantics guard: only methods with a REGISTERED device implementation
lower, and the C++ side additionally requires every peer to have
advertised the same impl id during the transport handshake.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tbus_torch.kernels.row_transform import (
    payload_mask, row_transform)

HOST_POSITIONS = 8

_lock = threading.Lock()
# (service, method) -> (fn, impl_id, builtin name or None). fn(rows:
# u8[R, L], peer_index: i32[R]) -> u8[R, L]; None = identity.
_device_methods: Dict[Tuple[str, str],
                      Tuple[Optional[Callable], str, Optional[str]]] = {}
lowered_calls = 0  # observability: bumped per executed fan-out call
batch_launches = 0  # fused executions (broadcast_gather_batch calls)
_test_delay_ms = 0  # test hook: simulates a wedged device backend (the
                    # deadline test sets it; the entry points sleep that
                    # long so the C++ executor-side timeout can fire)

# Named builtins registrable from C++ clients: shape-preserving u8
# transforms with a server-handler twin in tbus_torch/rpc.py:
# builtin_handler, so lowered and p2p results are byte-identical. These
# plain versions document the arithmetic; registered builtins always run
# through the row-transform kernel (its plain version on the CPU).
BUILTINS: Dict[str, Optional[Callable]] = {
    "echo": None,
    "xor255": lambda rows, idx: rows ^ 0xFF,
    "add_peer_index": lambda rows, idx: rows + (idx & 0xFF).to(
        torch.uint8)[:, None],
}


def register_device_method(service: str, method: str,
                           fn: Optional[Callable],
                           impl_id: str = "") -> None:
    """Registers the device computation for a service method.

    ``fn(rows: u8[R, L], peer_index: i32[R]) -> u8[R, L]`` works on a batch
    of rows on the rows' device; ``fn=None`` registers the identity (echo),
    and a value of :data:`BUILTINS` registers that builtin, which runs
    through the kernel. ``impl_id`` names the implementation version;
    lowering additionally requires every peer's server to have advertised
    the SAME impl id. A CUSTOM fn requires an explicit impl_id; only the
    identity carries the default "echo/v1".
    """
    if not impl_id:
        if fn is not None:
            raise ValueError(
                "register_device_method: custom fns require an explicit "
                "impl_id (it must match what the peers' servers advertise)")
        impl_id = "echo/v1"
    builtin = next((k for k, v in BUILTINS.items() if v is fn), None)
    with _lock:
        _device_methods[(service, method)] = (fn, impl_id, builtin)
    sync_native()


def sync_native() -> None:
    """Mirrors the registered impl ids into the C++ core's lowering check
    (CanLower reads a C++ map so it never takes the GIL on a fiber
    worker), if this process has loaded the core. Pure-torch use of this
    module never loads or builds it; enabling the torch fan-out backend
    loads it and syncs."""
    from tbus_torch import _native

    lib = _native.loaded()
    if lib is None:
        return
    with _lock:
        entries = [(k, v[1]) for k, v in _device_methods.items()]
    for (service, method), impl_id in entries:
        lib.tbus_set_device_impl_id(
            service.encode(), method.encode(), impl_id.encode())


def register_builtin(service: str, method: str, builtin: str,
                     impl_id: str) -> None:
    """Registers a named builtin transform (BUILTINS)."""
    if builtin not in BUILTINS:
        raise KeyError(f"unknown builtin device fn {builtin!r}")
    register_device_method(service, method, BUILTINS[builtin], impl_id)


def device_impl_id(service: str, method: str) -> str:
    """Registered impl id, or '' if the method has no device impl."""
    with _lock:
        entry = _device_methods.get((service, method))
        return entry[1] if entry is not None else ""


def mesh_kind(all_local: bool, mesh: Optional[str] = None) -> str:
    """"device" or "host". ``mesh`` (else TBUS_FANOUT_MESH, else "auto")
    decides; unlike the reference, ``all_local`` does not."""
    del all_local
    mode = mesh or os.environ.get("TBUS_FANOUT_MESH", "auto")
    if mode == "host":
        return "host"
    if mode in ("auto", "device"):
        return "device"
    raise ValueError(f"unknown fan-out mesh kind {mode!r}")


def positions(kind: str, n_peers: int) -> List[torch.device]:
    """The mesh positions for a fan-out to n_peers peers."""
    if n_peers < 1:
        raise ValueError(f"fan-out needs at least one peer, got {n_peers}")
    if kind == "host":
        return [torch.device("cpu")] * min(n_peers, HOST_POSITIONS)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device fan-out mesh needs CUDA and none is available "
            "(TBUS_FANOUT_MESH=host runs on the CPU)")
    n = min(n_peers, torch.cuda.device_count())
    return [torch.device("cuda", i) for i in range(n)]


def _pad_len(n: int) -> int:
    """4-byte length prefix + payload, rounded to a bounded set of size
    classes (powers of two and 1.5x steps) so waste stays <= 33%."""
    need = n + 4
    if need <= 128:
        return 128
    p = 128
    while p < need:
        if p + p // 2 >= need:
            return p + p // 2
        p *= 2
    return p


def _position_rows(entry, rows: torch.Tensor, pos: int,
                   rows_per_pos: int) -> torch.Tensor:
    """u8[B, L] on one position's device -> its peers' u8[B, rpp, L]."""
    fn, _impl, builtin = entry
    if builtin is not None:
        return row_transform(rows, pos, rows_per_pos, builtin)
    b, length = rows.shape
    rep = rows.unsqueeze(1).expand(b, rows_per_pos, length)
    idx = pos * rows_per_pos + torch.arange(
        rows_per_pos, dtype=torch.int32, device=rows.device)
    t = fn(rep.reshape(b * rows_per_pos, length), idx.repeat(b))
    t = t.reshape(b, rows_per_pos, length)
    return torch.where(payload_mask(rows)[:, None, :], t, rep)


def _fanout(service: str, method: str, rows: np.ndarray, n_peers: int,
            kind: str) -> np.ndarray:
    """Broadcast u8[B, L] to every position, transform, gather:
    returns u8[B, positions * rows_per_pos, L] on the host."""
    with _lock:
        entry = _device_methods.get((service, method))
    if entry is None:
        raise KeyError(f"no device method for {service}.{method}")
    devs = positions(kind, n_peers)
    rows_per_pos = (n_peers + len(devs) - 1) // len(devs)
    host = torch.from_numpy(rows)
    parts = [_position_rows(entry, host.to(dev), pos, rows_per_pos)
             for pos, dev in enumerate(devs)]
    # The gather: every position's rows, in position order, on the host.
    if len(parts) == 1:
        return parts[0].cpu().numpy()
    return torch.cat([p.cpu() for p in parts], dim=1).numpy()


def _encode(payloads: List[bytes], bsz: int, length: int) -> np.ndarray:
    rows = np.zeros((bsz, length), dtype=np.uint8)
    for b, p in enumerate(payloads):
        rows[b, :4] = np.frombuffer(
            np.uint32(len(p)).tobytes(), dtype=np.uint8)
        rows[b, 4: 4 + len(p)] = np.frombuffer(p, dtype=np.uint8)
    return rows


def _decode(out: np.ndarray, n_peers: int, length: int) -> List[bytes]:
    results: List[bytes] = []
    for i in range(n_peers):
        r = out[i]
        n = int(np.frombuffer(r[:4].tobytes(), dtype=np.uint32)[0])
        n = min(n, length - 4)
        results.append(r[4: 4 + n].tobytes())
    return results


def broadcast_gather(
    service: str,
    method: str,
    payload: bytes,
    n_peers: int,
    timeout_ms: int,
    all_local: bool = True,
    mesh: Optional[str] = None,
) -> List[bytes]:
    """Broadcast `payload` to every peer position, apply the device
    method, gather every position's response. Returns one bytes per peer.

    Runs on the bridge's executor thread, which enforces the RPC deadline
    (it abandons a job past it); timeout_ms is accepted for parity."""
    global lowered_calls
    del timeout_ms
    if _test_delay_ms:
        time.sleep(_test_delay_ms / 1e3)
    kind = mesh_kind(all_local, mesh)
    length = _pad_len(len(payload))
    out = _fanout(service, method, _encode([payload], 1, length), n_peers,
                  kind)
    results = _decode(out[0], n_peers, length)
    with _lock:
        lowered_calls += 1
    return results


def broadcast_gather_batch(
    service: str,
    method: str,
    payloads: List[bytes],
    n_peers: int,
    timeout_ms: int,
    all_local: bool = True,
    mesh: Optional[str] = None,
) -> List[List[bytes]]:
    """B independent broadcast_gather calls fused into one execution (one
    kernel launch per position for the whole batch). The batch is padded
    to the next power of two, as the reference pads it; padding rows are
    zero-length and their outputs dropped."""
    global lowered_calls, batch_launches
    del timeout_ms
    if _test_delay_ms:
        time.sleep(_test_delay_ms / 1e3)
    kind = mesh_kind(all_local, mesh)
    length = _pad_len(max(len(p) for p in payloads))
    bsz = 1
    while bsz < len(payloads):
        bsz *= 2
    out = _fanout(service, method, _encode(payloads, bsz, length), n_peers,
                  kind)
    all_results = [_decode(out[b], n_peers, length)
                   for b in range(len(payloads))]
    with _lock:
        lowered_calls += len(payloads)
        batch_launches += 1
    return all_results
