"""Per-peer row transform of a lowered fan-out: the CUDA kernel's wrapper
and its plain PyTorch version.

``row_transform(rows, pos, rpp, builtin)`` maps u8[B, L] to u8[B, rpp, L]:
row b, peer r of mesh position ``pos`` gets the builtin applied to the
payload columns 4 <= c < 4 + n_b (n_b = the little-endian u32 in bytes
0..3 of row b); the length prefix and the padding pass through. It is the
port of tbus/parallel/runtime.py:_row_transform for a whole batch in one
launch. The kernel is csrc/row_transform.cu.
"""

from __future__ import annotations

import torch

# Builtin name -> the kernel's code (csrc/row_transform.cu enum Builtin).
BUILTIN_CODES = {"echo": 0, "xor255": 1, "add_peer_index": 2}

# Kernel launches made by this process (bumped only where the kernel is
# launched, never by the plain version).
launches = 0

_MAX_ROWS = 65535  # grid.y


def _check(rows: torch.Tensor, pos: int, rpp: int, builtin: str) -> None:
    if builtin not in BUILTIN_CODES:
        raise KeyError(f"unknown builtin {builtin!r}")
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(
            f"rows must be u8[B, L], got {rows.dtype} {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    b, length = rows.shape
    if length % 16 or length >= 2**31 or b > _MAX_ROWS:
        raise ValueError(
            f"rows of shape {tuple(rows.shape)}: L must be a multiple of 16 "
            f"below 2^31 and B at most {_MAX_ROWS}")
    if rpp < 1 or pos < 0:
        raise ValueError(f"need rpp >= 1 and pos >= 0, got {rpp}, {pos}")


def payload_mask(rows: torch.Tensor) -> torch.Tensor:
    """bool[B, L]: True on the payload columns 4 <= c < 4 + n_b of each row,
    where n_b is the row's little-endian u32 length prefix."""
    n = rows[:, :4].to(torch.int64)
    n = n[:, 0] | (n[:, 1] << 8) | (n[:, 2] << 16) | (n[:, 3] << 24)
    end = (n + 4) & 0xFFFFFFFF  # u32 wrap, as the reference computes it
    col = torch.arange(rows.shape[1], device=rows.device)
    return (col[None, :] >= 4) & (col[None, :] < end[:, None])


def row_transform_reference(rows: torch.Tensor, pos: int, rpp: int,
                            builtin: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    _check(rows, pos, rpp, builtin)
    b, length = rows.shape
    out = rows.unsqueeze(1).expand(b, rpp, length).clone()
    if builtin == "echo":
        return out
    mask = payload_mask(rows)
    if builtin == "xor255":
        t = out ^ 0xFF
    else:
        idx = (pos * rpp + torch.arange(rpp, device=rows.device)) & 0xFF
        t = out + idx.to(torch.uint8)[None, :, None]
    return torch.where(mask[:, None, :], t, out)


def row_transform(rows: torch.Tensor, pos: int, rpp: int,
                  builtin: str) -> torch.Tensor:
    """u8[B, L] -> u8[B, rpp, L]. Launches the CUDA kernel for a CUDA
    tensor; the plain version serves only tensors on the CPU."""
    global launches
    _check(rows, pos, rpp, builtin)
    if rows.device.type == "cpu":
        return row_transform_reference(rows, pos, rpp, builtin)
    if rows.device.type != "cuda":
        raise ValueError(f"row_transform: unsupported device {rows.device}")
    if rows.data_ptr() % 16:
        raise ValueError("row_transform: rows must be 16-byte aligned")
    from tbus_torch.kernels import _build

    lib = _build.row_transform_lib()
    b, length = rows.shape
    out = torch.empty((b, rpp, length), dtype=torch.uint8, device=rows.device)
    if b == 0:
        return out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.tbus_row_transform(
            rows.data_ptr(), out.data_ptr(), b, length, rpp, pos,
            BUILTIN_CODES[builtin], stream)
    if err != 0:
        raise RuntimeError(f"row_transform kernel launch failed: CUDA error {err}")
    launches += 1
    return out
