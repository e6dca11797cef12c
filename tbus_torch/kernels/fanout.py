"""K7, the fused fan-out kernel's wrapper and its plain PyTorch version.

``fanout`` replaces cpp/tpu/native_fanout.cc:166 ``fanout_mlir``, the
device program of the native collective fan-out engine:

- broadcast: u8[bucket] -> u8[n * bucket], row i = f(input, i);
- scatter: u8[n * bucket] -> u8[n * bucket], row i = f(input row i, i);

with f echo, ``x ^ 0xFF`` (xor255) or ``x + (i & 0xFF)`` mod 256
(add_peer_index: the reference's iota is converted to ui8, so it wraps at
256 peers). The kernel lives in tbus_torch/csrc/device_programs.cu
(``tbus_fanout``); the C++ engine (tbus_torch/csrc/cuda_fanout.cc)
launches it through the device runtime, which counts those launches
itself (tbus_torch.rpc.device_stats()["launches"]["fanout"]). The wrapper
launches it on a CUDA tensor and takes the plain version only for a
tensor on the CPU.
"""

from __future__ import annotations

import torch

# Builtin name -> K7's op code (csrc/device_programs.cu).
BUILTINS = {"echo": 0, "xor255": 1, "add_peer_index": 2}

# Kernel launches made by this process through fanout() (bumped only
# where the kernel is launched, never by the plain version).
launches = 0


def _check(x: torch.Tensor, n: int, bucket: int, scatter: bool,
           builtin: str) -> None:
    if builtin not in BUILTINS:
        raise KeyError(f"unknown builtin {builtin!r}")
    if n < 1 or bucket < 1:
        raise ValueError(f"want n >= 1 and bucket >= 1, got {n}, {bucket}")
    want = n * bucket if scatter else bucket
    if x.dtype != torch.uint8 or x.dim() != 1 or x.numel() != want \
            or not x.is_contiguous():
        raise ValueError(f"want a contiguous u8[{want}], got {x.dtype} "
                         f"{tuple(x.shape)}")


def fanout_plain(x: torch.Tensor, n: int, bucket: int, scatter: bool,
                 builtin: str) -> torch.Tensor:
    """Plain PyTorch version of K7, on any device."""
    _check(x, n, bucket, scatter, builtin)
    m = x.view(n, bucket) if scatter else x.view(1, bucket).expand(n, bucket)
    if builtin == "xor255":
        m = m ^ 0xFF
    elif builtin == "add_peer_index":
        peer = (torch.arange(n, device=x.device) & 0xFF).to(torch.uint8)
        m = m + peer[:, None]  # u8 arithmetic wraps mod 256
    else:
        m = m.clone()
    return m.reshape(n * bucket)


def fanout(x: torch.Tensor, n: int, bucket: int, scatter: bool,
           builtin: str) -> torch.Tensor:
    """u8 -> u8[n * bucket]: K7 for a CUDA tensor, the plain version for
    a CPU one."""
    global launches
    _check(x, n, bucket, scatter, builtin)
    if x.device.type == "cpu":
        return fanout_plain(x, n, bucket, scatter, builtin)
    if x.device.type != "cuda":
        raise ValueError(f"fanout: unsupported device {x.device}")
    from tbus_torch.kernels import _build

    out = torch.empty(n * bucket, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.device_programs_lib().tbus_fanout(
            x.data_ptr(), out.data_ptr(), n, bucket, 1 if scatter else 0,
            BUILTINS[builtin],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fanout kernel launch failed: CUDA error {err}")
    launches += 1
    return out
