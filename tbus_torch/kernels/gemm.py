"""The fan-out step's matrix products: kernels K1 and K2 (csrc/gemm_bf16.cu)
and their plain PyTorch versions.

They replace the device compute of tbus/parallel/collective.py:186
make_fanout_step.shard_body:

- :func:`matmul_bf16_f32` (K1), ``dot(bf16(x), bf16(w),
  preferred_element_type=f32)`` (:188-189): x [M, K] and w [K, N], f32 or
  bf16, rounded to bf16, multiplied exactly, summed in f32, f32 [M, N] out.
  On the card it is two launches: a pack of both operands into bf16
  K-major scratch padded to the GEMM's tile (:func:`pack_reference` is its
  plain version), then the TMA + wgmma GEMM of csrc/gemm_sm90.cuh;
- :func:`dw_f32_bf16` (K2), its transpose for w: ``bf16(bf16(x)^T . dy)``
  as f32 [K, N], with dy kept in f32 (the reference's jaxpr rounds dW, not
  dy, to bf16). On the card it is two launches: a pack of bf16(x)^T and of
  dy^T split exactly into three bf16 terms (:func:`dw_pack_reference` is
  its plain version), then one GEMM of the same mainloop over the three
  terms, whose epilogue rounds each sum to bf16.

:class:`BF16Matmul` pairs them as an autograd Function (the gradient is
taken for w only, as the reference's value_and_grad is). The plain
versions run their f32 products with TF32 off.
"""

from __future__ import annotations

import ctypes

import torch

from tbus_torch.kernels import DTYPE_CODES, ieee_fp32, split3_reference

# Kernel launches made by this process (bumped only where a kernel is
# launched, never by a plain version).
matmul_launches = 0
dw_launches = 0

_MAX_DIM = 2**31 - 1

# The shared GEMM's tile (csrc/gemm_sm90.cuh: kCluster blocks of kBM rows,
# kBN columns, kBK deep), for the plain pack. The kernel takes its scratch
# shape from C (tbus_gemm_padded); tests hold this copy to the header.
TILE = (256, 256, 64)


def _round_up(v: int, to: int) -> int:
    return max(1, -(-v // to)) * to


def padded_shape(m: int, k: int, n: int, tile=TILE):
    """(Mp, Kp, Np): M, K, N rounded up to the tile (at least one)."""
    bm, bn, bk = tile
    return _round_up(m, bm), _round_up(k, bk), _round_up(n, bn)


def _check(name: str, a: torch.Tensor, b: torch.Tensor, inner: int) -> None:
    for t in (a, b):
        if t.dim() != 2 or t.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: operands must be 2-D f32 or bf16, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if max(t.shape, default=0) > _MAX_DIM:
            raise ValueError(f"{name}: dimension over 2^31 - 1")
    if a.shape[inner] != b.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a.device}")


def matmul_bf16_f32_reference(x: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """Plain version of K1, on any device."""
    _check("matmul_bf16_f32", x, w, 1)
    with ieee_fp32():
        return x.bfloat16().float() @ w.bfloat16().float()


def pack_reference(x: torch.Tensor, w: torch.Tensor, tile=TILE):
    """Plain version of K1's pack: (xb [Mp, Kp], wtb [Np, Kp]), bf16(x) and
    bf16(w)^T (round to nearest even), zero-padded to the tile."""
    _check("matmul_bf16_f32", x, w, 1)
    (m, k), n = x.shape, w.shape[1]
    mp, kp, np_ = padded_shape(m, k, n, tile)
    xb = torch.zeros((mp, kp), dtype=torch.bfloat16, device=x.device)
    wtb = torch.zeros((np_, kp), dtype=torch.bfloat16, device=x.device)
    xb[:m, :k] = x.bfloat16()
    wtb[:n, :k] = w.bfloat16().T
    return xb, wtb


def _check_dw(x: torch.Tensor, dy: torch.Tensor) -> None:
    _check("dw_f32_bf16", x, dy, 0)
    if dy.dtype != torch.float32:
        raise ValueError(f"dw_f32_bf16: dy must be f32, got {dy.dtype}")


def dw_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of K2, on any device."""
    _check_dw(x, dy)
    with ieee_fp32():
        return (x.bfloat16().float().T @ dy).bfloat16().float()


def dw_pack_reference(x: torch.Tensor, dy: torch.Tensor, tile=TILE):
    """Plain version of K2's pack: (at [Kp, Mq], bt [Np, 3 Mq]) with
    (Kp, Mq, Np) = padded_shape(K, M, N): at = bf16(x)^T and bt = [lo^T |
    mid^T | hi^T], dy^T's exact split (:func:`split3_reference`), smallest
    term first, each zero-padded to Mq columns. The GEMM sums
    at . bt[:, i Mq:(i + 1) Mq]^T over the three terms."""
    _check_dw(x, dy)
    (m, k), n = x.shape, dy.shape[1]
    kp, mq, np_ = padded_shape(k, m, n, tile)
    at = torch.zeros((kp, mq), dtype=torch.bfloat16, device=x.device)
    bt = torch.zeros((np_, 3 * mq), dtype=torch.bfloat16, device=x.device)
    at[:k, :m] = x.bfloat16().T
    hi, mid, lo = split3_reference(dy)
    for i, term in enumerate((lo, mid, hi)):
        bt[:n, i * mq:i * mq + m] = term.T
    return at, bt


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _padded(lib, m: int, k: int, n: int):
    """The mainloop's operand shape for an m x k by k x n product, from C
    (tbus_gemm_padded): (Mp, Kp, Np)."""
    dims = (ctypes.c_longlong * 3)()
    lib.tbus_gemm_padded(m, k, n, dims)
    return tuple(dims)


def matmul_bf16_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 [M, N] = bf16(x) . bf16(w), summed in f32. Launches K1 (pack,
    then GEMM; counted once) for CUDA tensors; the plain version serves
    only tensors on the CPU."""
    if x.device.type == "cpu":
        return matmul_bf16_f32_reference(x, w)
    return matmul_bf16_f32_packed(x, w)[0]


def matmul_bf16_f32_packed(x: torch.Tensor, w: torch.Tensor):
    """K1 on CUDA tensors, its scratch kept: (y, xb, wtb), where y is
    matmul_bf16_f32's result and xb, wtb the operands as the pack kernel
    wrote them (:func:`pack_reference` is their plain version)."""
    global matmul_launches
    _check("matmul_bf16_f32", x, w, 1)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_bf16_f32_packed: needs CUDA tensors, got "
                         f"{x.device}")
    from tbus_torch.kernels import _build

    lib = _build.gemm_lib()
    x, w = x.contiguous(), w.contiguous()
    (m, k), n = x.shape, w.shape[1]
    mp, kp, np_ = _padded(lib, m, k, n)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    xb = torch.empty((mp, kp), dtype=torch.bfloat16, device=x.device)
    wtb = torch.empty((np_, kp), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tbus_matmul_bf16_f32(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), xb.data_ptr(),
            wtb.data_ptr(), m, n, k, mp, np_, kp, DTYPE_CODES[x.dtype],
            DTYPE_CODES[w.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"matmul_bf16_f32 kernel launch failed: CUDA "
                           f"error {err}")
    matmul_launches += 1
    return y, xb, wtb


def dw_f32_bf16(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """f32 [K, N] = bf16_round(bf16(x)^T . dy) for x [M, K] (f32 or bf16)
    and dy f32 [M, N]. Launches K2 (pack, then GEMM; counted once) for
    CUDA tensors; the plain version serves only tensors on the CPU."""
    if x.device.type == "cpu":
        return dw_reference(x, dy)
    return dw_f32_bf16_packed(x, dy)[0]


def dw_f32_bf16_packed(x: torch.Tensor, dy: torch.Tensor):
    """K2 on CUDA tensors, its scratch kept: (dw, at, bt), where dw is
    dw_f32_bf16's result and at, bt the operands as the pack kernel wrote
    them (:func:`dw_pack_reference` is their plain version)."""
    global dw_launches
    _check_dw(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"dw_f32_bf16_packed: needs CUDA tensors, got "
                         f"{x.device}")
    from tbus_torch.kernels import _build

    lib = _build.gemm_lib()
    x, dy = x.contiguous(), dy.contiguous()
    (m, k), n = x.shape, dy.shape[1]
    kp, mq, np_ = _padded(lib, k, m, n)
    dw = torch.empty((k, n), dtype=torch.float32, device=x.device)
    at = torch.empty((kp, mq), dtype=torch.bfloat16, device=x.device)
    bt = torch.empty((np_, 3 * mq), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tbus_dw_f32_bf16(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), at.data_ptr(),
            bt.data_ptr(), m, k, n, kp, mq, np_, DTYPE_CODES[x.dtype],
            _stream(x))
    if err != 0:
        raise RuntimeError(f"dw_f32_bf16 kernel launch failed: CUDA error "
                           f"{err}")
    dw_launches += 1
    return dw, at, bt


class BF16Matmul(torch.autograd.Function):
    """y = matmul_bf16_f32(x, w) with dW = dw_f32_bf16(x, dy) as the
    backward. x takes no gradient (the reference differentiates w only)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if x.requires_grad:
            raise ValueError("BF16Matmul: x takes no gradient")
        ctx.save_for_backward(x)
        return matmul_bf16_f32(x, w)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        (x,) = ctx.saved_tensors
        return None, dw_f32_bf16(x, dy)
