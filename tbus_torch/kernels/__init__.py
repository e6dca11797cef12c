"""Kernels written by hand for Hopper, each module holding one kernel's
wrapper (with its launch counter) beside its plain PyTorch version."""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch

# The kernels' input dtype codes (csrc: 0 = f32, 1 = bf16).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@contextlib.contextmanager
def ieee_fp32() -> Iterator[None]:
    """Full-f32 matrix products inside the block: TF32 off for cuBLAS and
    cuDNN (the plain versions restate the reference's f32 arithmetic, which
    TF32's 10-bit mantissa is not), restored on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def split3_reference(a: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact split of f32 values into three bf16 terms (hi, mid, lo),
    as csrc/gemm_sm90.cuh split3 computes it: hi = bf16_rn(a), mid =
    bf16_rn(a - hi), lo = bf16_rn(a - hi - mid), both differences exact in
    f32. hi + mid + lo == a for every finite a with |a| >= 2^-110 (lo's
    last bit stays above bf16's least subnormal, 2^-133); below that, lo
    rounds as a bf16 subnormal, off by at most 2^-134. A finite a whose
    bf16_rn overflows takes hi = bf16_rz(a), so the split stays exact;
    +-inf splits to (+-inf, 0, 0) and NaN to (NaN, 0, 0)."""
    a = a.float()
    hi = a.bfloat16()
    over = torch.isinf(hi) & torch.isfinite(a)
    if bool(over.any()):
        rz = (a.view(torch.int32) & -65536).view(torch.float32).bfloat16()
        hi = torch.where(over, rz, hi)
    hf = hi.float()
    r = torch.where(torch.isfinite(hf), a - hf, torch.zeros_like(a))
    mid = r.bfloat16()
    lo = (r - mid.float()).bfloat16()
    return hi, mid, lo
