"""Kernels written by hand for Hopper, each module holding one kernel's
wrapper (with its launch counter) beside its plain PyTorch version."""

from __future__ import annotations

import contextlib
from typing import Iterator

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
