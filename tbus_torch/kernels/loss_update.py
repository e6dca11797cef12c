"""The fan-out step's loss and update: kernels K8a, K8b and K9
(csrc/loss_update.cu) and their plain PyTorch versions.

They replace the rest of the device compute of
tbus/parallel/collective.py:186 make_fanout_step:

- :func:`sumsq` (K8a), the loss ``jnp.sum(y * y)`` (:194): an f32 scalar,
  the sum of squares of y f32 [R, N/tp]. On the card a fixed grid takes
  per-thread f32 sums reduced by warp shuffles into one partial a block,
  and one more block sums the partials in index order, so the same y
  gives the same bits on every call (no float atomics). A y that fits one
  block's share takes the first launch alone;
- :func:`sumsq_grad` (K8b), its gradient under value_and_grad (:206):
  ``dy = 2 * (gbar * y)`` with the cotangent gbar, a 0-dim f32 tensor read
  from device memory (the step never syncs with the host). The product is
  rounded before it is doubled, as the reference's ``gbar*y + gbar*y`` and
  torch's autograd of ``y * y`` both round it;
- :func:`sgd_update` (K9), the update ``w - 1e-3 * g`` (:207), which XLA
  fuses into one multiply-subtract: ``w1 = fma(-c, g, w)`` with c =
  f32(lr), rounded once, into a new tensor (callers reuse w).

:class:`SumSquares` pairs K8a and K8b as an autograd Function. The plain
versions serve tensors on the CPU; on a CUDA tensor a wrapper launches its
kernel or raises.
"""

from __future__ import annotations

import math

import torch

# Kernel launches made by this process (bumped only where a kernel is
# launched, never by a plain version).
sumsq_launches = 0
sumsq_grad_launches = 0
sgd_update_launches = 0

_F32_OVERFLOW = 2.0**128  # where f32 rounding of a finite value gives inf


def _check(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: operands must be f32, got {t.dtype}")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: operands on "
                         f"{', '.join(str(t.device) for t in ts)}")
    if ts[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {ts[0].device}")


def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    _check(name, a, b)
    if a.shape != b.shape:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")


def _check_grad(y: torch.Tensor, gbar: torch.Tensor) -> None:
    _check("sumsq_grad", y, gbar)
    if gbar.dim() != 0:
        raise ValueError(f"sumsq_grad: gbar must be 0-dim, got "
                         f"{tuple(gbar.shape)}")


def sumsq_reference(y: torch.Tensor) -> torch.Tensor:
    """Plain version of K8a, on any device: 0-dim f32 sum of y * y."""
    _check("sumsq", y)
    return torch.sum(y * y)


def sumsq_grad_reference(y: torch.Tensor,
                         gbar: torch.Tensor) -> torch.Tensor:
    """Plain version of K8b, on any device: 2 * (gbar * y) in f32."""
    _check_grad(y, gbar)
    return 2 * (gbar * y)


def sgd_update_reference(w: torch.Tensor, g: torch.Tensor,
                         lr: float) -> torch.Tensor:
    """Plain version of K9, on any device: fma(-f32(lr), g, w) rounded once
    to f32, as XLA's fused multiply-subtract computes ``w - lr * g``.

    torch has no FMA, so it computes in f64: c * g of two f32 values is
    exact there, and w - c * g rounds once to f64 and again to f32. That
    second rounding differs from a single one only where the f64 result
    lies exactly halfway between two f32 values while the exact result
    does not; there the exact residual of the f64 subtraction (TwoSum)
    says which way to go. Equal to a true single rounding for every finite
    input."""
    _check_pair("sgd_update", w, g)
    c = torch.tensor(lr, dtype=torch.float32).double()
    wd, p = w.double(), c * g.double()
    s = wd - p
    f = s.float()
    fd = f.double()
    # A finite s that rounds to inf lies at or past 2^128, the value one
    # f32 step above the largest finite f32.
    fd = torch.where(torch.isinf(f) & torch.isfinite(s),
                     torch.copysign(torch.full_like(s, _F32_OVERFLOW), s),
                     fd)
    inf = torch.full_like(f, math.inf)
    other = torch.nextafter(f, torch.where(s > fd, inf, -inf))
    tie = (s != fd) & ((fd + other.double()) * 0.5 == s)
    bb = s - wd
    r = (wd - (s - bb)) + (-p - bb)
    return torch.where(tie & (r > 0), torch.maximum(f, other),
                       torch.where(tie & (r < 0), torch.minimum(f, other),
                                   f))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib():
    from tbus_torch.kernels import _build

    return _build.loss_update_lib()


def _raise(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def sumsq(y: torch.Tensor) -> torch.Tensor:
    """0-dim f32 sum of y * y. Launches K8a (one or two launches, counted
    once) for a CUDA tensor; the plain version serves only the CPU. An
    empty y gives 0 with no launch."""
    global sumsq_launches
    if y.device.type == "cpu":
        return sumsq_reference(y)
    _check("sumsq", y)
    lib = _lib()
    y = y.contiguous()
    out = torch.empty((), dtype=torch.float32, device=y.device)
    n = y.numel()
    if n == 0:
        return out.zero_()
    blocks = lib.tbus_sumsq_blocks(n)
    partials = torch.empty((blocks,), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        err = lib.tbus_sumsq(y.data_ptr(), out.data_ptr(),
                             partials.data_ptr(), n, _stream(y))
    _raise("sumsq", err)
    sumsq_launches += 1
    return out


def sumsq_grad(y: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """2 * (gbar * y) in f32, gbar a 0-dim f32 tensor on y's device.
    Launches K8b for CUDA tensors; the plain version serves only the
    CPU."""
    global sumsq_grad_launches
    if y.device.type == "cpu":
        return sumsq_grad_reference(y, gbar)
    _check_grad(y, gbar)
    lib = _lib()
    y, gbar = y.contiguous(), gbar.contiguous()
    dy = torch.empty_like(y)
    if y.numel() == 0:
        return dy
    with torch.cuda.device(y.device):
        err = lib.tbus_sumsq_grad(y.data_ptr(), gbar.data_ptr(),
                                  dy.data_ptr(), y.numel(), _stream(y))
    _raise("sumsq_grad", err)
    sumsq_grad_launches += 1
    return dy


def sgd_update(w: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """fma(-f32(lr), g, w) rounded once, a new f32 tensor of w's shape.
    Launches K9 for CUDA tensors; the plain version serves only the
    CPU."""
    global sgd_update_launches
    if w.device.type == "cpu":
        return sgd_update_reference(w, g, lr)
    _check_pair("sgd_update", w, g)
    lib = _lib()
    w, g = w.contiguous(), g.contiguous()
    w1 = torch.empty_like(w)
    if w.numel() == 0:
        return w1
    with torch.cuda.device(w.device):
        err = lib.tbus_sgd_update(w.data_ptr(), g.data_ptr(), w1.data_ptr(),
                                  lr, w.numel(), _stream(w))
    _raise("sgd_update", err)
    sgd_update_launches += 1
    return w1


class SumSquares(torch.autograd.Function):
    """loss = sumsq(y) (K8a) with dy = sumsq_grad(y, gbar) (K8b) as the
    backward."""

    @staticmethod
    def forward(ctx, y: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(y)
        return sumsq(y)

    @staticmethod
    def backward(ctx, gbar: torch.Tensor) -> torch.Tensor:
        (y,) = ctx.saved_tensors
        return sumsq_grad(y, gbar)
