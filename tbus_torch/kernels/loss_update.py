"""The fan-out step's loss and update: kernels K8a, K8b and K9
(csrc/loss_update.cu) and their plain PyTorch versions.

They replace the rest of the device compute of
tbus/parallel/collective.py:186 make_fanout_step:

- :func:`sumsq` (K8a), the loss ``jnp.sum(y * y)`` (:194): an f32 scalar,
  the sum of squares of y f32 [R, N/tp]. On the card it is one launch: a
  fixed grid takes per-thread f32 sums reduced by warp shuffles into one
  partial a block, and the block that draws the last ticket from an
  integer counter sums the partials in index order, so the same y gives
  the same bits on every call (no float atomics). The partials and the
  counter live in a scratch buffer kept per device and stream
  (:func:`_scratch_for`);
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
kernel or raises. A launch makes one ctypes call: the library's functions
are held here after the first load, the current device is switched only
when the tensor lies on another one, and K8a's scratch is kept between
calls, so that after warm-up a call allocates only its output. K8b and
K9 check their operands with a few attribute reads and raise through the
full checks only where those reads refuse; ``SumSquares.backward``
launches K8b without the checks that autograd and the forward already
hold.
"""

from __future__ import annotations

import math

import torch

# Kernel launches made by this process (bumped only where a kernel is
# launched, never by a plain version).
sumsq_launches = 0
sumsq_grad_launches = 0
sgd_update_launches = 0

_F32 = torch.float32
_F32_OVERFLOW = 2.0**128  # where f32 rounding of a finite value gives inf


def _check(name: str, *ts: torch.Tensor) -> None:
    device = ts[0].device
    for t in ts:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: operands must be f32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: operands on "
                             f"{', '.join(str(t.device) for t in ts)}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


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


# Set by _load() at first use, so that a launch runs no import and builds
# no signature list: the library's entry points, the words of K8a's
# scratch, and PyTorch's getters of the current CUDA device and of the
# raw handle of a device's current stream. Those two are torch._C's own,
# which PyTorch's compiled code calls (~0.2 µs each on the H100's host,
# where torch.accelerator.current_stream() takes 1.1-2.4 µs; PERF.md §7);
# a CPU build of torch lacks them, and the card tests check that the
# installed build has them.
_sumsq = _sumsq_grad = _sgd_update = None
_device = _stream = None
_scratch_words = 0


def _load() -> None:
    global _sumsq, _sumsq_grad, _sgd_update, _device, _stream
    global _scratch_words
    from tbus_torch.kernels import _build

    lib = _build.loss_update_lib()
    _scratch_words = lib.tbus_sumsq_scratch_words()
    _device = torch._C._cuda_getDevice
    _stream = torch._C._cuda_getCurrentRawStream
    _sumsq, _sumsq_grad, _sgd_update = (
        lib.tbus_sumsq, lib.tbus_sumsq_grad, lib.tbus_sgd_update)


# K8a's scratch, one zeroed int32 buffer of _scratch_words per (device,
# stream): word 0 the ticket counter, which the kernel leaves at 0, then
# one partial per block of the largest grid (~4 KiB). Keyed by stream
# too, so that launches running at once on two streams never share a
# counter; a buffer serves its stream's launches in their order. No lock:
# threads racing on one key can at worst each make a buffer, all zeroed.
_scratch = {}


def _scratch_for(device, stream: int) -> torch.Tensor:
    buf = _scratch.get((device, stream))
    if buf is None:
        buf = _scratch[(device, stream)] = torch.zeros(
            _scratch_words, dtype=torch.int32, device=device)
    return buf


def _raise(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def sumsq(y: torch.Tensor) -> torch.Tensor:
    """0-dim f32 sum of y * y. Launches K8a once for a CUDA tensor; the
    plain version serves only the CPU. An empty y gives 0 with no
    launch."""
    global sumsq_launches
    if y.device.type == "cpu":
        return sumsq_reference(y)
    _check("sumsq", y)
    if _sumsq is None:
        _load()
    index = y.get_device()
    if index != _device():
        with torch.cuda.device(index):
            return sumsq(y)
    if not y.is_contiguous():
        y = y.contiguous()
    n = y.numel()
    if n == 0:
        return y.new_zeros(())
    stream = _stream(index)
    out = y.new_empty(())
    _raise("sumsq", _sumsq(y.data_ptr(), out.data_ptr(),
                           _scratch_for(index, stream).data_ptr(), n,
                           stream))
    sumsq_launches += 1
    return out


def sumsq_grad(y: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """2 * (gbar * y) in f32, gbar a 0-dim f32 tensor on y's device.
    Launches K8b for CUDA tensors; the plain version serves only the
    CPU."""
    if (y.is_cuda and y.dtype is _F32 and gbar.dtype is _F32
            and not gbar.dim() and gbar.get_device() == y.get_device()):
        return _sumsq_grad_cuda(y, gbar)
    if y.device.type == "cpu":
        return sumsq_grad_reference(y, gbar)
    _check_grad(y, gbar)  # raises on what the test above refused
    return _sumsq_grad_cuda(y, gbar)


def _sumsq_grad_cuda(y: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """K8b on CUDA operands that hold sumsq_grad's checks: y f32, gbar a
    0-dim f32 tensor on y's device (as autograd hands SumSquares.backward
    its cotangent)."""
    global sumsq_grad_launches
    if _sumsq_grad is None:
        _load()
    index = y.get_device()
    if index != _device():
        with torch.cuda.device(index):
            return _sumsq_grad_cuda(y, gbar)
    if not y.is_contiguous():
        y = y.contiguous()
    dy = torch.empty_like(y)
    n = y.numel()
    if n:
        err = _sumsq_grad(y.data_ptr(), gbar.data_ptr(), dy.data_ptr(), n,
                          _stream(index))
        if err:
            _raise("sumsq_grad", err)
        sumsq_grad_launches += 1
    return dy


def sgd_update(w: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """fma(-f32(lr), g, w) rounded once, a new f32 tensor of w's shape.
    Launches K9 for CUDA tensors; the plain version serves only the
    CPU."""
    global sgd_update_launches
    if not (w.is_cuda and w.dtype is _F32 and g.dtype is _F32
            and g.get_device() == w.get_device() and w.shape == g.shape):
        if w.device.type == "cpu":
            return sgd_update_reference(w, g, lr)
        _check_pair("sgd_update", w, g)  # raises on what was refused
    if _sgd_update is None:
        _load()
    index = w.get_device()
    if index != _device():
        with torch.cuda.device(index):
            return sgd_update(w, g, lr)
    if not w.is_contiguous():
        w = w.contiguous()
    if not g.is_contiguous():
        g = g.contiguous()
    w1 = torch.empty_like(w)
    n = w.numel()
    if n:
        err = _sgd_update(w.data_ptr(), g.data_ptr(), w1.data_ptr(), lr, n,
                          _stream(index))
        if err:
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
        # The forward checked y, and autograd hands back a 0-dim f32
        # cotangent on y's device: on the card K8b launches without
        # sumsq_grad's checks.
        (y,) = ctx.saved_tensors
        if y.is_cuda:
            return _sumsq_grad_cuda(y, gbar)
        return sumsq_grad(y, gbar)
