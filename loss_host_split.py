#!/usr/bin/env python3
"""The host path of the loss wrappers (tbus_torch/kernels/loss_update.py:
K8a sumsq, K8b sumsq_grad, K9 sgd_update) on one NVIDIA card, split by
piece on the host's clock.

For y f32 [4, 16], [16, 16] and [4096, 4096]: each wrapper's and its
library call's enqueue time per call (back-to-back calls with no
synchronise, median of 5 runs), then each piece a wrapper's launch path
can run, timed alone in a loop (median of 5 rounds, µs per call). Pieces
that launch run only where y is small, few enough that the launch queue
never fills.

    python3 loss_host_split.py

chip_smoke.py prints the wrappers' enqueue times on every run; this
script is the split behind them, kept apart from the smoke run.
"""

import subprocess
import sys
import time

import numpy as np


def _enqueue_us(torch, fn, n, warmup=3, rounds=5):
    """Host µs per call over n back-to-back calls with no synchronise,
    the median of `rounds` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        times.append((time.perf_counter_ns() - t0) / n / 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def _enter(ctx):
    with ctx:
        pass


def _median_us(torch, fn, reps, rounds=5):
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter_ns() - t0) / reps / 1e3)
        torch.cuda.synchronize()
    return float(np.median(times))


def split(torch, shape):
    from tbus_torch.kernels import _build, loss_update as lu

    rng = np.random.default_rng(1234)
    y, w, g = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(s)).cuda()
               for s in (1.0, 0.02, 37.0))
    gb = torch.tensor(0.37, device="cuda")
    g2, dy, yv = 2 * gb, torch.empty_like(y), y.view(-1)
    f32 = torch.float32
    lib = _build.loss_update_lib()
    n, index = y.numel(), y.get_device()
    blocks = lib.tbus_sumsq_blocks(n)  # the two-kernel form allocated these
    stream = torch.cuda.current_stream().cuda_stream
    calls = 20 if n > 1e6 else 200
    enqueue = {
        "lu.sumsq": lambda: lu.sumsq(y),
        "lu.sumsq_grad": lambda: lu.sumsq_grad(y, gb),
        "lu.sgd_update": lambda: lu.sgd_update(w, g, 1e-3),
        "torch.dot": lambda: torch.dot(yv, yv),
        "torch.mul": lambda: torch.mul(y, g2),
        "torch.sub": lambda: torch.sub(w, g, alpha=1e-3)}
    # SumSquares.backward's K8b path, past sumsq_grad's checks.
    enqueue["lu._sumsq_grad_cuda"] = lambda: lu._sumsq_grad_cuda(y, gb)
    pieces = {
        "empty loop": lambda: None,
        "_check": lambda: lu._check("sumsq", y),
        "_check_grad": lambda: lu._check_grad(y, gb),
        "_check_pair": lambda: lu._check_pair("sgd_update", w, g),
        "K8b's attribute checks": lambda: (
            y.is_cuda and y.dtype is f32 and gb.dtype is f32
            and not gb.dim() and gb.get_device() == y.get_device()),
        "K9's attribute checks": lambda: (
            w.is_cuda and w.dtype is f32 and g.dtype is f32
            and g.get_device() == w.get_device() and w.shape == g.shape),
        "import + _build.loss_update_lib()": _build.loss_update_lib,
        "y.contiguous()": y.contiguous,
        "y.is_contiguous()": y.is_contiguous,
        "torch.empty(()) on y.device": lambda: torch.empty(
            (), dtype=torch.float32, device=y.device),
        "y.new_empty(())": lambda: y.new_empty(()),
        "torch.empty_like(y)": lambda: torch.empty_like(y),
        "torch.empty((blocks,)) on y.device": lambda: torch.empty(
            (blocks,), dtype=torch.float32, device=y.device),
        "ctypes tbus_sumsq_blocks(n)": lambda: lib.tbus_sumsq_blocks(n),
        "ctypes tbus_sumsq_grad, n 0 (no launch)": lambda: (
            lib.tbus_sumsq_grad(y.data_ptr(), gb.data_ptr(), dy.data_ptr(),
                                0, stream)),
        "ctypes tbus_sgd_update, n 0 (no launch)": lambda: (
            lib.tbus_sgd_update(w.data_ptr(), g.data_ptr(), dy.data_ptr(),
                                1e-3, 0, stream)),
        "with torch.cuda.device(y.device)": lambda: _enter(
            torch.cuda.device(y.device)),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.accelerator.current_device_index()": (
            torch.accelerator.current_device_index),
        "y.get_device()": y.get_device,
        "torch.cuda.current_stream(y.device).cuda_stream": lambda: (
            torch.cuda.current_stream(y.device).cuda_stream),
        "torch.accelerator.current_stream(i).native_handle": lambda: (
            torch.accelerator.current_stream(index).native_handle),
        "torch.accelerator.current_stream() + device_index + native_handle":
            lambda: _stream_once(torch),
        "torch._C._cuda_getCurrentRawStream(i) (private)": lambda: (
            torch._C._cuda_getCurrentRawStream(index)),
        "torch._C._cuda_getDevice() (private)": torch._C._cuda_getDevice,
        "y.data_ptr()": y.data_ptr,
        "y.numel()": y.numel,
        "lu._scratch_for(i, stream)": lambda: lu._scratch_for(index, stream)}
    lu.sumsq(y)  # loads the library and makes this stream's scratch
    if n < 1e6:
        pieces["ctypes tbus_sumsq_grad + its launch"] = lambda: (
            lib.tbus_sumsq_grad(y.data_ptr(), gb.data_ptr(), dy.data_ptr(),
                                n, stream))
        pieces["ctypes tbus_sgd_update + its launch"] = lambda: (
            lib.tbus_sgd_update(w.data_ptr(), g.data_ptr(), dy.data_ptr(),
                                1e-3, n, stream))
    return ({k: _enqueue_us(torch, f, calls) for k, f in enqueue.items()},
            {k: _median_us(torch, f, 200 if "+ its launch" in k else 2000)
             for k, f in pieces.items()})


def _stream_once(torch):
    s = torch.accelerator.current_stream()
    return s.device_index, s.native_handle


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs only on an NVIDIA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    for shape in ((4, 16), (16, 16), (4096, 4096)):
        enqueue, pieces = split(torch, shape)
        print(f"host path at {shape} (µs a call, host clock): enqueue "
              + ", ".join(f"{k} {v:.2f}" for k, v in enqueue.items())
              + f" [{smi}]")
        print(f"host pieces at {shape} (µs a call, median of 5 rounds): "
              + "; ".join(f"{k} {v:.3f}" for k, v in pieces.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
