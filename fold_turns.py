#!/usr/bin/env python3
"""K3 (ring attention's fold, tbus_torch/kernels/ring_fold.py) of two or
more source trees, timed in turns on one NVIDIA card.

Each tree runs in a child process of its own, in the order given, which
imports that tree's ``tbus_torch`` and builds its ring-fold library from
that tree's sources. Per shape (lq = lk = 8192; d 128 and 256, and 320
and 512 past the resident-q kernels; f32 and bf16 inputs) a child
checks one fold's o / l against the plain version (2e-5), times
back-to-back folds into one carry on CUDA events, and reads each device
kernel's time a fold from torch.profiler (the parts: pack, fold and,
where it runs, combine; or the one kernel of a design that launches
one).

    python3 fold_turns.py TREE [TREE ...]

Compare two trees in turns (A, B, B, A): ``python3 fold_turns.py
old new new old``. Prints one line a tree and shape, then the card's name
and power limit; writes every number to chiprun_out/fold_turns.json.
"""

import json
import math
import os
import re
import subprocess
import sys

SHAPES = [(8192, 8192, 128), (8192, 8192, 256), (8192, 8192, 320),
          (8192, 8192, 512)]
ITERS = 10
SEED = 1234


def _cuda_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_ms(torch, fn, n):
    """Device ms a call of each kernel fn() launches (name -> ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def child(tree):
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != os.path.dirname(
                                os.path.abspath(__file__))]
    import numpy as np
    import torch

    from tbus_torch.kernels import ring_fold as rf

    if not os.path.abspath(rf.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {rf.__file__}, not from {tree}")
    rows = []
    for lq, lk, d in SHAPES:
        rng = np.random.default_rng(SEED + d)
        base = [torch.from_numpy(rng.standard_normal(
            (n, d), dtype=np.float32)).cuda() for n in (lq, lk, lk)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in base)

            def carry():
                return (torch.full((lq,), -math.inf, device="cuda"),
                        torch.zeros((lq,), device="cuda"),
                        torch.zeros((lq, d), device="cuda"))

            m, l, o = carry()
            rf.fold_(q, k, v, m, l, o)
            pm, pl, po = rf.fold_reference(q, k, v, *carry())
            got, want = o / l[:, None], po / pl[:, None]
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
            del pm, pl, po, got, want
            c = carry()
            ms = _cuda_ms(torch, lambda: rf.fold_(q, k, v, *c), ITERS)
            parts = _kernel_ms(torch, lambda: rf.fold_(q, k, v, *c), 3)
            rows.append({"tree": tree, "shape": [lq, lk, d],
                         "dtype": str(dtype)[6:], "ms": ms,
                         "max_abs_err": err, "parts_ms": parts})
    print(json.dumps(rows), flush=True)
    return 0


def _short(kernel):
    """A kernel's name from the profiler's key, without its parameters."""
    kernel = re.sub(r"^void |\(anonymous namespace\)::", "", kernel)
    return kernel.split("(")[0].strip()


def main(trees):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    out = []
    for i, tree in enumerate(trees):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(tree)],
            capture_output=True, text=True, cwd=os.path.abspath(tree))
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise RuntimeError(f"turn {i} ({tree}) failed")
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        for r in rows:
            r["turn"] = i
            parts = ", ".join(f"{_short(k)} {v * 1e3:.1f} us"
                              for k, v in sorted(r["parts_ms"].items()))
            print(f"turn {i} {tree} {r['dtype']} {tuple(r['shape'])}: "
                  f"{r['ms'] * 1e3:.1f} us a fold (CUDA events, n={ITERS}); "
                  f"device parts: {parts}; o/l max abs err "
                  f"{r['max_abs_err']:.3g}", flush=True)
        out += rows
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "fold_turns.json"), "w") as f:
        json.dump({"smi": smi, "rows": out}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
