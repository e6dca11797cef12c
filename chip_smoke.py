#!/usr/bin/env python3
"""Drives the PyTorch port's main path on one NVIDIA card, phase by phase.

The main path is the lowered ParallelChannel fan-out: a call to 8 peers
that all advertise the same device method is answered by the card, with
the row-transform CUDA kernel (tbus_torch/csrc/row_transform.cu) in place
of the reference's tbus/parallel/runtime.py:_row_transform. Payloads of
4 KiB and 1 MiB, the three builtins, and fused batches as the fan-out
bridge's executor forms them (up to kMaxBatch = 16 calls).

Phases: (i) device; (ii) build the kernel with nvcc; (iii) the kernel
against its plain version at the main path's shapes, timed beside its
bound; (iv) the runtime's device kind against its host kind; (v) the
main path through the runtime entry points the bridge calls, with every
launch counter reset before and read after, checked against the bytes
the p2p servers' handlers return, with per-call latency; (vi) a profile
of lowered calls. Any failure exits nonzero; the last line is the
device JSON only on success.

The RPC leg (tpu:// servers, the C++ bridge) is not driven here: it
needs the C++ core libtbus.so, which links protobuf, and GPU hosts
without protobuf cannot build it. The CPU tests hold that leg
(tests/test_torch_fanout_rpc.py).

Run from the root of a checkout:  python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SEED = 1234
N_PEERS = 8
SIZES = {"4KiB": 4096, "1MiB": 1 << 20}
BUILTINS = {"echo": "Echo", "xor255": "Xor", "add_peer_index": "Add"}
SERVICE = "FanoutSvc"
# The main path's kernel shapes (B, rows_per_pos, L), L from _pad_len:
# one 4 KiB call, a fused batch of 8 1 MiB calls, a full batch of 4 KiB
# calls (15 or 16 calls pad to kMaxBatch = 16 rows).
KERNEL_SHAPES = [(1, 8, 6144), (8, 8, 1572864), (16, 8, 6144)]


def say(*parts):
    print(*parts, flush=True)


def phase(name):
    say(f"== {name}")


def _cuda_ms(torch, fn, iters, warmup=3):
    """Mean device ms per call over `iters` back-to-back calls."""
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


def _pctl(samples_s, q):
    return float(np.percentile(np.asarray(samples_s) * 1e6, q))


def phase_device(torch):
    phase("device")
    if not torch.cuda.is_available():
        say("no CUDA device: this script runs only on an NVIDIA card")
        return None
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    say(f"device: {name}, count {count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    say(smi)
    return {"name": name, "count": count, "smi": smi.splitlines()[0]}


def phase_build():
    phase("build")
    from tbus_torch.kernels import _build

    t0 = time.monotonic()
    _build.row_transform_lib()
    for name, secs in sorted(_build.build_seconds.items()):
        say(f"built {name} with nvcc: {secs:.1f} s")
    say(f"build phase wall: {time.monotonic() - t0:.1f} s")


def _kernel_rows(torch, rng, b, length, payload_n):
    rows = rng.integers(0, 256, (b, length), dtype=np.uint8)
    lengths = [payload_n] * b
    lengths[0] = length - 4
    if b > 1:
        lengths[-1] = 0  # a batch's zero-length padding row
    for i, n in enumerate(lengths):
        rows[i, :4] = np.frombuffer(np.uint32(n).tobytes(), dtype=np.uint8)
    return torch.from_numpy(rows).cuda()


def phase_kernel(torch, dev):
    phase("kernel: row_transform against its plain version")
    from tbus_torch.kernels import row_transform as rt

    rng = np.random.default_rng(SEED)
    shapes = []
    max_err = 0
    for b, rpp, length in KERNEL_SHAPES:
        payload_n = SIZES["1MiB"] if length > 6144 else SIZES["4KiB"]
        rows = _kernel_rows(torch, rng, b, length, payload_n)
        for builtin in BUILTINS:
            got = rt.row_transform(rows, 1, rpp, builtin)
            want = rt.row_transform_reference(rows, 1, rpp, builtin)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max().item())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"row_transform {builtin} {(b, rpp, length)}: kernel "
                    f"differs from its plain version (max abs err {err})")
        iters = 50 if length > 6144 else 500
        launch = lambda: rt.row_transform(  # noqa: E731
            rows, 1, rpp, "add_peer_index")
        ms = _kernel_device_ms(torch, launch, iters)
        call_ms = _cuda_ms(torch, launch, iters)
        plain_ms = _cuda_ms(torch, lambda: rt.row_transform_reference(
            rows, 1, rpp, "add_peer_index"), max(iters // 10, 5))
        nbytes = b * length + b * rpp * length
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        say(f"row_transform (B,rpp,L)=({b},{rpp},{length}): byte-equal for "
            f"{', '.join(BUILTINS)}; kernel {ms * 1e3:.2f} us on the "
            f"device ({nbytes / ms / 1e6:.0f} GB/s = "
            f"{bound_ms / ms * 100:.1f}% of the bound "
            f"{bound_ms * 1e3:.2f} us for {nbytes} bytes); back-to-back "
            f"wrapper calls {call_ms * 1e3:.2f} us each; plain version "
            f"{plain_ms * 1e3:.2f} us; [{dev['smi']}]")
        shapes.append({"shape": [b, rpp, length], "ms": ms,
                       "call_ms": call_ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms})
    say("library: no single PyTorch call computes this masked per-peer "
        "transform (library_ms null)")
    return shapes, max_err


def phase_runtime():
    phase("runtime: device kind against host kind")
    from tbus_torch.parallel import runtime

    rng = np.random.default_rng(SEED + 1)
    for builtin, method in BUILTINS.items():
        runtime.register_builtin(SERVICE, method, builtin, f"{builtin}/v1")
        for size in SIZES.values():
            p = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            dev = runtime.broadcast_gather(SERVICE, method, p, N_PEERS, 0,
                                           mesh="device")
            host = runtime.broadcast_gather(SERVICE, method, p, N_PEERS, 0,
                                            mesh="host")
            if dev != host:
                raise AssertionError(f"broadcast_gather {builtin} {size}")
        for bsz, size in ((8, SIZES["1MiB"]), (16, SIZES["4KiB"]),
                          (3, SIZES["4KiB"])):
            ps = [rng.integers(0, 256, size - b, dtype=np.uint8).tobytes()
                  for b in range(bsz)]
            dev = runtime.broadcast_gather_batch(SERVICE, method, ps,
                                                 N_PEERS, 0, mesh="device")
            host = runtime.broadcast_gather_batch(SERVICE, method, ps,
                                                  N_PEERS, 0, mesh="host")
            if dev != host:
                raise AssertionError(
                    f"broadcast_gather_batch {builtin} {bsz}x{size}")
    say(f"broadcast_gather and _batch: device == host for "
        f"{', '.join(BUILTINS)} at {', '.join(SIZES)} and batches of "
        f"8x1MiB, 16x4KiB, 3x4KiB")


def _p2p_answers(builtin, payload):
    """What the 8 p2p servers answer: server i runs builtin_handler(b, i),
    the handler twin of the device builtin."""
    import tbus_torch as tt

    return [tt.builtin_handler(builtin, i)(payload) for i in range(N_PEERS)]


def _latencies(fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def phase_main(dev):
    phase("main path: lowered fan-out calls served by the card")
    from tbus_torch.kernels import row_transform as rt
    from tbus_torch.parallel import runtime

    for builtin, method in BUILTINS.items():
        runtime.register_builtin(SERVICE, method, builtin, f"{builtin}/v1")
    rng = np.random.default_rng(SEED + 2)
    payloads = {k: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for k, n in SIZES.items()}
    fused = {k: [payloads[k][:-1] + bytes([i]) for i in range(n)]
             for k, n in (("4KiB", 15), ("1MiB", 8))}
    want = {(b, k): _p2p_answers(b, p)
            for b in BUILTINS for k, p in payloads.items()}
    want_fused = {k: [_p2p_answers("add_peer_index", p) for p in ps]
                  for k, ps in fused.items()}

    # The main path's run: every count starts at 0 here. The calls go
    # through the entry points the fan-out bridge's executor calls, with
    # the default mesh kind (the card).
    rt.launches = 0
    runtime.lowered_calls = 0
    runtime.batch_launches = 0
    for builtin, method in BUILTINS.items():
        for k, p in payloads.items():
            got = runtime.broadcast_gather(SERVICE, method, p, N_PEERS,
                                           10000)
            if got != want[(builtin, k)]:
                raise AssertionError(f"lowered {builtin} {k} differs from "
                                     f"the p2p handlers' answer")
    for k, ps in fused.items():
        # 15 calls pad to a batch of 16, as a full executor drain does.
        got = runtime.broadcast_gather_batch(SERVICE, "Add", ps, N_PEERS,
                                             10000)
        if got != want_fused[k]:
            raise AssertionError(f"fused {len(ps)}x{k} batch is wrong")
    counts = {"kernel_launches": rt.launches,
              "lowered_calls": runtime.lowered_calls,
              "batch_launches": runtime.batch_launches}
    say(f"main-path counts: {json.dumps(counts)}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"main path missed the card: {counts}")
    say(f"lowered == p2p handlers' bytes: {', '.join(BUILTINS)} at "
        f"{', '.join(SIZES)} over {N_PEERS} peers; fused 15x4KiB and "
        f"8x1MiB batches")

    for k, p in payloads.items():
        lat = _latencies(lambda: runtime.broadcast_gather(
            SERVICE, "Echo", p, N_PEERS, 10000), 50 if k == "4KiB" else 20)
        say(f"lowered call {k} x{N_PEERS} peers (runtime entry point, "
            f"host clock): p50 {_pctl(lat, 50):.0f} us p99 "
            f"{_pctl(lat, 99):.0f} us (n={len(lat)}; [{dev['smi']}])")
    for k, ps in fused.items():
        lat = _latencies(lambda: runtime.broadcast_gather_batch(
            SERVICE, "Add", ps, N_PEERS, 10000), 10)
        say(f"fused batch {len(ps)}x{k}: p50 {_pctl(lat, 50):.0f} us p99 "
            f"{_pctl(lat, 99):.0f} us per batch (n={len(lat)}; "
            f"[{dev['smi']}])")
    say("p2p over tpu://: not measured by this script (it does not build "
        "libtbus.so, which needs protobuf); the RPC leg is held on the "
        "CPU by tests/test_torch_fanout_rpc.py")
    return counts["kernel_launches"]


def _device_profile(torch, fn, n):
    """Runs fn() n times under torch.profiler; returns (wall_us, device
    activities as (name, us per call, count per call)), device-side
    events only (kernels and copies), so nothing is counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return wall_us, sorted(rows, key=lambda r: -r[1])


def _kernel_device_ms(torch, fn, n):
    """Device time of one row_transform_kernel launch, from the profiler
    (the card's own clock, without host launch overhead)."""
    _, rows = _device_profile(torch, fn, n)
    us = [r[1] / r[2] for r in rows if "row_transform_kernel" in r[0]]
    if not us:
        raise AssertionError("the profiler saw no row_transform_kernel")
    return us[0] / 1e3


def phase_profile(torch, dev):
    phase("profile: where a lowered call's time goes")
    from tbus_torch.parallel import runtime

    cases = (
        ("1MiB call", 10, lambda: runtime.broadcast_gather(
            SERVICE, "Echo", bytes(SIZES["1MiB"]), N_PEERS, 10000)),
        ("4KiB call", 50, lambda: runtime.broadcast_gather(
            SERVICE, "Echo", bytes(SIZES["4KiB"]), N_PEERS, 10000)),
        ("8x1MiB fused batch", 3, lambda: runtime.broadcast_gather_batch(
            SERVICE, "Echo", [bytes(SIZES["1MiB"])] * 8, N_PEERS, 10000)),
    )
    for name, n, fn in cases:
        wall_us, rows = _device_profile(torch, fn, n)
        busy = sum(r[1] for r in rows)
        for key, us, count in rows[:4]:
            say(f"  {name}: device {us:9.1f} us x{count:g}  {key[:60]}")
        say(f"{name}: wall {wall_us / n:.0f} us, device busy {busy:.0f} us "
            f"= {busy / (wall_us / n) * 100:.1f}% (idle "
            f"{100 - busy / (wall_us / n) * 100:.1f}%) [{dev['smi']}]")

    # Host-clock stages of the fused 8 x 1 MiB batch, as
    # broadcast_gather_batch runs them: encode the rows, fan out (H2D,
    # kernel, D2H into host memory), decode each peer's bytes.
    rng = np.random.default_rng(SEED + 3)
    ps = [rng.integers(0, 256, SIZES["1MiB"], dtype=np.uint8).tobytes()
          for _ in range(8)]
    length = runtime._pad_len(SIZES["1MiB"])
    stages = {"encode": [], "fanout": [], "decode": []}
    for _ in range(5):
        t0 = time.perf_counter()
        rows = runtime._encode(ps, 8, length)
        t1 = time.perf_counter()
        out = runtime._fanout(SERVICE, "Add", rows, N_PEERS, "device")
        t2 = time.perf_counter()
        for b in range(8):
            runtime._decode(out[b], N_PEERS, length)
        t3 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(dt)
    say("8x1MiB fused batch stages (host clock, p50 of 5): " + ", ".join(
        f"{k} {_pctl(v, 50):.0f} us" for k, v in stages.items())
        + f" [{dev['smi']}]")


def main():
    import torch

    dev = phase_device(torch)
    if dev is None:
        return 1
    phase_build()
    shapes, max_err = phase_kernel(torch, dev)
    phase_runtime()
    launches = phase_main(dev)
    phase_profile(torch, dev)
    main_shape = shapes[1]  # the fused 1 MiB batch
    say(dev["smi"])
    say(json.dumps({"kernels": [{
        "name": "row_transform",
        "route": "cuda",
        "source": "tbus_torch/csrc/row_transform.cu",
        "replaces": "tbus/parallel/runtime.py:197",
        "launches": launches,
        "match": max_err == 0,
        "max_abs_err": max_err,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": main_shape["shape"],
        "shapes": shapes,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
