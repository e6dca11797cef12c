#!/usr/bin/env python3
"""Drives the PyTorch port's main paths on one NVIDIA card, phase by phase.

Path 1, the lowered ParallelChannel fan-out: a call to 8 peers that all
advertise the same device method is answered by the card, with the
row-transform CUDA kernel (tbus_torch/csrc/row_transform.cu) in place of
the reference's tbus/parallel/runtime.py:_row_transform. Payloads of
4 KiB and 1 MiB, the three builtins, and fused batches as the fan-out
bridge's executor forms them (up to kMaxBatch = 16 calls).

Path 2, the graft entry (tbus_torch.entry, the twin of
__graft_entry__.py): the fan-out training step
(tbus_torch.parallel.collective.make_fanout_step) with its bf16 GEMM (K1)
and dW (K2) kernels (tbus_torch/csrc/gemm_bf16.cu), and ring attention
with its online-softmax fold kernel (K3, tbus_torch/csrc/ring_fold.cu).
The card is one H100 and NCCL takes one rank per card, so the step's
dp/tp collectives run as a one-rank NCCL group (their multi-rank
behaviour is held on the CPU by tests/test_torch_collectives.py).

Path 3, the C++ device plane (tbus_torch/csrc/cuda_runtime.cc, the port
of cpp/tpu/pjrt_runtime.cc and serve_engine.cc): device methods and the
continuous-batching generate method on a loopback server, every payload
through the runtime's dispatch thread and kernels K4 u8_transform, K5
dot128 and K6 dotbench (tbus_torch/csrc/device_programs.cu).

Path 4, the fused fan-out engine (tbus_torch/csrc/cuda_fanout.cc, the
port of cpp/tpu/native_fanout.cc) with DMA registration of the block
pool (cudaHostRegister through the reference's table, cpp/tpu/pjrt_dma.h,
armed before the first init): an 8-way ParallelChannel call answered by
one execution of K7 (tbus_torch/csrc/device_programs.cu tbus_fanout)
with no Python on the path, the PartitionChannel scatter, tensor-parallel
serving over 4 shard servers, and the device stream sink with its bench.

Path 5, the core's C++ load generator and multi-host bring-up: bench_echo
(tbus_torch.rpc, no Python on its loop) against path 3's server for the
native echo, K4's methods and K5's dot128, with the tpu:// path's
per-stage decomposition (stage_stats) and one call's rpcz span; then
tbus_torch.parallel.distributed.init by coordinator and global_mesh,
driving path 2's step (K1, K2) at hidden 4096.

Path 6, the core's ops planes around path 3's device methods (K4, K5):
the wait profiler and flight recorder, the port runtime's /status line,
an SLO on a device method with its recorder trigger, the channel
options (http, h2, grpc through GrpcStub, gzip, zlib, pooled, short,
lb=rr over list://), the cache tier with replay and the reshard drill
(the host's legs), the metrics sink and the autotune controller.

Path 7, the fleet drills (the shared core's rpc/fleet.cc through
tbus_torch.rpc, with the port's node tbus_torch.rpc.FLEET_NODE) and a
live tpu:// link redial under path 3's device traffic (K4, K5).

Phases: (i) device; (ii) build: the C++ core (the protobuf-free flavour
where protobuf is missing, as on the card's machine) with cmake+ninja
while nvcc builds every kernel (one per source, all at once), then both
bridges with g++; the registers and spills from ptxas, and cuobjdump's
SASS of K1's, K2's and K6's GEMM and of K3's and K5's split-term
kernels: HGMMA (wgmma), no HMMA, no spills; (iii)
row_transform against its plain version at path 1's shapes, timed beside
its bound; (iv) the runtime's device kind against its host kind; (v)
path 1 through the runtime entry points the bridge calls, with its
counts reset before and read after, checked against the bytes the p2p
servers' handlers return, with per-call latency; (vi) a profile of
lowered calls; (vii) K1 and K2 against their plain versions at the
entry's shape, at hidden 4096 x rows 4096, at the shared TMA + wgmma
GEMM's tile edges and at long K, timed beside their bounds and cuBLAS
(torch.mm bf16 -> f32, with and without its casts; torch.matmul f32), K1
and K2 in parts (pack and GEMM, from the profiler), both packs bit-equal
to their plain versions; (viii) K3 against its plain version over 4
carried folds at 8192 x 8192 x 128 (32K context on a 4-position ring),
in f32 and bf16, with the fused last fold (o / l in q's dtype), timed
beside its bound (the split-term design's bf16 passes, the f32 FMA
figure beside) and scaled_dot_product_attention, in parts (pack, fold,
combine), and at head dims 256 and 200 (the chunked f32 FMA kernel);
(ix) path 2 through
entry(device="cuda") at the entry's shapes and at hidden 4096, and
make_ring_attention at seq 8192, with the K1, K2 and K3 counts reset
before and read after, held against the same step on the CPU's plain
path and against plain full attention, with the step's wall time and
device-busy share; (x) dryrun_multichip(1) in its own process; (xi) K4,
K5 and K6 against their plain versions at path 3's shapes (the 256 KiB
serving step, 4 KiB and 1 MiB payloads, dot128 at k = 2048,
dotbench4096x32 and chains at the GEMM's tile edges): K4 byte for byte,
also through the library with in and out at one offset (a scalar head)
and as its first design's kernel (v1); K5 on normal payloads and on rows
of f32 subnormals, of mixed scales and with NaN and +-inf; K4 timed at 4
KiB, 64 KiB, 256 KiB and 1 MiB and K5 at k = 2048 on the profiler's
clock beside their first designs (tbus_u8_transform_v1, tbus_dot128_v1),
K4's floor (an empty kernel in its launch shape, one 16-byte load and
store a thread), their bounds and the library calls on the same clock
(x + 1, bitwise_xor, clone; torch.matmul f32 with TF32 off); (xii) path
3a: device methods (echo,
xor255, incr at 4 KiB and 1 MiB, dot128 at 1 MiB, dotbench4096x32 on a
4-byte seed), every reply held to the plain version on the card, with
the runtime's launch counts reset before and read after, per-call
p50/p99 and the device-busy share of a profiled call; (xiii) path 3b:
generate (incr, xor255) at max_batch 64, token_bytes 4096: 64 concurrent
streams of 16 tokens checked byte for byte, then bench_serve for 2 s,
with serve_stats naming the CUDA engine; (xiv) path 1's RPC leg: a
ParallelChannel to 8 tpu:// servers, p2p and then lowered through the
torch fan-out bridge, byte-equal, p50/p99 at 4 KiB and 1 MiB; (xv) K7
against its plain version (broadcast and scatter, the three builtins, n
in 1, 8, 64, buckets 128 B to 1 MiB, a ragged one and an unaligned
input), timed at path 4's shapes beside its bound and the library call
(x.expand(n, -1) ^ 255, .clone()); (xvi) path 4 with the runtime's
launch counts reset before and read after: (b) the 8-way fan-out over 8
tpu:// servers through enable_native_fanout in this process (which ran
the torch leg), echo/xor255/add_peer_index at 4 KiB and 1 MiB,
byte-equal to p2p (compared inside at divergence permille 1000, then
returned at 0), p50/p99 beside p2p; (c) PartitionChannel scatter, 8
partitions x 1 MiB; (d) tensor-parallel generate over 4 shard servers,
64 streams x 16 tokens of 4 KiB byte-exact, then bench_serve, with
fallback_steps 0; (e) bench_device_stream, 256 MiB in 1 MiB chunks,
xor255, echo on, every chunk counted by the sink; each with the DMA
tripwires and donation/alias hits; (xvii) path 4 again in a child with
DMA registration off; (xviii) path 5a, run after (xiii) while path 3's
server is up, with the runtime's launch counts reset before and read
after: bench_echo for 1 s a leg at 4 KiB and 1 MiB against the native
echo, Echo and Xor (K4) and Dot (K5, 1 MiB only), in this process over
TCP at concurrency 1 (beside phase xii's Python-loop p50) and from a
generator child process (`chip_smoke.py --gen-child`, which runs the
tbus_torch.rpc calls its parent writes to its stdin, and serves path 6
too) over TCP and tpu:// at concurrency 1 and 8 (qps, p50, p99,
p999; dot128's GFLOP/s), each tpu:// leg with both processes'
stage_stats hops, K4's and K5's launches at least the calls each leg
completed, one traced call's client and server rpcz spans, and the
wires and surfaces that fail on the card's core; (xix) path 5b:
init("127.0.0.1:<port>", 1, 0), global_mesh(("dp", "tp")) and the
fan-out step at hidden 4096 x rows 4096, equal bit for bit to the step
on default_mesh(1), with its wall p50 and the K1 and K2 counts reset
before and read after; (xx) path 6, run after (xviii) while path 3's
server is up, with the runtime's launch counts reset before and read
after, its calls made from path 5a's generator child: (a)
wait_profile_* in the server process over 1 s tpu:// legs at c=1
(native echo and Echo at 4 KiB, Dot at 1 MiB) with each leg's five
hottest wait sites, its classes and the sites through the port's
runtime beside path 5a's handler hop; the
flight ring's DevService.Echo records; a recorder_capture bundle with
every section; (b) /status's device line of path 3's server (platform
gpu, 1 device, executions risen by the calls of (a)); (c) a loose and a
tight p99 objective on DevService.Xor at 4 KiB, the tight one's
slo:<name>:burn=1 rule armed in the calling process: its fast burn
over 1, the loose one's under, the rule fired and a bundle with an slo
section, one exemplar's budget waterfall; (d) Xor at 4 KiB and 1 MiB
through the core's defaults and each channel option, 100 calls a size,
every reply byte-equal to K4's plain version, p50/p99, both servers of
lb=rr taking calls;
(e) bench_cache over TCP and tpu:// (256 KiB values, 96 keys, GETs,
c=8, 1 s), replay(verify=True) of a seeded 1000-record corpus and
cache_reshard_drill(); (f) two metrics_flush() into a sink of this
process: one node, DevService.Xor's rollup counting at least (c)'s
calls, slo_fleet naming (c)'s objectives; (g) autotune over a 2 s
tpu:// Xor leg at c=8, every tunable flag put back, 100 Xor calls
byte-exact after; (xxi) path 7's redial, after (xx) from the same
generator child, with the runtime's launch counts reset before and read
after: 2 s tpu:// legs at c=8 (Xor 4 KiB on K4, then Dot 1 MiB on K5,
bench_echo_overload: no retries, every failure counted), 1 s into each a
change of tbus_shm_lanes (and, for Dot, tbus_shm_ext_chains), the redial
walker it starts, then link_redial(2000): at least one link
renegotiated, the new caps on every link (shm_links()), no failed call,
K4's and K5's launches at least the calls completed; then 100 Xor calls
byte-equal to K4's plain version and 100 Dot calls within phase xi's
tolerance over the redialed link, the flags put back and redialed;
(xxii) fleet_drill at bench.py --fleet's defaults (6 port nodes, 1,200
ms phases, seed 1) from the same generator child, held to every
invariant of tests/test_fleet.py; (xxiii) fleet_roll at bench.py
--roll's (4 nodes): 4 clean rolls, no call lost or failed, the
capability skew diverged; no node (the child's process group) outlives
its drill. Any failure exits nonzero; the
last line is the device JSON only on success.

Run from the root of a checkout:  python3 chip_smoke.py
"""

import ctypes
import json
import math
import os
import select
import struct
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_TC_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
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
    from tbus_torch import _native
    from tbus_torch.kernels import _build

    t0 = time.monotonic()
    # The kernels (one nvcc each) build while the C++ core builds.
    errors = []

    def kernels():
        try:
            _build.build_kernels()
        except Exception as e:  # re-raised below, in this thread
            errors.append(e)

    worker = threading.Thread(target=kernels)
    worker.start()
    t_core = time.monotonic()
    core = _build.core()
    core_s = time.monotonic() - t_core
    flavor = _native.core_flavor()
    worker.join()
    if errors:
        raise errors[0]
    say(f"built the C++ core ({flavor}): {core_s:.1f} s -> "
        f"{os.path.relpath(core)}")
    if flavor != ("protobuf" if _native.has_protobuf() else "protobuf-free"):
        raise AssertionError(f"core flavour {flavor} on a host where "
                             f"protobuf is {_native.has_protobuf()}")
    for name, fn in (("torch_fanout", _build.fanout_bridge_lib),
                     ("torch_device", _build.device_bridge_lib)):
        t1 = time.monotonic()
        fn()
        say(f"built the {name} bridge with g++: "
            f"{time.monotonic() - t1:.1f} s")
    for name, secs in sorted(_build.build_seconds.items()):
        say(f"built {name}: {secs:.1f} s")
        for line in _build.build_logs.get(name, "").splitlines():
            if "Used" in line or "spill" in line or "arning" in line:
                say(f"  {name}: {line.strip()}")
    say(f"build phase wall: {time.monotonic() - t0:.1f} s")
    _check_gemm_build(_build)
    return flavor


def _check_gemm_build(_build):
    """K1's, K2's and K6's GEMM is the TMA + wgmma mainloop, and K3's
    d <= 128 fold and K5 the split-term wgmma kernels: HGMMA and no HMMA
    in their SASS, and no spills in ptxas's report of the build (kept
    beside the library, so a cached build is checked too)."""
    for lib, kernel in (("gemm_bf16", "gemm_sm90_kernel"),
                        ("device_programs", "gemm_sm90_kernel"),
                        ("device_programs", "dot128_kernel"),
                        ("ring_fold", "fold_wgmma_kernel")):
        sass = _build.gemm_sass(lib, kernel)
        usage = {fn: u for fn, u in _build.ptxas_usage(lib).items()
                 if kernel in fn}
        if not sass:
            raise AssertionError(f"lib{lib}: no {kernel} in its SASS")
        for fn, counts in sass.items():
            u = usage.get(fn, {})
            if "spill_stores" not in u:
                raise AssertionError(f"lib{lib} {fn}: no spill count in "
                                     f"ptxas's report of the build")
            spills = u["spill_stores"] + u["spill_loads"]
            say(f"lib{lib} {fn}: SASS HGMMA {counts['HGMMA']}, HMMA "
                f"{counts['HMMA']}; ptxas {u.get('registers')} registers, "
                f"{spills} spill bytes")
            if counts["HGMMA"] == 0 or counts["HMMA"] != 0:
                raise AssertionError(f"lib{lib} {fn} is not a wgmma kernel: "
                                     f"{counts}")
            if spills:
                raise AssertionError(f"lib{lib} {fn} spills {spills} bytes")
    if not any("StoreBf16Rounded" in fn
               for fn in _build.gemm_sass("gemm_bf16")):
        raise AssertionError("libgemm_bf16: no K2 GEMM (StoreBf16Rounded)")


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


def _device_parts(torch, fn, n, kernels, tries=3):
    """Device ms of one launch of each of `kernels` (name -> a substring of
    the kernel's name) while fn() runs, from the profiler. Now and then
    the profiler records none of a run's launches of a kernel that ran
    (seen on the card with K7, and with K1 and K3 in a step's profile), so
    a run that misses one is profiled again, up to `tries` runs."""
    for _ in range(tries):
        _, rows = _device_profile(torch, fn, n)
        out = {}
        for part, kname in kernels.items():
            us = [r[1] / r[2] for r in rows if kname in r[0]]
            if us:
                out[part] = us[0] / 1e3
        if len(out) == len(kernels):
            return out
    missing = sorted(k for p, k in kernels.items() if p not in out)
    raise AssertionError(f"the profiler saw no {', '.join(missing)} in "
                         f"{tries} runs")


def _device_call_ms(torch, fn, n, tries=3):
    """Device ms of one fn() call from the profiler, the clock
    _kernel_device_ms reads, for library calls whose kernels have names
    of their own: each kernel or copy fn() runs once a call, its time a
    launch summed over them. Per launch, so a run in which the profiler
    missed some launches still counts (see _device_parts); a run in
    which it saw none is profiled again."""
    for _ in range(tries):
        _, rows = _device_profile(torch, fn, n)
        if rows:
            return sum(r[1] / r[2] for r in rows) / 1e3
    raise AssertionError(f"the profiler saw no device work in {tries} runs")


def _raise_cuda(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _kernel_device_ms(torch, fn, n, kernel="row_transform_kernel"):
    """Device time of one launch of `kernel`, from the profiler (the
    card's own clock, without host launch overhead)."""
    return _device_parts(torch, fn, n, {"ms": kernel})["ms"]


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


# ---- path 2: the graft entry, its GEMM and fold kernels ----

GEMM_SHAPES = [(4, 16, 16), (4096, 4096, 4096)]  # (M, K, N), timed
# Checked only: on and one past the shared GEMM's tile edges (blocks of
# 128 rows paired into 256, 256 columns, 64 deep), and long K.
GEMM_CHECKS = [(128, 64, 256), (129, 65, 257), (256, 4104, 384),
               (64, 16384, 64)]
FOLD = (8192, 8192, 128, 4)  # lq, lk, d, folds: one position of a 4-ring
# Head dims over K3's 128-wide chunk: (lq, lk, d), two carried folds each.
WIDE_FOLDS = [(2048, 2048, 256), (1000, 777, 200)]
HIDDEN = 4096  # one dense layer of a 7B-class model


def _bf16_ulp(torch, a):
    """One bf16 ulp at |a| (8 significant bits)."""
    _, e = torch.frexp(a.abs().double())
    return torch.ldexp(torch.ones_like(a, dtype=torch.float64),
                       torch.clamp(e - 8, min=-133))


def _dw_check(torch, x, dy, got, want):
    """K2 against its plain version: within one bf16 ulp, plus the gap two
    f32 sums of M terms in different orders can open, sqrt(M) * 2^-24 *
    sum|t| each (the probabilistic bound); at M = 4 that term is ~1e-6 of
    an ulp. Returns (ok, max err, elements beyond one ulp, max err in
    ulps)."""
    from tbus_torch.kernels import ieee_fp32

    diff = (got.double() - want.double()).abs()
    ulp = _bf16_ulp(torch, torch.maximum(got.abs(), want.abs()))
    with ieee_fp32():
        sumabs = x.bfloat16().float().abs().T @ dy.abs()
    order = 2 * math.sqrt(x.shape[0]) * 2.0**-24 * sumabs.double()
    ok = bool((diff <= ulp + order).all())
    return (ok, float(diff.max()), int((diff > ulp).sum()),
            float((diff / ulp).max()))


def phase_gemm(torch, dev):
    phase("kernels K1, K2: the fan-out step's GEMMs against plain versions")
    from tbus_torch.kernels import gemm, ieee_fp32

    rng = np.random.default_rng(SEED + 10)
    out = {}
    for m, k, n in GEMM_SHAPES + GEMM_CHECKS:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                             * np.float32(0.02))
        dy = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32))
        x, w, dy = x.cuda(), w.cuda(), dy.cuda()
        y, xb, wtb = gemm.matmul_bf16_f32_packed(x, w)
        yp = gemm.matmul_bf16_f32_reference(x, w)
        xbp, wtbp = gemm.pack_reference(x, w)
        g, at, bt = gemm.dw_f32_bf16_packed(x, dy)
        gp = gemm.dw_reference(x, dy)
        atp, btp = gemm.dw_pack_reference(x, dy)
        torch.cuda.synchronize()
        k1_err = float((y - yp).abs().max())
        k1_ok = k1_err <= 1e-4 * float(yp.abs().max())
        k2_ok, k2_err, k2_beyond, k2_ulps = _dw_check(torch, x, dy, g, gp)
        with ieee_fp32():  # the exact sum, rounded once
            exact = (x.bfloat16().double().T @ dy.double()).bfloat16()
        k2_exact = float((g.bfloat16() == exact).double().mean())
        p2_exact = float((gp.bfloat16() == exact).double().mean())
        # K1's and K2's packs against their plain versions: the same bf16
        # bits, the same padded shapes.
        pack_ok = torch.equal(xb, xbp) and torch.equal(wtb, wtbp)
        dw_pack_ok = (torch.equal(at.view(torch.int16), atp.view(torch.int16))
                      and torch.equal(bt.view(torch.int16),
                                      btp.view(torch.int16)))
        if not (k1_ok and k2_ok and pack_ok and dw_pack_ok):
            raise AssertionError(
                f"GEMM kernels at (M,K,N)={(m, k, n)}: K1 err {k1_err} "
                f"(ok {k1_ok}), pack equal to its plain version {pack_ok} "
                f"(shapes {tuple(xb.shape)}, {tuple(wtb.shape)} against "
                f"{tuple(xbp.shape)}, {tuple(wtbp.shape)}); K2 err "
                f"{k2_err}, {k2_beyond} beyond 1 ulp, max {k2_ulps:.2f} ulp "
                f"(ok {k2_ok}), pack equal to its plain version {dw_pack_ok}"
                f" (shapes {tuple(at.shape)}, {tuple(bt.shape)} against "
                f"{tuple(atp.shape)}, {tuple(btp.shape)})")
        if (m, k, n) in GEMM_CHECKS:
            say(f"K1, K2 (M,K,N)={(m, k, n)}: K1 max|k-p| {k1_err:.3g} <= "
                f"1e-4*max|p|, pack bit-equal to its plain version; K2 "
                f"max|k-p| {k2_err:.3g}, {k2_beyond} beyond "
                f"1 bf16 ulp (max {k2_ulps:.2f} ulp), pack bit-equal to its "
                f"plain version")
            continue
        big = m * n * k > 1e9
        iters = 10 if big else 200
        flops = 2.0 * m * n * k
        rec = {}
        xb, wb = x.bfloat16(), w.bfloat16()
        for name, kern, plain, lib, rate, nbytes in (
                # library_ms for K1: cuBLAS on the bf16 operands with f32
                # accumulation and f32 out, K1's function on inputs rounded
                # beforehand (the rounding is not timed).
                ("matmul_bf16_f32", lambda: gemm.matmul_bf16_f32(x, w),
                 lambda: gemm.matmul_bf16_f32_reference(x, w),
                 lambda: torch.mm(xb, wb, out_dtype=torch.float32),
                 BF16_TC_FLOPS, 4 * (m * k + k * n + m * n)),
                # K2's design does 3 bf16 passes (dy's exact split terms).
                ("dw_f32_bf16", lambda: gemm.dw_f32_bf16(x, dy),
                 lambda: gemm.dw_reference(x, dy),
                 lambda: x.T @ dy, BF16_TC_FLOPS / 3,
                 4 * (m * k + m * n + k * n))):
            with ieee_fp32():  # the f32 products below run with TF32 off
                lib_ms = _cuda_ms(torch, lib, iters)
                plain_ms = _cuda_ms(torch, plain, iters)
            ms = _cuda_ms(torch, kern, iters)
            bound_ms = max(flops / rate, nbytes / HBM_BYTES_PER_S) * 1e3
            rec[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms,
                         "bound_by": ("operations" if flops / rate
                                      >= nbytes / HBM_BYTES_PER_S
                                      else "bytes"),
                         "tflops": flops / ms / 1e9}
        rec["matmul_bf16_f32"]["max_abs_err"] = k1_err
        rec["dw_f32_bf16"]["max_abs_err"] = k2_err
        k1 = rec["matmul_bf16_f32"]
        # Two more yardsticks for K1: K1's whole function in cuBLAS, the
        # casts to bf16 timed; and the full-f32 product of the unrounded
        # operands, TF32 off (a slower function than K1's).
        k1["library_cast_ms"] = _cuda_ms(
            torch, lambda: torch.mm(x.bfloat16(), w.bfloat16(),
                                    out_dtype=torch.float32), iters)
        with ieee_fp32():
            k1["library_f32_ms"] = _cuda_ms(torch, lambda: x @ w, iters)
        # K1 in parts, on the card's own clock: the pack and the GEMM.
        k1.update(_device_parts(
            torch, lambda: gemm.matmul_bf16_f32(x, w), iters,
            {"pack_ms": "pack_operands_kernel",
             "gemm_ms": "gemm_sm90_kernel"}))
        k1["gemm_tflops"] = flops / k1["gemm_ms"] / 1e9
        pack_bytes = (m * k + k * n) * 4 + (xb.numel() + wtb.numel()) * 2
        k1["pack_bound_ms"] = pack_bytes / HBM_BYTES_PER_S * 1e3
        out[(m, k, n)] = rec
        k2 = rec["dw_f32_bf16"]
        # K2 in parts: the pack and the split-term GEMM.
        k2.update(_device_parts(
            torch, lambda: gemm.dw_f32_bf16(x, dy), iters,
            {"pack_ms": "dw_pack_kernel", "gemm_ms": "StoreBf16Rounded"}))
        k2["gemm_tflops"] = 3 * flops / k2["gemm_ms"] / 1e9
        k2["pack_bound_ms"] = ((m * k + m * n) * 4 + (at.numel() + bt.numel())
                               * 2) / HBM_BYTES_PER_S * 1e3
        k2["fma_bound_ms"] = flops / F32_FLOPS * 1e3
        k2["design"] = "split_wgmma"
        say(f"K1 matmul_bf16_f32 (M,K,N)={(m, k, n)}: max|k-p| {k1_err:.3g}"
            f" <= 1e-4*max|p|; {k1['ms'] * 1e3:.1f} us "
            f"({k1['tflops']:.1f} TFLOP/s) vs bound "
            f"{k1['bound_ms'] * 1e3:.2f} us ({k1['bound_by']}, bf16 tensor "
            f"cores) = {k1['bound_ms'] / k1['ms'] * 100:.1f}%; in parts on "
            f"the device: pack {k1['pack_ms'] * 1e3:.1f} us (bound "
            f"{k1['pack_bound_ms'] * 1e3:.1f} us, bytes), GEMM "
            f"{k1['gemm_ms'] * 1e3:.1f} us ({k1['gemm_tflops']:.1f} "
            f"TFLOP/s); plain {k1['plain_ms'] * 1e3:.1f} us; torch.mm bf16 "
            f"-> f32 {k1['library_ms'] * 1e3:.1f} us, with its casts "
            f"{k1['library_cast_ms'] * 1e3:.1f} us; torch.matmul f32 "
            f"{k1['library_f32_ms'] * 1e3:.1f} us [{dev['smi']}]")
        say(f"K2 dw_f32_bf16 (M,K,N)={(m, k, n)}: max|k-p| {k2_err:.3g}, "
            f"{k2_beyond} of {k * n} beyond 1 bf16 ulp (max "
            f"{k2_ulps:.2f} ulp; f32 summation order); equal to the exact "
            f"sum rounded once: kernel {k2_exact * 100:.2f}%, plain "
            f"{p2_exact * 100:.2f}%; {k2['ms'] * 1e3:.1f} us "
            f"({k2['tflops']:.1f} TFLOP/s of the function) vs bound "
            f"{k2['bound_ms'] * 1e3:.2f} us ({k2['bound_by']}, 3 bf16 "
            f"tensor-core passes) = {k2['bound_ms'] / k2['ms'] * 100:.1f}% "
            f"(f32 FMA figure {k2['fma_bound_ms'] * 1e3:.2f} us); in parts "
            f"on the device: pack {k2['pack_ms'] * 1e3:.1f} us (bound "
            f"{k2['pack_bound_ms'] * 1e3:.1f} us, bytes), GEMM "
            f"{k2['gemm_ms'] * 1e3:.1f} us ({k2['gemm_tflops']:.1f} TFLOP/s "
            f"over 3 passes); plain {k2['plain_ms'] * 1e3:.1f} us; "
            f"torch.matmul f32 {k2['library_ms'] * 1e3:.1f} us "
            f"[{dev['smi']}]")
    return out


def _fold_inputs(torch, rng, dtype):
    lq, lk, d, folds = FOLD
    q = torch.from_numpy(rng.standard_normal((lq, d), dtype=np.float32))
    ks = torch.from_numpy(rng.standard_normal((folds, lk, d),
                                              dtype=np.float32))
    vs = torch.from_numpy(rng.standard_normal((folds, lk, d),
                                              dtype=np.float32))
    return q.cuda().to(dtype), ks.cuda().to(dtype), vs.cuda().to(dtype)


def _carry(torch, lq, d):
    return (torch.full((lq,), -math.inf, device="cuda"),
            torch.zeros((lq,), device="cuda"),
            torch.zeros((lq, d), device="cuda"))


def phase_fold(torch, dev):
    phase("kernel K3: ring attention's fold against its plain version")
    import torch.nn.functional as F

    from tbus_torch.kernels import ieee_fp32, ring_fold as rf

    lq, lk, d, folds = FOLD
    rng = np.random.default_rng(SEED + 11)
    flops = 4.0 * lq * lk * d  # per fold, the function's two products
    # The split-term design's bf16 passes of 2 lq lk d: 6 + 6 for f32
    # inputs, 1 + 3 for bf16 (csrc/ring_fold.cu).
    passes = {torch.float32: 12, torch.bfloat16: 4}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, ks, vs = _fold_inputs(torch, rng, dtype)
        m, l, o = _carry(torch, lq, d)
        pm, pl, po = _carry(torch, lq, d)
        for i in range(folds):
            rf.fold_(q, ks[i], vs[i], m, l, o)
            pm, pl, po = rf.fold_reference(q, ks[i], vs[i], pm, pl, po)
        got, want = o / l[:, None], po / pl[:, None]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        # The fused last fold: o / l in q's dtype, written by the kernel.
        fin = rf.fold_(q, ks[0], vs[0], *_carry(torch, lq, d), final=True)
        fin_want = rf.fold_reference(q, ks[0], vs[0], *_carry(torch, lq, d),
                                     final=True)
        fin_diff = (fin.double() - fin_want.double()).abs()
        fin_err = float(fin_diff.max())
        # Both round o / l, within 2e-5 of each other in f32, to q's dtype
        # once: a bf16 output may differ by one more bf16 ulp.
        ftol = 2e-5 + 2e-5 * fin_want.double().abs()
        if dtype == torch.bfloat16:
            ftol = ftol + _bf16_ulp(torch, fin_want.float())
        if fin.dtype != dtype or not bool((fin_diff <= ftol).all()):
            raise AssertionError(f"final fold {dtype}: max abs err {fin_err}")
        # Timing: back-to-back folds into one carry.
        carry = _carry(torch, lq, d)
        ms = _cuda_ms(torch, lambda: rf.fold_(q, ks[0], vs[0], *carry), 10)
        plain_ms = _cuda_ms(torch, lambda: rf.fold_reference(
            q, ks[0], vs[0], *_carry(torch, lq, d)), 5)
        qb, kf, vf = (t[None, None] for t in (q, ks.reshape(-1, d),
                                              vs.reshape(-1, d)))
        with ieee_fp32():
            sdpa_32k = _cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qb, kf, vf), 5)
            sdpa_one = _cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qb, ks[0][None, None], vs[0][None, None]), 5)
        nbytes = (q.numel() + 2 * ks[0].numel()) * q.element_size() \
            + 2 * 4 * (2 * lq + lq * d)
        op_ms = passes[dtype] * flops / 2 / BF16_TC_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(op_ms, bytes_ms)
        fma_ms = flops / F32_FLOPS * 1e3
        parts = _device_parts(
            torch, lambda: rf.fold_(q, ks[0], vs[0], *carry), 5,
            {"pack_ms": "fold_pack_kernel", "fold_ms": "fold_wgmma_kernel",
             "combine_ms": "fold_combine_kernel"})
        name = str(dtype).replace("torch.", "")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": sdpa_one,
                     "library_32k_ms": sdpa_32k, "bound_ms": bound_ms,
                     "bound_by": ("operations" if op_ms >= bytes_ms
                                  else "bytes"),
                     "fma_bound_ms": fma_ms, "passes": passes[dtype],
                     "max_abs_err": err, "final_max_abs_err": fin_err,
                     "tflops": flops / ms / 1e9, **parts}
        say(f"K3 ring_fold {name} (lq,lk,d)={(lq, lk, d)} x{folds} carried "
            f"folds: o/l within 2e-5 (max abs err {err:.3g}); the fused "
            f"last fold's {name} o/l within 2e-5"
            f"{' + 1 bf16 ulp' if dtype == torch.bfloat16 else ''} (max abs "
            f"err {fin_err:.3g}); one fold {ms * 1e3:.0f} us "
            f"({flops / ms / 1e9:.1f} TFLOP/s of the function) vs bound "
            f"{bound_ms * 1e3:.1f} us ({passes[dtype]} bf16 tensor-core "
            f"passes) = {bound_ms / ms * 100:.1f}% (f32 FMA figure "
            f"{fma_ms * 1e3:.1f} us); in parts on the device: pack "
            f"{parts['pack_ms'] * 1e3:.1f} us, fold "
            f"{parts['fold_ms'] * 1e3:.1f} us, combine "
            f"{parts['combine_ms'] * 1e3:.1f} us; plain "
            f"{plain_ms * 1e3:.0f} us; scaled_dot_product_attention over "
            f"{lk} keys {sdpa_one * 1e3:.0f} us, over {folds * lk} keys "
            f"{sdpa_32k * 1e3:.0f} us (vs {folds} folds "
            f"{folds * ms * 1e3:.0f} us) [{dev['smi']}]")
    for wlq, wlk, wd in WIDE_FOLDS:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.from_numpy(rng.standard_normal(
                (wlq, wd), dtype=np.float32)).cuda().to(dtype)
            m, l, o = _carry(torch, wlq, wd)
            pm, pl, po = _carry(torch, wlq, wd)
            for _ in range(2):
                k, v = (torch.from_numpy(rng.standard_normal(
                    (wlk, wd), dtype=np.float32)).cuda().to(dtype)
                    for _ in range(2))
                rf.fold_(q, k, v, m, l, o)
                pm, pl, po = rf.fold_reference(q, k, v, pm, pl, po)
            got, want = o / l[:, None], po / pl[:, None]
            torch.testing.assert_close(m, pm, rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
            say(f"K3 ring_fold {str(dtype)[6:]} (lq,lk,d)={(wlq, wlk, wd)} "
                f"x2 carried folds, the chunked f32 FMA kernel over "
                f"{-(-wd // rf.HEAD_CHUNK)} head-dim chunks: o/l within 2e-5 "
                f"(max abs err "
                f"{float((got - want).abs().max()):.3g})")
    return out


def _plain_attention(torch, q, k, v):
    from tbus_torch.kernels import ieee_fp32

    with ieee_fp32():
        s = (q.float() @ k.float().T) / math.sqrt(q.shape[1])
        return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def _run_steps(step, w, x, n):
    losses = []
    for _ in range(n):
        loss, w = step(w, x)
        losses.append(float(loss))
    return losses, w


def _wall_p50_us(torch, fn, n):
    lat = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return _pctl(lat, 50)


def _check_big_step(torch, w, x, loss, w1, losses):
    """The hidden-4096 step against the same step through the plain
    versions on the card (one rank: the collectives are identities): the
    loss to rtol 1e-5, w1 within lr * (one bf16 ulp of g, plus the f32
    summation-order gap as K2 is held, plus what K1's y moves g by) plus
    one f32 ulp of w. The
    reference's lr of 1e-3 is above this width's stable step 2 / lambda_max
    of the loss's Hessian 2 x^T x, so the loss rises from step to step,
    as the reference's would; the script prints both."""
    from tbus_torch.kernels import gemm, ieee_fp32

    y = gemm.matmul_bf16_f32_reference(x, w)
    want_loss = float((y * y).sum())
    g = gemm.dw_reference(x, 2 * y)
    want_w1 = w - 1e-3 * g
    ulp = _bf16_ulp(torch, g)
    dy_gap = 2 * (gemm.matmul_bf16_f32(x, w) - y).abs()
    with ieee_fp32():
        xa = x.bfloat16().float().abs().T
        sumabs, moved = xa @ (2 * y).abs(), xa @ dy_gap
    order = 2 * math.sqrt(x.shape[0]) * 2.0**-24 * sumabs.double()
    tol = (1e-3 * (ulp + order + moved.double())
           + 2.0**-23 * w.abs().double())
    diff = (w1.double() - want_w1.double()).abs()
    loss_err = abs(loss - want_loss) / want_loss
    say(f"hidden {HIDDEN} x rows {HIDDEN} step vs its plain versions on the "
        f"card: loss {loss} vs {want_loss} (rel err {loss_err:.3g}), w1 max "
        f"abs err {float(diff.max()):.3g} (max {float((diff / tol).max()):.2f}"
        f" of its tolerance)")
    if not (loss_err <= 1e-5 and bool((diff <= tol).all())
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError("hidden-4096 step differs from its plain path")
    v = torch.ones(x.shape[1], device=x.device)
    with ieee_fp32():
        for _ in range(30):  # power iteration for lambda_max(2 x^T x)
            v = x.T @ (x @ v)
            v = v / v.norm()
        lam = float(2 * (x @ v).square().sum())
    say(f"hidden {HIDDEN} losses over 2 steps {losses}: lr 1e-3 vs stable "
        f"step 2 / lambda_max = {2 / lam:.3g} (lambda_max {lam:.4g}), so "
        f"the loss {'falls' if losses[1] < losses[0] else 'rises'}")


def phase_entry(torch, dev, tmp):
    phase("main path 2: entry(device='cuda') step and ring attention")
    from torch.distributed.device_mesh import init_device_mesh

    from tbus_torch import entry
    from tbus_torch.kernels import gemm, ring_fold as rf
    from tbus_torch.parallel import collective, distributed

    # The same step on the CPU's plain path (a one-rank gloo group).
    distributed.init_store(0, 1, os.path.join(tmp, "store_cpu"), "gloo")
    try:
        step, (w, x) = entry.entry("cpu")
        cpu_losses, cpu_w1 = _run_steps(step, w, x, 1)
        cpu_losses += _run_steps(step, cpu_w1, x, 1)[0]
    finally:
        distributed.shutdown()

    distributed.init_store(0, 1, os.path.join(tmp, "store_cuda"), "nccl")
    try:
        # The main path's run: every count starts at 0 here.
        gemm.matmul_launches = gemm.dw_launches = rf.launches = 0
        collective.ring_rotations = 0
        step, (w, x) = entry.entry("cuda")
        losses, w1 = _run_steps(step, w, x, 1)
        losses += _run_steps(step, w1, x, 1)[0]
        mesh = collective.default_mesh(1, "cuda")
        big_step, (bw, bx) = entry._make(mesh, hidden=HIDDEN, rows=HIDDEN)
        big_loss, big_w1 = big_step(bw, bx)
        big_losses = [float(big_loss), float(big_step(big_w1, bx)[0])]
        ring = init_device_mesh("cuda", (1,), mesh_dim_names=("sp",))
        attn = collective.make_ring_attention(ring, "sp")
        rng = np.random.default_rng(SEED + 12)
        qkv = [torch.from_numpy(rng.standard_normal(
            (FOLD[0], FOLD[2]), dtype=np.float32)).cuda() for _ in range(3)]
        att = attn(*qkv)
        torch.cuda.synchronize()
        counts = {"matmul_bf16_f32": gemm.matmul_launches,
                  "dw_f32_bf16": gemm.dw_launches,
                  "ring_fold": rf.launches,
                  "ring_rotations": collective.ring_rotations}
        say(f"main-path 2 counts: {json.dumps(counts)}")
        if min(counts["matmul_bf16_f32"], counts["dw_f32_bf16"],
               counts["ring_fold"]) <= 0:
            raise AssertionError(f"main path 2 missed a kernel: {counts}")

        loss_err = abs(losses[0] - cpu_losses[0]) / abs(cpu_losses[0])
        w1_err = float((w1.cpu() - cpu_w1).abs().max())
        say(f"entry step on the card vs the CPU plain path: losses "
            f"{losses} vs {cpu_losses} (rel err {loss_err:.3g}), w1 max "
            f"abs err {w1_err:.3g}")
        if not (loss_err <= 1e-5 and w1_err <= 1e-7):
            raise AssertionError("entry step differs from the CPU path")
        if not losses[1] < losses[0]:
            raise AssertionError(f"loss did not fall: {losses}")
        _check_big_step(torch, bw, bx, float(big_loss), big_w1, big_losses)
        want = _plain_attention(torch, *qkv)
        att_err = float((att - want).abs().max())
        torch.testing.assert_close(att, want, rtol=2e-5, atol=2e-5)
        say(f"make_ring_attention (world 1, seq {FOLD[0]}, d {FOLD[2]}) "
            f"== plain full attention (max abs err {att_err:.3g})")

        for name, fn, n, n_prof in (
                ("entry shape step", lambda: step(w, x), 50, 20),
                (f"hidden {HIDDEN} step", lambda: big_step(bw, bx), 10, 3),
                (f"ring attention seq {FOLD[0]}", lambda: attn(*qkv), 10,
                 3)):
            wall = _wall_p50_us(torch, fn, n)
            prof_us, rows = _device_profile(torch, fn, n_prof)
            per_call, busy = prof_us / n_prof, sum(r[1] for r in rows)
            for key, us, cnt in rows[:5]:
                say(f"  {name}: device {us:9.1f} us x{cnt:g}  {key[:60]}")
            say(f"{name}: wall p50 {wall:.0f} us (host clock, n={n}); "
                f"profiled wall {per_call:.0f} us, device busy {busy:.0f} "
                f"us = {busy / per_call * 100:.1f}% [{dev['smi']}]")
    finally:
        distributed.shutdown()
    return counts


def phase_dryrun():
    phase("dryrun_multichip(1, device='cuda') in its own process")
    from tbus_torch import entry

    t0 = time.monotonic()
    res = entry.dryrun_multichip(1, device="cuda", rpc=False, timeout_s=300)
    summary = [{key: r[key] for key in ("rank", "loss", "w1_shape",
                                         "attn_shape", "ring_rotations")}
               for r in res]
    say(f"dryrun_multichip(1): {json.dumps(summary)} in "
        f"{time.monotonic() - t0:.1f} s")


# ---- path 3: the C++ device plane (tbus_torch/csrc/cuda_runtime.cc) ----

U8_TRANSFORMS = ("echo", "xor255", "incr")
SERVE_STEP = 64 * 4096  # ServeOptions defaults: max_batch x token_bytes
# K4 timed at the path's sizes: a 4 KiB payload, a 64 KiB shard of path
# 4d's step, the serving step, a 1 MiB payload.
K4_SIZES = [4096, 1 << 16, SERVE_STEP, 1 << 20]
DOT128_K = (1 << 20) // 512  # bench.py:282-284's 1 MiB payload
DOTBENCH = (4096, 32)  # bench.py:306 dotbench4096x32
# (N, T) checked: (256, 3) and (384, 2) on and past the GEMM's 256 tile.
DOTBENCH_CHECKS = [(128, 4), (256, 2), (1000, 3), (256, 3), (384, 2)]


def _dot128_tol(torch, x):
    """Two f32 sums of 128 products in different orders differ by at most
    2 * 128 * 2^-24 * sum|x_i W_ij| (the first-order error bound of each)."""
    from tbus_torch.kernels import device_programs as dp, ieee_fp32

    with ieee_fp32():
        mag = x.abs() @ dp.dot128_weight(x.device).abs()
    return 2 * 128 * 2.0**-24 * mag


def _dotbench_check(torch, n, t, seed, got_sum, got_last):
    """K6 against its plain version. The last matrix element by element:
    one bf16 ulp (the two f32 sums of the final product may round to
    neighbours), plus what the inputs' own differences and the f32 order
    can move the final product: 2^-7 (one ulp, relative) + n * 2^-24 of
    bf16(1/n) * sum_k |v_prev[i, k]| |W[k, j]|. The checksum: 2^-7 *
    sum|v| (one bf16 ulp of the result, and the last matrix's ulps) plus
    the f32 order gap n * 2^-24 * sum|v| (sqrt of the n^2 terms). Returns
    (ok, checksum err, its tolerance, elements beyond one ulp, max
    element err in ulps)."""
    from tbus_torch.kernels import device_programs as dp, ieee_fp32

    want_sum, want_last = dp.dotbench_reference(seed, n, t, device="cuda",
                                                return_last=True)
    prev = dp.dotbench_reference(seed, n, t - 1, device="cuda",
                                 return_last=True)[1]
    _, w = dp.dotbench_operands(seed, n, "cuda")
    inv = float(dp.dotbench_inverse(n))
    with ieee_fp32():
        mag = (prev.float().abs() @ w.float().abs()) * inv
    a, b = got_last.double(), want_last.double()
    diff = (a - b).abs()
    ulp = _bf16_ulp(torch, torch.maximum(a.abs(), b.abs()))
    elem_tol = ulp + (2.0**-7 + n * 2.0**-24) * mag.double()
    sumabs = float(want_last.float().abs().double().sum())
    sum_tol = (2.0**-7 + n * 2.0**-24) * sumabs
    sum_err = abs(float(got_sum.reshape(())) - float(want_sum))
    ok = bool((diff <= elem_tol).all()) and sum_err <= sum_tol
    return (ok, sum_err, sum_tol, int((diff > ulp).sum()),
            float((diff / ulp).max()))


def phase_device_kernels(torch, dev):
    phase("kernels K4-K6: the device plane's programs against their plain "
          "versions")
    from tbus_torch.kernels import _build, device_programs as dp, ieee_fp32

    rng = np.random.default_rng(SEED + 20)
    recs = {}

    # K4: byte for byte at the path's shapes, ragged lengths and an
    # unaligned start (the scalar path); then through the library with in
    # and out at one offset modulo 16 (a scalar head before the vector
    # body), and the v1 kernel, which is timed beside it.
    lib = _build.device_programs_lib()
    stream = torch.cuda.current_stream().cuda_stream
    raw = torch.from_numpy(rng.integers(0, 256, (1 << 20) + 64,
                                        dtype=np.uint8)).cuda()
    cases = [(0, n) for n in (SERVE_STEP, 4096, 1 << 20, 1, 4097,
                              (1 << 20) + 1)] + [(3, 4096 + 5)]
    for off, n in cases:
        x = raw[off:off + n]
        for tf in U8_TRANSFORMS:
            got = dp.u8_transform(x, tf)
            if not torch.equal(got, dp.u8_transform_reference(x, tf)):
                raise AssertionError(f"u8_transform {tf} n={n} off={off}")
    sink = torch.empty_like(raw)
    lib_cases = [(off, n) for off, n in (
        (0, 1 << 20), (0, (1 << 20) + 9), (0, (1 << 16) + 5),
        (5, SERVE_STEP + 3), (15, 4096 + 1))]
    for fn in ("tbus_u8_transform", "tbus_u8_transform_v1"):
        for off, n in lib_cases:
            x, out = raw[off:off + n], sink[off:off + n]
            for tf in U8_TRANSFORMS:
                _raise_cuda(getattr(lib, fn)(x.data_ptr(), out.data_ptr(), n,
                                             dp.U8_OPS[tf], stream), fn)
                if not torch.equal(out, dp.u8_transform_reference(x, tf)):
                    raise AssertionError(f"{fn} {tf} n={n} off={off}")
    torch.cuda.synchronize()
    say(f"K4 byte-equal to its plain version for {', '.join(U8_TRANSFORMS)}"
        f" at n in {[n for _, n in cases]} (one unaligned start), and with "
        f"the v1 kernel through the library at (offset, n) in {lib_cases} "
        f"(in and out at one offset: a scalar head before the vector body)")
    k4 = []
    for n in K4_SIZES:
        x, out = raw[:n], sink[:n]
        v1_ms = _kernel_device_ms(
            torch, lambda: lib.tbus_u8_transform_v1(
                x.data_ptr(), out.data_ptr(), n, dp.U8_OPS["incr"], stream),
            200, "u8_transform_v1_kernel")
        ms = _kernel_device_ms(torch, lambda: dp.u8_transform(x, "incr"),
                               200, "u8_transform_kernel")
        echo_ms = _kernel_device_ms(torch, lambda: dp.u8_transform(x, "echo"),
                                    200, "u8_transform_kernel")
        empty_ms = _kernel_device_ms(
            torch, lambda: lib.tbus_k4_floor_empty(n, stream), 200,
            "floor_empty_kernel")
        copy_ms = _kernel_device_ms(
            torch, lambda: lib.tbus_k4_floor_copy16(x.data_ptr(),
                                                    out.data_ptr(), n,
                                                    stream), 200,
            "floor_copy16_kernel")
        call_ms = _cuda_ms(torch, lambda: dp.u8_transform(x, "incr"), 200)
        plain_ms = _cuda_ms(torch, lambda: dp.u8_transform_reference(
            x, "incr"), 200)
        lib_ms = {"add": _device_call_ms(torch, lambda: x + 1, 200),
                  "xor": _device_call_ms(
                      torch, lambda: torch.bitwise_xor(x, 255), 200),
                  "clone": _device_call_ms(torch, lambda: x.clone(), 200)}
        bound_ms = 2 * n / HBM_BYTES_PER_S * 1e3
        k4.append({"n": n, "ms": ms, "echo_ms": echo_ms, "v1_ms": v1_ms,
                   "floor_empty_ms": empty_ms,
                   "floor_copy16_ms": copy_ms, "call_ms": call_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms["add"],
                   "library_all_ms": lib_ms, "bound_ms": bound_ms})
        say(f"K4 u8_transform incr n={n}, profiler clock: {ms * 1e3:.3f} us "
            f"(echo {echo_ms * 1e3:.3f} us; v1 design "
            f"{v1_ms * 1e3:.3f} us); floor: empty "
            f"kernel in K4's shape {empty_ms * 1e3:.3f} us, one 16-byte "
            f"load+store a thread {copy_ms * 1e3:.3f} us; bound "
            f"{bound_ms * 1e3:.3f} us (bytes; {bound_ms / ms * 100:.1f}%); "
            f"library x+1 {lib_ms['add'] * 1e3:.3f}, bitwise_xor "
            f"{lib_ms['xor'] * 1e3:.3f}, clone {lib_ms['clone'] * 1e3:.3f} "
            f"us; CUDA events: wrapper call {call_ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us [{dev['smi']}]")
    recs["u8_transform"] = {"max_abs_err": 0, "shapes": k4,
                            **k4[K4_SIZES.index(1 << 20)]}

    # K5: against the plain product with TF32 off, at the card tests' k
    # and on the hard payloads (NaN and +-inf where the plain version has
    # them; rows of f32 subnormals; rows of very different scales).
    dot_err = 0.0
    checks = [("normal", k) for k in (1, 2, 7, 8, 17, 64, 1000, DOT128_K,
                                      4096)]
    checks += [(kind, k) for kind in ("subnormal", "scales", "nonfinite")
               for k in (1, 64, DOT128_K)]
    for kind, k in checks:
        if kind == "normal":
            xn = rng.standard_normal((k, 128), dtype=np.float32)
        else:
            xn = dp.dot128_payload(kind, k, 100 + k)
        x = torch.from_numpy(xn).cuda()
        got, want = dp.dot128(x), dp.dot128_reference(x)
        for f in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(f(got), f(want)):
                raise AssertionError(f"dot128 {kind} k={k}: {f.__name__} "
                                     f"differs")
        fin = torch.isfinite(want)
        diff = (got - want).abs()[fin]
        if not bool((diff <= _dot128_tol(torch, x)[fin]).all()):
            raise AssertionError(f"dot128 {kind} k={k}: max err "
                                 f"{float(diff.max())}")
        if kind == "normal":
            dot_err = max(dot_err, float(diff.max()))
        if kind == "subnormal" and int(torch.count_nonzero(got)) <= \
                got.numel() // 2:
            raise AssertionError(f"dot128 subnormal k={k}: flushed")
    say(f"K5 within 2*128*2^-24*(|x|@|W|) of its plain version at k in "
        f"{[k for kind, k in checks if kind == 'normal']} (max abs err "
        f"{dot_err:.3g}) and on subnormal, mixed-scale and nonfinite rows "
        f"at k in (1, 64, {DOT128_K}), NaN and inf where it has them")
    x = torch.from_numpy(rng.standard_normal((DOT128_K, 128),
                                             dtype=np.float32)).cuda()
    y = torch.empty_like(x)
    w = dp.dot128_weight("cuda")
    ms = _kernel_device_ms(torch, lambda: dp.dot128(x), 200, "dot128_kernel")
    v1_ms = _kernel_device_ms(
        torch, lambda: lib.tbus_dot128_v1(x.data_ptr(), y.data_ptr(),
                                          DOT128_K, stream), 200,
        "dot128_v1_kernel")
    plain_ms = _cuda_ms(torch, lambda: dp.dot128_reference(x), 200)
    with ieee_fp32():
        lib_ms = _device_call_ms(torch, lambda: torch.matmul(x, w), 200)
    nbytes = 2 * DOT128_K * 512
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    tc_ms = 3 * 2.0 * DOT128_K * 128 * 128 / BF16_TC_FLOPS * 1e3
    fma_ms = 2.0 * DOT128_K * 128 * 128 / F32_FLOPS * 1e3
    k5 = {"k": DOT128_K, "ms": ms, "v1_ms": v1_ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "bytes",
          "tensor_bound_ms": tc_ms, "fma_bound_ms": fma_ms}
    say(f"K5 dot128 k={DOT128_K}, profiler clock: {ms * 1e3:.3f} us (v1 "
        f"design {v1_ms * 1e3:.3f} us); bound {bound_ms * 1e3:.3f} us "
        f"(bytes; {bound_ms / ms * 100:.1f}%; the 3 bf16 tensor passes "
        f"{tc_ms * 1e3:.3f} us, f32 FMA figure {fma_ms * 1e3:.3f} us); "
        f"torch.matmul f32 (TF32 off) {lib_ms * 1e3:.3f} us; plain (CUDA "
        f"events) {plain_ms * 1e3:.2f} us [{dev['smi']}]")
    recs["dot128"] = {"max_abs_err": dot_err, **k5}

    # K6: the chained bf16 product.
    dot_seed = 0.5
    k6_err = 0.0
    for n, t in DOTBENCH_CHECKS + [DOTBENCH]:
        seed_t = torch.tensor([dot_seed], device="cuda")
        got_sum, got_last = dp.dotbench(seed_t, n, t, return_last=True)
        ok, err, tol, beyond, ulps = _dotbench_check(
            torch, n, t, dot_seed, got_sum, got_last)
        say(f"K6 dotbench{n}x{t}: checksum {float(got_sum):.6g} err "
            f"{err:.3g} (tol {tol:.3g}); last matrix {beyond} of {n * n} "
            f"elements beyond one bf16 ulp, max {ulps:.2f} ulp")
        if not ok:
            raise AssertionError(f"dotbench{n}x{t} differs from its plain "
                                 f"version")
        k6_err = max(k6_err, err)
    n, t = DOTBENCH
    seed_t = torch.tensor([dot_seed], device="cuda")
    ms = _cuda_ms(torch, lambda: dp.dotbench(seed_t, n, t), 5, warmup=1)
    plain_ms = _cuda_ms(torch, lambda: dp.dotbench_reference(
        dot_seed, n, t, device="cuda"), 3, warmup=1)
    a0, w = dp.dotbench_operands(dot_seed, n, "cuda")
    inv = dp.dotbench_inverse(n).cuda()

    def library_chain():
        v = a0
        for _ in range(t):
            v = torch.mm(v, w) * inv
        return v.float().sum().bfloat16()

    lib_ms = _cuda_ms(torch, library_chain, 5, warmup=1)
    lib_one_ms = _cuda_ms(torch, lambda: torch.mm(a0, w), 20)
    step_ms = _kernel_device_ms(torch, lambda: dp.dotbench(seed_t, n, t), 2,
                                "gemm_sm90_kernel")
    flops = t * 2.0 * n**3
    bound_ms = flops / BF16_TC_FLOPS * 1e3
    say(f"K6 dotbench{n}x{t}: {ms:.3f} ms per call ({flops / ms / 1e9:.1f} "
        f"TFLOP/s; one product {step_ms * 1e3:.1f} us on the device) vs "
        f"bound {bound_ms:.3f} ms (operations, bf16 TC) = "
        f"{bound_ms / ms * 100:.1f}%; plain (f32 products, TF32 off) "
        f"{plain_ms:.3f} ms; cuBLAS bf16 chain {lib_ms:.3f} ms, one "
        f"torch.mm {lib_one_ms * 1e3:.1f} us [{dev['smi']}]")
    recs["dotbench"] = {"max_abs_err": k6_err, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "library_one_ms": lib_one_ms,
                        "step_ms": step_ms, "bound_ms": bound_ms,
                        "bound_by": "operations", "n": n, "t": t}
    return recs


DEVICE_METHODS = {"Echo": "echo", "Xor": "xor255", "Incr": "incr",
                  "Dot": "dot128", "Bench": f"dotbench{DOTBENCH[0]}x"
                  f"{DOTBENCH[1]}"}
GEN_METHODS = {"Generate": "incr", "GenXor": "xor255"}


def _device_server():
    """One loopback server with path 3's mounts: the device methods and
    the two generate methods (mounted before start, as the reference)."""
    import tbus_torch as tt

    s = tt.Server()
    for method, tf in DEVICE_METHODS.items():
        s.add_device_method("DevService", method, tf)
    s.add_echo("DevService", "Plain")  # the same RPC without the device
    for method, tf in GEN_METHODS.items():
        s.add_generate_method("GenService", method, tf, max_batch=64,
                              token_bytes=4096)
    return s, s.start(0)


def _device_reply_ok(torch, method, payload, got):
    """A device method's reply against the plain versions on the card."""
    from tbus_torch.kernels import device_programs as dp

    tf = DEVICE_METHODS[method]
    if tf == "dot128":
        x = torch.frombuffer(bytearray(payload), dtype=torch.float32)
        x = x.reshape(-1, 128).cuda()
        y = torch.frombuffer(bytearray(got), dtype=torch.float32).cuda()
        diff = (y.reshape(-1, 128) - dp.dot128_reference(x)).abs()
        return len(got) == len(payload) and bool(
            (diff <= _dot128_tol(torch, x)).all())
    if tf.startswith("dotbench"):
        n, t = dp.parse_dotbench(tf)
        seed = struct.unpack("<f", payload)[0]
        want, last = dp.dotbench_reference(seed, n, t, device="cuda",
                                           return_last=True)
        tol = (2.0**-7 + n * 2.0**-24) * float(last.float().abs().sum())
        return len(got) == 4 and abs(
            struct.unpack("<f", got)[0] - float(want)) <= tol
    return got == dp.device_method_reference(tf, payload, device="cuda")


def phase_device_methods(torch, dev, port):
    phase("main path 3a: device methods through the CUDA runtime")
    import tbus_torch as tt
    from tbus_torch import rpc

    rng = np.random.default_rng(SEED + 21)
    ch = tt.Channel(f"127.0.0.1:{port}", timeout_ms=60000)
    u8 = {k: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
          for k, n in SIZES.items()}
    x = rng.standard_normal((DOT128_K, 128), dtype=np.float32).tobytes()
    seed = struct.pack("<f", 0.5)
    calls = [(m, k, u8[k]) for m in ("Echo", "Xor", "Incr") for k in SIZES]
    calls += [("Dot", "1MiB", x), ("Bench", "seed", seed)]

    # The main path's run: every count starts at 0 here.
    rpc.reset_device_launches()
    before = rpc.device_stats()
    replies = {(m, k): ch.call("DevService", m, p) for m, k, p in calls}
    after = rpc.device_stats()
    launches = after["launches"]
    say(f"device_stats before: {json.dumps(before)}")
    say(f"device_stats after:  {json.dumps(after)}")
    for m, k, p in calls:
        if not _device_reply_ok(torch, m, p, replies[(m, k)]):
            raise AssertionError(f"device method {m} at {k} differs from "
                                 f"its plain version")
    if after["platform"] != "cuda" or min(
            launches[k] for k in ("u8_transform", "dot128", "dotbench")) <= 0:
        raise AssertionError(f"path 3a missed a kernel: {launches}")
    say(f"every reply equals its plain version on the card: "
        f"{', '.join(f'{m}/{k}' for m, k, _ in calls)}; launches on the "
        f"path: {json.dumps(launches)}")

    lat = {}
    plain = [("Plain", k, u8[k]) for k in SIZES]
    for m, k, p in calls + plain:
        n = 5 if m == "Bench" else 40
        samples = _latencies(lambda: ch.call("DevService", m, p), n)
        lat[f"{m}/{k}"] = {"p50_us": _pctl(samples, 50),
                           "p99_us": _pctl(samples, 99), "n": n}
        say(f"{'device method' if m != 'Plain' else 'native echo'} {m} "
            f"({DEVICE_METHODS.get(m, 'no device')}) {k}: p50 "
            f"{lat[f'{m}/{k}']['p50_us']:.0f} us p99 "
            f"{lat[f'{m}/{k}']['p99_us']:.0f} us (host clock, n={n}) "
            f"[{dev['smi']}]")
    busy = {}
    for m, k, p in (("Echo", "1MiB", u8["1MiB"]), ("Echo", "4KiB", u8["4KiB"]),
                    ("Dot", "1MiB", x), ("Bench", "seed", seed)):
        n = 2 if m == "Bench" else 20
        wall_us, rows = _device_profile(
            torch, lambda: ch.call("DevService", m, p), n)
        per_call, dev_us = wall_us / n, sum(r[1] for r in rows)
        busy[f"{m}/{k}"] = {"wall_us": per_call, "device_us": dev_us}
        for key, us, cnt in rows[:4]:
            say(f"  {m} {k}: device {us:9.1f} us x{cnt:g}  {key[:60]}")
        say(f"{m} {k} call: wall {per_call:.0f} us, device busy "
            f"{dev_us:.1f} us = {dev_us / per_call * 100:.1f}% [{dev['smi']}]")
    return launches, lat, busy


def _token_truth(tf, prompt, ntokens, token_bytes=4096):
    """The documented token rule: state = prompt repeated to token_bytes,
    the transform applied once per step; token i is the state after step
    i + 1."""
    reps = -(-token_bytes // len(prompt))
    state = np.frombuffer((prompt * reps)[:token_bytes], dtype=np.uint8)
    out = []
    for _ in range(ntokens):
        state = state ^ 0xFF if tf == "xor255" else state + np.uint8(1)
        out.append(state.tobytes())
    return out


def phase_serving(torch, dev, port):
    phase("main path 3b: continuous-batching generate on the CUDA step "
          "engine")
    import tbus_torch as tt
    from tbus_torch import rpc

    n_streams, ntokens = 64, 16
    rpc.reset_device_launches()
    before = {s["name"]: s for s in tt.serve_stats()}
    errors = []

    def one(i, method):
        try:
            ch = tt.Channel(f"127.0.0.1:{port}", timeout_ms=60000)
            prompt = f"prompt-{method}-{i:03d}".encode()
            want = _token_truth(GEN_METHODS[method], prompt, ntokens)
            req = struct.pack("<I", ntokens) + prompt
            with tt.Stream.create(ch, "GenService", method, req) as st:
                for k in range(ntokens):
                    if st.read(timeout_ms=60000) != want[k]:
                        raise AssertionError(f"{method} stream {i} token {k}")
                if st.read(timeout_ms=60000) is not None:
                    raise AssertionError(f"{method} stream {i}: no clean end")
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    for method in GEN_METHODS:
        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(i, method))
                   for i in range(n_streams)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        say(f"{method} ({GEN_METHODS[method]}): {n_streams} concurrent "
            f"streams x {ntokens} tokens of 4096 bytes byte-exact in "
            f"{time.monotonic() - t0:.2f} s")
    launches = rpc.device_stats()["launches"]
    stats = {s["name"]: s for s in tt.serve_stats()}
    for method in GEN_METHODS:
        st = stats[f"GenService.{method}"]
        b = before.get(f"GenService.{method}", {})
        steps = st["steps"] - b.get("steps", 0)
        if st.get("engine") != "cuda" or st["engine_failures"] != 0 \
                or st["engine_steps"] != st["steps"] or steps <= 0:
            raise AssertionError(f"serve stats: {st}")
        say(f"serve_stats GenService.{method}: engine {st['engine']}, "
            f"{steps} steps (all on the engine), plan hits/misses "
            f"{st['plan_hits']}/{st['plan_misses']}, peak batch "
            f"{st['peak_batch']}")
    if launches["u8_transform"] <= 0:
        raise AssertionError(f"path 3b missed K4: {launches}")
    say(f"launches on path 3b: {json.dumps(launches)}")

    bench = tt.bench_serve(f"127.0.0.1:{port}", "GenService", "Generate",
                           concurrency=64, duration_ms=2000, ntokens=ntokens,
                           token_bytes=4096, timeout_ms=10000)
    if bench["ok"] <= 0 or bench["other"] or bench["timedout"]:
        raise AssertionError(f"bench_serve: {bench}")
    say(f"bench_serve 64 x {ntokens} tokens, 2 s: {bench['token_qps']:.0f} "
        f"tokens/s, {bench['seq_qps']:.0f} seq/s, TTFT p50 "
        f"{bench['ttft_p50_us']:.0f} us p99 {bench['ttft_p99_us']:.0f} us, "
        f"gap p50 {bench['gap_p50_us']:.0f} us p99 {bench['gap_p99_us']:.0f} "
        f"us, ok {bench['ok']} shed {bench['shed']} [{dev['smi']}]")
    wall_us, rows = _device_profile(torch, lambda: tt.bench_serve(
        f"127.0.0.1:{port}", "GenService", "Generate", concurrency=64,
        duration_ms=300, ntokens=ntokens, token_bytes=4096,
        timeout_ms=10000), 1)
    dev_us = sum(r[1] for r in rows)
    for key, us, cnt in rows[:4]:
        say(f"  serving 0.3 s: device {us:9.1f} us x{cnt:g}  {key[:60]}")
    say(f"serving under bench_serve (0.3 s window): device busy "
        f"{dev_us / wall_us * 100:.1f}% of {wall_us / 1e3:.0f} ms "
        f"[{dev['smi']}]")
    return launches, bench


def phase_rpc_leg(dev):
    phase("path 1's RPC leg: ParallelChannel to 8 tpu:// servers, lowered "
          "and p2p")
    import tbus_torch as tt
    from tbus_torch.parallel import runtime

    tt.advertise_device_method("FanoutRpc", "Echo", "echo/v1")
    tt.advertise_device_method("FanoutRpc", "Xor", "xor255/v1")
    servers, pchan = [], tt.ParallelChannel()
    for _ in range(N_PEERS):
        s = tt.Server()
        s.add_echo("FanoutRpc", "Echo")
        s.add_method("FanoutRpc", "Xor", tt.builtin_handler("xor255"))
        servers.append(s)
        pchan.add(f"tpu://127.0.0.1:{s.start(0)}")
    if not pchan.collective_eligible:
        raise AssertionError("the 8 tpu:// servers are not fan-out eligible")
    rng = np.random.default_rng(SEED + 22)
    payloads = {k: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for k, n in SIZES.items()}
    out = {}
    p2p = {k: pchan.call("FanoutRpc", "Echo", p, 30000)
           for k, p in payloads.items()}
    xor_p2p = pchan.call("FanoutRpc", "Xor", payloads["4KiB"], 30000)
    for k, p in payloads.items():
        if p2p[k] != p * N_PEERS:
            raise AssertionError(f"p2p echo {k}")
        lat = _latencies(lambda: pchan.call("FanoutRpc", "Echo", p, 30000),
                         50 if k == "4KiB" else 20)
        out[f"p2p/{k}"] = {"p50_us": _pctl(lat, 50), "p99_us": _pctl(lat, 99)}
    if not tt.enable_torch_fanout():
        raise AssertionError("enable_torch_fanout failed")
    tt.register_device_echo("FanoutRpc", "Echo")
    tt.register_device_method("FanoutRpc", "Xor", "xor255", "xor255/v1")
    before = tt.torch_lowered_calls()
    for k, p in payloads.items():
        if pchan.call("FanoutRpc", "Echo", p, 30000) != p2p[k]:
            raise AssertionError(f"lowered echo {k} differs from p2p")
    if pchan.call("FanoutRpc", "Xor", payloads["4KiB"], 30000) != xor_p2p:
        raise AssertionError("lowered xor255 4KiB differs from p2p")
    if tt.torch_lowered_calls() < before + 3:
        raise AssertionError("the calls did not lower")
    for k, p in payloads.items():
        lat = _latencies(lambda: pchan.call("FanoutRpc", "Echo", p, 30000),
                         50 if k == "4KiB" else 20)
        out[f"lowered/{k}"] = {"p50_us": _pctl(lat, 50),
                               "p99_us": _pctl(lat, 99)}
    for key, v in out.items():
        say(f"ParallelChannel x{N_PEERS} tpu:// {key}: p50 "
            f"{v['p50_us']:.0f} us p99 {v['p99_us']:.0f} us [{dev['smi']}]")
    say(f"lowered == p2p bytes (echo 4KiB, 1MiB; xor255 4KiB); "
        f"{tt.torch_lowered_calls() - before} lowered calls, "
        f"{runtime.lowered_calls} through the runtime")
    for s in servers:
        s.stop()
    return out


# ---- path 4: the fused fan-out engine (tbus_torch/csrc/cuda_fanout.cc) ----

# K7's checks: (n, bucket) over the three builtins, broadcast and scatter.
# n = 4 and buckets 1 KiB to 64 KiB are path 4d's serving steps (a step of
# 1 to 64 rows of 4 KiB scattered over 4 shards), 4 KiB and 1 MiB are 4b's
# and 4c's, 6144 is a half-step length class; bucket 1000 is ragged (the
# kernel's scalar path).
FANOUT_N = (1, 4, 8, 64)
FANOUT_BUCKETS = (128, 1000, 1024, 2048, 4096, 6144, 8192, 16384, 32768,
                  65536, 1 << 20)
FANOUT_CHECKS = [(n, b) for n in FANOUT_N for b in FANOUT_BUCKETS]
# Timed at the main path's shapes: path 4b's 8 x 4 KiB and 8 x 1 MiB
# broadcasts, 4c's 8 x 1 MiB scatter and 4d's 4 x 64 KiB serving step.
FANOUT_TIMED = [(8, 4096, False), (8, 1 << 20, False), (8, 1 << 20, True),
                (4, 1 << 16, True)]
NATIVE_SERVICE = "NativeRpc"
NATIVE_METHODS = {"Echo": ("echo", "echo/v1"), "Xor": ("xor255", "xor255/v1"),
                  "Add": ("add_peer_index", "add_peer_index/v1")}
TP_SHARDS = 4
SINK_BYTES, SINK_CHUNK = 256 << 20, 1 << 20


def phase_fanout_kernel(torch, dev):
    phase("kernel K7: the fused fan-out against its plain version")
    from tbus_torch.kernels import fanout as fk

    rng = np.random.default_rng(SEED + 30)
    cases = 0
    for n, bucket in FANOUT_CHECKS:
        for scatter in (False, True):
            size = n * bucket if scatter else bucket
            raw = torch.from_numpy(rng.integers(0, 256, size + 1,
                                                dtype=np.uint8)).cuda()
            for x in (raw[:size], raw[1:]):  # aligned, and one byte in
                for builtin in fk.BUILTINS:
                    got = fk.fanout(x, n, bucket, scatter, builtin)
                    if not torch.equal(got, fk.fanout_plain(
                            x, n, bucket, scatter, builtin)):
                        raise AssertionError(
                            f"K7 {builtin} n={n} bucket={bucket} "
                            f"scatter={scatter} differs from its plain "
                            f"version")
                    cases += 1
    torch.cuda.synchronize()
    say(f"K7 byte-equal to fanout_plain in {cases} cases: "
        f"{', '.join(fk.BUILTINS)} x broadcast/scatter x n in {FANOUT_N} x "
        f"bucket in {FANOUT_BUCKETS} (1000 ragged), aligned and unaligned")
    shapes = []
    for n, bucket, scatter in FANOUT_TIMED:
        size = n * bucket if scatter else bucket
        x = torch.from_numpy(rng.integers(0, 256, size,
                                          dtype=np.uint8)).cuda()
        for builtin in fk.BUILTINS:  # the timed inputs themselves
            if not torch.equal(fk.fanout(x, n, bucket, scatter, builtin),
                               fk.fanout_plain(x, n, bucket, scatter,
                                               builtin)):
                raise AssertionError(
                    f"K7 {builtin} n={n} bucket={bucket} scatter={scatter} "
                    f"differs from its plain version on the timed input")
        # The kernel's device time with its input out of L2 (50 MiB on
        # the H100): the timed launches cycle through copies of the input
        # that together hold more than 3x L2.
        copies = [x.clone() for _ in range(max(2, -(-(160 << 20) // (
            size + n * bucket))))]
        turn = iter(range(1 << 30))
        cold = lambda: fk.fanout(  # noqa: E731
            copies[next(turn) % len(copies)], n, bucket, scatter, "xor255")
        launch = lambda: fk.fanout(x, n, bucket, scatter, "xor255")  # noqa
        iters = 200 if n * bucket <= (1 << 20) else 50
        ms = _kernel_device_ms(torch, cold, iters, "fanout_kernel")
        hot_ms = _kernel_device_ms(torch, launch, iters, "fanout_kernel")
        call_ms = _cuda_ms(torch, launch, iters)
        plain_ms = _cuda_ms(torch, lambda: fk.fanout_plain(
            x, n, bucket, scatter, "xor255"), iters)
        rows = x.view(n, bucket) if scatter else x.view(1, bucket).expand(
            n, bucket)
        lib_ms = _cuda_ms(torch, lambda: rows ^ 255, iters)
        lib_clone_ms = _cuda_ms(torch, lambda: rows.clone(), iters)
        nbytes = size + n * bucket
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shapes.append({"n": n, "bucket": bucket, "scatter": scatter,
                       "ms": ms, "l2_hot_ms": hot_ms, "call_ms": call_ms,
                       "plain_ms": plain_ms,
                       "library_ms": lib_ms, "library_clone_ms": lib_clone_ms,
                       "bound_ms": bound_ms})
        say(f"K7 xor255 {'scatter' if scatter else 'broadcast'} n={n} "
            f"bucket={bucket}: {ms * 1e3:.2f} us on the device, input out "
            f"of L2 ({hot_ms * 1e3:.2f} us with it in L2) (bound "
            f"{bound_ms * 1e3:.3f} us, bytes, {nbytes} of them; "
            f"{bound_ms / ms * 100:.1f}%); wrapper call {call_ms * 1e3:.2f} "
            f"us; plain {plain_ms * 1e3:.2f} us; library "
            f"{'x.view(n, -1)' if scatter else 'x.expand(n, -1)'} ^ 255 "
            f"{lib_ms * 1e3:.2f} us, .clone() {lib_clone_ms * 1e3:.2f} us "
            f"[{dev['smi']}]")
    return {"max_abs_err": 0, "shapes": shapes, **shapes[1]}


def _dma_line(tag, before, after):
    keys = ("h2d_copy_bytes", "d2h_copy_bytes", "donation_hits",
            "donation_misses", "alias_hits", "alias_misses", "reg_failures")
    delta = {k: after[k] - before[k] for k in keys}
    delta["enabled"] = after["enabled"]
    delta["host_registered"] = after["host_registered"]
    say(f"  DMA {tag}: {json.dumps(delta)}")
    return delta


def _advertise_native(tt):
    for method, (_, impl) in NATIVE_METHODS.items():
        tt.advertise_device_method(NATIVE_SERVICE, method, impl)
    tt.advertise_device_method("GenTPShard", "Generate", "serve/v1")


def _native_fleet(tt):
    """Eight tpu:// servers answering the builtins' p2p twins."""
    servers, ports = [], []
    for i in range(N_PEERS):
        s = tt.Server()
        s.add_echo(NATIVE_SERVICE, "Echo")
        s.add_method(NATIVE_SERVICE, "Xor", tt.builtin_handler("xor255"))
        s.add_method(NATIVE_SERVICE, "Add",
                     tt.builtin_handler("add_peer_index", i))
        servers.append(s)
        ports.append(s.start(0))
    return servers, ports


def phase_path4(dev, quick=False):
    """Path 4 (b)-(e) in this process: returns its numbers. quick: the
    children's window (fewer timed calls, no profile, 128 MiB streamed)."""
    import tbus_torch as tt
    from tbus_torch import rpc

    _advertise_native(tt)  # before the servers start: adverts ride the
    # tpu:// handshake
    dma_on = rpc.device_dma_stats()["enabled"]
    tag = "DMA on" if dma_on else "DMA off"
    res = {"dma": dma_on, "lat": {}, "dma_stats": {}}
    rng = np.random.default_rng(SEED + 31)
    servers, ports = _native_fleet(tt)
    pchan = tt.ParallelChannel()
    for p in ports:
        pchan.add(f"tpu://127.0.0.1:{p}")
    if not pchan.collective_eligible:
        raise AssertionError("path 4: the 8 tpu:// servers are not eligible")
    payloads = {k: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for k, n in SIZES.items()}
    p2p = {(m, k): pchan.call(NATIVE_SERVICE, m, p, 30000)
           for m in NATIVE_METHODS for k, p in payloads.items()}
    for (m, k), got in p2p.items():
        want = b"".join(_p2p_answers(NATIVE_METHODS[m][0], payloads[k]))
        if got != want:
            raise AssertionError(f"p2p {m} {k}")
    n_lat = {"4KiB": 100 if quick else 200, "1MiB": 20 if quick else 30}
    for k, p in payloads.items():
        lat = _latencies(lambda: pchan.call(NATIVE_SERVICE, "Echo", p, 30000),
                         n_lat[k])
        res["lat"][f"p2p/{k}"] = {"p50_us": _pctl(lat, 50),
                                  "p99_us": _pctl(lat, 99), "n": len(lat)}

    # (b) The C++ engine, in the process that ran the torch leg.
    phase(f"main path 4b: ParallelChannel x{N_PEERS} lowered by the C++ "
          f"engine onto K7 ({tag})")
    if not tt.enable_native_fanout():
        raise AssertionError("enable_native_fanout failed")
    for m, (builtin, impl) in NATIVE_METHODS.items():
        tt.register_native_device_method(NATIVE_SERVICE, m, builtin, impl)
    st0, dev0, dma0 = (tt.native_fanout_stats(), rpc.device_stats(),
                       rpc.device_dma_stats())
    tt.flag_set("tbus_fanout_divergence_permille", 1000)
    for (m, k), want in p2p.items():
        # At 1000 the p2p bytes are served and the lowered ones compared.
        if pchan.call(NATIVE_SERVICE, m, payloads[k], 30000) != want:
            raise AssertionError(f"guarded {m} {k}")
    tt.flag_set("tbus_fanout_divergence_permille", 0)
    for (m, k), want in p2p.items():
        if pchan.call(NATIVE_SERVICE, m, payloads[k], 30000) != want:
            raise AssertionError(f"lowered {m} {k} differs from p2p")
    st1, dev1 = tt.native_fanout_stats(), rpc.device_stats()
    calls = 2 * len(p2p)
    lowered = st1["lowered_calls"] - st0["lowered_calls"]
    execs = st1["device_execs"] - st0["device_execs"]
    k7 = dev1["launches"]["fanout"] - dev0["launches"]["fanout"]
    if (lowered != calls or execs != calls or k7 != calls
            or st1["divergence_checked"] - st0["divergence_checked"]
            != len(p2p) or st1["divergence_mismatch"] != 0):
        raise AssertionError(f"path 4b counts: {calls} calls, {st1}, "
                             f"K7 launches {k7}")
    say(f"lowered == p2p byte for byte: {', '.join(NATIVE_METHODS)} at "
        f"{', '.join(SIZES)} over {N_PEERS} peers, compared inside at "
        f"permille 1000 ({len(p2p)} checked, 0 mismatched) and returned at "
        f"0; {calls} lowered calls = {execs} device_execs = {k7} K7 "
        f"launches")
    res["dma_stats"]["b"] = _dma_line(f"4b {tag} (byte checks)", dma0,
                                      rpc.device_dma_stats())
    for k, p in payloads.items():
        d0 = rpc.device_dma_stats()
        for _ in range(3):
            pchan.call(NATIVE_SERVICE, "Echo", p, 30000)
        lat = _latencies(lambda: pchan.call(NATIVE_SERVICE, "Echo", p, 30000),
                         n_lat[k])
        res["lat"][f"native/{k}"] = {"p50_us": _pctl(lat, 50),
                                     "p99_us": _pctl(lat, 99),
                                     "n": len(lat)}
        res["dma_stats"][f"b/{k}"] = _dma_line(f"4b {tag} echo {k} timed",
                                               d0, rpc.device_dma_stats())
    if not quick:
        import torch

        for k, p in payloads.items():
            n = 30 if k == "4KiB" else 10
            wall_us, prof = _device_profile(torch, lambda: pchan.call(
                NATIVE_SERVICE, "Echo", p, 30000), n)
            busy = sum(r[1] for r in prof)
            for key, us, cnt in prof[:4]:
                say(f"  4b {k} call: device {us:9.1f} us x{cnt:g}  "
                    f"{key[:60]}")
            res.setdefault("busy", {})[k] = {"wall_us": wall_us / n,
                                             "device_us": busy}
            say(f"4b {k} lowered call: wall {wall_us / n:.0f} us, device "
                f"busy {busy:.1f} us = {busy / (wall_us / n) * 100:.1f}% "
                f"[{dev['smi']}]")
    for key in ("p2p/4KiB", "native/4KiB", "p2p/1MiB", "native/1MiB"):
        v = res["lat"][key]
        say(f"ParallelChannel x{N_PEERS} tpu:// {key} ({tag}): p50 "
            f"{v['p50_us']:.0f} us p99 {v['p99_us']:.0f} us (n={v['n']}) "
            f"[{dev['smi']}]")

    # (c) PartitionChannel scatter: 8 partitions x 1 MiB.
    phase(f"main path 4c: PartitionChannel scatter, {N_PEERS} x 1 MiB "
          f"({tag})")
    url = "list://" + ",".join(f"tpu://127.0.0.1:{p} {i}/{N_PEERS}"
                               for i, p in enumerate(ports))
    part = tt.PartitionChannel(N_PEERS, url)
    if not part.collective_eligible:
        raise AssertionError("path 4c: partitions are not eligible")
    body = rng.integers(0, 256, N_PEERS << 20, dtype=np.uint8)
    rows = body.reshape(N_PEERS, 1 << 20)
    want = {"Echo": body.tobytes(), "Xor": (body ^ 0xFF).tobytes(),
            "Add": (rows + np.arange(N_PEERS, dtype=np.uint8)[:, None]
                    ).tobytes()}
    st0, dma0 = tt.native_fanout_stats(), rpc.device_dma_stats()
    for m in NATIVE_METHODS:
        part.call(NATIVE_SERVICE, m, body.tobytes(), 30000)  # warm sockets
    tt.flag_set("tbus_fanout_divergence_permille", 1000)
    for m, w in want.items():
        if part.call(NATIVE_SERVICE, m, body.tobytes(), 30000) != w:
            raise AssertionError(f"guarded partition {m}")
    tt.flag_set("tbus_fanout_divergence_permille", 0)
    for m, w in want.items():
        if part.call(NATIVE_SERVICE, m, body.tobytes(), 30000) != w:
            raise AssertionError(f"lowered partition {m} is wrong")
    st1 = tt.native_fanout_stats()
    scattered = st1["scatter_calls"] - st0["scatter_calls"]
    if scattered < 2 * len(want) or st1["divergence_mismatch"] != 0:
        raise AssertionError(f"path 4c did not lower: {st1}")
    res["dma_stats"]["c"] = _dma_line(f"4c {tag}", dma0,
                                      rpc.device_dma_stats())
    b8 = body.tobytes()
    lat = _latencies(lambda: part.call(NATIVE_SERVICE, "Xor", b8, 30000),
                     10 if quick else 20)
    res["lat"]["scatter/8x1MiB"] = {"p50_us": _pctl(lat, 50),
                                    "p99_us": _pctl(lat, 99), "n": len(lat)}
    say(f"partition scatter 8 x 1 MiB == the builtins' answers "
        f"({', '.join(want)}); {scattered} scatter calls lowered; xor255 "
        f"p50 {_pctl(lat, 50):.0f} us p99 {_pctl(lat, 99):.0f} us "
        f"({tag}) [{dev['smi']}]")
    for s in servers:
        s.stop()

    # (d) Tensor-parallel serving over 4 shard servers.
    phase(f"main path 4d: tensor-parallel generate over {TP_SHARDS} shards "
          f"({tag})")
    shards, shard_ports = [], []
    for _ in range(TP_SHARDS):
        s = tt.Server()
        s.add_method("GenTPShard", "Generate", tt.builtin_handler("xor255"))
        shards.append(s)
        shard_ports.append(s.start(0))
    adverts0 = tt.native_fanout_stats()["advertised_peers"]
    hs = [tt.Channel(f"tpu://127.0.0.1:{p}", timeout_ms=10000)
          for p in shard_ports]  # the links carry the adverts: kept open
    for ch in hs:
        ch.call("GenTPShard", "Generate", b"hs")
    deadline = time.monotonic() + 10
    while (tt.native_fanout_stats()["advertised_peers"] < adverts0
           + TP_SHARDS and time.monotonic() < deadline):
        time.sleep(0.005)
    gen = tt.Server()
    gen.add_generate_method(
        "GenTP", "Generate", "xor255", max_batch=64, token_bytes=4096,
        peers=",".join(f"127.0.0.1:{p}" for p in shard_ports))
    gport = gen.start(0)
    fs0, dma0 = tt.fanout_step_stats(), rpc.device_dma_stats()
    errors, n_streams, ntokens = [], 64, 16

    def one(i):
        try:
            ch = tt.Channel(f"127.0.0.1:{gport}", timeout_ms=60000)
            prompt = f"tp-prompt-{i:03d}".encode()
            want_t = _token_truth("xor255", prompt, ntokens)
            req = struct.pack("<I", ntokens) + prompt
            with tt.Stream.create(ch, "GenTP", "Generate", req) as st:
                for k in range(ntokens):
                    if st.read(timeout_ms=60000) != want_t[k]:
                        raise AssertionError(f"tp stream {i} token {k}")
                if st.read(timeout_ms=60000) is not None:
                    raise AssertionError(f"tp stream {i}: no clean end")
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(n_streams)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    fs1 = tt.fanout_step_stats()
    if fs1["fallback_steps"] != fs0["fallback_steps"] or \
            fs1["collective_steps"] <= fs0["collective_steps"]:
        raise AssertionError(f"path 4d steps: {fs0} -> {fs1}")
    say(f"{n_streams} streams x {ntokens} tokens of 4096 bytes byte-exact; "
        f"{fs1['collective_steps'] - fs0['collective_steps']} steps as one "
        f"ScatterGather each, fallback_steps 0")
    bench = tt.bench_serve(f"127.0.0.1:{gport}", "GenTP", "Generate",
                           concurrency=64, duration_ms=1000 if quick
                           else 2000, ntokens=ntokens, token_bytes=4096,
                           timeout_ms=10000)
    fs2 = tt.fanout_step_stats()
    if bench["ok"] <= 0 or bench["other"] or bench["timedout"] or \
            fs2["fallback_steps"] != fs0["fallback_steps"]:
        raise AssertionError(f"path 4d bench: {bench} {fs2}")
    res["serve"] = {**bench, "collective_steps":
                    fs2["collective_steps"] - fs0["collective_steps"],
                    "fallback_steps": 0}
    res["dma_stats"]["d"] = _dma_line(f"4d {tag}", dma0,
                                      rpc.device_dma_stats())
    say(f"bench_serve tensor-parallel 64 x {ntokens} tokens ({tag}): "
        f"{bench['token_qps']:.0f} tokens/s, {bench['seq_qps']:.0f} seq/s, "
        f"TTFT p50 {bench['ttft_p50_us']:.0f} us p99 "
        f"{bench['ttft_p99_us']:.0f} us, gap p50 {bench['gap_p50_us']:.0f} "
        f"us p99 {bench['gap_p99_us']:.0f} us, ok {bench['ok']}; "
        f"collective steps {res['serve']['collective_steps']}, fallback 0 "
        f"[{dev['smi']}]")
    gen.stop()
    for s in shards:
        s.stop()
    del hs

    # (e) The device stream sink.
    phase(f"main path 4e: device stream sink, {SINK_BYTES >> 20} MiB in "
          f"1 MiB chunks ({tag})")
    sink = tt.Server()
    sink.add_device_stream_sink("DeviceStream", "Sink", "xor255", echo=True)
    sport = sink.start(0)
    ss0, dma0 = tt.stream_sink_stats(), rpc.device_dma_stats()
    total = SINK_BYTES // 2 if quick else SINK_BYTES
    r = tt.bench_device_stream(f"tpu://127.0.0.1:{sport}", total, SINK_CHUNK,
                               "xor255")
    deadline = time.monotonic() + 30
    while (tt.stream_sink_stats()["chunks"] - ss0["chunks"] < r["chunks"]
           and time.monotonic() < deadline):
        time.sleep(0.01)
    ss1 = tt.stream_sink_stats()
    sunk = ss1["chunks"] - ss0["chunks"]
    if r["chunks"] != total // SINK_CHUNK or sunk != r["chunks"] or \
            ss1["failures"] != ss0["failures"]:
        raise AssertionError(f"path 4e: {r}, sink {ss0} -> {ss1}")
    res["sink"] = {**r, "sunk_chunks": sunk}
    res["dma_stats"]["e"] = _dma_line(f"4e {tag}", dma0,
                                      rpc.device_dma_stats())
    say(f"bench_device_stream {total >> 20} MiB ({tag}): "
        f"{r['goodput_MBps']:.0f} MB/s, gap p50 {r['gap_p50_us']:.0f} us "
        f"p99 {r['gap_p99_us']:.0f} us, {r['chunks']} chunks produced on "
        f"the device, {sunk} run through the sink's device [{dev['smi']}]")
    sink.stop()
    return res


def phase_path4_pair():
    """Path 4 (b)-(e) again in two like child processes, the DMA table
    armed in one and off in the other, over the same window: the pair
    that says what registration changes."""
    out = {}
    for mode in ("on", "off"):
        phase(f"path 4 in a child process, DMA {mode}")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--path4-child",
             mode], capture_output=True, text=True, timeout=300,
            env=dict(os.environ, TBUS_PJRT_DMA="0"))
        for line in proc.stdout.splitlines():
            if line.startswith(("  ", "ParallelChannel", "bench", "partition",
                                "lowered ==", "64 streams", "==")):
                say(f"  [child, DMA {mode}] {line.strip()}")
        if proc.returncode != 0:
            raise AssertionError(
                f"the DMA-{mode} child failed:\n{proc.stdout[-3000:]}\n"
                f"{proc.stderr[-3000:]}")
        out[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out


def path4_child(mode):
    """Entry of a path-4 child: the DMA table armed before the pool comes
    up (mode "on") or left off ("off"), the runtime on the card, then path
    4 (b)-(e) in its child window; the last line is its JSON."""
    import torch
    import tbus_torch as tt
    from tbus_torch import rpc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    dev = {"name": torch.cuda.get_device_name(0), "smi": smi.splitlines()[0]}
    if mode == "on":
        tt.device_enable_dma()
    tt.init()
    tt.device_init("cuda")
    if rpc.device_dma_stats()["enabled"] != (mode == "on"):
        raise AssertionError(f"the DMA-{mode} child has the table "
                             f"{rpc.device_dma_stats()['enabled']}")
    res = phase_path4(dev, quick=True)
    say(json.dumps(res))
    return 0


# ---- path 5: the core's load generator and global_mesh on the card ----

GEN_MS = 1000  # one generator leg
GEN_CELLS = [("Plain", "4KiB"), ("Plain", "1MiB"), ("Echo", "4KiB"),
             ("Echo", "1MiB"), ("Xor", "4KiB"), ("Xor", "1MiB"),
             ("Dot", "1MiB")]  # Dot at 1 MiB only, as bench.py:282-291
GEN_CONC = (1, 8)
GEN_WIRES = ("http", "h2", "grpc", "thrift", "nshead")
# The runtime's kernel each device method launches once a call.
GEN_KERNEL = {"Echo": "u8_transform", "Xor": "u8_transform",
              "Dot": "dot128"}
DOT128_FLOPS = 2.0 * ((1 << 20) // 512) * 128 * 128  # bench.py:290


def _gen_leg(rpc, addr, method, key, conc):
    return rpc.bench_echo(addr, SIZES[key], conc, GEN_MS,
                          service="DevService", method=method)


def _hops(stats, before=None):
    """The tpu:// hops a stage_stats() snapshot holds: the count since
    `before` and p50/p99 (ns) over the recorder's recent samples."""
    out = {}
    for name, st in stats.items():
        if not name.startswith("tbus_shm_stage_") or "_lane" in name:
            continue
        n = st["count"] - (before or {}).get(name, {}).get("count", 0)
        if n > 0:
            out[name[len("tbus_shm_stage_"):]] = {
                "count": n, "p50_ns": st["p50_ns"], "p99_ns": st["p99_ns"]}
    return out


# A traced call's hops, in order: (name, from, to), each stamp a
# ("client" | "server", stage) of the call's two rpcz spans ("start" and
# "end" are the client span's own ends). Their sum is the call's latency.
SPAN_HOPS = [
    ("issue_to_publish", ("client", "start"), ("client", "send_publish")),
    ("publish_to_ring", ("client", "send_publish"), ("client", "send_ring")),
    ("ring_to_server_pickup", ("client", "send_ring"), ("server", "rx_pickup")),
    ("pickup_to_dispatch", ("server", "rx_pickup"), ("server", "dispatch")),
    ("dispatch_to_done", ("server", "dispatch"), ("server", "done")),
    ("done_to_resp_publish", ("server", "done"), ("server", "resp_publish")),
    ("resp_publish_to_client_pickup", ("server", "resp_publish"),
     ("client", "resp_pickup")),
    ("pickup_to_wakeup", ("client", "resp_pickup"), ("client", "wakeup")),
    ("wakeup_to_end", ("client", "wakeup"), ("client", "end")),
]


def _span_hops(pairs):
    """p50 and p90 (us) of each hop over the traced calls, and their
    count (calls whose spans carry every stamp)."""
    per_hop = {name: [] for name, _, _ in SPAN_HOPS}
    total, n = [], 0
    for client, server in pairs:
        ns = {("client", "start"): client["start_us"] * 1000,
              ("client", "end"): client["end_us"] * 1000}
        for side, sp in (("client", client), ("server", server)):
            ns.update({(side, st["stage"]): st["ns"] for st in sp["stages"]})
        if not all(a in ns and b in ns for _, a, b in SPAN_HOPS):
            continue
        n += 1
        for name, a, b in SPAN_HOPS:
            per_hop[name].append((ns[b] - ns[a]) / 1e3)
        total.append(client["latency_us"])
    if n == 0:
        return {"calls": 0}
    out = {name: {"p50_us": float(np.percentile(v, 50)),
                  "p90_us": float(np.percentile(v, 90))}
           for name, v in per_hop.items()}
    out["total"] = {"p50_us": float(np.percentile(total, 50)),
                    "p90_us": float(np.percentile(total, 90))}
    out["calls"] = n
    return out


def _child_legs(child, port):
    """Path 5a's legs from the generator child, over loopback TCP and
    over tpu:// (the shm fabric between two processes, whose hops
    stage_stats decomposes: the client's read in the child, the server's
    in this process)."""
    from tbus_torch import rpc

    legs = []
    for transport in ("tcp", "tpu"):
        addr = (f"tpu://127.0.0.1:{port}" if transport == "tpu"
                else f"127.0.0.1:{port}")
        for method, key in GEN_CELLS:
            for conc in GEN_CONC:
                s0, l0 = rpc.stage_stats(), rpc.device_stats()["launches"]
                c0 = child.call("stage_stats")
                r = child.call("bench_echo", addr=addr, payload=SIZES[key],
                               concurrency=conc, duration_ms=GEN_MS,
                               service="DevService", method=method)
                c1 = child.call("stage_stats")
                s1, l1 = rpc.stage_stats(), rpc.device_stats()["launches"]
                leg = dict(r, transport=transport, proc="child",
                           method=method, size=key, conc=conc,
                           launches={k: l1[k] - l0[k]
                                     for k in ("u8_transform", "dot128")})
                if transport == "tpu":
                    leg["client_hops"] = _hops(c1, c0)
                    leg["server_hops"] = _hops(s1, s0)
                legs.append(leg)
    return legs


def _traced_legs(child, port):
    """Traced tpu:// legs from the generator child: rpcz on in both
    processes, each cell at c=1 paced to 150 calls/s (each call finds the
    threads parked, unlike a back-to-back leg) (under rpcz's sampling
    budget of 1000 spans/s, and within the 64 newest spans the core
    returns), so every call is traced on both sides; a call's client and
    server spans share its trace id, and their stamps share the host's
    clock."""
    from tbus_torch import rpc

    traced, seen = [], set()
    for method, key in GEN_CELLS:
        leg = dict(addr=f"tpu://127.0.0.1:{port}", payload=SIZES[key],
                   concurrency=1, duration_ms=300, qps=150.0,
                   service="DevService", method=method)
        # The same paced leg untraced first: what rpcz adds to a call.
        paced = child.call("bench_echo", **leg)
        rpc.rpcz_enable(True)
        try:
            child.call("rpcz_enable", on=True)
            child.call("bench_echo", **leg)
            child.call("rpcz_enable", on=False)
            client = [sp for sp in child.call("rpcz_dump_json")
                      if sp["side"] == "client" and sp["method"] == method
                      and sp["trace_id"] not in seen]
            seen.update(sp["trace_id"] for sp in client)
            ids = {sp["trace_id"] for sp in client}
            servers = {sp["trace_id"]: sp for sp in rpc.rpcz_dump_json()
                       if sp["side"] == "server" and sp["trace_id"] in ids}
        finally:
            rpc.rpcz_enable(False)
        pairs = [(c, servers[c["trace_id"]]) for c in client
                 if c["trace_id"] in servers]
        traced.append({"method": method, "size": key,
                       "untraced_p50_us": paced["p50_us"],
                       "hops": _span_hops(pairs),
                       "example": list(pairs[0]) if pairs else None})
    return traced


def _failing_surfaces(child, port):
    """What of the core's surfaces does not work on it, said by trying: the
    wires from the generator child, the rest in this process (one core)."""
    from tbus_torch import rpc

    failing = []
    for wire in GEN_WIRES:
        try:
            child.call("bench_echo", addr=f"127.0.0.1:{port}", payload=4096,
                       concurrency=1, duration_ms=100, protocol=wire,
                       service="DevService", method="Plain")
        except _ChildError as e:
            if not e.error.startswith("RuntimeError: "):
                raise
            failing.append(f"bench_echo(protocol={wire!r}): "
                           f"{e.error[len('RuntimeError: '):]}")
    try:
        rpc.trace_perfetto()
    except (RuntimeError, ValueError) as e:
        failing.append(f"trace_perfetto: {e}")
    try:
        ctypes.CDLL("libssl.so.3")
    except OSError:
        failing.append("enable_ssl: libssl.so.3 is not loadable (TLS "
                       "off in the core)")
    return failing


def _say_leg(dev, leg, py_lat):
    tf = DEVICE_METHODS.get(leg["method"], "native echo")
    py = py_lat.get(f"{leg['method']}/{leg['size']}")
    extra = ""
    if leg["method"] == "Dot":
        extra = (f", dot128 {leg['qps'] * DOT128_FLOPS / 1e9:.1f} GFLOP/s "
                 f"sustained")
    say(f"5a {leg['proc']} {leg['transport']} {leg['method']} ({tf}) "
        f"{leg['size']} c={leg['conc']}: qps {leg['qps']:.0f}, p50 "
        f"{leg['p50_us']:.0f} us, p99 {leg['p99_us']:.0f} us, p999 "
        f"{leg['p999_us']:.0f} us{extra}; Python loop p50 "
        f"{py['p50_us']:.0f} us (phase xii, in process, TCP, c=1) "
        f"[{dev['smi']}]")
    for side in ("client", "server"):
        hops = leg.get(f"{side}_hops")
        if hops:
            say(f"    {side} hops (ns p50/p99, count): " + ", ".join(
                f"{h} {v['p50_ns']}/{v['p99_ns']} x{v['count']}"
                for h, v in hops.items()))


def _check_leg_launches(leg):
    """A device method's kernel ran at least once for every call the
    generator completed (qps x the leg's time is a floor of that)."""
    kernel = GEN_KERNEL.get(leg["method"])
    completed = int(leg["qps"] * GEN_MS / 1000)
    if kernel and leg["launches"][kernel] < completed:
        raise AssertionError(
            f"5a {leg['transport']} {leg['method']} {leg['size']} "
            f"c={leg['conc']}: {leg['launches'][kernel]} {kernel} launches "
            f"for >= {completed} completed calls")
    return completed


def phase_generator(dev, port, py_lat, child):
    phase("main path 5a: the core's C++ load generator against path 3's "
          "server (loopback TCP and tpu://)")
    from tbus_torch import rpc

    # The main path's run: every count starts at 0 here.
    rpc.reset_device_launches()
    legs = []
    for method, key in GEN_CELLS:  # in this process, as phase xii
        before = rpc.device_stats()["launches"]
        r = _gen_leg(rpc, f"127.0.0.1:{port}", method, key, 1)
        after = rpc.device_stats()["launches"]
        legs.append(dict(r, transport="tcp", proc="in-process",
                         method=method, size=key, conc=1,
                         launches={k: after[k] - before[k]
                                   for k in ("u8_transform", "dot128")}))
    legs += _child_legs(child, port)
    traced = _traced_legs(child, port)
    failing = _failing_surfaces(child, port)
    launches = rpc.device_stats()["launches"]
    completed = {"u8_transform": 0, "dot128": 0}
    for leg in legs:
        _say_leg(dev, leg, py_lat)
        n = _check_leg_launches(leg)
        if leg["method"] in GEN_KERNEL:
            completed[GEN_KERNEL[leg["method"]]] += n
        if leg["transport"] == "tpu" and not (
                leg["client_hops"] and leg["server_hops"]):
            raise AssertionError(f"5a tpu:// leg without stage hops: {leg}")
    say(f"launches on path 5a: {json.dumps(launches)} (completed device "
        f"calls >= {json.dumps(completed)})")
    for cell in traced:
        hops = cell["hops"]
        if hops["calls"] < 1:
            raise AssertionError(f"5a: no traced call of {cell['method']} "
                                 f"{cell['size']} has both spans whole")
        say(f"5a traced tpu:// {cell['method']} "
            f"({DEVICE_METHODS.get(cell['method'], 'native echo')}) "
            f"{cell['size']} c=1, {hops['calls']} calls, hop p50 us "
            f"(p90): " + ", ".join(
                f"{name} {hops[name]['p50_us']:.1f} "
                f"({hops[name]['p90_us']:.1f})"
                for name, _, _ in SPAN_HOPS)
            + f"; call p50 {hops['total']['p50_us']:.0f} us traced, "
            f"{cell['untraced_p50_us']:.0f} us untraced at the same pace "
            f"[{dev['smi']}]")
    client, server = traced[2]["example"]  # Echo 4KiB
    for side, span in (("client", client), ("server", server)):
        say(f"rpcz {side} span, DevService.Echo 4KiB over tpu://: "
            f"{json.dumps(span)}")
    say(f"failing on this core: {json.dumps(failing)}")
    return launches, legs, traced


# ---- path 6: the core's ops planes around the device methods ----

OPS_MS = 1000  # one leg of 6a and 6c
OPS_LEGS = [("Plain", "4KiB"), ("Echo", "4KiB"), ("Dot", "1MiB")]  # 6a
OPS_CALLS = 100  # a 6d variant's calls at each size, and 6g's check
# 6d's variants: (name, Channel keyword arguments), the core's defaults
# first; "grpc" goes through GrpcStub, "lb=rr" over a list:// of two
# servers.
OPS_VARIANTS = [("default", {}), ("http", {"protocol": "http"}),
                ("h2", {"protocol": "h2"}), ("grpc", {"protocol": "grpc"}),
                ("gzip", {"compress": 1}), ("zlib", {"compress": 2}),
                ("pooled", {"connection": "pooled"}),
                ("short", {"connection": "short"}), ("lb=rr", {"lb": "rr"})]


def gen_child():
    """Entry of the generator process of paths 5a, 6 and 7: runs the
    tbus_torch.rpc calls (and _CHILD_FNS) its parent writes to stdin, one
    JSON line each
    ({"fn", "kwargs"}), and answers each with one JSON line ({"result"}
    or {"error"})."""
    from tbus_torch import rpc

    rpc.init()
    for line in sys.stdin:
        cmd = json.loads(line)
        try:
            fn = _CHILD_FNS.get(cmd["fn"]) or getattr(rpc, cmd["fn"])
            out = {"result": fn(**cmd["kwargs"])}
        except Exception as e:  # the parent fails the run with it
            out = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(out), flush=True)
    return 0


class _ChildError(AssertionError):
    """A call the generator child raised on; `error` is its
    "<type>: <message>"."""

    def __init__(self, fn, kwargs, error):
        super().__init__(f"generator child: {fn}({kwargs}): {error}")
        self.error = error


class _GenChild:
    """The generator process of paths 5a, 6 and 7 (gen_child), a second
    process on path 3's server: call(fn, **kwargs) runs
    tbus_torch.rpc.fn (or a function of _CHILD_FNS) there, each call
    under a deadline."""

    def __init__(self):
        # A session of its own: path 7's fleet nodes share its process
        # group, and only theirs is checked and killed.
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gen-child"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            start_new_session=True)

    def call(self, fn, **kwargs):
        self.proc.stdin.write(json.dumps({"fn": fn, "kwargs": kwargs}) + "\n")
        self.proc.stdin.flush()
        if not select.select([self.proc.stdout], [], [], 120)[0]:
            raise AssertionError(f"generator child: {fn} took over 120 s")
        out = json.loads(self.proc.stdout.readline() or '{"error": "ended"}')
        if "error" in out:
            raise _ChildError(fn, kwargs, out["error"])
        return out["result"]

    def close(self):
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        try:  # a node of a drill cut short
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _status_lines(port):
    """A server's /status page: its method lines and its device line."""
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}/status",
                                  timeout=30).read().decode().splitlines()


def _device_line(port):
    """The runtime's /status line as {key: value}."""
    line = [x for x in _status_lines(port)
            if x.startswith(("cuda_runtime:", "pjrt:"))]
    if len(line) != 1 or not line[0].startswith("cuda_runtime: "):
        raise AssertionError(f"/status has no device line of the port's "
                             f"runtime: {line}")
    return dict(tok.split("=") for tok in line[0].split()[1:])


def _served(port, method):
    """Calls a server of this process has served of `method`."""
    line = [x for x in _status_lines(port)
            if x.strip().startswith(method + " ")]
    return int(line[0].split("count=")[1].split()[0]) if line else 0


def _wait_sites(dump, n=5):
    """The n hottest sites of a wait_profile_dump(): (total_us, samples,
    max_us, class, frames)."""
    sites = []
    body = dump.split("-- wait sites (by total wait) --\n", 1)[-1]
    for line in body.splitlines():
        parts = line.split("\t")
        if len(parts) < 5 or not parts[0].endswith("us"):
            continue
        sites.append((int(parts[0][:-2]), int(parts[1]),
                      int(parts[2][4:-2]), parts[3], parts[4]))
    return sites[:n]


def _site_name(frames):
    """A site's callers: the first three frames with a symbol past the
    butex wait itself."""
    names = [f for f in frames.split("<")
             if f and not f.startswith("0x") and "butex_wait" not in f]
    return " < ".join(n[:48] for n in names[:3]) or frames[:60]


def _xor_truth(payload):
    """K4's plain xor255 on the card (the replies 6d and 6g hold to)."""
    from tbus_torch.kernels import device_programs as dp

    return dp.device_method_reference("xor255", payload, device="cuda")


def _ops_wait_sites(dev, child, port, traced):
    """6a: where a device call waits, leg by leg."""
    from tbus_torch import rpc

    tpu = f"tpu://127.0.0.1:{port}"
    hop = {(c["method"], c["size"]): c["hops"] for c in traced}
    execs0 = int(_device_line(port)["executions"])
    completed = {"u8_transform": 0, "dot128": 0}
    rpc.wait_profiler_enable(True)
    try:
        for method, key in OPS_LEGS:
            rpc.wait_profile_reset()
            r = child.call("bench_echo", addr=tpu, payload=SIZES[key],
                           concurrency=1, duration_ms=OPS_MS,
                           service="DevService", method=method)
            calls = int(r["qps"] * OPS_MS / 1000)
            if method in GEN_KERNEL:
                completed[GEN_KERNEL[method]] += calls
            stats, dump = rpc.wait_profile_stats(), rpc.wait_profile_dump()
            sites = _wait_sites(dump)
            say(f"6a tpu:// {method} "
                f"({DEVICE_METHODS.get(method, 'native echo')}) {key} c=1: "
                f"qps {r['qps']:.0f}, p50 {r['p50_us']:.0f} us, p99 "
                f"{r['p99_us']:.0f} us; {stats['samples']} wait samples in "
                f"the server process ({dump.splitlines()[0]}), "
                f"{stats['sites']} sites, classes (us) "
                f"{json.dumps(stats['classes'])} [{dev['smi']}]")
            for total, samples, mx, cls, frames in sites:
                say(f"    {cls:8s} total {total} us, {samples} samples, max "
                    f"{mx} us, {total / max(calls, 1):.1f} us a completed "
                    f"call; {_site_name(frames)[:90]}")
            if method == "Echo":  # read before Dot's calls fill the ring
                ring = [x for x in rpc.flight_ring(256)
                        if x["method"] == "DevService.Echo"]
            if method == "Plain":
                continue
            # Parks whose stack runs through the port's runtime
            # (tbus::cuda): a handler fiber waiting on its device job.
            runtime = [x for x in _wait_sites(dump, 40)
                       if "_ZN4tbus4cuda" in x[4]]
            handler = hop[(method, key)].get("dispatch_to_done", {})
            say(f"6a {method} {key}: sampled parks through the port's "
                f"runtime (tbus::cuda frames): {len(runtime)} sites, "
                + (", ".join(f"{t / n:.1f} us a sampled park (estimate, "
                             f"{n} samples of {calls} calls) at "
                             f"{_site_name(f)}"
                             for t, n, _, _, f in runtime) or "none")
                + f"; beside it the handler hop dispatch -> done p50 "
                f"{handler.get('p50_us', float('nan')):.1f} us (path 5a's "
                f"traced spans, this run) [{dev['smi']}]")
    finally:
        rpc.wait_profiler_enable(False)
    if not ring or not all("lat_us" in r for r in ring):
        raise AssertionError("6a: the flight ring holds no DevService.Echo "
                             "record with lat_us")
    say(f"6a flight ring: {len(ring)} DevService.Echo records of the newest "
        f"256, e.g. {json.dumps(ring[0])}")
    boost = rpc.flag_get("tbus_recorder_boost_ms")
    rpc.flag_set("tbus_recorder_boost_ms", 0)
    try:
        bid = rpc.recorder_capture("path 6", profile_seconds=0)
    finally:
        rpc.flag_set("tbus_recorder_boost_ms", boost)
    bundle = [b for b in rpc.recorder_bundles()["bundles"] if b["id"] == bid]
    sections = set(bundle[0]["sections"]) if bundle else set()
    text = rpc.recorder_bundle_text(bid)
    if sections != {"ring", "cpu", "wait", "vars", "sched", "slo"} or (
            "tbus_pjrt_h2d_copy_bytes" not in text):
        raise AssertionError(f"6a bundle {bid}: sections {sections}, DMA "
                             f"counters in vars: "
                             f"{'tbus_pjrt_h2d_copy_bytes' in text}")
    say(f"6a recorder_capture('path 6') bundle {bid}: sections "
        f"{json.dumps(bundle[0]['sections'])}, its vars carry the DMA "
        f"counters")
    # 6b: the device line of path 3's server.
    line = _device_line(port)
    rose, calls = int(line["executions"]) - execs0, sum(completed.values())
    if line["platform"] != "gpu" or line["devices"] != "1" or rose < calls:
        raise AssertionError(f"6b /status device line {line}: executions "
                             f"rose {rose} for >= {calls} device calls")
    say(f"6b /status of path 3's server: cuda_runtime: "
        f"{' '.join(f'{k}={v}' for k, v in line.items())} (executions "
        f"+{rose} across 6a, >= {calls} completed device calls)")
    return completed


def _ops_slo(dev, child, port, legs):
    """6c: two objectives on DevService.Xor (K4, 4 KiB), the tight one
    burning and firing the recorder in the calling process."""
    from tbus_torch import rpc

    tpu = f"tpu://127.0.0.1:{port}"
    leg = [g for g in legs if g["transport"] == "tpu" and g["conc"] == 1
           and g["method"] == "Xor" and g["size"] == "4KiB"][0]
    loose_us, tight_us = int(10 * leg["p99_us"]), max(1, int(leg["p50_us"]))
    # Objectives are kept per name: the loose one on every call of the
    # method, the tight one on its calls to this server (Name@peer, the
    # peer as the caller names it).
    loose, tight = "DevService.Xor", f"DevService.Xor@{tpu}"
    spec = f"{loose}:p99_us={loose_us};{tight}:p99_us={tight_us}"
    # No CPU profile in a triggered bundle (it would block 1 s a bundle).
    profile_s = child.call("flag_get", name="tbus_recorder_profile_s")
    child.call("flag_set", name="tbus_slo_spec", value=spec)
    child.call("flag_set", name="tbus_recorder_profile_s", value=0)
    rpc.flag_set("tbus_slo_spec", spec)  # for 6f's sink-side rollup
    fired0 = child.call("recorder_stats")["fired"]
    try:
        child.call("recorder_arm", triggers=f"slo:{tight}:burn=1")
        r = child.call("bench_echo", addr=tpu, payload=SIZES["4KiB"],
                       concurrency=1, duration_ms=OPS_MS,
                       service="DevService", method="Xor")
        burns = {name: child.call("slo_burn", name=name)
                 for name in (loose, tight)}
        deadline = time.monotonic() + 5
        while True:  # the trigger engine polls every 500 ms
            fired = child.call("recorder_stats")["fired"]
            bundles = [b for b in child.call("recorder_bundles")["bundles"]
                       if b["reason"].startswith(f"slo:{tight}")]
            if (fired > fired0 and bundles) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        status = child.call("slo_status")
    finally:
        child.call("recorder_disarm")
        child.call("flag_set", name="tbus_slo_spec", value="")
        child.call("flag_set", name="tbus_recorder_profile_s",
                   value=profile_s)
    if not (burns[loose] < 1 < burns[tight]) or fired <= fired0 or not (
            bundles and "slo" in bundles[-1]["sections"]):
        raise AssertionError(f"6c: burns {burns}, fired {fired0} -> "
                             f"{fired}, bundles {bundles}")
    exemplars = [e for s in status["slos"] if s["name"] == tight
                 for e in s["exemplars"] if e["waterfall"]]
    if not exemplars:
        raise AssertionError(f"6c: no exemplar with a waterfall: {status}")
    say(f"6c tpu:// Xor (xor255) 4KiB c=1 for {OPS_MS} ms: qps "
        f"{r['qps']:.0f}, p50 {r['p50_us']:.0f} us, p99 {r['p99_us']:.0f} us;"
        f" loose p99 <= {loose_us} us (10 x path 5a's p99) fast burn "
        f"{burns[loose]}, tight p99 <= {tight_us} us (path 5a's p50) fast "
        f"burn {burns[tight]}; the rule fired ({fired0} -> {fired}), bundle "
        f"{bundles[-1]['id']} ({bundles[-1]['reason']}) sections "
        f"{json.dumps(bundles[-1]['sections'])} [{dev['smi']}]")
    say(f"6c exemplar waterfall of a device call: "
        f"{exemplars[0]['waterfall']} ({exemplars[0]['kind']}, "
        f"{exemplars[0]['latency_us']} us)")
    return int(r["qps"] * OPS_MS / 1000), (loose, tight)


def _ops_channels(dev, port):
    """6d: Xor (K4) through the channel options, each reply held to K4's
    plain version on the card."""
    import tbus_torch as tt

    rng = np.random.default_rng(SEED + 61)
    payloads = {k: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for k, n in SIZES.items()}
    truth = {k: _xor_truth(p) for k, p in payloads.items()}
    second = tt.Server()
    second.add_device_method("DevService", "Xor", "xor255")
    other = second.start(0)
    calls = 0
    try:
        for name, kwargs in OPS_VARIANTS:
            if name == "grpc":
                xor = tt.GrpcStub(f"127.0.0.1:{port}", 60000).unary_unary(
                    "/DevService/Xor")
            else:
                addr = (f"list://127.0.0.1:{port},127.0.0.1:{other}"
                        if name == "lb=rr" else f"127.0.0.1:{port}")
                ch = tt.Channel(addr, 60000, **kwargs)
                xor = (lambda c: lambda body: c.call("DevService", "Xor",
                                                     body))(ch)
            served0 = [_served(p, "DevService.Xor") for p in (port, other)]
            lat = {}
            for key, body in payloads.items():
                samples = []
                for _ in range(OPS_CALLS):
                    t0 = time.perf_counter()
                    got = xor(body)
                    samples.append(time.perf_counter() - t0)
                    if got != truth[key]:
                        raise AssertionError(f"6d {name} {key}: the reply "
                                             f"differs from K4's plain "
                                             f"version")
                calls += OPS_CALLS
                lat[key] = (_pctl(samples, 50), _pctl(samples, 99))
            served = [_served(p, "DevService.Xor") - s0
                      for p, s0 in zip((port, other), served0)]
            if name == "lb=rr" and min(served) <= 0:
                raise AssertionError(f"6d lb=rr: calls per server {served}")
            say(f"6d Xor via {name}: p50/p99 us 4KiB "
                f"{lat['4KiB'][0]:.0f}/{lat['4KiB'][1]:.0f}, 1MiB "
                f"{lat['1MiB'][0]:.0f}/{lat['1MiB'][1]:.0f} (host clock, "
                f"Python loop, n={OPS_CALLS}), calls per server {served}, "
                f"every reply byte-equal to K4's plain version "
                f"[{dev['smi']}]")
    finally:
        second.stop()
    return calls


def _ops_cache(dev, child):
    """6e: the cache tier on the card's core (the host's CPU; no device
    work)."""
    import tbus_torch as tt

    s = tt.Server()
    s.add_cache()
    cport = s.start(0)
    try:
        for transport in ("tcp", "tpu"):
            addr = (f"tpu://127.0.0.1:{cport}" if transport == "tpu"
                    else f"127.0.0.1:{cport}")
            r = child.call("bench_cache", addr=addr, duration_ms=OPS_MS)
            say(f"6e bench_cache over {transport} from the child (host CPU, "
                f"not the card; 256 KiB values, 96 keys, GETs, c=8, "
                f"{OPS_MS} ms): qps {r['qps']:.0f}, GET "
                f"{r['get_mbps']:.1f} MB/s, hit rate {r['hit_rate']}, p50 "
                f"{r['p50_us']:.0f} us, p99 {r['p99_us']:.0f} us "
                f"[{dev['smi']}]")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            corpus = os.path.join(tmp, "cache.rec")
            tt.cache_corpus_write(corpus, seed=11, n=1000, key_space=64,
                                  value_bytes=4096, set_permille=100)
            rep = tt.replay(corpus, f"127.0.0.1:{cport}", verify=True)
        if rep["round_trip_ok"] != 1 or rep["failed"] != 0:
            raise AssertionError(f"6e replay: {rep}")
        drill = tt.cache_reshard_drill()
        if drill["ok"] != 1:
            raise AssertionError(f"6e cache_reshard_drill: {drill}")
    finally:
        s.stop()
    say(f"6e replay(verify=True) of 1000 records (seed 11): "
        f"{json.dumps(rep)} (host CPU)")
    say(f"6e cache_reshard_drill(): ok {drill['ok']} (host CPU)")


AUTOTUNE_KEYS = ("steps", "keeps", "reverts", "rollbacks")  # 6g prints


def _ops_autotune(dev, child, port):
    """6g: the autotune controller's lifecycle over a tpu:// Xor leg,
    every flag put back."""
    from tbus_torch import rpc

    before = {d["name"]: d["value"] for d in rpc.flag_domains()}
    rpc.autotune_enable()
    try:
        r = child.call("bench_echo", addr=f"tpu://127.0.0.1:{port}",
                       payload=SIZES["4KiB"], concurrency=8,
                       duration_ms=2 * OPS_MS, service="DevService",
                       method="Xor")
        st = rpc.autotune_stats()
    finally:
        rpc.autotune_disable()
        for name, value in before.items():
            rpc.flag_set(name, value)
    after = {name: rpc.flag_get(name) for name in before}
    if after != before:
        raise AssertionError(f"6g: flags not restored: {before} -> {after}")
    import tbus_torch as tt

    ch = tt.Channel(f"127.0.0.1:{port}", 60000)
    body = np.random.default_rng(SEED + 67).integers(
        0, 256, SIZES["4KiB"], dtype=np.uint8).tobytes()
    truth = _xor_truth(body)
    for _ in range(OPS_CALLS):
        if ch.call("DevService", "Xor", body) != truth:
            raise AssertionError("6g: Xor after autotune differs from K4's "
                                 "plain version")
    say(f"6g autotune over tpu:// Xor 4KiB c=8 for {2 * OPS_MS} ms: qps "
        f"{r['qps']:.0f}, p50 {r['p50_us']:.0f} us; stats "
        f"{json.dumps({k: st[k] for k in AUTOTUNE_KEYS})}"
        f"; {len(before)} flags put back, {OPS_CALLS} Xor calls byte-exact "
        f"after [{dev['smi']}]")
    return int(r["qps"] * 2 * OPS_MS / 1000) + OPS_CALLS


def phase_ops_planes(dev, port, legs, traced, child):
    phase("main path 6: the core's ops planes around path 3's device "
          "methods (wait profiler, recorder, SLO, channel options, cache "
          "tier, metrics sink, autotune)")
    import tbus_torch as tt
    from tbus_torch import rpc

    sink = tt.Server()
    sink.enable_metrics_sink()
    sink_port = sink.start(0)
    rpc.metrics_sink_reset()
    rpc.metrics_set_collector(f"127.0.0.1:{sink_port}")
    # The main path's run: every count starts at 0 here.
    rpc.reset_device_launches()
    try:
        completed = _ops_wait_sites(dev, child, port, traced)
        xor_calls, names = _ops_slo(dev, child, port, legs)
        completed["u8_transform"] += xor_calls + _ops_channels(dev, port)
        _ops_cache(dev, child)
        rpc.metrics_flush()
        rpc.metrics_flush()
        fleet = rpc.fleet_query()
        slo_fleet = rpc.slo_fleet()
        completed["u8_transform"] += _ops_autotune(dev, child, port)
        launches = rpc.device_stats()["launches"]
    finally:
        rpc.metrics_set_collector("")
        rpc.flag_set("tbus_slo_spec", "")
        sink.stop()
    # 6f: this process's node, its device method's rollup, the objectives.
    lat = fleet["rollups"]["latency"].get("rpc_server_DevService.Xor", {})
    if (len(fleet["nodes"]) != 1 or lat.get("count", 0) < xor_calls
            or not lat["merged_p50"] <= lat["merged_p99"]
            <= lat["merged_p999"]):
        raise AssertionError(f"6f fleet_query: {len(fleet['nodes'])} nodes, "
                             f"DevService.Xor rollup {lat}")
    node = next(iter(slo_fleet["nodes"].values()), {})
    if set(node) != set(names):
        raise AssertionError(f"6f slo_fleet lists {sorted(node)}, not "
                             f"{names}")
    say(f"6f fleet_query: 1 node, rpc_server_DevService.Xor count "
        f"{lat['count']} (>= {xor_calls} from 6c), merged p50/p99/p999 "
        f"{lat['merged_p50']}/{lat['merged_p99']}/{lat['merged_p999']} us "
        f"over {lat['samples']} samples; slo_fleet: {json.dumps(node)} "
        f"[{dev['smi']}]")
    if any(launches[k] < n or launches[k] <= 0 for k, n in completed.items()):
        raise AssertionError(f"path 6: launches {launches} for >= "
                             f"{completed} completed device calls")
    say(f"launches on path 6: {json.dumps(launches)} (completed device "
        f"calls >= {json.dumps(completed)})")
    return launches


# ---- path 7: a live tpu:// redial under device traffic, the fleet drills ----

REDIAL_MS = 2000  # one redial leg
REDIAL_AT_MS = 1000  # the flag change and link_redial, this far into it
REDIAL_CONC = 8
REDIAL_CALLS = 100  # Xor and Dot calls over the redialed link after the legs
FLEET_DRILL = {"nodes": 6, "phase_ms": 1200, "seed": 1}  # bench.py --fleet
FLEET_ROLL = {"nodes": 4, "phase_ms": 1200}  # bench.py --roll
DRILL_KINDS = ("echo_la", "echo_chash", "fanout", "stream_chunk")
DRILL_PHASES = ("baseline", "kill", "hang", "revive", "reshard")
ROLL_PHASES = ("baseline", "mixed", "upgraded")
_redial_anchor = []  # the generator child's channel holding xxi's link


def redial_start(addr):
    """Generator child, phase xxi: opens the channel that holds the
    tpu:// link for the whole phase; returns this process's redial flags
    and its live cross-process links."""
    from tbus_torch import rpc

    ch = rpc.Channel(addr, timeout_ms=60000)
    ch.call("DevService", "Plain", b"w")
    _redial_anchor.append(ch)
    return {"lanes": rpc.flag_get("tbus_shm_lanes"),
            "chains": rpc.flag_get("tbus_shm_ext_chains"),
            "links": rpc.shm_links()}


def redial_now(flags):
    """Generator child: sets `flags` (redial-gated tunables), waits for the
    redial walker the change starts to renegotiate every live link, then
    link_redial(2000) once more; the counts, the wall times (the walker's
    from the change until its last counter moved) and the links' caps
    after."""
    from tbus_torch import rpc

    c0 = rpc.redial_counters()
    t0 = time.perf_counter()
    for name, value in flags.items():
        rpc.flag_set(name, value)
    c1, t1 = rpc.wait_redials_settled(c0)
    n = rpc.link_redial(2000)
    t2 = time.perf_counter()
    return {"renegotiated": n, "walker": {k: c1[k] - c0[k] for k in c0},
            "walker_ms": (t1 - t0) * 1e3, "redial_ms": (t2 - t1) * 1e3,
            "links": rpc.shm_links()}


def redial_leg(addr, method, size, flags):
    """Generator child, phase xxi: a REDIAL_MS closed-loop leg at
    REDIAL_CONC over tpu:// (bench_echo_overload: no retries, every
    failure counted) on a thread, with redial_now(flags) REDIAL_AT_MS
    into it."""
    from tbus_torch import rpc

    out = {}

    def leg():
        try:
            out["leg"] = rpc.bench_echo_overload(
                addr, "DevService", method, size, REDIAL_CONC, REDIAL_MS,
                timeout_ms=5000)
        except Exception as e:  # read by the parent
            out["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=leg)
    t.start()
    try:
        time.sleep(REDIAL_AT_MS / 1000)
        out["redial"] = redial_now(flags)
    finally:
        t.join()
    if "error" in out:
        raise RuntimeError(out["error"])
    return out


def redial_checks(xor, xor_sha256, dot):
    """Generator child, phase xxi: REDIAL_CALLS Xor and Dot calls in a
    Python loop over the phase's link; the Xor replies whose sha256
    differs from the parent's, and Dot's distinct replies (base64)."""
    import base64
    import hashlib

    ch = _redial_anchor[0]
    xor, dot = base64.b64decode(xor), base64.b64decode(dot)
    bad = sum(hashlib.sha256(ch.call("DevService", "Xor", xor)).hexdigest()
              != xor_sha256 for _ in range(REDIAL_CALLS))
    dots = {ch.call("DevService", "Dot", dot) for _ in range(REDIAL_CALLS)}
    return {"xor_bad": bad,
            "dot": [base64.b64encode(d).decode() for d in dots]}


def phase_redial(torch, dev, port, child, gen_legs):
    phase("main path 7 (xxi): a live tpu:// redial under K4 and K5 traffic "
          "from the generator child")
    import base64
    import hashlib

    from tbus_torch import rpc

    addr = f"tpu://127.0.0.1:{port}"
    rng = np.random.default_rng(SEED + 71)
    xor_body = rng.integers(0, 256, SIZES["4KiB"], dtype=np.uint8).tobytes()
    dot_body = rng.standard_normal((SIZES["1MiB"] // 512, 128),
                                   dtype=np.float32).tobytes()
    server_lanes = rpc.flag_get("tbus_shm_lanes")
    # The server advertises every lane: the child's flags alone decide
    # what a redial negotiates (the smaller advert wins).
    rpc.flag_set("tbus_shm_lanes", 4)
    # The main path's run: every count starts at 0 here.
    rpc.reset_device_launches()
    try:
        start = child.call("redial_start", addr=addr)
        if not start["links"]:
            raise AssertionError("xxi: no cross-process tpu:// link in the "
                                 "generator child")
        lanes1 = 4 if any(x["lanes"] != 4 for x in start["links"]) else 2
        legs = [("Xor", "4KiB", {"tbus_shm_lanes": lanes1}),
                ("Dot", "1MiB", {"tbus_shm_lanes": 1,
                                 "tbus_shm_ext_chains": 1 - start["chains"]})]
        done = {"u8_transform": 0, "dot128": 0}
        for method, key, flags in legs:
            l0 = rpc.device_stats()["launches"]
            r = child.call("redial_leg", addr=addr, method=method,
                           size=SIZES[key], flags=flags)
            l1 = rpc.device_stats()["launches"]
            leg, rd = r["leg"], r["redial"]
            kernel = GEN_KERNEL[method]
            failed = leg["shed"] + leg["timedout"] + leg["other"]
            want = {"lanes": flags["tbus_shm_lanes"],
                    "chains": flags.get("tbus_shm_ext_chains",
                                        start["chains"])}
            caps = {(x["lanes"], x["chains"]) for x in rd["links"]}
            if (rd["renegotiated"] < 1 or failed != 0
                    or caps != {(want["lanes"], want["chains"])}
                    or l1[kernel] - l0[kernel] < leg["ok"]):
                raise AssertionError(
                    f"xxi {method} {key}: renegotiated "
                    f"{rd['renegotiated']}, {failed} failed calls, link "
                    f"caps {caps} (want {want}), {l1[kernel] - l0[kernel]} "
                    f"{kernel} launches for {leg['ok']} calls")
            done[kernel] += int(leg["ok"])
            base = next(g for g in gen_legs if g["proc"] == "child"
                        and g["transport"] == "tpu" and g["method"] == method
                        and g["size"] == key and g["conc"] == REDIAL_CONC)
            say(f"xxi redial {REDIAL_AT_MS} ms into a {REDIAL_MS} ms tpu:// "
                f"{method} ({DEVICE_METHODS[method]}) {key} c={REDIAL_CONC} "
                f"leg, flags {json.dumps(flags)}: the walker renegotiated "
                f"{rd['walker']['renegotiated']} link(s) in "
                f"{rd['walker_ms']:.1f} ms after the flag change, then "
                f"link_redial(2000) renegotiated {rd['renegotiated']} in "
                f"{rd['redial_ms']:.1f} ms (wall); link caps now "
                f"{json.dumps(rd['links'])}; leg qps {leg['goodput_qps']:.0f}"
                f", p50 {leg['p50_us']:.0f} us, p99 {leg['p99_us']:.0f} us, "
                f"{int(leg['ok'])} ok, 0 failed; path 5a's leg without a "
                f"redial: qps {base['qps']:.0f}, p50 {base['p50_us']:.0f} us"
                f", p99 {base['p99_us']:.0f} us; {kernel} launches "
                f"{l1[kernel] - l0[kernel]} [{dev['smi']}]")
        truth = _xor_truth(xor_body)
        got = child.call("redial_checks",
                         xor=base64.b64encode(xor_body).decode(),
                         xor_sha256=hashlib.sha256(truth).hexdigest(),
                         dot=base64.b64encode(dot_body).decode())
        if got["xor_bad"] or not all(
                _device_reply_ok(torch, "Dot", dot_body, base64.b64decode(d))
                for d in got["dot"]):
            raise AssertionError(f"xxi: after the redials {got['xor_bad']} "
                                 f"Xor replies differ from K4's plain "
                                 f"version, or a Dot reply is out of "
                                 f"phase xi's tolerance")
        done["u8_transform"] += REDIAL_CALLS
        done["dot128"] += REDIAL_CALLS
        back = child.call("redial_now", flags={
            "tbus_shm_lanes": start["lanes"],
            "tbus_shm_ext_chains": start["chains"]})
        launches = rpc.device_stats()["launches"]
    finally:
        rpc.flag_set("tbus_shm_lanes", server_lanes)
    if any(launches[k] < n for k, n in done.items()):
        raise AssertionError(f"path 7: launches {launches} for >= {done} "
                             f"completed device calls")
    say(f"xxi after both redials: {REDIAL_CALLS} Xor calls byte-equal to "
        f"K4's plain version and {REDIAL_CALLS} Dot calls within phase xi's "
        f"tolerance ({len(got['dot'])} distinct Dot replies), over the "
        f"redialed link; flags put back ({start['lanes']} lanes, chains "
        f"{start['chains']}) and redialed: {back['renegotiated']} link(s) "
        f"in {back['redial_ms']:.1f} ms [{dev['smi']}]")
    say(f"launches on path 7: {json.dumps(launches)} (completed device "
        f"calls >= {json.dumps(done)})")
    return launches


def _group_members(pgid):
    """Pids of the live processes of process group pgid (zombies, which
    hold nothing, left out)."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, _, pgrp = f.read().rsplit(")", 1)[1].split()[:3]
        except (OSError, ValueError):
            continue
        if state != "Z" and int(pgrp) == pgid:
            found.append(int(pid))
    return found


def _drill_failures(r, nodes):
    """tests/test_fleet.py's _check_invariants and its soak's error split,
    as the list of the checks that fail."""
    led, rb, rs = r["ledger"], r["rebalance_ms"], r["reshard"]
    phases = {p["name"]: p for p in r["phases"]}
    checks = {
        "ok == 1": r["ok"] == 1, "no failures": r["failures"] == [],
        "lost == 0": r["lost"] == 0,
        "misaccounted == 0": r["misaccounted"] == 0,
        "issued == resolved": led["issued"] == led["resolved"],
        "outstanding == 0": led["outstanding"] == 0,
        "baseline failed == 0": phases["baseline"]["failed"] == 0,
        "0 < merged p99 <= bound":
            0 < r["merged_p99_us"] <= r["p99_bound_us"],
        "revived in deadline": 0 <= rb["revived"] <= rb["deadline"],
        "resumed in deadline": 0 <= rb["resumed"] <= rb["deadline"],
        "reshard moved": rs["from"] != rs["to"],
        "reshard in bound": 0 <= rs["calls_to_converge"] <= rs["bound"],
        "nodes": r["nodes"] == nodes,
        "failed == sum(errors)":
            led["failed"] == sum(int(v) for v in led["errors"].values())}
    checks.update({f"{k} issued": led["kinds"][k]["issued"] > 0
                   for k in DRILL_KINDS})
    checks.update({f"{p} ok": phases[p]["ok"] > 0 for p in DRILL_PHASES})
    return [name for name, held in checks.items() if not held]


def _roll_failures(r, nodes):
    """tests/test_fleet.py's rolling-upgrade invariants, as the list of
    the checks that fail."""
    led, skew = r["ledger"], r["skew"]
    phases = {p["name"]: p for p in r["phases"]}
    checks = {
        "ok == 1": r["ok"] == 1, "no failures": r["failures"] == [],
        "lost == 0": r["lost"] == 0,
        "misaccounted == 0": r["misaccounted"] == 0,
        "failed == 0": r["failed"] == 0,
        "issued == resolved": led["issued"] == led["resolved"],
        "outstanding == 0": led["outstanding"] == 0,
        "rolls": len(r["rolls"]) == nodes,
        "skew diverged": skew["diverged"] == 1,
        "mixed hashes >= 2": skew["mixed_hashes"] >= 2,
        "hash moved": skew["hash_before"] != skew["hash_after"]}
    for st in r["rolls"]:
        checks[f"roll {st['node']} clean"] = (
            st["ok"] == 1 and st["drain_rpc_ok"] == 1
            and st["forced_closes"] == 0 and min(
                st["drain_ms"], st["respawn_ms"], st["republish_ms"]) >= 0)
    for p in ROLL_PHASES:
        checks[f"{p} ok, none failed"] = (phases[p]["ok"] > 0
                                          and phases[p]["failed"] == 0)
    return [name for name, held in checks.items() if not held]


def _say_phases(dev, what, r):
    for p in r["phases"]:
        say(f"{what} phase {p['name']}: goodput {p['goodput_qps']} qps, p50 "
            f"{p['p50_us']} us, p99 {p['p99_us']} us, {p['ok']} ok, "
            f"{p['failed']} failed (host CPU) [{dev['smi']}]")


def _nodes_of(child):
    """The live processes of the generator child's group but itself: the
    nodes of its drills."""
    return [p for p in _group_members(child.proc.pid) if p != child.proc.pid]


def phase_fleet(dev, child):
    phase("main path 7 (xxii, xxiii): the fleet drill and the rolling "
          "upgrade with the port's nodes, from the generator child of "
          "paths 5a, 6 and xxi (host CPU; the fleet load is loopback TCP)")
    try:
        argv = child.call("fleet_node_argv")
        t0 = time.perf_counter()
        r = child.call("fleet_drill", node_argv=argv, **FLEET_DRILL)
        drill_s = time.perf_counter() - t0
        bad = _drill_failures(r, FLEET_DRILL["nodes"])
        if bad:
            raise AssertionError(f"xxii fleet_drill({FLEET_DRILL}): {bad}; "
                                 f"{json.dumps(r)[:4000]}")
        _say_phases(dev, "xxii drill", r)
        led, rb, rs = r["ledger"], r["rebalance_ms"], r["reshard"]
        say(f"xxii fleet_drill({FLEET_DRILL}) in {drill_s:.1f} s, plan "
            f"{json.dumps(r['plan'])}: merged /fleet p99 "
            f"{r['merged_p99_us']} us (bound {r['p99_bound_us']} us); "
            f"rebalance revived {rb['revived']} ms, resumed {rb['resumed']} "
            f"ms (deadline {rb['deadline']} ms); reshard {rs['from']} -> "
            f"{rs['to']} in {rs['calls_to_converge']} calls (bound "
            f"{rs['bound']}); ledger issued {led['issued']}, resolved "
            f"{led['resolved']}, failed {led['failed']} "
            f"{json.dumps(led['errors'])}, lost {r['lost']} (host CPU) "
            f"[{dev['smi']}]")
        t0 = time.perf_counter()
        r = child.call("fleet_roll", node_argv=argv, **FLEET_ROLL)
        roll_s = time.perf_counter() - t0
        bad = _roll_failures(r, FLEET_ROLL["nodes"])
        if bad:
            raise AssertionError(f"xxiii fleet_roll({FLEET_ROLL}): {bad}; "
                                 f"{json.dumps(r)[:4000]}")
        _say_phases(dev, "xxiii roll", r)
        for st in r["rolls"]:
            say(f"xxiii roll node {st['node']}: drain {st['drain_ms']} ms, "
                f"respawn {st['respawn_ms']} ms, republish "
                f"{st['republish_ms']} ms, forced closes "
                f"{st['forced_closes']} (host CPU) [{dev['smi']}]")
        say(f"xxiii fleet_roll({FLEET_ROLL}) in {roll_s:.1f} s: lost "
            f"{r['lost']}, failed {r['failed']}, ledger issued "
            f"{r['ledger']['issued']}, skew {json.dumps(r['skew'])} "
            f"(host CPU) [{dev['smi']}]")
    finally:
        end = time.monotonic() + 10
        while _nodes_of(child) and time.monotonic() < end:
            time.sleep(0.1)
        left = _nodes_of(child)
        for pid in left:
            os.kill(pid, signal.SIGKILL)
    if left:
        raise AssertionError(f"fleet nodes outlived their drills: {left}")
    say("no fleet node outlived its drill")


# What the generator child runs besides tbus_torch.rpc's functions.
_CHILD_FNS = {"redial_start": redial_start, "redial_now": redial_now,
              "redial_leg": redial_leg, "redial_checks": redial_checks}


def phase_global_mesh(torch, dev):
    phase("main path 5b: init by coordinator, global_mesh, and the fan-out "
          f"step at hidden {HIDDEN}")
    import socket

    from tbus_torch import entry
    from tbus_torch.kernels import gemm
    from tbus_torch.parallel import collective, distributed

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    distributed.init(coordinator, 1, 0)
    try:
        mesh = distributed.global_mesh(("dp", "tp"))
        if tuple(mesh.mesh.shape) != (1, 1) or mesh.device_type != "cuda":
            raise AssertionError(f"global_mesh on one card: {mesh}")
        # The main path's run: every count starts at 0 here.
        gemm.matmul_launches = gemm.dw_launches = 0
        step, (w, x) = entry._make(mesh, hidden=HIDDEN, rows=HIDDEN)
        loss, w1 = step(w, x)
        wall = _wall_p50_us(torch, lambda: step(w, x), 10)
        torch.cuda.synchronize()
        counts = {"matmul_bf16_f32": gemm.matmul_launches,
                  "dw_f32_bf16": gemm.dw_launches}
        if min(counts.values()) <= 0:
            raise AssertionError(f"path 5b missed a kernel: {counts}")
        ref, (rw, rx) = entry._make(collective.default_mesh(1, "cuda"),
                                    hidden=HIDDEN, rows=HIDDEN)
        want_loss, want_w1 = ref(rw, rx)
        if not (torch.equal(w, rw) and torch.equal(x, rx)
                and torch.equal(loss, want_loss)
                and torch.equal(w1, want_w1)):
            raise AssertionError("the step on global_mesh differs from "
                                 "path 2's on default_mesh")
    finally:
        distributed.shutdown()
    say(f"global_mesh(('dp', 'tp')) after init({coordinator!r}, 1, 0): "
        f"shape (1, 1) on cuda; hidden {HIDDEN} x rows {HIDDEN} step loss "
        f"{float(loss)} and w1 equal path 2's step on default_mesh bit for "
        f"bit; wall p50 {wall:.0f} us (host clock, n=10); launches "
        f"{json.dumps(counts)} [{dev['smi']}]")
    say("one card holds one NCCL rank: the multi-process global_mesh job "
        "(8 gloo ranks in 2 simulated hosts) runs in the CPU tests, "
        "tests/test_torch_global_mesh.py")
    return counts


def main():
    import torch

    dev = phase_device(torch)
    if dev is None:
        return 1
    flavor = phase_build()
    import tbus_torch as tt
    from tbus_torch import rpc

    # DMA registration is armed before the block pool comes up (the first
    # init), so every region it carves is registered; path 4 runs again in
    # two like children, with it armed and off.
    tt.device_enable_dma()
    shapes, max_err = phase_kernel(torch, dev)
    phase_runtime()
    launches = phase_main(dev)
    phase_profile(torch, dev)
    gemm_recs = phase_gemm(torch, dev)
    fold_recs = phase_fold(torch, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        counts = phase_entry(torch, dev, tmp)
    phase_dryrun()
    dp_recs = phase_device_kernels(torch, dev)
    k7_rec = phase_fanout_kernel(torch, dev)
    tt.device_init("cuda")
    say(f"DMA table at runtime start: {json.dumps(rpc.device_dma_stats())}")
    server, port = _device_server()
    child = None
    try:
        dm_launches, dm_lat, _ = phase_device_methods(torch, dev, port)
        serve_launches, _ = phase_serving(torch, dev, port)
        child = _GenChild()
        gen_launches, gen_legs, traced = phase_generator(dev, port, dm_lat,
                                                         child)
        ops_launches = phase_ops_planes(dev, port, gen_legs, traced, child)
        redial_launches = phase_redial(torch, dev, port, child, gen_legs)
        phase_fleet(dev, child)
    finally:
        if child is not None:
            child.close()
        server.stop()
    mesh_counts = phase_global_mesh(torch, dev)
    torch_leg = phase_rpc_leg(dev)
    # Path 4's run: every count starts at 0 here.
    rpc.reset_device_launches()
    path4 = phase_path4(dev)
    k7_launches = rpc.device_stats()["launches"]["fanout"]
    if k7_launches <= 0:
        raise AssertionError("path 4 missed K7")
    say(f"launches on path 4: {json.dumps(rpc.device_stats()['launches'])}")
    pair = phase_path4_pair()
    for key in ("4KiB", "1MiB"):
        lat = {m: pair[m]["lat"] for m in ("on", "off")}
        say(f"ParallelChannel x{N_PEERS} {key} p50/p99 us: p2p "
            f"{path4['lat'][f'p2p/{key}']['p50_us']:.0f}/"
            f"{path4['lat'][f'p2p/{key}']['p99_us']:.0f}, torch-lowered "
            f"{torch_leg[f'lowered/{key}']['p50_us']:.0f}/"
            f"{torch_leg[f'lowered/{key}']['p99_us']:.0f}, C++ engine "
            f"{path4['lat'][f'native/{key}']['p50_us']:.0f}/"
            f"{path4['lat'][f'native/{key}']['p99_us']:.0f} (DMA on); like "
            f"children, same window: DMA on p2p "
            f"{lat['on'][f'p2p/{key}']['p50_us']:.0f}/"
            f"{lat['on'][f'p2p/{key}']['p99_us']:.0f} C++ engine "
            f"{lat['on'][f'native/{key}']['p50_us']:.0f}/"
            f"{lat['on'][f'native/{key}']['p99_us']:.0f}, DMA off p2p "
            f"{lat['off'][f'p2p/{key}']['p50_us']:.0f}/"
            f"{lat['off'][f'p2p/{key}']['p99_us']:.0f} C++ engine "
            f"{lat['off'][f'native/{key}']['p50_us']:.0f}/"
            f"{lat['off'][f'native/{key}']['p99_us']:.0f} [{dev['smi']}]")
    for part in ("b", "c", "d", "e"):
        say(f"path 4{part} main, DMA on: "
            f"{json.dumps(path4['dma_stats'][part])}")
        for m in ("on", "off"):
            say(f"path 4{part} child, DMA {m}: "
                f"{json.dumps(pair[m]['dma_stats'][part])}")
    say(f"core flavour: {flavor}")
    main_shape = shapes[1]  # the fused 1 MiB batch
    big = gemm_recs[GEMM_SHAPES[1]]
    kernels = [{
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
    }]
    for name, replaces in (
            ("matmul_bf16_f32", "tbus/parallel/collective.py:188"),
            ("dw_f32_bf16", "tbus/parallel/collective.py:206")):
        rec = big[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tbus_torch/csrc/gemm_bf16.cu", "replaces": replaces,
            "launches": counts[name] + mesh_counts[name], "match": True,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": list(GEMM_SHAPES[1]),
            "shapes": {str(list(k)): v[name] for k, v in gemm_recs.items()},
        })
        if name == "matmul_bf16_f32":
            kernels[-1].update({
                "design": "tma_wgmma",
                "library_cast_ms": rec["library_cast_ms"],
                "pack_ms": rec["pack_ms"], "gemm_ms": rec["gemm_ms"]})
        else:
            kernels[-1].update({
                "design": rec["design"], "fma_bound_ms": rec["fma_bound_ms"],
                "pack_ms": rec["pack_ms"], "gemm_ms": rec["gemm_ms"]})
    f32 = fold_recs["float32"]
    kernels.append({
        "name": "ring_fold", "route": "cuda",
        "source": "tbus_torch/csrc/ring_fold.cu",
        "replaces": "tbus/parallel/collective.py:125",
        "launches": counts["ring_fold"], "match": True,
        "max_abs_err": max(r["max_abs_err"] for r in fold_recs.values()),
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"], "shape": list(FOLD[:3]),
        "design": "split_wgmma", "fma_bound_ms": f32["fma_bound_ms"],
        "dtypes": fold_recs,
    })
    # Path 3's kernels: launches are the runtime's own counts over path 3a
    # (device methods), 3b (serving), 5a (the generator), 6 (the ops
    # planes) and 7 (the redial), each run from 0.
    for name, replaces, shape in (
            ("u8_transform", "cpp/tpu/serve_engine.cc:28", [1 << 20]),
            ("dot128", "cpp/tpu/pjrt_runtime.cc:207", [DOT128_K, 128]),
            ("dotbench", "cpp/tpu/pjrt_runtime.cc:245", list(DOTBENCH))):
        rec = dp_recs[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tbus_torch/csrc/device_programs.cu",
            "replaces": replaces,
            "launches": (dm_launches[name] + serve_launches[name]
                         + gen_launches[name] + ops_launches[name]
                         + redial_launches[name]),
            "match": True, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec.get("bound_by", "bytes"),
            "library_ms": rec["library_ms"], "shape": shape,
            "detail": rec,
        })
        kernels[-1]["design"] = {"u8_transform": "latency_shaped",
                                 "dot128": "split_wgmma",
                                 "dotbench": "tma_wgmma"}[name]
    kernels.append({
        "name": "fanout", "route": "cuda",
        "source": "tbus_torch/csrc/device_programs.cu",
        "replaces": "cpp/tpu/native_fanout.cc:166",
        "launches": k7_launches, "match": True,
        "max_abs_err": k7_rec["max_abs_err"], "ms": k7_rec["ms"],
        "plain_ms": k7_rec["plain_ms"], "bound_ms": k7_rec["bound_ms"],
        "bound_by": "bytes", "library_ms": k7_rec["library_ms"],
        "shape": [8, 1 << 20], "shapes": k7_rec["shapes"],
    })
    say(dev["smi"])
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--path4-child"]:
            code = path4_child(sys.argv[2])
        elif sys.argv[1:2] == ["--gen-child"]:
            code = gen_child()
        else:
            code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
