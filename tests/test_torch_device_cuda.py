"""The device plane's kernels K4-K6 against their plain versions, and the
CUDA runtime's two mounts end to end, on the card.

The kernels have no CPU mode, so these tests skip without an NVIDIA card.
This file imports no JAX, so it runs on GPU hosts without JAX; run it
there without tests/conftest.py, which imports JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_device_cuda.py

K4 runs every branch of its design: the vector body (the wrapper), a
scalar head before it when both pointers share their offset modulo 16,
the all-scalar path when they do not, and a size that takes a second
round of the grid, each with ragged lengths. K5 (the tensor cores over an
exact bf16 split of x) runs normal payloads, rows made only of f32
subnormals, rows of very different scales, and NaN and +-inf among
finite values below 2^100; its weight scratch equals its plain version
byte for byte, the wrapper and the device runtime run it at once, and
its SASS holds HGMMA with no spills.

Tolerances: K4 exact bytes. K5 within 2 * 128 * 2^-24 * (|x| @ |W|), the
gap two f32 sums of 128 products in different orders can open (the
tensor cores' truncating adds, two k-steps in each term's accumulator of
each of four warpgroups, take a few 2^-23 of |x| @ |W|, inside it;
tests/test_torch_dot128_split.py), with NaN and +-inf where the plain
version has them. K6: the
last matrix within one bf16 ulp per element plus (2^-7 + n * 2^-24) *
bf16(1/n) * (|v_prev| @ |W|) (an input's one-ulp difference and the f32
order, carried through the last product); the checksum within (2^-7 +
n * 2^-24) * sum|v|.
"""

import struct
import threading

import numpy as np
import pytest
import torch

from tbus_torch.kernels import device_programs as dp
from tbus_torch.kernels import ieee_fp32


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


def _bf16_ulp(a):
    _, e = torch.frexp(a.abs().double())
    return torch.ldexp(torch.ones_like(a, dtype=torch.float64),
                       torch.clamp(e - 8, min=-133))


@pytest.mark.cuda
@pytest.mark.parametrize("transform", ["echo", "xor255", "incr"])
def test_u8_transform_matches_plain_version(transform):
    _need_card()
    rng = np.random.default_rng(11)
    raw = torch.from_numpy(rng.integers(0, 256, (1 << 20) + 64,
                                        dtype=np.uint8)).cuda()
    for n in (0, 1, 15, 16, 17, 4095, 4096, 4097, 64 * 4096, (1 << 20) + 1):
        for off in (0, 1, 3):
            x = raw[off:off + n]
            before = dp.u8_launches
            got = dp.u8_transform(x, transform)
            assert dp.u8_launches == before + (1 if n else 0)
            assert torch.equal(got, dp.u8_transform_reference(x, transform)), (
                transform, n, off)


# K4's sizes: the path's (4 KiB, 64 KiB, the 256 KiB step, 1 MiB), each
# with a ragged neighbour, and 16 MiB + 1, past one round of the grid.
K4_SIZES = [4096, 4096 + 3, 1 << 16, (1 << 16) + 5, 1 << 18, (1 << 18) + 7,
            1 << 20, (1 << 20) + 9, (16 << 20) + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["vector", "head", "scalar"])
@pytest.mark.parametrize("transform", ["echo", "xor255", "incr"])
def test_u8_transform_branches(transform, branch):
    """Each branch of K4 byte-equal to the plain version: in and out at
    offsets (0, 0) through the wrapper (the vector body), (off, off) for a
    scalar head before the vector body, (off, 0) for the all-scalar
    path."""
    _need_card()
    from tbus_torch.kernels import _build

    fn = _build.device_programs_lib().tbus_u8_transform
    rng = np.random.default_rng(23)
    raw = torch.from_numpy(rng.integers(0, 256, (16 << 20) + 64,
                                        dtype=np.uint8)).cuda()
    sink = torch.empty_like(raw)
    for n in K4_SIZES:
        for off in ((0,) if branch == "vector" else (1, 7, 15)):
            x = raw[off:off + n]
            if branch == "vector":
                got = dp.u8_transform(x, transform)
            else:
                out_off = 0 if branch == "scalar" else off
                got = sink[out_off:out_off + n]
                assert fn(x.data_ptr(), got.data_ptr(), n,
                          dp.U8_OPS[transform],
                          torch.cuda.current_stream().cuda_stream) == 0
            assert torch.equal(got, dp.u8_transform_reference(x, transform)), (
                branch, transform, n, off)


def _dot128_check(x):
    """K5 against its plain version: NaN and +-inf at the same places,
    the finite values within 2 * 128 * 2^-24 * (|x| @ |W|)."""
    got, want = dp.dot128(x), dp.dot128_reference(x)
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(want))
    with ieee_fp32():
        tol = 2 * 128 * 2.0**-24 * (x.abs() @ dp.dot128_weight("cuda").abs())
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    assert bool((err <= tol[fin]).all()), float(err.max())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 7, 8, 17, 64, 1000, 2048, 4096])
def test_dot128_matches_plain_version(k):
    _need_card()
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((k, 128),
                                             dtype=np.float32)).cuda()
    _dot128_check(x)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 64, 2048])
@pytest.mark.parametrize("kind", ["subnormal", "scales", "nonfinite"])
def test_dot128_hard_payloads(kind, k):
    _need_card()
    x = torch.from_numpy(dp.dot128_payload(kind, k, 100 + k)).cuda()
    got = _dot128_check(x)
    if kind == "subnormal":
        assert int(torch.count_nonzero(got)) > got.numel() // 2
    if kind == "nonfinite":
        assert bool((~torch.isfinite(got)).any())


@pytest.mark.cuda
def test_dot128_weight_scratch_equals_its_plain_version():
    _need_card()
    dp.dot128(torch.zeros((1, 128), device="cuda"))
    w = dp._dot128_weight_scratch(torch.device("cuda"))
    assert torch.equal(w, dp.dot128_weight_image("cuda").view(torch.uint8))


@pytest.mark.cuda
def test_dot128_wrapper_and_runtime_at_once():
    """The wrapper (its per-device weight scratch, PyTorch's stream) and
    the device runtime (its plan's scratch, its own stream, its dispatch
    thread) run K5 from one library at the same time; every answer
    holds."""
    _need_card()
    import tbus_torch as tt

    tt.device_init("cuda")
    s = tt.Server()
    s.add_device_method("DevCuda", "dot128", "dot128")
    port = s.start(0)
    rng = np.random.default_rng(77)
    xs = [rng.standard_normal((k, 128), dtype=np.float32)
          for k in (8, 64, 2048)]
    errors = []

    def wrapper_side():
        try:
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                for i in range(60):
                    _dot128_check(torch.from_numpy(xs[i % 3]).cuda())
            side.synchronize()
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    try:
        ch = tt.Channel(f"127.0.0.1:{port}", timeout_ms=30000)
        w = np.abs(dp.dot128_weight().numpy())
        side = threading.Thread(target=wrapper_side)
        side.start()
        for i in range(60):
            x = xs[i % 3]
            y = np.frombuffer(ch.call("DevCuda", "dot128", x.tobytes()),
                              dtype=np.float32).reshape(x.shape)
            want = dp.dot128_reference(torch.from_numpy(x)).numpy()
            assert (np.abs(y - want)
                    <= 2 * 128 * 2.0**-24 * (np.abs(x) @ w)).all(), i
        side.join(timeout=300)
        assert not side.is_alive()
        assert not errors, errors[0]
    finally:
        s.stop()


@pytest.mark.cuda
def test_k5_runs_wgmma():
    """K5's product is wgmma: HGMMA in dot128_kernel's SASS, no HMMA,
    and no spills in ptxas's report of the build."""
    _need_card()
    from tbus_torch.kernels import _build

    dp.dot128(torch.zeros((64, 128), device="cuda"))
    report = _build.gemm_sass("device_programs", "dot128_kernel")
    usage = _build.ptxas_usage("device_programs")
    assert report, "no dot128_kernel in libdevice_programs"
    for fn, counts in report.items():
        assert counts["HGMMA"] > 0 and counts["HMMA"] == 0, (fn, counts)
        assert usage[fn]["spill_stores"] + usage[fn]["spill_loads"] == 0, (
            fn, usage[fn])


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(128, 1), (128, 4), (256, 2), (130, 2),
                                 (1000, 3), (2048, 4), (256, 3), (384, 2)])
def test_dotbench_matches_plain_version(n, t):
    _need_card()
    seed = 0.375
    got_sum, got_last = dp.dotbench(torch.tensor([seed], device="cuda"), n,
                                    t, return_last=True)
    want_sum, want_last = dp.dotbench_reference(seed, n, t, "cuda",
                                                return_last=True)
    prev = dp.dotbench_reference(seed, n, t - 1, "cuda", return_last=True)[1]
    _, w = dp.dotbench_operands(seed, n, "cuda")
    inv = float(dp.dotbench_inverse(n))
    with ieee_fp32():
        mag = (prev.float().abs() @ w.float().abs()).double() * inv
    a, b = got_last.double(), want_last.double()
    tol = _bf16_ulp(torch.maximum(a.abs(), b.abs())) + (
        2.0**-7 + n * 2.0**-24) * mag
    assert bool(((a - b).abs() <= tol).all())
    sum_tol = (2.0**-7 + n * 2.0**-24) * float(b.abs().sum())
    assert abs(float(got_sum.reshape(())) - float(want_sum)) <= sum_tol


@pytest.mark.cuda
def test_k6_gemm_runs_wgmma():
    """K6's products are the TMA + wgmma mainloop: HGMMA in its SASS, no
    HMMA (mma.sync)."""
    _need_card()
    from tbus_torch.kernels import _build

    dp.dotbench(torch.tensor([0.5], device="cuda"), 128, 1)
    report = _build.gemm_sass("device_programs")
    assert report, "no gemm_sm90_kernel in libdevice_programs"
    for fn, counts in report.items():
        assert counts["HGMMA"] > 0 and counts["HMMA"] == 0, (fn, counts)


@pytest.mark.cuda
def test_cuda_runtime_mounts_serve_over_rpc():
    """Device methods and a generate method on the CUDA runtime, called
    over RPC: replies equal the plain versions, tokens are byte-exact, the
    serving stats name the CUDA engine, and every kernel's launch count
    rises."""
    _need_card()
    import tbus_torch as tt
    from tbus_torch import rpc

    tt.device_init("cuda")
    s = tt.Server()
    for tf in ("echo", "xor255", "incr", "dot128", "dotbench256x2"):
        s.add_device_method("DevCuda", tf, tf)
    s.add_generate_method("GenCuda", "Generate", "xor255", max_batch=8,
                          token_bytes=128)
    port = s.start(0)
    try:
        rpc.reset_device_launches()
        ch = tt.Channel(f"127.0.0.1:{port}", timeout_ms=30000)
        rng = np.random.default_rng(5)
        for n in (1, 127, 4097, (1 << 20) + 1):
            p = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for tf in ("echo", "xor255", "incr"):
                assert ch.call("DevCuda", tf, p) == \
                    dp.device_method_reference(tf, p), (tf, n)
        x = rng.standard_normal((8, 128), dtype=np.float32)
        y = np.frombuffer(ch.call("DevCuda", "dot128", x.tobytes()),
                          dtype=np.float32).reshape(8, 128)
        want = dp.dot128_reference(torch.from_numpy(x)).numpy()
        tol = 2 * 128 * 2.0**-24 * (np.abs(x) @ np.abs(
            dp.dot128_weight().numpy()))
        assert (np.abs(y - want) <= tol).all()
        got = struct.unpack("<f", ch.call("DevCuda", "dotbench256x2",
                                          struct.pack("<f", 0.5)))[0]
        want_sum, last = dp.dotbench_reference(0.5, 256, 2, "cuda",
                                               return_last=True)
        assert abs(got - float(want_sum)) <= (2.0**-7 + 256 * 2.0**-24) * \
            float(last.float().abs().sum())
        with pytest.raises(tt.RpcError, match="multiple of 512"):
            ch.call("DevCuda", "dot128", b"\0" * 100)
        req = struct.pack("<I", 4) + b"xy"
        with tt.Stream.create(ch, "GenCuda", "Generate", req) as st:
            state = np.frombuffer((b"xy" * 64)[:128], dtype=np.uint8)
            for _ in range(4):
                state = state ^ 0xFF
                assert st.read(timeout_ms=30000) == state.tobytes()
            assert st.read(timeout_ms=30000) is None
        launches = rpc.device_stats()["launches"]
        assert min(launches[k] for k in ("u8_transform", "dot128",
                                         "dotbench")) > 0, launches
        assert launches["fanout"] == 0, launches  # nothing fanned out here
        gen = [g for g in tt.serve_stats() if g["name"] == "GenCuda.Generate"]
        assert gen and gen[0]["engine"] == "cuda"
        assert gen[0]["engine_steps"] == gen[0]["steps"] > 0
    finally:
        s.stop()
