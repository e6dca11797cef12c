"""The fan-out step's GEMM kernels (K1, K2) against their plain versions, on
the card.

The kernels have no CPU mode, so these tests skip without an NVIDIA card.
This file imports no JAX; run it on the card without tests/conftest.py:

    python -m pytest -m cuda --noconftest tests/test_torch_gemm_cuda.py

Tolerances. K1: max|kernel - plain| <= 1e-4 * max|plain|; both multiply
the same bf16 values exactly and differ only in the order of the f32 sum.
K2: within one bf16 ulp elementwise, plus the gap that two f32 sums of
the same M terms taken in different orders can open: sqrt(M) * 2^-24 *
sum|t| each (the probabilistic bound). Both round an f32 sum to bf16
once; a near-tie may round the other way, and where the terms cancel
(at M = 4096 some results are far smaller than sum|t|) the f32 sums
themselves differ by more than an ulp of the result. At the entry's
M = 4 the second term is about 1e-6 of an ulp. K2 multiplies dy's exact
three-term bf16 split on the tensor cores (tbus_torch/csrc/gemm_bf16.cu),
so the same tolerance holds it on dy of a wide dynamic range, on tiny dy
(whose lowest term is a bf16 subnormal: the split then drops dy's bits
below 2^-133, at most 2^-134 each, far under an ulp of these sums) and
where dy holds +-inf (non-finite results where the plain version's are).
"""

import math

import numpy as np
import pytest
import torch

from tbus_torch.kernels import gemm

# (M, K, N): the entry's shape, one dense layer of a 7B-class model,
# ragged shapes that are no multiple of any tile, shapes on and one past
# the shared GEMM's tile edges (128 rows, 256 columns, 64 deep), and long K.
SHAPES = [(4, 16, 16), (4096, 4096, 4096), (1, 1, 1), (37, 29, 50),
          (130, 129, 257), (200, 300, 33), (4, 16, 32), (128, 64, 256),
          (129, 65, 257), (256, 4104, 384), (64, 16384, 64)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _operands(card, m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                         * np.float32(0.02))
    dy = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32))
    return x.to(card), w.to(card), dy.to(card)


def _bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits)."""
    _, e = torch.frexp(a.abs().double())
    return torch.ldexp(torch.ones_like(a, dtype=torch.float64),
                       torch.clamp(e - 8, min=-133))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("x_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("w_dtype", DTYPES, ids=str)
def test_matmul_kernel_matches_plain_version(card, shape, x_dtype, w_dtype):
    m, k, n = shape
    x, w, _ = _operands(card, m, k, n, seed=m + k + n)
    x, w = x.to(x_dtype), w.to(w_dtype)
    before = gemm.matmul_launches
    got = gemm.matmul_bf16_f32(x, w)
    torch.cuda.synchronize()
    assert gemm.matmul_launches == before + 1
    want = gemm.matmul_bf16_f32_reference(x, w)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("x_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("w_dtype", DTYPES, ids=str)
def test_pack_kernel_equals_plain_pack(card, shape, x_dtype, w_dtype):
    """K1's pack writes the bits and the padded shape of pack_reference."""
    m, k, n = shape
    x, w, _ = _operands(card, m, k, n, seed=2 * m + n)
    x, w = x.to(x_dtype), w.to(w_dtype)
    _, xb, wtb = gemm.matmul_bf16_f32_packed(x, w)
    want_xb, want_wtb = gemm.pack_reference(x, w)
    assert xb.shape == want_xb.shape and wtb.shape == want_wtb.shape
    assert torch.equal(xb, want_xb) and torch.equal(wtb, want_wtb)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("x_dtype", DTYPES, ids=str)
def test_dw_kernel_within_one_bf16_ulp(card, shape, x_dtype):
    m, k, n = shape
    x, _, dy = _operands(card, m, k, n, seed=3 * m + k)
    x = x.to(x_dtype)
    before = gemm.dw_launches
    got = gemm.dw_f32_bf16(x, dy)
    torch.cuda.synchronize()
    assert gemm.dw_launches == before + 1
    want = gemm.dw_reference(x, dy)
    assert got.dtype == torch.float32 and got.shape == (k, n)
    assert torch.equal(got, got.bfloat16().float())  # rounded to bf16
    diff = (got.double() - want.double()).abs()
    ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    sumabs = gemm.dw_reference(x.abs(), dy.abs()).double()
    order = 2 * math.sqrt(m) * 2.0**-24 * sumabs
    assert bool((diff <= ulp + order).all()), (diff / ulp).max().item()


def _dw_within_tolerance(x, dy, got, want):
    """Non-finite where the plain version is (NaN for NaN, the same
    infinity), and within one bf16 ulp plus the summation-order gap
    elsewhere."""
    assert torch.equal(got.isnan(), want.isnan())
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    ok = torch.isfinite(want)
    assert bool(torch.isfinite(got[ok]).all())
    diff = (got.double() - want.double()).abs()[ok]
    ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))[ok]
    sumabs = gemm.dw_reference(x.abs(), dy.abs()).double()[ok]
    order = 2 * math.sqrt(x.shape[0]) * 2.0**-24 * sumabs
    assert bool((diff <= ulp + order).all()), (diff / ulp).max().item()


def _dy_cases(card, m, n, seed):
    rng = np.random.default_rng(seed)
    normal = rng.standard_normal((m, n))
    sign = rng.choice([-1.0, 1.0], (m, n))
    wide = normal * 2.0 ** rng.uniform(-100, 100, (m, n))
    # |dy| in [2^-112, 2^-111): hi and mid normal, lo a bf16 subnormal.
    tiny = sign * rng.uniform(1, 2, (m, n)) * 2.0**-112
    inf = normal.copy()
    inf[rng.integers(0, m, 3), rng.integers(0, n, 3)] = [np.inf, -np.inf,
                                                         np.inf]
    return {name: torch.from_numpy(a.astype(np.float32)).to(card)
            for name, a in (("wide", wide), ("tiny", tiny), ("inf", inf))}


DY_SHAPES = [(4, 16, 16), (129, 65, 257), (256, 300, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DY_SHAPES, ids=str)
@pytest.mark.parametrize("case", ["wide", "tiny", "inf"])
@pytest.mark.parametrize("x_dtype", DTYPES, ids=str)
def test_dw_kernel_on_dy_of_any_range(card, shape, case, x_dtype):
    m, k, n = shape
    x, _, _ = _operands(card, m, k, n, seed=5 * m + n)
    x = x.to(x_dtype)
    dy = _dy_cases(card, m, n, seed=m + 7 * n)[case]
    got = gemm.dw_f32_bf16(x, dy)
    torch.cuda.synchronize()
    want = gemm.dw_reference(x, dy)
    if case == "inf":
        assert not bool(torch.isfinite(want).all())
    _dw_within_tolerance(x, dy, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + DY_SHAPES, ids=str)
@pytest.mark.parametrize("x_dtype", DTYPES, ids=str)
def test_dw_pack_kernel_equals_plain_pack(card, shape, x_dtype):
    """K2's pack writes the bits and the padded shapes of
    dw_pack_reference: bf16(x)^T and dy^T's exact split."""
    m, k, n = shape
    x, _, dy = _operands(card, m, k, n, seed=4 * m + k)
    dys = dict(_dy_cases(card, m, n, seed=k), normal=dy)
    # The largest finite values, whose bf16_rn overflows: hi = bf16_rz.
    top = dy.clone()
    big = torch.finfo(torch.float32).max
    top[0, 0], top[-1, -1] = big, -big
    dys["max"] = top
    for name, d in dys.items():
        _, at, bt = gemm.dw_f32_bf16_packed(x.to(x_dtype), d)
        want_at, want_bt = gemm.dw_pack_reference(x.to(x_dtype), d)
        assert at.shape == want_at.shape and bt.shape == want_bt.shape
        assert torch.equal(at.view(torch.int16), want_at.view(torch.int16))
        assert torch.equal(bt.view(torch.int16),
                           want_bt.view(torch.int16)), name


@pytest.mark.cuda
def test_dw_keeps_dy_in_f32(card):
    """K2 must not round dy to bf16. Six rows of x = 1 and dy = 1 + 2^-8
    (a tie that bf16 rounds to 1): the f32 sum 6 + 6 * 2^-8 rounds to the
    bf16 6.03125, while a bf16 dy would sum to 6."""
    x = torch.ones((6, 1), device=card)
    dy = torch.full((6, 1), 1 + 2**-8, device=card)
    assert gemm.dw_f32_bf16(x, dy).item() == 6.03125
    assert gemm.dw_reference(x, dy).item() == 6.03125


@pytest.mark.cuda
def test_autograd_function_runs_both_kernels(card):
    x, w, dy = _operands(card, 64, 48, 80, seed=9)
    w = w.requires_grad_(True)
    m0, d0 = gemm.matmul_launches, gemm.dw_launches
    y = gemm.BF16Matmul.apply(x, w)
    (g,) = torch.autograd.grad(y, (w,), dy)
    torch.cuda.synchronize()
    assert (gemm.matmul_launches, gemm.dw_launches) == (m0 + 1, d0 + 1)
    assert torch.equal(g, gemm.dw_f32_bf16(x, dy))


@pytest.mark.cuda
def test_k1_gemm_runs_wgmma(card):
    """K1's GEMM is the TMA + wgmma mainloop: HGMMA in its SASS, no HMMA
    (mma.sync)."""
    x, w, _ = _operands(card, 4, 16, 16, seed=1)
    gemm.matmul_bf16_f32(x, w)
    from tbus_torch.kernels import _build

    report = _build.gemm_sass("gemm_bf16")
    assert report, "no gemm_sm90_kernel in libgemm_bf16"
    for fn, counts in report.items():
        assert counts["HGMMA"] > 0 and counts["HMMA"] == 0, (fn, counts)


@pytest.mark.cuda
def test_k2_gemm_runs_wgmma(card):
    """K2's product is the shared TMA + wgmma mainloop with its rounding
    epilogue: HGMMA in its SASS, no HMMA (mma.sync), no spills."""
    x, _, dy = _operands(card, 4, 16, 16, seed=2)
    gemm.dw_f32_bf16(x, dy)
    from tbus_torch.kernels import _build

    report = {fn: c for fn, c in _build.gemm_sass("gemm_bf16").items()
              if "StoreBf16Rounded" in fn}
    assert report, "no K2 gemm_sm90_kernel in libgemm_bf16"
    usage = _build.ptxas_usage("gemm_bf16")
    for fn, counts in report.items():
        assert counts["HGMMA"] > 0 and counts["HMMA"] == 0, (fn, counts)
        assert usage[fn]["spill_stores"] + usage[fn]["spill_loads"] == 0
