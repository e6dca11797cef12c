"""Ring attention's fold kernel (K3) against its plain version, on the card.

The kernel has no CPU mode, so these tests skip without an NVIDIA card.
This file imports no JAX; run it on the card without tests/conftest.py:

    python -m pytest -m cuda --noconftest tests/test_torch_ring_fold_cuda.py

Tolerance: 2e-5 absolute and relative on o / l after the folds, as the
reference's own ring test holds ring attention to full attention
(tests/test_collectives.py:97). The kernel rescales per tile of 64 keys
where the plain version takes one max over the whole block, and sums in
another order; the same inputs reach both in f32, so bf16 inputs are held
to the same tolerance. Every width runs the split-term design (both
products on wgmma over exact bf16 terms): heads up to 256 wide with q
resident (d padded to 128, 192 or 256), wider ones streaming q through
column groups of 192 or 256. The fused last fold (final=True) writes
o / l in q's dtype: an f32 output is held to the same 2e-5, a bf16 one
to that plus one bf16 ulp (both round an f32 value that close to bf16
once).
"""

import math

import numpy as np
import pytest
import torch

from tbus_torch.kernels import ring_fold as rf

# (lq, lk, d, folds): the entry's ring (local 8, d 16), the JAX test's
# (local 16, d 32), 32K context over a 4-position ring, ragged shapes
# that are no multiple of the 64-row tiles, the wide heads (d 129-256:
# 8192 x 256 as Gemma's heads at 8K context, and ragged widths padded
# to 192 and 256) and past them (the streamed route: 320 and 512 at 8K
# and 1K context, and ragged widths 400 and 1000, the last in four column
# groups).
SHAPES = [(8, 8, 16, 8), (16, 16, 32, 8), (8192, 8192, 128, 4),
          (1, 1, 8, 2), (100, 77, 48, 3), (65, 130, 128, 2),
          (200, 63, 100, 2), (8, 8, 256, 4), (1024, 1024, 256, 2),
          (100, 77, 200, 3), (70, 129, 129, 2), (33, 65, 400, 2),
          (8192, 8192, 256, 2), (8192, 8192, 320, 2), (1024, 1024, 512, 2),
          (100, 77, 1000, 2)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _carry(lq, d, device):
    return (torch.full((lq,), -math.inf, device=device),
            torch.zeros((lq,), device=device),
            torch.zeros((lq, d), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fold_kernel_matches_plain_version(card, shape, dtype):
    lq, lk, d, folds = shape
    rng = np.random.default_rng(lq + lk + d)
    q = torch.from_numpy(rng.standard_normal((lq, d), dtype=np.float32))
    q = q.to(card, dtype)
    blocks = [tuple(torch.from_numpy(rng.standard_normal(
        (lk, d), dtype=np.float32)).to(card, dtype) for _ in range(2))
        for _ in range(folds)]
    m, l, o = _carry(lq, d, card)
    pm, pl, po = _carry(lq, d, card)
    before = rf.launches, rf.wide_launches, rf.stream_launches
    for k, v in blocks:
        rf.fold_(q, k, v, m, l, o)
        pm, pl, po = rf.fold_reference(q, k, v, pm, pl, po)
    torch.cuda.synchronize()
    assert (rf.launches, rf.wide_launches, rf.stream_launches) == (
        before[0] + folds, before[1] + (folds if 128 < d <= 256 else 0),
        before[2] + (folds if d > 256 else 0))
    assert bool(torch.isfinite(o).all()) and bool((l > 0).all())
    torch.testing.assert_close(m, pm, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(o / l[:, None], po / pl[:, None],
                               rtol=2e-5, atol=2e-5)


def _bf16_ulp(a):
    _, e = torch.frexp(a.abs().double())
    return torch.ldexp(torch.ones_like(a, dtype=torch.float64),
                       torch.clamp(e - 8, min=-133))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 16, 1), (16, 16, 32, 8),
                                   (100, 77, 48, 3), (8192, 8192, 128, 2),
                                   (70, 129, 129, 2), (33, 65, 400, 2),
                                   (100, 77, 256, 2), (65, 130, 192, 2),
                                   (100, 77, 1000, 2)],
                         ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_final_fold_writes_the_normalised_output(card, shape, dtype):
    lq, lk, d, folds = shape
    rng = np.random.default_rng(lq * 3 + lk + d)
    q = torch.from_numpy(rng.standard_normal((lq, d), dtype=np.float32))
    q = q.to(card, dtype)
    blocks = [tuple(torch.from_numpy(rng.standard_normal(
        (lk, d), dtype=np.float32)).to(card, dtype) for _ in range(2))
        for _ in range(folds)]
    m, l, o = _carry(lq, d, card)
    pm, pl, po = _carry(lq, d, card)
    for k, v in blocks[:-1]:
        rf.fold_(q, k, v, m, l, o)
        pm, pl, po = rf.fold_reference(q, k, v, pm, pl, po)
    k, v = blocks[-1]
    o_before = o.clone()
    before = rf.launches
    out = rf.fold_(q, k, v, m, l, o, final=True)
    want = rf.fold_reference(q, k, v, pm, pl, po, final=True)
    pm, pl, po = rf.fold_reference(q, k, v, pm, pl, po)
    torch.cuda.synchronize()
    assert rf.launches == before + 1
    assert out.dtype == dtype and out.shape == (lq, d)
    assert want.dtype == dtype and torch.equal(o, o_before)
    torch.testing.assert_close(m, pm, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(l, pl, rtol=2e-5, atol=2e-5)
    exact = (po / pl[:, None]).double()
    tol = 2e-5 + 2e-5 * exact.abs()
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(exact.float())
    assert bool(((out.double() - exact).abs() <= tol).all())
    assert bool(((want.double() - exact).abs() <= tol).all())


@pytest.mark.cuda
def test_k3_runs_wgmma(card):
    """Every d folds in the split-term wgmma kernel: HGMMA in the SASS of
    each of its ten instantiations (f32 and bf16 inputs, each at the
    resident widths 128, 192 and 256 and at the streamed column groups of
    192 (d 320) and 256 (d 512)), no HMMA, and no spills in ptxas's
    report."""
    for d in (16, 129, 256, 320, 512):
        for dtype in DTYPES:
            q = torch.ones((8, d), device=card, dtype=dtype)
            rf.fold_(q, q, q, *_carry(8, d, card))
    torch.cuda.synchronize()
    from tbus_torch.kernels import _build

    report = _build.gemm_sass("ring_fold", kernel="fold_wgmma_kernel")
    assert len(report) == 10, report
    usage = _build.ptxas_usage("ring_fold")
    for fn, counts in report.items():
        assert counts["HGMMA"] > 0 and counts["HMMA"] == 0, (fn, counts)
        assert usage[fn]["spill_stores"] + usage[fn]["spill_loads"] == 0, \
            (fn, usage[fn])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fold_takes_heads_of_many_column_groups(card, dtype):
    """A head past 256 splits o into column groups whose blocks never talk,
    so any number of them runs: at d 2049 nine groups of 256 (2112
    padded columns), the fused last fold of equal rows giving every
    output 1."""
    d = 2049
    assert rf.column_groups(d) == (9, 256)
    q = torch.ones((8, d), device=card, dtype=dtype)
    before = rf.launches, rf.stream_launches
    out = rf.fold_(q, q, q, *_carry(8, d, card), final=True)
    torch.cuda.synchronize()
    assert (rf.launches, rf.stream_launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert bool((out.float() == 1).all())


@pytest.mark.cuda
def test_fma_fold_kernel_is_gone(card):
    """No fold past 256 runs outside the wgmma kernel: the former chunked
    f32 FMA kernel (ring_fold_kernel) is not in the library's SASS."""
    rf.fold_(*(torch.ones((8, 320), device=card) for _ in range(3)),
             *_carry(8, 320, card))
    torch.cuda.synchronize()
    from tbus_torch.kernels import _build

    assert _build.gemm_sass("ring_fold", kernel="ring_fold_kernel") == {}
    assert _build.gemm_sass("ring_fold", kernel="fold_wgmma_kernel")
