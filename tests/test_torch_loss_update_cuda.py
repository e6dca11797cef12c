"""The fan-out step's loss, its gradient and the update (K8a, K8b, K9)
against their plain versions, on the card.

The kernels have no CPU mode, so these tests skip without an NVIDIA card.
This file imports no JAX; run it on the card without tests/conftest.py:

    python -m pytest -m cuda --noconftest tests/test_torch_loss_update_cuda.py

Tolerances. K8a: rtol 1e-5 against torch's sum on the card (f32 sums of
up to 16.7 M terms in another order), and bit-equal between two calls on
the same y (a fixed grid, no float atomics). K8b and K9: bit-equal; both
sides round the same products once (K8b gbar * y, then an exact doubling;
K9 one fused multiply-subtract, its plain version an exact f64 emulation).
"""

import numpy as np
import pytest
import torch

from tbus_torch.kernels import _build, loss_update as lu

# The entry's y [4, 16] and w [16, 16], a ragged shape, and one dense layer
# of a 7B-class model; "offset" takes a view one float into a buffer.
SHAPES = [(4, 16), (16, 16), (1000, 37), (4096, 4096)]
CASES = SHAPES + ["offset"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _tensor(card, case, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    if case == "offset":
        buf = torch.from_numpy(rng.standard_normal(
            1000 * 37 + 1, dtype=np.float32) * np.float32(scale)).to(card)
        return buf[1:].view(1000, 37)
    return torch.from_numpy(rng.standard_normal(case, dtype=np.float32)
                            * np.float32(scale)).to(card)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
def test_sumsq_matches_plain_and_is_deterministic(card, case):
    y = _tensor(card, case, 1)
    before = lu.sumsq_launches
    a, b = lu.sumsq(y), lu.sumsq(y)
    torch.cuda.synchronize()
    assert lu.sumsq_launches == before + 2
    assert a.shape == () and a.dtype == torch.float32
    assert torch.equal(_bits(a), _bits(b))
    want = lu.sumsq_reference(y)
    torch.testing.assert_close(a, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("gbar", [1.0, 0.37])
def test_sumsq_grad_is_bit_equal_to_plain(card, case, gbar):
    y = _tensor(card, case, 2)
    gb = torch.tensor(gbar, dtype=torch.float32, device=card)
    before = lu.sumsq_grad_launches
    got = lu.sumsq_grad(y, gb)
    torch.cuda.synchronize()
    assert lu.sumsq_grad_launches == before + 1
    assert got.shape == y.shape
    assert torch.equal(_bits(got), _bits(lu.sumsq_grad_reference(y, gb)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("scale", [1.0, 37.0, 1e4])
def test_sgd_update_is_bit_equal_to_plain(card, case, scale):
    w = _tensor(card, case, 3, 0.02)
    g = _tensor(card, case, 4, scale)
    before = lu.sgd_update_launches
    got = lu.sgd_update(w, g, 1e-3)
    torch.cuda.synchronize()
    assert lu.sgd_update_launches == before + 1
    assert got.shape == w.shape and got.data_ptr() != w.data_ptr()
    assert torch.equal(_bits(got), _bits(lu.sgd_update_reference(w, g, 1e-3)))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_head_body_and_tail_at_one_offset(card, offset):
    """Every pointer one to three floats past a 16-byte boundary: a scalar
    head, the float4 body and a scalar tail (the wrappers' fresh outputs
    always take the aligned body)."""
    n = 1000 * 37
    y = _tensor(card, (n + offset,), 5)
    g = _tensor(card, (n + offset,), 6, 37.0)
    gb = torch.tensor(0.37, device=card)
    dy = torch.full((n + offset,), float("nan"), device=card)
    w1 = torch.full((n + offset,), float("nan"), device=card)
    lib = _build.loss_update_lib()
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.tbus_sumsq_grad(y[offset:].data_ptr(), gb.data_ptr(),
                               dy[offset:].data_ptr(), n, stream) == 0
    assert lib.tbus_sgd_update(y[offset:].data_ptr(), g[offset:].data_ptr(),
                               w1[offset:].data_ptr(), 1e-3, n, stream) == 0
    torch.cuda.synchronize()
    assert torch.isnan(dy[:offset]).all() and torch.isnan(w1[:offset]).all()
    want_dy = lu.sumsq_grad_reference(y[offset:], gb)
    want_w1 = lu.sgd_update_reference(y[offset:], g[offset:], 1e-3)
    assert torch.equal(_bits(dy[offset:]), _bits(want_dy))
    assert torch.equal(_bits(w1[offset:]), _bits(want_w1))


@pytest.mark.cuda
def test_empty_tensors_launch_nothing(card):
    e = torch.empty((0, 7), device=card)
    before = (lu.sumsq_launches, lu.sumsq_grad_launches,
              lu.sgd_update_launches)
    assert float(lu.sumsq(e)) == 0.0
    assert lu.sumsq_grad(e, torch.tensor(1.0, device=card)).shape == (0, 7)
    assert lu.sgd_update(e, e, 1e-3).shape == (0, 7)
    assert (lu.sumsq_launches, lu.sumsq_grad_launches,
            lu.sgd_update_launches) == before


@pytest.mark.cuda
def test_card_tensors_refuse_what_the_kernels_do_not_take(card):
    y = torch.ones(4, 16, device=card)
    with pytest.raises(ValueError, match="f32"):
        lu.sumsq(y.bfloat16())
    with pytest.raises(ValueError, match="operands on"):
        lu.sumsq_grad(y, torch.tensor(1.0))
    with pytest.raises(ValueError, match="differ"):
        lu.sgd_update(y, y.T, 1e-3)


@pytest.mark.cuda
def test_sum_squares_backward_runs_k8b(card):
    y = _tensor(card, (4, 16), 7).requires_grad_(True)
    before = (lu.sumsq_launches, lu.sumsq_grad_launches)
    loss = lu.SumSquares.apply(y)
    loss.backward()
    torch.cuda.synchronize()
    assert (lu.sumsq_launches, lu.sumsq_grad_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(_bits(y.grad), _bits(2 * y.detach()))
