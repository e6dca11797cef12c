"""The kernels' plain versions against the reference's arithmetic, on the CPU.

On the CPU the wrappers run these plain versions (the CUDA kernels are
held to them on the card by tests/test_torch_gemm_cuda.py and
tests/test_torch_ring_fold_cuda.py), so these tests pin the arithmetic
that both must have:

- K1's plain version against jnp.dot(bf16, bf16, preferred f32), the
  reference's service handler (tbus/parallel/collective.py:188): exact on
  inputs whose f32 sums are exact in any order (half of them bf16 ties, so
  round-to-nearest-even shows), and to 1e-6 relative on random inputs
  (f32 sums in another order);
- K2's plain version against JAX's own gradient of that product: equal
  bit for bit, while the same product with dy rounded to bf16 is not;
- the fold's plain version against a numpy restatement of :128-137, from
  the -inf carry of a ring's first step and from a carry mid-ring, to
  1e-5 (exp and f32 sums in another order: a few f32 ulps of values up
  to ~10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbus_torch.kernels import gemm, ring_fold as rf


def _dyadic(rng, shape):
    """+-[1, 2) with 9 significant bits: bf16 keeps 8, so half the values
    are ties, and products of two bf16 values summed over <= 64 terms are
    exact in f32."""
    k = rng.integers(256, 512, shape)
    sign = rng.choice([-1.0, 1.0], shape)
    return (sign * k / 256.0).astype(np.float32)


def _jax_matmul(x, w):
    return np.asarray(jnp.dot(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(w).astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32))


def _jax_dw(x, w, dy):
    """The reference's own transpose: grad of <dot(bf16 x, bf16 w), dy>."""
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def f(w_):
        return jnp.vdot(jnp.dot(xb, w_.astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32), dy)

    return np.asarray(jax.grad(f)(jnp.asarray(w)))


SHAPES = [(4, 16, 16), (16, 16, 32), (33, 64, 45)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matmul_plain_is_exact_on_bf16_ties(shape):
    m, k, n = shape
    rng = np.random.default_rng(m + n)
    x, w = _dyadic(rng, (m, k)), _dyadic(rng, (k, n))
    got = gemm.matmul_bf16_f32_reference(torch.from_numpy(x),
                                         torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, _jax_matmul(x, w))
    # The ties really rounded (to even): an f32 product differs.
    assert not np.array_equal(got, x @ w)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matmul_plain_matches_jax_on_random_inputs(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * n)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) * np.float32(0.02)
    got = gemm.matmul_bf16_f32_reference(torch.from_numpy(x),
                                         torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, _jax_matmul(x, w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dw_plain_equals_jax_gradient(shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) * np.float32(0.02)
    dy = rng.standard_normal((m, n), dtype=np.float32)
    want = _jax_dw(x, w, dy)
    got = gemm.dw_reference(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_array_equal(got.numpy(), want)
    # A bf16 dy is another function: it misses JAX's gradient widely.
    xb = torch.from_numpy(x).bfloat16().float()
    dy16 = torch.from_numpy(dy).bfloat16().float()
    wrong = (xb.T @ dy16).bfloat16().float().numpy()
    assert np.mean(wrong != want) > 0.2


def test_cpu_wrappers_take_the_plain_versions():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, 16), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 4), dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal((8, 4), dtype=np.float32))
    launches = (gemm.matmul_launches, gemm.dw_launches)
    assert torch.equal(gemm.matmul_bf16_f32(x, w),
                       gemm.matmul_bf16_f32_reference(x, w))
    assert torch.equal(gemm.dw_f32_bf16(x, dy), gemm.dw_reference(x, dy))
    wg = w.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(gemm.BF16Matmul.apply(x, wg), (wg,), dy)
    assert torch.equal(g, gemm.dw_reference(x, dy))
    assert (gemm.matmul_launches, gemm.dw_launches) == launches
    with pytest.raises(ValueError):
        gemm.matmul_bf16_f32(x, dy)  # [8, 16] . [8, 4] does not chain
    with pytest.raises(ValueError):
        gemm.dw_f32_bf16(x, dy.bfloat16())  # dy must stay f32


def _np_fold(q, k, v, m, l, o):
    """tbus/parallel/collective.py:128-137 in numpy f32."""
    f = np.float32
    qf, kf, vf = (a.astype(f) for a in (q, k, v))
    scale = f(1.0) / np.sqrt(f(q.shape[-1]))
    s = np.einsum("qd,kd->qk", qf, kf) * scale
    m_new = np.maximum(m, s.max(axis=-1))
    with np.errstate(invalid="ignore"):
        alpha = np.exp(m - m_new)
    p = np.exp(s - m_new[:, None])
    return m_new, l * alpha + p.sum(axis=-1), o * alpha[:, None] + p @ vf


@pytest.mark.parametrize("carry", ["first", "mid_ring"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_fold_plain_matches_numpy_restatement(carry, dtype):
    lq, lk, d = 16, 24, 32
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
               .to(dtype) for n in (lq, lk, lk))
    if carry == "first":
        m = np.full((lq,), -np.inf, np.float32)
        l = np.zeros((lq,), np.float32)
        o = np.zeros((lq, d), np.float32)
    else:
        m = rng.standard_normal(lq, dtype=np.float32)
        l = rng.uniform(1.0, 5.0, lq).astype(np.float32)
        o = rng.standard_normal((lq, d), dtype=np.float32)
    got = rf.fold_reference(q, k, v, *(torch.from_numpy(a) for a in (m, l, o)))
    want = _np_fold(*(t.float().numpy() for t in (q, k, v)), m, l, o)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)

    # fold_ writes the same carry in place, through the plain version.
    mt, lt, ot = (torch.from_numpy(a.copy()) for a in (m, l, o))
    launches = rf.launches
    rf.fold_(q, k, v, mt, lt, ot)
    assert rf.launches == launches
    for g, t in zip(got, (mt, lt, ot)):
        assert torch.equal(g, t)


def test_fold_rejects_a_bad_carry():
    q = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        rf.fold_(q, q, q, torch.zeros(4), torch.zeros(4),
                 torch.zeros((4, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        rf.fold_(q, q.bfloat16(), q, torch.zeros(4), torch.zeros(4),
                 torch.zeros((4, 8)))
