"""The exact bf16 split-term products of K2 and K3, on the CPU.

K2 (dW) and K3 (ring attention's fold) run their f32 products on the
tensor cores by splitting each f32 operand exactly into three bf16 terms
(tbus_torch/csrc/gemm_sm90.cuh split3, :func:`split3_reference` here). The
kernels run only on the card; these tests pin, before any card runs them:

- the split: hi + mid + lo == a exactly wherever the terms can hold a's
  bits (every finite |a| >= 2^-110), within 2^-134 below that, and the
  special values (+-0, +-inf, NaN, the largest finite value);
- each design's arithmetic, emulated: split terms, each product exact (in
  f64), each group of 16 products (one wgmma k-step) summed exactly and
  rounded into an f32 accumulator, the terms in the kernels' order
  (smallest first), K3's i + j <= 2 cross terms, its padded widths
  (128, 192, 256, and past 256 the streamed route's D with its column
  groups and its s summed chunk after chunk of 64 columns) and tiles of
  64 or 32 keys with the online rescale, p's split by integer
  arithmetic (round half away from zero, exact all the same), its key
  splits and their merge. K3's emulation is held to
  the JAX package's ring attention (tbus/parallel/collective.py :125
  ring_attention.fold over a 4-position ring, as
  tests/test_collectives.py runs it) within its 2e-5, f32 and bf16
  inputs; K2's to JAX's gradient of shard_body's product within
  chip_smoke.py's _dw_check tolerance (one bf16 ulp plus 2 sqrt(M)
  2^-24 sum|t|, the gap two f32 sums in different orders can open);
- K2's plain pack: its padded shapes follow the header's tile, and its
  product over the three terms equals the exact one;
- the fused last fold on the CPU path, and the build key of K3's library.
"""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import Mesh

from tbus.parallel import collective as jcol
from tbus_torch.kernels import _build, gemm, ring_fold as rf
from tbus_torch.kernels import split3_reference

F32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The emulations below run thousands of tiny float64 products, where
    torch's intra-op threads only spin beside XLA's (the conftest's 8
    virtual devices): on one thread the file runs about ten times faster,
    the products the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split_sum(a: torch.Tensor) -> torch.Tensor:
    return sum(t.double() for t in split3_reference(a))


# ---- the split ----


@pytest.mark.parametrize("scale_exp", [-100, -60, -20, 0, 20, 60, 100])
def test_split_is_exact_on_random_f32(scale_exp):
    rng = np.random.default_rng(scale_exp + 200)
    a = rng.standard_normal(20000) * 2.0 ** rng.uniform(-20, 20, 20000)
    a = torch.from_numpy((a * 2.0**scale_exp).astype(np.float32))
    hi, mid, lo = split3_reference(a)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    err = (_split_sum(a) - a.double()).abs()
    big = a.abs() >= 2.0**-110
    assert int(big.sum()) > 10000
    assert float(err[big].max()) == 0.0
    assert float(err.max()) <= 2.0**-134
    # Each term holds the next 8 bits: |mid| <= 2^-8 |hi|, |lo| <= 2^-8 |mid|.
    nz = hi != 0
    assert bool((mid.double().abs()[nz]
                 <= hi.double().abs()[nz] * 2.0**-8).all())
    assert bool((lo.double().abs() <= mid.double().abs() * 2.0**-8).all())


@settings(max_examples=300, deadline=None)
@given(st.floats(width=32, allow_nan=False, allow_infinity=False))
def test_split_is_exact_for_any_finite_f32(x):
    a = torch.tensor([x], dtype=torch.float32)
    hi, mid, lo = split3_reference(a)
    got = float(_split_sum(a))
    if x == 0 or abs(x) >= 2.0**-110:
        assert got == float(a)
    else:
        assert abs(got - float(a)) <= 2.0**-134
    assert math.isfinite(float(hi))


def test_split_special_values():
    a = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, F32_MAX,
                      -F32_MAX, 1.0, 1 + 2.0**-8 + 2.0**-16 + 2.0**-23])
    hi, mid, lo = split3_reference(a)
    assert hi[:2].tolist() == [0.0, 0.0]
    assert math.copysign(1.0, float(hi[1])) == -1.0  # -0 keeps its sign
    assert hi[2:4].tolist() == [math.inf, -math.inf]
    assert mid[2:5].tolist() == [0.0] * 3 and lo[2:5].tolist() == [0.0] * 3
    assert math.isnan(float(hi[4]))
    # The largest finite value: bf16_rn would overflow, so hi = bf16_rz
    # and the split stays exact and finite.
    assert bool(torch.isfinite(hi[5:7]).all())
    assert torch.equal(_split_sum(a[5:]), a[5:].double())
    # 1 + 2^-8 + 2^-16 + 2^-23 needs all three terms: hi rounds up to
    # 1 + 2^-7, mid takes back 2^-8 - 2^-16, lo holds 2^-23.
    assert (float(hi[8]), float(mid[8]), float(lo[8])) == (
        1 + 2.0**-7, -(2.0**-8 - 2.0**-16), 2.0**-23)


def test_split_near_the_subnormals():
    """At and above 2^-110 exact; below, lo rounds as a bf16 subnormal, off
    by at most 2^-134 (half of bf16's least subnormal, 2^-133); f32
    subnormals included."""
    rng = np.random.default_rng(11)
    for e in range(-149, -100):
        m = rng.integers(2**23, 2**24, 500).astype(np.float64)
        a = torch.from_numpy((m * 2.0 ** (e - 23)).astype(np.float32))
        a = torch.cat([a, -a])
        err = (_split_sum(a) - a.double()).abs()
        if e >= -110:
            assert float(err.max()) == 0.0, e
        else:
            assert float(err.max()) <= 2.0**-134, e


# ---- K2: dW as one bf16 GEMM over dy's three terms ----


def _round_f32(a: torch.Tensor) -> torch.Tensor:
    return a.float().double()


def emulate_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K2's arithmetic: the pack, then k16 groups of exact products summed
    into an f32 accumulator along bt's 3 Mq columns ([lo | mid | hi]), A's
    columns wrapping every Mq; each sum rounded to bf16 once."""
    at, bt = gemm.dw_pack_reference(x, dy)
    k, n = x.shape[1], dy.shape[1]
    mq = at.shape[1]
    a64, b64 = at.double(), bt.double()
    acc = torch.zeros((at.shape[0], bt.shape[0]), dtype=torch.float64)
    for g in range(0, 3 * mq, 16):
        ga = g % mq
        acc = _round_f32(acc + a64[:, ga:ga + 16] @ b64[:, g:g + 16].T)
    return acc[:k, :n].float().bfloat16().float()


def _jax_dw(x, dy):
    """JAX's gradient of shard_body's product (collective.py:188), as
    tests/test_torch_kernels_plain.py takes it."""
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    w = jnp.zeros((x.shape[1], dy.shape[1]), jnp.float32)

    def f(w_):
        return jnp.vdot(jnp.dot(xb, w_.astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32), dy)

    return np.asarray(jax.grad(f)(w))


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(a.abs().double())
    return torch.ldexp(torch.ones_like(a, dtype=torch.float64),
                       torch.clamp(e - 8, min=-133))


@pytest.mark.parametrize("shape", [(4, 16, 16), (37, 29, 50),
                                   (129, 65, 257), (300, 70, 40)], ids=str)
@pytest.mark.parametrize("dy_range", ["normal", "wide", "tiny"])
def test_k2_emulation_matches_jax_gradient(shape, dy_range):
    m, k, n = shape
    rng = np.random.default_rng(m * 7 + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    dy = rng.standard_normal((m, n))
    if dy_range == "wide":
        dy = dy * 2.0 ** rng.uniform(-60, 60, (m, n))
    elif dy_range == "tiny":  # lo is a bf16 subnormal
        dy = np.sign(dy) * rng.uniform(1, 2, (m, n)) * 2.0**-112
    dy = dy.astype(np.float32)
    got = emulate_dw(torch.from_numpy(x), torch.from_numpy(dy))
    want = torch.from_numpy(np.array(_jax_dw(x, dy)))
    assert torch.equal(want, gemm.dw_reference(torch.from_numpy(x),
                                               torch.from_numpy(dy)))
    diff = (got.double() - want.double()).abs()
    ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    sumabs = (torch.from_numpy(x).bfloat16().double().abs().T
              @ torch.from_numpy(dy).double().abs())
    order = 2 * math.sqrt(m) * 2.0**-24 * sumabs
    assert bool((diff <= ulp + order).all()), float((diff / ulp).max())


@pytest.mark.parametrize("shape", [(1, 1, 1), (4, 16, 16), (65, 300, 257),
                                   (129, 513, 100)], ids=str)
def test_dw_pack_follows_the_header_tile(shape):
    """at [Kp, Mq] and bt [Np, 3 Mq]: Kp and Np on the mainloop's 256-row
    and 256-column tile, Mq on its 64-deep k (gemm.TILE, itself held to
    the header by tests/test_torch_gemm_pack.py); the padding is zero and
    the three terms' product equals the exact one."""
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    at, bt = gemm.dw_pack_reference(x, dy)
    bm, bn, bk = gemm.TILE
    kp, mq, np_ = gemm.padded_shape(k, m, n)
    assert at.shape == (kp, mq) and bt.shape == (np_, 3 * mq)
    assert kp % bm == 0 and np_ % bn == 0 and mq % bk == 0
    assert k <= kp < k + bm and n <= np_ < n + bn and m <= mq < m + bk
    assert torch.equal(at[:k, :m], x.bfloat16().T)
    pad_a, pad_b = at.clone(), bt.clone()
    pad_a[:k, :m] = 0
    for i in range(3):
        pad_b[:n, i * mq:i * mq + m] = 0
    assert not pad_a.any() and not pad_b.any()
    hi, mid, lo = split3_reference(dy)
    for i, term in enumerate((lo, mid, hi)):
        assert torch.equal(bt[:n, i * mq:i * mq + m], term.T)
    a64 = at.double()
    prod = sum(a64 @ bt[:, i * mq:(i + 1) * mq].double().T for i in range(3))
    exact = x.bfloat16().double().T @ dy.double()
    assert torch.allclose(prod[:k, :n], exact, rtol=1e-12, atol=0)


# ---- K3: the fold over split operands ----


def _terms(a: torch.Tensor, nt: int):
    """The kernel's operand terms as f64: the split of f32 inputs, the
    value itself for bf16 ones."""
    if nt == 1:
        return [a.double()]
    return [t.double() for t in split3_reference(a)]


def split3_bits(a: torch.Tensor):
    """K3's split of p (csrc/ring_fold.cu split3_bits): each term rounded
    half away from zero by integer arithmetic on the f32 bits, as f64."""
    def rna(t):
        bits = (t.float().view(torch.int32) + 0x8000) & -65536
        return bits.view(torch.float32).double()

    hi = rna(a)
    r = a.double() - hi
    mid = rna(r)
    return [hi, mid, r - mid]


def _pairs(ni: int, nj: int):
    """Cross terms (i, j) with i + j <= 2, the smallest first, as the
    kernel orders them."""
    return [(i, s - i) for s in (2, 1, 0) for i in range(s, -1, -1)
            if i < ni and s - i < nj]


def fold_tiling(d: int, nt: int):
    """K3's padded head width and keys per tile (csrc/ring_fold.cu Fold):
    d up to 128 pads to 128 with 64-key tiles; wider heads pad to the next
    multiple of 64, with 32-key tiles for f32 inputs (three terms) up to
    256 and 64 for bf16; past 256 (q streamed) 64-key tiles for both."""
    kd = 128 if d <= 128 else -(-d // 64) * 64
    return kd, 32 if 128 < kd <= rf.RESIDENT_MAX_D and nt == 3 else 64


def s_order(dpad: int, nt: int, half: int, halves: int):
    """The (q term, k term, first column) of each k16 step of s, in the
    order the kernel sums them into one consumer's accumulator: resident
    q, each cross term over the consumer's k16 steps of the whole head
    dim; past 256 (q streamed), chunk after chunk of 64 columns, each
    chunk's cross terms over its k16 steps. With f32 inputs on wide heads
    a consumer takes every other k16 step from its `half`-th."""
    step = 16 * halves
    if dpad > rf.RESIDENT_MAX_D:
        return [(i, j, g) for b in range(0, dpad, 64)
                for i, j in _pairs(nt, nt)
                for g in range(b + 16 * half, b + 64, step)]
    return [(i, j, g) for i, j in _pairs(nt, nt)
            for g in range(16 * half, dpad, step)]


def emulate_fold(q, k, v, m, l, o, nsplit, final=False):
    """K3's arithmetic on one block (csrc/ring_fold.cu): head dim padded to
    its width, tiles of keys (fold_tiling) split into nsplit runs, each run
    an online softmax from -inf with s and o_tile summed by k16 groups into
    f32 (s in s_order), o = fma(o, a, o_tile), p split by split3_bits;
    then the merge with the carry. Wide heads (d > 128) with f32 inputs
    sum s over the head dim's two halves (alternate groups of 16 columns)
    apart and add the halves (bf16 inputs: one sum, handed over as p);
    their column halves of o run the same arithmetic on the same p. Past
    256, o's columns are G groups of OW (ring_fold.column_groups), v
    zero-padded to G OW, and every group computes all of s the same way
    (its chunks in s_order, halves and all)."""
    nt = 3 if q.dtype == torch.float32 else 1
    lq, d = q.shape
    lk = k.shape[0]
    dpad, keys = fold_tiling(d, nt)
    groups, width = (rf.column_groups(d) if dpad > rf.RESIDENT_MAX_D
                     else (1, dpad))
    tiles = -(-lk // keys)
    f32 = np.float32
    scale = float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(d))))

    def padded(a, rows, cols=dpad):
        out = torch.zeros((rows, cols), dtype=a.dtype)
        out[:a.shape[0], :d] = a
        return out

    qt = _terms(padded(q.float(), lq), nt)
    kt = _terms(padded(k.float(), tiles * keys), nt)
    vt = _terms(padded(v.float(), tiles * keys, groups * width), nt)
    parts = []
    for sp in range(nsplit):
        mr = torch.full((lq,), -math.inf, dtype=torch.float64)
        lr = torch.zeros(lq, dtype=torch.float64)
        orun = torch.zeros((lq, groups * width), dtype=torch.float64)
        for j in range(sp * tiles // nsplit, (sp + 1) * tiles // nsplit):
            tile = slice(keys * j, keys * j + keys)
            # Wide heads, f32 inputs: each consumer sums s over its half
            # of the head dim (every other group of 16 columns), and s is
            # the f32 sum of the two halves.
            nh = 2 if dpad > 128 and nt == 3 else 1
            halves = []
            for h in range(nh):
                sh = torch.zeros((lq, keys), dtype=torch.float64)
                for i, jj, g in s_order(dpad, nt, h, nh):
                    sh = _round_f32(sh + qt[i][:, g:g + 16]
                                    @ kt[jj][tile, g:g + 16].T)
                halves.append(sh)
            s = _round_f32(sum(halves))
            s = _round_f32(s * scale)
            s[:, torch.arange(keys) + keys * j >= lk] = -math.inf
            m_new = torch.maximum(mr, s.max(dim=1).values)
            alpha = torch.from_numpy(np.exp((mr - m_new).numpy().astype(f32))
                                     ).double()
            p = torch.from_numpy(np.exp((s - m_new[:, None]).numpy()
                                        .astype(f32))).double()
            lr = _round_f32(lr * alpha)
            for c in range(keys):
                lr = _round_f32(lr + p[:, c])
            pt = split3_bits(p)
            ot = torch.zeros((lq, groups * width), dtype=torch.float64)
            for c0 in range(0, groups * width, width):  # a block's group
                cols = slice(c0, c0 + width)
                for i, jj in _pairs(3, nt):
                    for g in range(0, keys, 16):
                        ot[:, cols] = _round_f32(
                            ot[:, cols] + pt[i][:, g:g + 16]
                            @ vt[jj][tile][g:g + 16, cols])
            orun = _round_f32(orun * alpha[:, None] + ot)
            mr = m_new
        parts.append((mr, lr, orun[:, :d]))
    mx = torch.stack([m.double()] + [p[0] for p in parts]).max(dim=0).values

    def e(a):
        return torch.from_numpy(np.exp((a - mx).numpy().astype(f32))).double()

    a_in = e(m.double())
    ln = _round_f32(l.double() * a_in)
    acc = _round_f32(o.double() * a_in[:, None])
    for ms, ls, os_ in parts:
        a = e(ms)
        ln = _round_f32(ln + ls * a)
        acc = _round_f32(acc + os_ * a[:, None])
    if final:
        return (acc / ln[:, None]).float().to(q.dtype)
    return mx.float(), ln.float(), acc.float()


RING = 4  # ring positions: 4 carried folds


def _ring_inputs(local, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((RING * local, d)).astype(np.float32)
            for _ in range(3)]


def _emulated_ring(q, k, v, local, nsplit):
    """Each position folds the blocks in the order the ring brings them
    (its own, then its left neighbour's, ...), the last fold fused."""
    out = []
    for r in range(RING):
        qr = q[r * local:(r + 1) * local]
        d = q.shape[1]
        carry = (torch.full((local,), -math.inf), torch.zeros(local),
                 torch.zeros((local, d)))
        for step in range(RING):
            b = (r - step) % RING
            kb, vb = k[b * local:(b + 1) * local], v[b * local:(b + 1) * local]
            res = emulate_fold(qr, kb, vb, *carry, nsplit,
                               final=step == RING - 1)
            if step < RING - 1:
                carry = res
        out.append(res)
    return torch.cat(out)


@pytest.mark.parametrize("local,d,nsplit", [(16, 32, 1), (100, 48, 2),
                                            (130, 128, 3), (64, 200, 2),
                                            (48, 256, 1), (40, 160, 3),
                                            (40, 320, 1), (130, 400, 2),
                                            (24, 512, 1)],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_k3_emulation_matches_jax_ring_attention(local, d, nsplit, dtype):
    """A 4-position ring: JAX's ring_attention (its fold over the carried
    blocks) against the emulated kernel, within test_collectives.py:97's
    2e-5. bf16 inputs reach the reference's fold as f32 after its cast, so
    JAX runs them as the same values in f32 and the output is compared
    before the final cast."""
    q, k, v = _ring_inputs(local, d, seed=local + d)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    if dtype == torch.bfloat16:
        q, k, v = (t.float().numpy() for t in (tq, tk, tv))
    ring = Mesh(np.array(jax.devices()[:RING]), ("sp",))
    want = np.array(jcol.make_ring_attention(ring, "sp")(q, k, v))
    # The output before the cast: run the emulation in f32 for bf16 too,
    # with one term per operand as the kernel takes bf16 inputs.
    got = _emulated_ring(tq, tk, tv, local, nsplit)
    if dtype == torch.bfloat16:
        exact = _emulated_ring_f32_out(tq, tk, tv, local, nsplit)
        np.testing.assert_allclose(exact, want, rtol=2e-5, atol=2e-5)
        ulp = _bf16_ulp(torch.from_numpy(want)).numpy()
        assert np.all(np.abs(got.float().numpy() - want)
                      <= ulp + 2e-5 + 2e-5 * np.abs(want))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _emulated_ring_f32_out(q, k, v, local, nsplit):
    """The emulated ring's o / l in f32 (before the cast to q's dtype)."""
    out = []
    for r in range(RING):
        qr = q[r * local:(r + 1) * local]
        carry = (torch.full((local,), -math.inf), torch.zeros(local),
                 torch.zeros((local, q.shape[1])))
        for step in range(RING):
            b = (r - step) % RING
            carry = emulate_fold(qr, k[b * local:(b + 1) * local],
                                 v[b * local:(b + 1) * local], *carry, nsplit)
        out.append((carry[2] / carry[1][:, None]).numpy())
    return np.concatenate(out)


@settings(max_examples=300, deadline=None)
@given(st.floats(min_value=2.0**-110, max_value=1.0, width=32))
def test_k3_bit_split_of_p_is_exact(x):
    """p in [2^-110, 1] splits exactly, each term a bf16 value (its low
    16 bits zero), the terms as small as split3's: |mid| <= 2^-8 |hi|,
    |lo| <= 2^-8 |mid|."""
    hi, mid, lo = split3_bits(torch.tensor([x], dtype=torch.float32))
    assert float(hi + mid + lo) == float(np.float32(x))
    for t in (hi, mid, lo):
        bits = t.float().view(torch.int32)
        assert torch.equal(t.float().double(), t)
        assert int(bits & 0xFFFF) == 0
    assert abs(float(mid)) <= abs(float(hi)) * 2.0**-8
    assert abs(float(lo)) <= abs(float(mid)) * 2.0**-8


def test_k3_emulation_drops_only_f32_level_terms():
    """The three dropped cross terms (i + j > 2) of s move it by ~2^-26 of
    sum|q||k|: below f32's own rounding of s."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    qt, kt = _terms(q, 3), _terms(k, 3)
    kept = sum(qt[i] @ kt[j].T for i, j in _pairs(3, 3))
    exact = q.double() @ k.double().T
    bound = 2.0**-24 * (q.double().abs() @ k.double().abs().T)
    assert bool(((kept - exact).abs() <= bound).all())


# ---- the fused last fold and the build key ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_final_fold_on_the_cpu_path(dtype):
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, 24))
                                .astype(np.float32)).to(dtype)
               for n in (10, 13, 13))
    m, l, o = torch.full((10,), -math.inf), torch.zeros(10), torch.zeros(
        (10, 24))
    rf.fold_(q, k, v, m, l, o)
    o_before = o.clone()
    want = rf.fold_reference(q, k, v, m, l, o, final=True)
    pm, pl, _ = rf.fold_reference(q, k, v, m, l, o)
    before = rf.launches
    out = rf.fold_(q, k, v, m, l, o, final=True)
    assert rf.launches == before  # the plain version, no kernel
    assert out.dtype == dtype and torch.equal(out, want)
    assert torch.equal(m, pm) and torch.equal(l, pl)
    assert torch.equal(o, o_before)


def test_ring_fold_build_key_follows_the_shared_header(tmp_path):
    """K3 builds on gemm_sm90.cuh's TMA and mbarrier pieces: an edit to the
    header alone must change libring_fold's key."""
    csrc = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")
    for f in ("ring_fold.cu", "gemm_sm90.cuh"):
        shutil.copy(os.path.join(csrc, f), tmp_path / f)
    sources = _build.cuda_sources("ring_fold", str(tmp_path))
    assert [os.path.basename(p) for p in sources] == ["ring_fold.cu",
                                                      "gemm_sm90.cuh"]
    before = _build.cuda_digest("ring_fold", str(tmp_path))
    assert before == _build.cuda_digest("ring_fold", csrc)
    with open(tmp_path / "gemm_sm90.cuh", "a") as f:
        f.write("// an edit to the header alone\n")
    assert _build.cuda_digest("ring_fold", str(tmp_path)) != before
