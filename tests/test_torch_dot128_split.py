"""K5's arithmetic on the CPU: dot128 as an exact bf16 split product,
against the JAX package's dot128.

K5 (tbus_torch/csrc/device_programs.cu dot128_kernel) computes the device
method dot128, x f32[k, 128] . W at precision HIGHEST, on the tensor
cores, in four warpgroups over 32 of x's columns each: each row's 32
values scaled by an exact power of two, split exactly into three bf16
terms by truncation, each term's product with W in bf16 exact in f32 and
summed in its own f32 accumulator, the three added smallest first; the
four sums, scale undone, added in f32. The kernel runs only on the card; here:

- W's values are exact in bf16;
- ``dot128_split_reference``, the plain restatement of that arithmetic,
  against the jnp restatement of build_mlir's dot128
  (cpp/tpu/pjrt_runtime.cc:207, as tests/test_torch_device_programs.py
  states it) within that file's tolerance, 1e-6 * (|x| @ |W|), at k in
  {1, 7, 64, 2048}, on normal payloads and on payloads with NaN and +-inf
  among finite values below 2^100 (NaN and inf where the plain version
  and JAX have them);
- rows made only of f32 subnormals. XLA on the CPU flushes f32
  subnormals to zero, as a TPU does, so the JAX package answers 0 there;
  the port's plain version keeps them (IEEE), and the split reference is
  held to it and to the exact product;
- the tensor cores' f32 additions, which truncate: an emulation that
  rounds toward zero after each k-step of each term's accumulator stays
  within the card's tolerance 2 * 128 * 2^-24 * (|x| @ |W|);
- the weight scratch's layout: its plain version read back the way wgmma
  reads shared memory (the 128-byte swizzle) gives W^T in the kernel's k
  order, and the product over that order is x . W.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tbus_torch.kernels import device_programs as dp

DOT_K = [1, 7, 64, 2048]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tbus_torch", "csrc", "device_programs.cu")


def _weight_f32(n=128):
    i = lax.broadcasted_iota(jnp.float32, (n, n), 0)
    j = lax.broadcasted_iota(jnp.float32, (n, n), 1)
    return (lax.rem(i * 3.0 + j * 5.0, 11.0) - 5.0) * 0.125


def jnp_dot128(x):
    """pjrt_runtime.cc:207-244: x f32[k,128] . W at precision HIGHEST."""
    return np.asarray(lax.dot_general(jnp.asarray(x), _weight_f32(),
                                      (((1,), (0,)), ((), ())),
                                      precision=lax.Precision.HIGHEST))


def _mag(x):
    """|x| @ |W| in f64."""
    w = np.abs(np.asarray(_weight_f32(), dtype=np.float64))
    return np.abs(x.astype(np.float64)) @ w


def _dot_tol(x):
    return 1e-6 * _mag(x)


def _card_tol(x):
    return 2 * 128 * 2.0**-24 * _mag(x)


def _exact(x):
    return x.astype(np.float64) @ np.asarray(_weight_f32(), dtype=np.float64)


def _split(x):
    return dp.dot128_split_reference(torch.from_numpy(x)).numpy()


def _trunc_split_sum(a):
    return sum(t.double() for t in dp.split3_trunc_reference(a))


@pytest.mark.parametrize("scale_exp", [-100, -60, -20, 0, 20, 60, 100])
def test_truncating_split_is_exact(scale_exp):
    """K5's split (split3_trunc): hi + mid + lo == a wherever lo stays a
    normal f32, |a| >= 2^-103; each term exact in bf16 (no rounding in
    the conversion); |mid| < 2^-7 |hi| and |lo| < 2^-7 |mid|."""
    rng = np.random.default_rng(scale_exp + 300)
    a = rng.standard_normal(20000) * 2.0 ** rng.uniform(-20, 20, 20000)
    a = torch.from_numpy((a * 2.0**scale_exp).astype(np.float32))
    hi, mid, lo = dp.split3_trunc_reference(a)
    big = a.abs() >= 2.0**-103
    assert int(big.sum()) > 10000
    err = (_trunc_split_sum(a) - a.double()).abs()
    assert float(err[big].max()) == 0.0
    nz = hi != 0
    assert bool((mid.double().abs()[nz] < hi.double().abs()[nz] * 2.0**-7)
                .all())
    assert bool((lo.double().abs() <= mid.double().abs() * 2.0**-7).all())


def test_truncating_split_special_values():
    f32 = np.finfo(np.float32)
    a = torch.tensor([0.0, -0.0, float(f32.max), -float(f32.max),
                      float(f32.tiny), 1.0 + 2.0**-23, float("inf"),
                      float("-inf"), float("nan")], dtype=torch.float32)
    hi, mid, lo = (t.double() for t in dp.split3_trunc_reference(a))
    assert torch.equal((hi + mid + lo)[:6], a.double()[:6])
    assert hi[6] == float("inf") and hi[7] == float("-inf")
    assert bool(torch.isnan(hi[8]))
    assert not bool(mid[6:].any()) and not bool(lo[6:].any())
    # A NaN whose payload sits only in the low 16 bits stays NaN.
    low_nan = torch.tensor([0x7F800001], dtype=torch.int32).view(
        torch.float32)
    assert bool(torch.isnan(dp.split3_trunc_reference(low_nan)[0]).all())


def test_dot128_weight_is_exact_in_bf16():
    w = dp.dot128_weight()
    assert torch.equal(w.bfloat16().float(), w)
    assert sorted(set(w.reshape(-1).tolist())) == [v / 8 for v in
                                                   range(-5, 6)]


@pytest.mark.parametrize("k", DOT_K)
def test_split_reference_against_jax(k):
    rng = np.random.default_rng(700 + k)
    x = rng.standard_normal((k, 128), dtype=np.float32)
    got = _split(x)
    assert (np.abs(got - jnp_dot128(x)) <= _dot_tol(x)).all()
    plain = dp.dot128_reference(torch.from_numpy(x)).numpy()
    assert (np.abs(got - plain) <= _dot_tol(x)).all()


@pytest.mark.parametrize("k", DOT_K)
def test_split_reference_nonfinite_positions(k):
    x = dp.dot128_payload("nonfinite", k, 900 + k)
    with np.errstate(invalid="ignore"):  # inf - inf, inf * 0
        got = _split(x)
        plain = dp.dot128_reference(torch.from_numpy(x)).numpy()
        ref = jnp_dot128(x)
        for other in (plain, ref):
            assert np.array_equal(np.isnan(got), np.isnan(other))
            assert np.array_equal(np.isposinf(got), np.isposinf(other))
            assert np.array_equal(np.isneginf(got), np.isneginf(other))
        fin = np.isfinite(got)
        assert (~fin).any() and (fin.any() or k == 1)
        assert (np.abs(got - ref)[fin] <= _dot_tol(x)[fin]).all()


def test_split_reference_on_subnormal_rows():
    x = dp.dot128_payload("subnormal", 64, 31)
    assert (np.abs(x) < np.finfo(np.float32).tiny).all()
    got = _split(x)
    plain = dp.dot128_reference(torch.from_numpy(x)).numpy()
    assert (np.abs(got - plain) <= _card_tol(x)).all()
    # f32 sums of exact products, the scale undone with one rounding in
    # each warpgroup's sum.
    rounding = dp.DOT128_GROUPS * 2.0**-150
    assert (np.abs(got - _exact(x)) <= _card_tol(x) / 2 + rounding).all()
    assert np.count_nonzero(got) > got.size // 2
    # The JAX package's dot128 flushes them (XLA's CPU backend, like a
    # TPU, treats f32 subnormals as zero); the port keeps them.
    assert not np.any(jnp_dot128(x))


def test_split_reference_rows_of_mixed_scale():
    """Rows whose largest value is deep in the subnormals, tiny, normal or
    large, side by side: each row's scale is exact and undone once in each
    warpgroup's sum (at most 2^-150 each where that sum is subnormal), so
    every row is as close to the exact product as a normal one. The plain
    f32 product rounds each product of a deep-subnormal row (x ~ 2^-140)
    to 2^-149, which its relative tolerance does not cover; it is held to
    the other rows."""
    rng = np.random.default_rng(47)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    for r, e in enumerate((-140, -126, -100, 0, 60, 99)):
        x[r] = (x[r].astype(np.float64) * 2.0**e).astype(np.float32)
    got = _split(x)
    rounding = dp.DOT128_GROUPS * 2.0**-150
    assert (np.abs(got - _exact(x)) <= _card_tol(x) / 2 + rounding).all()
    plain = dp.dot128_reference(torch.from_numpy(x)).numpy()
    assert (np.abs(got - plain) <= _card_tol(x))[1:].all()


def _round_toward_zero_f32(v):
    """f64 values rounded to f32 toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


@pytest.mark.parametrize("k", [64, 2048])
def test_truncating_accumulation_fits_the_card_tolerance(k):
    """Each warpgroup's tensor core sums a k-step's 16 exact products with
    the accumulator and truncates: 2 such steps in each of the three
    terms' accumulators of each of the 4 warpgroups, the terms then added
    in f32 (lo + mid, then hi), the warpgroups' sums too, stay within
    2 * 128 * 2^-24 * (|x| @ |W|) of the plain product."""
    rng = np.random.default_rng(5 + k)
    x = (rng.standard_normal((k, 128))
         * 2.0 ** rng.uniform(-8, 8, (k, 128))).astype(np.float32)
    order = dp.dot128_phys(torch.arange(128)).numpy()
    w = np.asarray(_weight_f32(), dtype=np.float64)
    steps = 8 // dp.DOT128_GROUPS
    y = np.zeros((k, 128), dtype=np.float32)
    for g in range(dp.DOT128_GROUPS):
        cols = slice(128 // dp.DOT128_GROUPS * g,
                     128 // dp.DOT128_GROUPS * (g + 1))
        s = dp.dot128_row_scale(torch.from_numpy(x[:, cols])).numpy()
        xs = torch.from_numpy(x * 2.0**s.astype(np.float64)).float()
        terms = [t.double().numpy() for t in dp.split3_trunc_reference(xs)]
        accs = []
        for term in terms[::-1]:  # lo, mid, hi: one accumulator each
            acc = np.zeros((k, 128), dtype=np.float32)
            for ks in range(g * steps, (g + 1) * steps):
                idx = order[16 * ks:16 * ks + 16]
                step = term[:, idx] @ w[idx]  # 16 exact products, in f64
                acc = _round_toward_zero_f32(acc.astype(np.float64) + step)
            accs.append(acc)
        acc = (accs[0] + accs[1]) + accs[2]
        y = y + (acc.astype(np.float64) * 2.0**-s).astype(np.float32)
    plain = dp.dot128_reference(torch.from_numpy(x)).numpy()
    err = np.abs(y.astype(np.float64) - plain)
    tol = _card_tol(x)
    assert (err <= tol).all()
    # Truncation costs at most ~2 * 2^-23 relative in an accumulator, the
    # adds a few 2^-24: far inside the tolerance.
    assert float((err / tol).max()) < 0.25


def test_restatement_follows_the_kernels_constants():
    """dot128_split_reference and dot128_weight_image restate the kernel's
    warpgroups and slices: their constants are the header's."""
    with open(CSRC) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kDotGroups") == dp.DOT128_GROUPS
    assert const("kDotSliceCols") == 32 and const("kDotRowTile") == 64
    assert dp.dot128_weight_image().numel() * 2 == 4 * 2 * 32 * 128


def _swizzle(addr):
    """The 128-byte swizzle wgmma and the TMA apply to a shared-memory
    byte address (1024-aligned base): bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def test_weight_image_is_what_wgmma_reads():
    """K5's B operand for slice ns and k-step ks is read from the slice's
    8 KiB at descriptor start (ks // 4) * 4096 + 32 * (ks % 4), row n at
    + 128 n (8-row groups 1024 bytes apart), slot kk at + 2 kk, through
    the swizzle. Read so, the image is W^T in the kernel's k order, and
    x's columns in that order times it give x . W exactly."""
    img = dp.dot128_weight_image().view(torch.int16).numpy()
    w = np.asarray(_weight_f32(), dtype=np.float32)
    order = dp.dot128_phys(torch.arange(128)).numpy()
    assert sorted(order.tolist()) == list(range(128))
    bt = np.zeros((128, 128), dtype=np.float32)  # bt[j, slot]
    for ns in range(4):
        base = ns * 8192
        for ks in range(8):
            start = (ks // 4) * 4096 + 32 * (ks % 4)
            for n in range(32):
                for kk in range(16):
                    byte = base + _swizzle(start + 128 * n + 2 * kk)
                    bits = np.int32(img[byte // 2]) << 16
                    bt[32 * ns + n, 16 * ks + kk] = bits.view(np.float32)
    assert np.array_equal(bt, w[order].T)
    rng = np.random.default_rng(3)
    x = rng.integers(-64, 64, (16, 128)).astype(np.float64)
    assert np.array_equal(x[:, order] @ bt.T.astype(np.float64),
                          x @ w.astype(np.float64))
