"""The fan-out step's loss and update (tbus_torch.kernels.loss_update, the
plain versions of K8a, K8b and K9) against the JAX package's step.

The reference's jitted step (tbus/parallel/collective.py:207) computes
``w - 1e-3 * g`` as one fused multiply-subtract, rounded once; so does the
port's update, held here bit for bit against
``jax.jit(lambda w, g: w - 1e-3 * g)`` and against an exact rounding in
rationals, on seeded inputs and on inputs built so that w - c g in f64
lands exactly halfway between two f32 values (where rounding in f64 and
again in f32 goes wrong). The one-rank step's w1 is bit-equal to the
reference's in at least 99.9% of elements: what still differs comes from
g, whose f32 sums the two take in other orders (within the step tests'
tolerances in tests/test_torch_collectives.py).

Tolerances: the loss, an f32 sum of squares in another order than XLA's,
to rtol 1e-6; its gradient 2 (gbar y) bit for bit (the same two roundings
on both sides).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbus.parallel import collective as jcol
from tbus_torch import entry as tentry
from tbus_torch.kernels import loss_update as lu
from tbus_torch.parallel import collective, distributed

LR = 1e-3
C = np.float32(LR)  # 0x3A83126F
_jax_update = jax.jit(lambda w, g: w - 1e-3 * g)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _rn32(q):
    """The f32 nearest the rational q, ties to even (inf past the top)."""
    with np.errstate(over="ignore"):
        f = np.float32(float(q))
    if not np.isfinite(f):
        return f
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(v.view(np.uint32)) & 1))


def _ulp32(v):
    v = abs(np.float32(v))
    return (Fraction(float(np.nextafter(v, np.float32(np.inf))))
            - Fraction(float(v)))


def _midpoint_inputs(count=12):
    """(w, g) pairs whose w - c g is a hair off, or exactly on, the midpoint
    of two f32 values. g in [1, 2) is picked so that c g lies just past the
    middle of its f32 ulp U: c g mod U = U/2 + x, x an f32 under U / 2^8;
    w = x (exactly a midpoint: ties to even) or x one f32 ulp of x away
    (off it by far less than f64 resolves at |c g|: f64 rounds onto the
    midpoint, and the tie must follow the sign of what f64 dropped)."""
    cm = int(C.view(np.uint32)) & 0x7FFFFF | 0x800000  # c's 24-bit mantissa
    gm = np.arange(1 << 23, 1 << 24, dtype=np.int64)
    p = cm * gm
    sh = np.where(p >= (1 << 47), 24, 23)  # c g's bits below its f32 ulp
    x = (p & ((np.int64(1) << sh) - 1)) - (np.int64(1) << (sh - 1))
    picked = gm[(np.abs(x) < (1 << (sh - 9))) & (x != 0)][:count]
    ws, gs = [], []
    for m in picked:
        for sign in (1, -1):
            g = np.float32(sign * int(m) * 2.0**-23)
            cg = Fraction(float(C)) * Fraction(float(g))
            u = _ulp32(np.float32(float(cg)))
            xf = np.float32(float(cg % u - u / 2))
            for w in (xf, np.nextafter(xf, np.float32(np.inf)),
                      np.nextafter(xf, np.float32(-np.inf))):
                ws.append(w)
                gs.append(g)
    return np.array(ws, np.float32), np.array(gs, np.float32)


def _scaled_inputs(scale):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((256, 256), dtype=np.float32) * np.float32(0.02)
    g = rng.standard_normal((256, 256), dtype=np.float32) * np.float32(scale)
    return w, g


def _update(w, g):
    return lu.sgd_update_reference(torch.from_numpy(w), torch.from_numpy(g),
                                   LR).numpy()


@pytest.mark.parametrize("case", [1, 37, 1e4, "midpoints"], ids=str)
def test_plain_update_equals_the_fused_reference(case):
    w, g = _midpoint_inputs() if case == "midpoints" else _scaled_inputs(case)
    got, want = _update(w, g), np.asarray(_jax_update(w, g))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if case == "midpoints":
        # The inputs do reach the case: rounding in f64, then in f32, goes
        # the wrong way on some of them.
        twice = (torch.from_numpy(w).double()
                 - float(C) * torch.from_numpy(g).double()).float().numpy()
        assert (_bits(twice) != _bits(want)).any()


def test_plain_update_rounds_once():
    """Against w - c g in rationals, rounded once: the midpoint cases, seeded
    values over f32's whole exponent range (their w - c g subnormal, huge,
    or past the largest f32 too), and exact subnormal midpoints (c 2^-117
    = 8589935 x 2^-150)."""
    rng = np.random.default_rng(5)
    mw, mg = _midpoint_inputs(4)
    bits = rng.integers(0, 0x7F7FFFFF, size=(2, 400), dtype=np.uint32)
    signs = rng.integers(0, 2, size=(2, 400), dtype=np.uint32) << 31
    rw, rg = (bits | signs).view(np.float32)
    sub_g = np.float32(2.0**-117)
    sw = np.array([0, 2**-149, -2**-149, 3 * 2**-149], np.float32)
    w = np.concatenate([mw, rw, sw, [np.float32(3.4e38)]])
    g = np.concatenate([mg, rg, np.full(4, sub_g, np.float32),
                        [np.float32(-3.4e38)]])
    got = _update(w, g)
    want = np.array([_rn32(Fraction(float(a)) - Fraction(float(C))
                           * Fraction(float(b))) for a, b in zip(w, g)],
                    np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("hidden,rows", [(16, 4), (256, 64)])
def test_one_rank_step_w1_is_bit_equal_to_the_reference(hidden, rows):
    """At hidden 256 x rows 64 the port's w1 equalled the reference's in
    81.0% of elements while it rounded the update twice."""
    jmesh = jcol.default_mesh(jax.devices()[:1])
    w, x = tentry.make_inputs(1, 1, hidden, rows)
    jl, jw1 = jcol.make_fanout_step(jmesh)(w, x)
    distributed.init_single("cpu")
    try:
        step = collective.make_fanout_step(collective.default_mesh(1, "cpu"))
        loss, w1 = step(torch.from_numpy(w), torch.from_numpy(x))
    finally:
        distributed.shutdown()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    same = float((_bits(w1.numpy()) == _bits(jw1)).mean())
    assert same >= 0.999, same


@pytest.mark.parametrize("shape", [(4, 16), (16, 16), (1000, 37), (64, 256)],
                         ids=str)
def test_sumsq_reference_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    y = rng.standard_normal(shape, dtype=np.float32)
    got = lu.sumsq_reference(torch.from_numpy(y))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jnp.sum(y * y)), rtol=1e-6)


@pytest.mark.parametrize("gbar", [1.0, 0.37])
def test_sumsq_gradient_is_bit_equal_to_jax(gbar):
    rng = np.random.default_rng(3)
    y = rng.standard_normal((64, 48), dtype=np.float32)
    gb = np.float32(gbar)
    loss, vjp = jax.vjp(lambda v: jnp.sum(v * v), y)
    (want,) = vjp(gb)
    ty = torch.from_numpy(y).requires_grad_(True)
    tloss = lu.SumSquares.apply(ty)
    tloss.backward(torch.tensor(gb))
    np.testing.assert_allclose(float(tloss.detach()), float(loss),
                               rtol=1e-6)
    np.testing.assert_array_equal(_bits(ty.grad.numpy()), _bits(want))
    direct = lu.sumsq_grad(torch.from_numpy(y), torch.tensor(gb))
    np.testing.assert_array_equal(_bits(direct.numpy()), _bits(want))


_BF16 = torch.ones(2, 3, dtype=torch.bfloat16)
_F32 = torch.ones(2, 3)


@pytest.mark.parametrize("call,match", [
    (lambda: lu.sumsq(_BF16), "f32"),
    (lambda: lu.sumsq_grad(_BF16, torch.tensor(1.0)), "f32"),
    (lambda: lu.sumsq_grad(_F32, torch.tensor(1.0, dtype=torch.bfloat16)),
     "f32"),
    (lambda: lu.sgd_update(_BF16, _BF16, LR), "f32"),
    (lambda: lu.sgd_update(_F32, torch.ones(3, 2), LR), "differ"),
    (lambda: lu.sumsq_grad(_F32, torch.ones(1)), "0-dim"),
    (lambda: lu.sumsq(torch.ones(2, device="meta")), "unsupported device"),
    (lambda: lu.sgd_update(_F32, torch.ones(2, 3, device="meta"), LR),
     "operands on"),
], ids=["sumsq-bf16", "grad-bf16", "grad-bf16-gbar", "update-bf16",
        "update-shapes", "grad-gbar-shape", "sumsq-meta", "update-devices"])
def test_error_paths_raise(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_empty_tensors():
    before = (lu.sumsq_launches, lu.sumsq_grad_launches,
              lu.sgd_update_launches)
    e = torch.ones(0, 5)
    assert float(lu.sumsq(e)) == 0.0
    assert lu.sumsq_grad(e, torch.tensor(1.0)).shape == (0, 5)
    assert lu.sgd_update(e, e, LR).shape == (0, 5)
    assert (lu.sumsq_launches, lu.sumsq_grad_launches,
            lu.sgd_update_launches) == before


def test_step_routes_its_loss_and_update_through_loss_update(monkeypatch):
    """A one-rank CPU step calls the loss, its gradient and the update of
    tbus_torch.kernels.loss_update once each (their plain versions, the
    CPU's)."""
    calls = []
    for name in ("sumsq_reference", "sumsq_grad_reference",
                 "sgd_update_reference"):
        fn = getattr(lu, name)
        monkeypatch.setattr(lu, name, lambda *a, _fn=fn, _name=name: (
            calls.append(_name), _fn(*a))[1])
    distributed.init_single("cpu")
    try:
        step, (w, x) = tentry.entry("cpu")
        step(w, x)
    finally:
        distributed.shutdown()
    assert sorted(calls) == ["sgd_update_reference", "sumsq_grad_reference",
                             "sumsq_reference"]


def test_scratch_is_kept_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(lu, "_scratch", {})
    monkeypatch.setattr(lu, "_scratch_words", 1057)
    a = lu._scratch_for("cpu", 1)
    b = lu._scratch_for("cpu", 2)
    c = lu._scratch_for("meta", 1)
    assert len({id(a), id(b), id(c)}) == 3
    assert a.device.type == "cpu" and c.device.type == "meta"
    for buf in (a, b, c):  # the counter, then room for 1,056 partials
        assert buf.dtype == torch.int32 and buf.shape == (1057,)
    assert not a.any() and not b.any()
    assert lu._scratch_for("cpu", 1) is a
    assert lu._scratch_for("cpu", 2) is b
    assert len(lu._scratch) == 3


@pytest.mark.parametrize("shape", [(4, 16), (16, 16), (1000, 37), (0, 16)],
                         ids=str)
def test_plain_path_makes_no_scratch_and_no_launch(monkeypatch, shape):
    """A CPU tensor takes the plain version: no scratch, no library, no
    launch counted."""
    monkeypatch.setattr(lu, "_scratch", {})
    monkeypatch.setattr(lu, "_load", lambda: pytest.fail("library loaded"))
    y = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape, dtype=np.float32))
    before = lu.sumsq_launches
    assert torch.equal(lu.sumsq(y), lu.sumsq_reference(y))
    assert lu._scratch == {} and lu.sumsq_launches == before


def test_launch_path_holds_the_library_functions(monkeypatch):
    """_load() keeps the library's entry points, and PyTorch's getters of
    the current device and stream, at module level, so that a launch
    reads them without an import or a signature list."""
    from tbus_torch.kernels import _build

    class Lib:
        tbus_sumsq = object()
        tbus_sumsq_grad = object()
        tbus_sgd_update = object()

        @staticmethod
        def tbus_sumsq_scratch_words():
            return 1057

    def device():
        return 0

    def stream(index):
        return 0

    loads = []
    monkeypatch.setattr(_build, "loss_update_lib",
                        lambda: (loads.append(1), Lib)[1])
    # PyTorch's CUDA getters, which a CPU build lacks.
    monkeypatch.setattr(torch._C, "_cuda_getDevice", device, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", stream,
                        raising=False)
    for name in ("_sumsq", "_sumsq_grad", "_sgd_update", "_device",
                 "_stream"):
        monkeypatch.setattr(lu, name, None)
    monkeypatch.setattr(lu, "_scratch_words", 0)
    lu._load()
    assert loads == [1]
    assert (lu._device, lu._stream) == (device, stream)
    assert (lu._sumsq, lu._sumsq_grad, lu._sgd_update) == (
        Lib.tbus_sumsq, Lib.tbus_sumsq_grad, Lib.tbus_sgd_update)
    assert lu._scratch_words == 1057


@pytest.mark.parametrize("shape", [(4, 16), (16, 16), (1000, 37), (0, 16)],
                         ids=str)
def test_plain_grad_and_update_load_nothing_and_launch_nothing(monkeypatch,
                                                               shape):
    """CPU operands pass K8b's and K9's attribute checks to the plain
    versions: no library, no launch counted, the plain bits."""
    monkeypatch.setattr(lu, "_load", lambda: pytest.fail("library loaded"))
    monkeypatch.setattr(lu, "_sumsq_grad_cuda",
                        lambda *a: pytest.fail("the card's path ran"))
    rng = np.random.default_rng(6)
    y, g = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for _ in range(2))
    gb = torch.tensor(0.37)
    before = (lu.sumsq_grad_launches, lu.sgd_update_launches)
    assert torch.equal(lu.sumsq_grad(y, gb), lu.sumsq_grad_reference(y, gb))
    assert torch.equal(lu.sgd_update(y, g, LR),
                       lu.sgd_update_reference(y, g, LR))
    assert (lu.sumsq_grad_launches, lu.sgd_update_launches) == before


@pytest.mark.parametrize("call", [
    lambda: lu.sumsq_grad(torch.ones(2, device="meta"),
                          torch.tensor(1.0, device="meta")),
    lambda: lu.sgd_update(torch.ones(2, device="meta"),
                          torch.ones(2, device="meta"), LR),
], ids=["grad-meta", "update-meta"])
def test_operands_off_cpu_and_card_are_refused(call):
    """What K8b's and K9's attribute checks refuse off the CPU goes to
    the full checks, which raise."""
    with pytest.raises(ValueError, match="unsupported device"):
        call()
