"""The fan-out step's loss, its gradient and the update (K8a, K8b, K9)
against their plain versions, on the card.

The kernels have no CPU mode, so these tests skip without an NVIDIA card.
This file imports no JAX; run it on the card without tests/conftest.py:

    python -m pytest -m cuda --noconftest tests/test_torch_loss_update_cuda.py

Tolerances. K8a: rtol 1e-5 against torch's sum on the card (f32 sums of
up to 16.7 M terms in another order), and bit-equal between calls on the
same y, on one stream or on two at once (a fixed grid, the partials
summed in index order by whichever block finishes last, no float
atomics). K8b and K9: bit-equal; both
sides round the same products once (K8b gbar * y, then an exact doubling;
K9 one fused multiply-subtract, its plain version an exact f64 emulation).
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

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


# K8b's and K9's grid: a block of 256 threads for each 1,024 floats, one
# wave 8 such blocks on each of 132 SMs.
WAVE = 132 * 8 * 256 * 4  # floats in the first wave of blocks
SIZES = [1, 2, 3, 4, 5, 1023, 1025, 2049, WAVE + 1, WAVE + 4]


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_grad_bit_equal_at_every_edge(card, n):
    """K8b at sizes below one vector, one past a block's floats and one
    past a wave's: the wrapper bit-equal to the plain version, and the
    entry point writing not a float past n."""
    y = _tensor(card, (n,), 15)
    gb = torch.tensor(0.37, device=card)
    want = _bits(lu.sumsq_grad_reference(y, gb))
    assert torch.equal(_bits(lu.sumsq_grad(y, gb)), want)
    dy = torch.full((n + 4,), float("nan"), device=card)
    assert _build.loss_update_lib().tbus_sumsq_grad(
        y.data_ptr(), gb.data_ptr(), dy.data_ptr(), n,
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(_bits(dy[:n]), want) and torch.isnan(dy[n:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_update_bit_equal_at_every_edge(card, n):
    w = _tensor(card, (n,), 16, 0.02)
    g = _tensor(card, (n,), 17, 37.0)
    want = _bits(lu.sgd_update_reference(w, g, 1e-3))
    assert torch.equal(_bits(lu.sgd_update(w, g, 1e-3)), want)
    w1 = torch.full((n + 4,), float("nan"), device=card)
    assert _build.loss_update_lib().tbus_sgd_update(
        w.data_ptr(), g.data_ptr(), w1.data_ptr(), 1e-3, n,
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(_bits(w1[:n]), want) and torch.isnan(w1[n:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
def test_grad_and_update_are_one_kernel_launch_each(card, case):
    y = _tensor(card, case, 19)
    gb = torch.tensor(0.37, device=card)
    for fn, kernel in ((lambda: lu.sumsq_grad(y, gb), "sumsq_grad"),
                       (lambda: lu.sgd_update(y, y, 1e-3), "sgd_update")):
        seen = _kernels(fn, 3, kernel)
        assert len(seen) == 1, seen
        ((name, count),) = seen.items()
        assert kernel in name and count == 3, seen


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
def test_grad_and_update_allocate_only_their_output(card, case):
    y = _tensor(card, case, 20)
    gb = torch.tensor(0.37, device=card)
    for fn in (lambda: lu.sumsq_grad(y, gb), lambda: lu.sgd_update(y, y, 1e-3)):
        fn()
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        out = fn()
        after = torch.cuda.memory_stats()["allocation.all.allocated"]
        assert after - before == 1 and out.shape == y.shape


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
def test_sum_squares_backward_runs_k8b(card, monkeypatch):
    """The backward launches K8b through the trimmed path: sumsq_grad's
    checks do not run (autograd and the forward hold them)."""
    y = _tensor(card, (4, 16), 7).requires_grad_(True)
    before = (lu.sumsq_launches, lu.sumsq_grad_launches)
    loss = lu.SumSquares.apply(y)
    monkeypatch.setattr(lu, "_check_grad",
                        lambda *a: pytest.fail("sumsq_grad's checks ran"))
    monkeypatch.setattr(lu, "sumsq_grad",
                        lambda *a: pytest.fail("sumsq_grad ran"))
    loss.backward()
    torch.cuda.synchronize()
    assert (lu.sumsq_launches, lu.sumsq_grad_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(_bits(y.grad), _bits(2 * y.detach()))


def _kernels(fn, calls, kernel="sumsq_kernel"):
    """Device kernels a profiled run of `calls` fn() calls launched (name
    -> count), after one unprofiled call. The profiler now and then
    misses a run's launches, so a run that saw fewer than `calls` of
    `kernel` is profiled again, up to three runs."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                seen[e.name] = seen.get(e.name, 0) + 1
        if sum(c for k, c in seen.items() if kernel in k) >= calls:
            break
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
def test_sumsq_is_one_kernel_launch(card, case):
    """One kernel a call, at every size: no finishing kernel, no memset."""
    y = _tensor(card, case, 8)
    seen = _kernels(lambda: lu.sumsq(y), 3)
    assert len(seen) == 1, seen
    ((name, count),) = seen.items()
    assert "sumsq_kernel" in name and "finish" not in name
    assert count == 3, seen


# n whose grid spans one block, two, and the most the kernel takes.
GRIDS = {"one": 4096, "two": 8192, "most": 4096 * 4096}


@pytest.mark.cuda
@pytest.mark.parametrize("grid", GRIDS)
def test_sumsq_is_bit_equal_across_calls_at_every_grid(card, grid):
    n = GRIDS[grid]
    blocks = _build.loss_update_lib().tbus_sumsq_blocks(n)
    assert blocks == {"one": 1, "two": 2}.get(grid, 132 * 8)
    y = _tensor(card, (n,), 10)
    got = [lu.sumsq(y) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(got[0]), _bits(t)) for t in got[1:])
    torch.testing.assert_close(got[0], lu.sumsq_reference(y), rtol=1e-5,
                               atol=0)
    buf = lu._scratch_for(y.get_device(),
                          torch.cuda.current_stream().cuda_stream)
    assert buf.numel() == 132 * 8 + 1
    assert int(buf[0]) == 0  # the counter is back at 0


@pytest.mark.cuda
def test_sumsq_on_two_streams_at_once(card):
    """Two streams run K8a at once on different y, each on its own
    scratch; every result equals its y's one-stream result bit for bit."""
    ys = [_tensor(card, (4096, 4096), 11), _tensor(card, (4096, 4096), 12)]
    want = [lu.sumsq(y) for y in ys]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[k].append(lu.sumsq(ys[k]))
    torch.cuda.synchronize()
    assert not torch.equal(_bits(want[0]), _bits(want[1]))
    for k in range(2):
        assert all(torch.equal(_bits(t), _bits(want[k])) for t in got[k])
    bufs = [lu._scratch_for(torch.cuda.current_device(), s.cuda_stream)
            for s in streams]
    assert bufs[0].data_ptr() != bufs[1].data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=str)
def test_sumsq_allocates_only_its_output(card, case):
    y = _tensor(card, case, 13)
    lu.sumsq(y)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = lu.sumsq(y)
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert after - before == 1 and out.shape == ()


@pytest.mark.cuda
def test_each_launch_is_one_ctypes_call(card, monkeypatch):
    y = _tensor(card, (4, 16), 14)
    gb = torch.tensor(0.37, device=card)
    lu.sumsq(y), lu.sumsq_grad(y, gb), lu.sgd_update(y, y, 1e-3)  # warm-up
    calls = []
    for name in ("_sumsq", "_sumsq_grad", "_sgd_update"):
        fn = getattr(lu, name)
        monkeypatch.setattr(lu, name, lambda *a, _fn=fn, _name=name: (
            calls.append(_name), _fn(*a))[1])
    lu.sumsq(y), lu.sumsq_grad(y, gb), lu.sgd_update(y, y, 1e-3)
    torch.cuda.synchronize()
    assert calls == ["_sumsq", "_sumsq_grad", "_sgd_update"]


@pytest.mark.cuda
def test_installed_torch_has_the_getters_the_launch_path_holds(card):
    """_load() holds torch._C's private getters of the current device and
    of a device's current stream; a torch that renamed them fails here."""
    index = torch.cuda.current_device()
    assert torch._C._cuda_getDevice() == index
    assert (torch._C._cuda_getCurrentRawStream(index)
            == torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
def test_launches_go_to_the_current_stream(card):
    lu.sumsq_grad(torch.ones(4, device=card), torch.tensor(1.0, device=card))
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        assert lu._stream(torch.cuda.current_device()) == s.cuda_stream
    assert (lu._stream(torch.cuda.current_device())
            == torch.cuda.current_stream().cuda_stream)
