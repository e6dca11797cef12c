"""The port's entry points (tbus_torch.entry), twins of __graft_entry__.py.

entry(device="cpu") gives the reference's shapes and a step that runs in
this process; dryrun_multichip(8, device="cpu") runs 8 gloo ranks (one
launch) through the fan-out step and ring attention, then the live
lowered fan-out in a child process. Its loss equals the reference's step
on the conftest's 8 virtual devices, to rtol 1e-6 (f32 sums in another
order). device="cuda" without a card raises: the port goes to the CPU
only when asked.
"""

import numpy as np
import pytest
import torch

from tbus.parallel import collective as jcol
from tbus_torch import entry as tentry
from tbus_torch.parallel import distributed


def test_entry_on_cpu_has_the_reference_shapes():
    distributed.init_single("cpu")
    try:
        step, (w, x) = tentry.entry("cpu")
        assert w.shape == (16, 16) and x.shape == (4, 16)  # dp = tp = 1
        assert w.dtype == x.dtype == torch.float32
        assert w.device.type == x.device.type == "cpu"
        loss, w1 = step(w, x)
        assert loss.shape == () and bool(torch.isfinite(loss))
        assert w1.shape == w.shape and not torch.equal(w1, w)
    finally:
        distributed.shutdown()


def test_dryrun_multichip_on_eight_gloo_ranks():
    # A generous limit: the RPC leg's child builds libtbus.so if no test
    # has built it yet.
    results = tentry.dryrun_multichip(8, device="cpu", rpc=True,
                                      timeout_s=600.0)
    assert [r["rank"] for r in results] == list(range(8))
    step = jcol.make_fanout_step(jcol.default_mesh())
    want = float(step(*tentry.make_inputs(4, 2))[0])
    for r in results:
        assert r["w1_shape"] == [16, 16]  # a tp shard of w [16, 32]
        assert r["attn_shape"] == [8, 16]
        assert r["ring_rotations"] == 7
        np.testing.assert_allclose(r["loss"], want, rtol=1e-6)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    with pytest.raises(RuntimeError):
        tentry.entry("cuda")
    with pytest.raises(RuntimeError):
        tentry.dryrun_multichip(8, device="cuda")
    with pytest.raises(RuntimeError):
        distributed.init_store(0, 1, "unused", "nccl")
    with pytest.raises(RuntimeError):
        distributed.init("unused:0", 1, 0)


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        tentry.entry("tpu")
    with pytest.raises(ValueError):
        distributed.launch_local("result = 0", 1, backend="mpi")
