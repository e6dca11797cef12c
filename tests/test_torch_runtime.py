"""The port's fan-out runtime against tbus.parallel.runtime.

broadcast_gather / broadcast_gather_batch run on the port's host kind
(the CPU, through the kernel's plain version) and on the JAX package's
host mesh of 8 virtual CPU devices, with the same numpy-seeded payloads.
The tolerance is exact bytes. Every registration uses a service name no
other test uses: the JAX runtime mirrors registrations into the C++
core's process-global lowering table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbus.parallel import runtime as jrt
from tbus_torch.parallel import runtime as trt

SVC = "TorchParity"
_LENGTHS = [0, 1, 123, 124, 4096, 1 << 20]
_PEERS = [1, 3, 8, 13]

# One custom device fn on both sides: 3*x + peer_index (mod 256).
_PAIRS = {
    "echo": ("echo", "echo"),
    "xor255": ("xor255", "xor255"),
    "add_peer_index": ("add_peer_index", "add_peer_index"),
    "custom": (lambda shard, idx: shard * jnp.uint8(3) + idx.astype(jnp.uint8),
               lambda rows, idx: rows * 3 + idx.to(torch.uint8)[:, None]),
}


@pytest.fixture(autouse=True)
def _no_mesh_env(monkeypatch):
    monkeypatch.delenv("TBUS_FANOUT_MESH", raising=False)


def _register(kind):
    """Registers `kind` on both sides under method kind; returns it."""
    jfn, tfn = _PAIRS[kind]
    impl = f"{kind}/v1"
    if isinstance(jfn, str):
        jrt.register_builtin(SVC, kind, jfn, impl)
        trt.register_builtin(SVC, kind, tfn, impl)
    else:
        jrt.register_device_method(SVC, kind, jfn, impl)
        trt.register_device_method(SVC, kind, tfn, impl)
    return kind


def _payloads(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in lengths]


@pytest.mark.parametrize("kind", list(_PAIRS))
def test_broadcast_gather_matches_jax(kind):
    method = _register(kind)
    for n_peers in _PEERS:
        for payload in _payloads(n_peers, _LENGTHS):
            want = jrt.broadcast_gather(SVC, method, payload, n_peers, 0)
            got = trt.broadcast_gather(SVC, method, payload, n_peers, 0,
                                       mesh="host")
            assert len(got) == n_peers
            assert got == want, (n_peers, len(payload))


@pytest.mark.parametrize("kind", list(_PAIRS))
def test_broadcast_gather_batch_matches_jax(kind):
    method = _register(kind)
    for bsz in (1, 3, 8):
        for n_peers in (1, 8, 13):
            # Mixed lengths in one batch: the longest sets the row class,
            # the batch pads to a power of two with zero-length rows.
            lengths = [_LENGTHS[(bsz + n_peers + b) % 5] for b in range(bsz)]
            payloads = _payloads(bsz * 100 + n_peers, lengths)
            want = jrt.broadcast_gather_batch(SVC, method, payloads,
                                              n_peers, 0)
            got = trt.broadcast_gather_batch(SVC, method, payloads,
                                             n_peers, 0, mesh="host")
            assert got == want, (bsz, n_peers)
    # A fused batch of 1 MiB calls, as the executor forms it.
    payloads = _payloads(99, [1 << 20] * 3)
    assert (trt.broadcast_gather_batch(SVC, method, payloads, 8, 0,
                                       mesh="host") ==
            jrt.broadcast_gather_batch(SVC, method, payloads, 8, 0))


def test_counters_move_alike():
    method = _register("xor255")
    j0 = (jrt.lowered_calls, jrt.batch_launches)
    t0 = (trt.lowered_calls, trt.batch_launches)
    for sizes in ([10], [10, 20, 30], [5] * 8):
        jrt.broadcast_gather_batch(SVC, method, _payloads(1, sizes), 3, 0)
        trt.broadcast_gather_batch(SVC, method, _payloads(1, sizes), 3, 0,
                                   mesh="host")
    jrt.broadcast_gather(SVC, method, b"one", 3, 0)
    trt.broadcast_gather(SVC, method, b"one", 3, 0, mesh="host")
    j1 = (jrt.lowered_calls, jrt.batch_launches)
    t1 = (trt.lowered_calls, trt.batch_launches)
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    assert t1[0] - t0[0] == 13 and t1[1] - t0[1] == 3


def test_errors_match_jax():
    def both(fn_j, fn_t, exc):
        with pytest.raises(exc):
            fn_j()
        with pytest.raises(exc):
            fn_t()

    both(lambda: jrt.register_builtin(SVC, "x", "nope", "v1"),
         lambda: trt.register_builtin(SVC, "x", "nope", "v1"), KeyError)
    both(lambda: jrt.register_device_method(SVC, "x", lambda s, i: s),
         lambda: trt.register_device_method(SVC, "x", lambda r, i: r),
         ValueError)
    both(lambda: jrt.broadcast_gather(SVC, "Unregistered", b"x", 2, 0),
         lambda: trt.broadcast_gather(SVC, "Unregistered", b"x", 2, 0,
                                      mesh="host"), KeyError)
    method = _register("echo")
    both(lambda: jrt.broadcast_gather_batch(SVC, method, [], 2, 0),
         lambda: trt.broadcast_gather_batch(SVC, method, [], 2, 0,
                                            mesh="host"), ValueError)
    # The identity takes the well-known default impl id on both sides.
    jrt.register_device_method(SVC, "DefaultId", None)
    trt.register_device_method(SVC, "DefaultId", None)
    assert (trt.device_impl_id(SVC, "DefaultId") ==
            jrt.device_impl_id(SVC, "DefaultId") == "echo/v1")
    assert trt.device_impl_id(SVC, "Unregistered") == ""


def test_mesh_kind_device_unless_host_is_asked(monkeypatch):
    assert trt.mesh_kind(True) == "device"
    assert trt.mesh_kind(False) == "device"
    monkeypatch.setenv("TBUS_FANOUT_MESH", "host")
    assert trt.mesh_kind(True) == "host"
    assert trt.mesh_kind(True, mesh="device") == "device"
    monkeypatch.setenv("TBUS_FANOUT_MESH", "bogus")
    with pytest.raises(ValueError):
        trt.mesh_kind(True)


def test_positions_follow_host_mesh_layout():
    # The JAX host mesh has 8 CPU devices here (tests/conftest.py).
    assert len(trt.positions("host", 13)) == len(jrt.mesh("host", 13).devices)
    assert len(trt.positions("host", 3)) == len(jrt.mesh("host", 3).devices)
    with pytest.raises(ValueError):
        trt.positions("host", 0)


def test_device_call_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device kind runs there")
    method = _register("echo")
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.broadcast_gather(SVC, method, b"x", 2, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.broadcast_gather_batch(SVC, method, [b"x", b"y"], 2, 0,
                                   mesh="device")
