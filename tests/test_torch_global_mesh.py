"""The port's multi-host bring-up (tbus_torch.parallel.distributed: init by
coordinator, global_mesh) against the reference's rules and its step.

Two 8-rank gloo jobs (tbus_torch.parallel.distributed.launch_local), each
child with a deadline:
- one host (every rank on this host): the twin of
  tests/test_collectives.py's test_distributed_global_mesh_single_host;
  the outer axis is 1 and gather_merge over the inner axis returns its
  input;
- two simulated hosts of 4 ranks, interleaved (rank r on host r % 2), the
  ranks re-joined through init(coordinator, 8, rank): the twin of
  tests/test_distributed.py's test_two_process_dcn_collective (every
  inner row on one host, the all-reduce total 12.0, the gather
  [[1.0] * 4, [2.0] * 4]); a plain-order mesh would put both hosts in
  each row, so the layout checks hold the grouping by host. The same job
  runs the fan-out step over global_mesh(("dp", "tp")) (dp 2 x tp 4),
  held against tbus.parallel.collective.make_fanout_step on the
  conftest's 8 CPU devices reshaped (2, 4), inputs from entry.make_inputs
  (numpy seed 0): loss to rtol 1e-6 (f32 sums in another order), w1 to
  atol 1e-8 (tests/test_torch_collectives.py's tolerances).

The ValueError cases and the one-process form run in this process.
"""

import socket

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tbus.parallel import collective as jcol
from tbus_torch import entry as tentry
from tbus_torch.parallel import collective, distributed

WORLD = 8
HOSTS = ["h0", "h1"] * (WORLD // 2)  # rank r on host r % 2

_SINGLE_HOST = """
import numpy as np
from tbus_torch.parallel import collective as C
mesh = distributed.global_mesh(("dcn", "ici"))
x = np.arange(float(world * 2), dtype=np.float32).reshape(world, 2)
i = mesh.get_local_rank("ici")
out = C.gather_merge(torch.from_numpy(x[i:i + 1].copy()),
                     mesh.get_group("ici"))
flat = distributed.global_mesh(("sp",))
result = {"shape": list(mesh.mesh.shape), "gathered": out.tolist(),
          "x": x.tolist(), "flat": list(flat.mesh.shape)}
"""

_TWO_HOSTS = """
from tbus_torch import entry
from tbus_torch.parallel import collective as C, params
distributed.shutdown()
distributed.init({coordinator!r}, world, rank, backend="gloo")
mesh = distributed.global_mesh(("dcn", "ici"))
x = torch.full((1, 1), float(int(distributed.host_key()[1:]) + 1))
total = C.replicated_fanout_merge(
    C.replicated_fanout_merge(x, mesh.get_group("ici")),
    mesh.get_group("dcn"))
row = C.gather_merge(x, mesh.get_group("ici")).T.contiguous()
matrix = C.gather_merge(row, mesh.get_group("dcn"))
step_mesh = distributed.global_mesh(("dp", "tp"))
step, (w, xs) = entry._make(step_mesh)
loss, w1 = step(w, xs)
result = {{"shape": list(mesh.mesh.shape), "layout": mesh.mesh.tolist(),
          "coords": [mesh.get_local_rank("dcn"), mesh.get_local_rank("ici")],
          "total": float(total), "gathered": matrix.tolist(),
          "loss": float(loss),
          "w1": params.gather_to_numpy(w1, step_mesh).tolist()}}
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# A launch whose ports another process of the host took or dialled tries
# afresh: the coordinator's port is picked by bind-then-close, and gloo's
# ranks listen on ephemeral ports, which a client elsewhere on the host
# (one redialling a server that went away) can reach and then close.
_PORT_RACES = ("address already in use", "connection closed by peer")


def _launch(make_body, host_keys=None):
    for attempt in range(3):
        try:
            return distributed.launch_local(make_body(), WORLD, "gloo", 120.0,
                                            host_keys=host_keys)
        except RuntimeError as e:
            if (not any(r in str(e).lower() for r in _PORT_RACES)
                    or attempt == 2):
                raise


@pytest.fixture(scope="module")
def single_host():
    return _launch(lambda: _SINGLE_HOST)


@pytest.fixture(scope="module")
def two_hosts():
    return _launch(lambda: _TWO_HOSTS.format(
        coordinator=f"127.0.0.1:{_free_port()}"), host_keys=HOSTS)


@pytest.fixture(scope="module")
def jax_step():
    devs = np.array(jax.devices()).reshape(2, 4)
    w, x = tentry.make_inputs(2, 4)
    loss, w1 = jcol.make_fanout_step(Mesh(devs, ("dp", "tp")))(w, x)
    return float(loss), np.asarray(w1)


def test_single_host_outer_axis_is_one(single_host):
    for r in single_host:
        assert r["shape"] == [1, WORLD]
        assert r["flat"] == [WORLD]


def test_single_host_gather_merge_returns_its_input(single_host):
    for r in single_host:
        np.testing.assert_array_equal(r["gathered"], r["x"])


def test_two_hosts_inner_rows_are_host_contiguous(two_hosts):
    layout = two_hosts[0]["layout"]
    assert two_hosts[0]["shape"] == [2, WORLD // 2]
    assert [[HOSTS[r] for r in row] for row in layout] == [["h0"] * 4,
                                                           ["h1"] * 4]
    for rank, r in enumerate(two_hosts):
        assert r["layout"] == layout  # every rank sees one layout
        d, i = r["coords"]
        assert layout[d][i] == rank


def test_two_hosts_all_reduce_total(two_hosts):
    # 4 ranks x 1.0 (h0) + 4 ranks x 2.0 (h1): needs the other host's.
    assert [r["total"] for r in two_hosts] == [12.0] * WORLD


def test_two_hosts_gather(two_hosts):
    for r in two_hosts:
        assert r["gathered"] == [[1.0] * 4, [2.0] * 4]


def test_fanout_step_on_global_mesh_matches_jax_loss(two_hosts, jax_step):
    for r in two_hosts:
        np.testing.assert_allclose(r["loss"], jax_step[0], rtol=1e-6)


def test_fanout_step_on_global_mesh_matches_jax_w1(two_hosts, jax_step):
    for r in two_hosts:
        w1 = np.asarray(r["w1"], dtype=np.float32)
        assert w1.shape == jax_step[1].shape == (16, 64)
        np.testing.assert_allclose(w1, jax_step[1], rtol=0, atol=1e-8)


@pytest.fixture
def one_rank():
    distributed.init("unused:0", num_processes=1, process_id=0,
                     backend="gloo")
    try:
        yield
    finally:
        distributed.shutdown()


@pytest.mark.parametrize("names,sizes", [
    (("a", "b", "c"), None),  # more than two axes need sizes
    (("dp", "tp"), (2, 2)),  # 4 != 1 rank
    (("sp",), (2,)),
])
def test_global_mesh_value_errors(one_rank, names, sizes):
    with pytest.raises(ValueError):
        distributed.global_mesh(names, sizes)


def test_one_process_init_forms_a_one_rank_group(one_rank):
    assert torch.distributed.get_world_size() == 1
    mesh = distributed.global_mesh(("dp", "tp"))
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("dp", "tp")
    three = distributed.global_mesh(("a", "b", "c"), (1, 1, 1))
    assert tuple(three.mesh.shape) == (1, 1, 1)


def test_one_rank_step_equals_default_mesh_bit_for_bit(one_rank):
    """The CPU form of chip_smoke.py's path 5b: on one rank, global_mesh's
    (1, 1) step and default_mesh(1)'s are the same step."""
    got = tentry._make(distributed.global_mesh(("dp", "tp")), 32, 8)
    want = tentry._make(collective.default_mesh(1, "cpu"), 32, 8)
    (gl, gw1), (wl, ww1) = (step(*args) for step, args in (got, want))
    assert torch.equal(gl, wl) and torch.equal(gw1, ww1)


def test_launch_local_checks_host_keys():
    with pytest.raises(ValueError):
        distributed.launch_local("result = 0", 2, host_keys=["h0"])
