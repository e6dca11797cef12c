"""The port's collective fan-out lowering against the JAX package's.

One 8-rank gloo job (dp 4 x tp 2, the mesh tests/conftest.py gives JAX)
runs every case of the port; the JAX side runs here, in the test process,
on the conftest's 8 virtual CPU devices. Both sides take the same
numpy-seeded inputs, and each rank's output is held against its block of
JAX's global output. Twins of tests/test_collectives.py:24-117 plus the
fan-out step's numbers (loss and w1) and ring attention.

Tolerances: the collectives move f32 values without arithmetic, or sum 2
to 4 of them, so they hold to 1e-6 relative. The step: loss to rtol
1e-6 (f32 sums in another order) and w1 to atol 1e-8 (a few f32 ulps at
|w| ~ 0.02; a bf16 rounding of dW in the wrong place, or a gradient
scaled by a mesh size, misses by 1e-5 or more). Ring attention: 2e-5 as
in test_collectives.py:97 for f32 inputs; for bf16 inputs both sides
accumulate in f32 and round once at the end, so they agree within one
bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from tbus.parallel import collective as jcol
from tbus_torch import entry as tentry
from tbus_torch.parallel import distributed

WORLD = 8
LOCAL, HEAD = 16, 32  # ring attention: rows per rank, head dim


# Source shared by both sides: run here and prepended to the ranks' body,
# so the children import no JAX.
_INPUTS = """
def _inputs(dp):
    import numpy as np
    rng = np.random.default_rng(5)
    f = np.float32
    return {
        "psum": rng.standard_normal((dp, %(world)d // dp)).astype(f),
        "gather": rng.standard_normal((%(world)d, 2)).astype(f),
        "a2a": rng.standard_normal((dp * dp, 2)).astype(f),
        "rs": rng.standard_normal((dp * dp, 3)).astype(f),
        "ring": rng.standard_normal((dp, 1)).astype(f),
        "qkv": rng.standard_normal((3, %(world)d * %(local)d,
                                    %(head)d)).astype(f),
    }
""" % {"world": WORLD, "local": LOCAL, "head": HEAD}
exec(_INPUTS)


# Each rank of the gloo job: every case, outputs as nested lists.
_BODY = """
import numpy as np
import torch
from tbus_torch import entry
from tbus_torch.parallel import collective as C, params
from torch.distributed.device_mesh import init_device_mesh

mesh = C.default_mesh(world, "cpu")
dp_g, tp_g = mesh.get_group("dp"), mesh.get_group("tp")
dp, tp = mesh["dp"].size(), mesh["tp"].size()
d, t = mesh.get_local_rank("dp"), mesh.get_local_rank("tp")
a = {k: torch.from_numpy(v) for k, v in _inputs(dp).items()}
rows = lambda g, i, n: g[i * n:(i + 1) * n]
res = {"coords": [d, t], "shape": [dp, tp]}
x = a["psum"][d:d + 1, t:t + 1].clone()
res["psum"] = C.replicated_fanout_merge(x, dp_g).tolist()
res["psum_input_kept"] = torch.equal(x, a["psum"][d:d + 1, t:t + 1])
res["gather"] = C.gather_merge(rows(a["gather"], d, 2), dp_g).tolist()
x = rows(a["a2a"], d, dp)
once = C.partition_scatter_gather(x, dp_g)
res["a2a"] = once.tolist()
res["a2a_twice"] = C.partition_scatter_gather(once, dp_g).tolist()
res["rs"] = C.reduce_scatter_merge(rows(a["rs"], d, dp), dp_g).tolist()
res["ring"] = C.ring_cascade(rows(a["ring"], d, 1), dp_g).tolist()
res["ring_back"] = C.ring_cascade(rows(a["ring"], d, 1), dp_g, -1).tolist()

step, (w, xs) = entry._make(mesh)
l0, w1 = step(w, xs)
l1, w2 = step(w1, xs)
res["loss"] = [float(l0), float(l1)]
res["w1"] = params.gather_to_numpy(w1, mesh).tolist()
res["w2"] = params.gather_to_numpy(w2, mesh).tolist()

ring = init_device_mesh("cpu", (world,), mesh_dim_names=("sp",))
attn = C.make_ring_attention(ring, "sp")
n = {local}
q, k, v = (rows(a["qkv"][i], rank, n) for i in range(3))
before = C.ring_rotations
res["attn"] = attn(q, k, v).tolist()
res["rotations"] = C.ring_rotations - before
res["attn_bf16"] = attn(q.bfloat16(), k.bfloat16(),
                        v.bfloat16()).float().tolist()
result = res
""".replace("{local}", str(LOCAL))


@pytest.fixture(scope="module")
def port():
    return [{k: (np.asarray(v, dtype=np.float32)
                 if isinstance(v, list) else v) for k, v in r.items()}
            for r in distributed.launch_local(
                _INPUTS + _BODY, WORLD, "gloo", 240.0)]


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == WORLD, "conftest must force 8 devices"
    return jcol.default_mesh()


@pytest.fixture(scope="module")
def inputs(mesh):
    return _inputs(mesh.shape["dp"])


def _smap(fn, mesh, in_spec, out_spec):
    return jcol.smap(fn, mesh, in_spec, out_spec)


def _each(port):
    for r in port:
        d, t = (int(c) for c in r["coords"])
        yield d, t, r


def test_default_mesh_is_2d(port, mesh):
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    for rank, r in enumerate(port):
        assert list(r["shape"]) == [dp, tp] == [4, 2]
        assert list(r["coords"]) == [rank // tp, rank % tp]


def test_replicated_fanout_merge_psum(port, mesh, inputs):
    f = _smap(lambda s: jcol.replicated_fanout_merge(s, "dp"),
              mesh, (P("dp", "tp"),), P(None, "tp"))
    ref = np.asarray(f(inputs["psum"]))
    for d, t, r in _each(port):
        np.testing.assert_allclose(r["psum"], ref[:, t:t + 1], rtol=1e-6)
        assert r["psum_input_kept"] is True


def test_gather_merge_concats(port, mesh, inputs):
    f = _smap(lambda s: jcol.gather_merge(s, "dp"),
              mesh, (P("dp", None),), P(None, None))
    ref = np.asarray(f(inputs["gather"]))
    for _d, _t, r in _each(port):
        np.testing.assert_array_equal(r["gather"], ref)


def test_all_to_all_matches_and_roundtrips(port, mesh, inputs):
    dp = mesh.shape["dp"]
    fwd = _smap(lambda s: jcol.partition_scatter_gather(s, "dp"),
                mesh, (P("dp", None),), P("dp", None))
    ref = np.asarray(fwd(inputs["a2a"]))
    for d, _t, r in _each(port):
        np.testing.assert_array_equal(r["a2a"], ref[d * dp:(d + 1) * dp])
        np.testing.assert_array_equal(
            r["a2a_twice"], inputs["a2a"][d * dp:(d + 1) * dp])


def test_reduce_scatter_merge(port, mesh, inputs):
    f = _smap(lambda s: jcol.reduce_scatter_merge(s, "dp"),
              mesh, (P("dp", None),), P("dp", None))
    ref = np.asarray(f(inputs["rs"]))
    for d, _t, r in _each(port):
        assert r["rs"].shape == (1, 3)
        np.testing.assert_allclose(r["rs"], ref[d:d + 1], rtol=1e-6)


def test_ring_cascade_rotates(port, mesh, inputs):
    f = _smap(lambda s: jcol.ring_cascade(s, "dp"),
              mesh, (P("dp", None),), P("dp", None))
    ref = np.asarray(f(inputs["ring"]))
    np.testing.assert_array_equal(ref.ravel(),
                                  np.roll(inputs["ring"].ravel(), 1))
    for d, _t, r in _each(port):
        np.testing.assert_array_equal(r["ring"], ref[d:d + 1])
        np.testing.assert_array_equal(
            r["ring_back"], np.roll(inputs["ring"], -1, axis=0)[d:d + 1])


@pytest.fixture(scope="module")
def jax_steps(mesh):
    step = jcol.make_fanout_step(mesh)
    w, x = tentry.make_inputs(mesh.shape["dp"], mesh.shape["tp"])
    l0, w1 = step(w, x)
    l1, w2 = step(w1, x)
    return [float(l0), float(l1)], np.asarray(w1), np.asarray(w2)


def test_fanout_step_matches_jax(port, jax_steps):
    losses, w1, _ = jax_steps
    for r in port:
        np.testing.assert_allclose(r["loss"][0], losses[0], rtol=1e-6)
        assert r["w1"].shape == w1.shape == (16, 32)
        np.testing.assert_allclose(r["w1"], w1, rtol=0, atol=1e-8)


def test_fanout_step_descends_like_jax(port, jax_steps):
    losses, _, w2 = jax_steps
    for r in port:
        l0, l1 = r["loss"]
        assert np.isfinite(l0) and np.isfinite(l1) and l1 < l0
        np.testing.assert_allclose(l1, losses[1], rtol=1e-6)
        np.testing.assert_allclose(r["w2"], w2, rtol=0, atol=1e-8)


def test_fanout_step_single_rank_in_process():
    """dp = tp = 1 in this process (a one-rank gloo group) against the
    reference's step on a one-device mesh."""
    jmesh = jcol.default_mesh(jax.devices()[:1])
    w, x = tentry.make_inputs(1, 1)
    jl, jw1 = jcol.make_fanout_step(jmesh)(w, x)
    distributed.init_single("cpu")
    try:
        step, (tw, tx) = tentry.entry("cpu")
        loss, w1 = step(tw, tx)
    finally:
        distributed.shutdown()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(w1.numpy(), np.asarray(jw1), rtol=0,
                               atol=1e-8)


@pytest.fixture(scope="module")
def jax_attn(inputs):
    ring = Mesh(np.array(jax.devices()), ("sp",))
    fn = jcol.make_ring_attention(ring, "sp")
    q, k, v = inputs["qkv"]
    f32 = np.asarray(fn(q, k, v))
    b16 = np.asarray(fn(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
                     .astype(jnp.float32))
    return f32, b16


def test_ring_attention_matches_jax(port, jax_attn):
    ref, _ = jax_attn
    for rank, r in enumerate(port):
        assert r["rotations"] == WORLD - 1
        np.testing.assert_allclose(
            r["attn"], ref[rank * LOCAL:(rank + 1) * LOCAL],
            rtol=2e-5, atol=2e-5)


def _bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits)."""
    _, e = np.frexp(np.abs(a).astype(np.float64))
    return np.ldexp(1.0, np.maximum(e - 8, -133))


def test_ring_attention_bf16_within_one_ulp_of_jax(port, jax_attn):
    _, ref = jax_attn
    for rank, r in enumerate(port):
        want = ref[rank * LOCAL:(rank + 1) * LOCAL]
        got = r["attn_bf16"]
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= ulp), (
            np.max(np.abs(got - want) / ulp))
