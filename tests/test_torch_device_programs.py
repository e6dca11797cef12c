"""The device plane's programs: the port against the JAX package.

- The u8 transforms (echo, xor255, incr): the JAX package's own device
  method on its fake PJRT device (tbus.pjrt_init("fake"),
  tbus.Server.add_device_method; cpp/tpu/pjrt_runtime.cc) against the
  port's runtime on its CPU backend through
  tbus_torch.rpc.Server.add_device_method, at lengths that cross the
  padding classes. Replies are byte-equal.
- dot128 and dotbench<N>x<T>: the fake device refuses them
  (pjrt_runtime.cc:937), so the reference is a jnp restatement of the
  programs build_mlir emits (:207-244, :245-330), run in JAX on the CPU.
  The plain PyTorch versions and the C++ CPU backend's replies are held to
  it.

Tolerances. dot128: within 1e-6 * (|x| @ |W|) (f32 sums of 128 products
in another order). dotbench: the last matrix within one bf16 ulp per
element plus (2^-7 + n * 2^-24) * bf16(1/n) * (|v_prev| @ |W|) (a
one-ulp difference in the inputs and the f32 order, carried through the
last product); the checksum within (2^-7 + n * 2^-24) * sum|v| (the
reference leaves the width and order of its bf16 reduce to the backend).

Both servers run in one child process (the PJRT runtime and the port's
runtime are each process-global); the child writes the replies, and the
comparisons run here.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tbus_torch.kernels import device_programs as dp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K4's path sizes (4 KiB, 64 KiB shards, the 256 KiB serving step, 1 MiB)
# and ragged lengths around them and the padding classes.
LENGTHS = [1, 127, 128, 4096, 4097, 1 << 16, (1 << 16) + 5, 1 << 18,
           1 << 20, (1 << 20) + 1]
U8 = ["echo", "xor255", "incr"]
DOT_K = [1, 8, 64]
DOTBENCH = [(128, 4), (256, 2)]
SEEDS = [0.5, -1.25]

CHILD = r"""
import struct, sys
import numpy as np
sys.path.insert(0, %(root)r)
import tbus
import tbus_torch as tt

tbus.init()
assert tbus.pjrt_init("fake")
tt.device_init("cpu")
ref, port = tbus.Server(), tt.Server()
for tf in %(u8)r:
    ref.add_device_method("Dev", tf, tf)
    port.add_device_method("Dev", tf, tf)
port.add_device_method("Dev", "dot128", "dot128")
for n, t in %(dotbench)r:
    name = f"dotbench{n}x{t}"
    port.add_device_method("Dev", name, name)
ref_ch = tbus.Channel(f"127.0.0.1:{ref.start(0)}", timeout_ms=60000)
port_ch = tt.Channel(f"127.0.0.1:{port.start(0)}", timeout_ms=60000)
rng = np.random.default_rng(29)
out = {}
for n in %(lengths)r:
    p = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    out[f"payload_{n}"] = np.frombuffer(p, np.uint8)
    for tf in %(u8)r:
        out[f"ref_{tf}_{n}"] = np.frombuffer(ref_ch.call("Dev", tf, p),
                                             np.uint8)
        out[f"port_{tf}_{n}"] = np.frombuffer(port_ch.call("Dev", tf, p),
                                              np.uint8)
for k in %(dot_k)r:
    x = rng.standard_normal((k, 128), dtype=np.float32)
    out[f"dot_x_{k}"] = x
    out[f"dot_y_{k}"] = np.frombuffer(port_ch.call("Dev", "dot128",
                                                   x.tobytes()), np.float32)
for n, t in %(dotbench)r:
    for i, seed in enumerate(%(seeds)r):
        r = port_ch.call("Dev", f"dotbench{n}x{t}", struct.pack("<f", seed))
        out[f"bench_{n}_{t}_{i}"] = np.frombuffer(r, np.float32)
np.savez(sys.argv[1], **out)
ref.stop()
port.stop()
print("CHILD-OK", flush=True)
"""


@pytest.fixture(scope="module")
def replies(tmp_path_factory):
    # The child loads the core through the JAX package's loader, whose
    # build lock holds within one process only: a test worker's `import
    # tbus` beside it may relink cpp/build/libtbus.so while the child
    # loads it. The port's loader builds it here under a file lock, after
    # any other build there has ended, and TBUS_LIB hands the child that
    # library, so the child builds nothing.
    from tbus_torch import _native

    env = dict(os.environ, TBUS_LIB=_native.build())
    path = str(tmp_path_factory.mktemp("device_programs") / "replies.npz")
    src = CHILD % {"root": ROOT, "u8": U8, "dotbench": DOTBENCH,
                   "lengths": LENGTHS, "dot_k": DOT_K, "seeds": SEEDS}
    proc = subprocess.run([sys.executable, "-c", src, path], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
    return dict(np.load(path))


# ---- the jnp restatement of build_mlir's dot128 and dotbench ----

def _iotas(n):
    shape = (n, n)
    return (lax.broadcasted_iota(jnp.float32, shape, 0),
            lax.broadcasted_iota(jnp.float32, shape, 1))


def _weight_f32(n):
    i, j = _iotas(n)
    return (lax.rem(i * 3.0 + j * 5.0, 11.0) - 5.0) * 0.125


def jnp_dot128(x):
    """pjrt_runtime.cc:207-244: x f32[k,128] . W at precision HIGHEST."""
    return lax.dot_general(jnp.asarray(x), _weight_f32(128),
                           (((1,), (0,)), ((), ())),
                           precision=lax.Precision.HIGHEST)


def jnp_dotbench(seed, n, t):
    """pjrt_runtime.cc:245-330: (checksum f32, last bf16 matrix, the one
    before it). Each product bf16 x bf16 -> bf16 is taken with f32
    accumulation; the reduce in f32, rounded once to bf16."""
    bf16 = jnp.bfloat16
    i, j = _iotas(n)
    w = _weight_f32(n).astype(bf16)
    a = ((lax.rem(i + j, 7.0) - 3.0) * 0.125).astype(bf16)
    v = a + jnp.float32(seed).astype(bf16)
    inv = jnp.asarray(1.0 / n, dtype=bf16)
    prev = v
    for _ in range(t):
        prev = v
        d = lax.dot_general(v, w, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32).astype(bf16)
        v = d * inv
    total = jnp.sum(v.astype(jnp.float32)).astype(bf16).astype(jnp.float32)
    return float(total), v, prev


def _bf16_ulp(a):
    e = np.frexp(np.abs(a).astype(np.float64))[1]
    return np.ldexp(1.0, np.maximum(e - 8, -133))


def _dot_tol(x):
    w = np.asarray(_weight_f32(128))
    return 1e-6 * (np.abs(x).astype(np.float64) @ np.abs(w))


def _dotbench_tols(n, v, prev):
    v = np.asarray(v.astype(jnp.float32), dtype=np.float64)
    prev = np.asarray(prev.astype(jnp.float32), dtype=np.float64)
    w = np.asarray(_weight_f32(n).astype(jnp.bfloat16).astype(jnp.float32),
                   dtype=np.float64)
    inv = float(jnp.asarray(1.0 / n, dtype=jnp.bfloat16))
    gap = 2.0**-7 + n * 2.0**-24
    elem = _bf16_ulp(v) + gap * inv * (np.abs(prev) @ np.abs(w))
    return elem, gap * np.abs(v).sum()


# ---- the u8 transforms: byte-equal to the JAX package's device methods ----

@pytest.mark.parametrize("transform", U8)
def test_u8_device_methods_equal_the_jax_packages(replies, transform):
    for n in LENGTHS:
        ref = replies[f"ref_{transform}_{n}"]
        assert len(ref) == n
        assert np.array_equal(replies[f"port_{transform}_{n}"], ref), n


@pytest.mark.parametrize("transform", U8)
def test_u8_plain_version_equals_the_jax_packages(replies, transform):
    """device_method_reference (padding class, u8_transform_reference, cut
    to length) gives the JAX package's bytes."""
    for n in LENGTHS:
        p = replies[f"payload_{n}"].tobytes()
        assert dp.device_method_reference(transform, p) == \
            replies[f"ref_{transform}_{n}"].tobytes(), n


def test_device_len_class_matches_the_reference_rule():
    # pjrt_runtime.cc:1185: 128, then powers of two with 1.5x half-steps.
    want = {0: 128, 1: 128, 128: 128, 129: 192, 192: 192, 193: 256,
            4096: 4096, 4097: 6144, 6145: 8192, (1 << 20) + 1: 1572864}
    assert {n: dp.device_len_class(n) for n in want} == want


# ---- dot128 against the jnp restatement ----

def test_dot128_weight_equals_the_reference_formula():
    assert np.array_equal(dp.dot128_weight().numpy(),
                          np.asarray(_weight_f32(128)))


@pytest.mark.parametrize("k", DOT_K)
def test_dot128_plain_version_against_jnp(replies, k):
    x = replies[f"dot_x_{k}"]
    got = dp.dot128(torch.from_numpy(x)).numpy()
    assert (np.abs(got - np.asarray(jnp_dot128(x))) <= _dot_tol(x)).all()


@pytest.mark.parametrize("k", DOT_K)
def test_dot128_cpu_backend_against_jnp_and_plain(replies, k):
    x = replies[f"dot_x_{k}"]
    got = replies[f"dot_y_{k}"].reshape(k, 128)
    assert (np.abs(got - np.asarray(jnp_dot128(x))) <= _dot_tol(x)).all()
    plain = dp.dot128_reference(torch.from_numpy(x)).numpy()
    assert (np.abs(got - plain) <= _dot_tol(x)).all()


# ---- dotbench against the jnp restatement ----

@pytest.mark.parametrize("n,t", DOTBENCH)
def test_dotbench_operands_equal_the_reference_formulas(n, t):
    for seed in SEEDS:
        a0, w = dp.dotbench_operands(seed, n)
        i, j = _iotas(n)
        want_a = (((lax.rem(i + j, 7.0) - 3.0) * 0.125).astype(jnp.bfloat16)
                  + jnp.float32(seed).astype(jnp.bfloat16))
        want_w = _weight_f32(n).astype(jnp.bfloat16)
        assert np.array_equal(a0.float().numpy(),
                              np.asarray(want_a.astype(jnp.float32)))
        assert np.array_equal(w.float().numpy(),
                              np.asarray(want_w.astype(jnp.float32)))
    assert float(dp.dotbench_inverse(n)) == float(
        jnp.asarray(1.0 / n, dtype=jnp.bfloat16))


@pytest.mark.parametrize("n,t", DOTBENCH)
def test_dotbench_plain_version_against_jnp(n, t):
    for seed in SEEDS:
        want, v, prev = jnp_dotbench(seed, n, t)
        got, last = dp.dotbench(torch.tensor([seed]), n, t, return_last=True)
        elem_tol, sum_tol = _dotbench_tols(n, v, prev)
        diff = np.abs(last.float().numpy().astype(np.float64)
                      - np.asarray(v.astype(jnp.float32), dtype=np.float64))
        assert (diff <= elem_tol).all()
        assert abs(float(got[0]) - want) <= sum_tol


@pytest.mark.parametrize("n,t", DOTBENCH)
def test_dotbench_cpu_backend_against_jnp_and_plain(replies, n, t):
    for i, seed in enumerate(SEEDS):
        got = float(replies[f"bench_{n}_{t}_{i}"][0])
        want, v, prev = jnp_dotbench(seed, n, t)
        _, sum_tol = _dotbench_tols(n, v, prev)
        assert abs(got - want) <= sum_tol
        assert abs(got - float(dp.dotbench_reference(seed, n, t))) <= sum_tol


def test_dotbench_names_refused_with_the_reference_text():
    for bad in ("dotbench64x2", "dotbench128x0", "dotbench16385x1",
                "dotbench128x257", "dotbenchfoo"):
        with pytest.raises(ValueError, match=(
                r"^dotbench wants dotbench<N>x<T>, 128<=N<=16384, "
                r"1<=T<=256; got " + bad + "$")):
            dp.parse_dotbench(bad)
    assert dp.parse_dotbench("dotbench4096x32") == (4096, 32)
