"""K7, the fused fan-out (tbus_torch/kernels/fanout.py and
tbus_torch/csrc/device_programs.cu), against the reference's program.

The reference's device program is cpp/tpu/native_fanout.cc:166
fanout_mlir, StableHLO that no JAX function of the package wraps; it is
restated here in jax.numpy op for op (broadcast_in_dim or reshape, xor
with 255, an iota along the peer axis converted to ui8 and added) and
held byte for byte against fanout_plain, with inputs from numpy seeds.
The C++ CPU backend's K7 program (the loop the device runtime runs with
device_init("cpu"), reached through the bridge in a child process, since
the runtime is one per process) is held against fanout_plain as well.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbus_torch.kernels import fanout as fk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILTINS = ["echo", "xor255", "add_peer_index"]


def fanout_mlir_jnp(x, n, bucket, scatter, builtin):
    """fanout_mlir, op for op."""
    a = jnp.asarray(x)
    if scatter:
        m = jnp.reshape(a, (n, bucket))
    else:
        m = jax.lax.broadcast_in_dim(a, (n, bucket), (1,))
    if builtin == "xor255":
        m = jnp.bitwise_xor(m, jnp.full((n, bucket), 255, jnp.uint8))
    elif builtin == "add_peer_index":
        i32 = jax.lax.broadcasted_iota(jnp.int32, (n, bucket), 0)
        m = m + jax.lax.convert_element_type(i32, jnp.uint8)
    return np.asarray(jnp.reshape(m, (n * bucket,)))


@pytest.mark.parametrize("builtin", BUILTINS)
@pytest.mark.parametrize("scatter", [False, True], ids=["bcast", "scatter"])
@pytest.mark.parametrize("n", [1, 3, 8, 300])
@pytest.mark.parametrize("bucket", [128, 192, 4096])
def test_fanout_plain_matches_fanout_mlir(builtin, scatter, n, bucket):
    rng = np.random.default_rng([n, bucket, int(scatter)])
    x = rng.integers(0, 256, n * bucket if scatter else bucket,
                     dtype=np.uint8)
    got = fk.fanout_plain(torch.from_numpy(x), n, bucket, scatter, builtin)
    want = fanout_mlir_jnp(x, n, bucket, scatter, builtin)
    assert got.dtype == torch.uint8 and got.shape == (n * bucket,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fanout_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.arange(256, dtype=torch.uint8)
    before = fk.launches
    got = fk.fanout(x, 300, 256, False, "add_peer_index")
    assert fk.launches == before  # no kernel launched for a CPU tensor
    assert torch.equal(got, fk.fanout_plain(x, 300, 256, False,
                                            "add_peer_index"))
    # Peer 256 wraps to +0, as the reference's ui8 iota does.
    assert torch.equal(got[256 * 256:257 * 256], x)
    with pytest.raises(ValueError):
        fk.fanout(x, 2, 128, False, "echo")  # input is not u8[bucket]
    with pytest.raises(KeyError):
        fk.fanout(x, 1, 256, False, "incr")


CPU_BACKEND_CHILD = r"""
import ctypes, sys
sys.path.insert(0, %(root)r)
import numpy as np
import torch
import tbus_torch as tt
from tbus_torch import rpc
from tbus_torch.kernels import fanout as fk
tt.init()
tt.device_init("cpu")
B = rpc._device_bridge()
rng = np.random.default_rng(7)
cases = 0
for n, bucket in ((1, 128), (3, 192), (8, 4096), (300, 128)):
    for scatter in (False, True):
        for code, builtin in enumerate(("echo", "xor255", "add_peer_index")):
            x = rng.integers(0, 256, n * bucket if scatter else bucket,
                             dtype=np.uint8)
            # A short input is zero-padded to the program's length.
            short = x[:-5].tobytes()
            out = ctypes.create_string_buffer(n * bucket)
            rc = B.tbus_torch_device_run_fanout(code, n, bucket, int(scatter),
                                                short, len(short), out,
                                                n * bucket)
            assert rc == 0, rc
            x[-5:] = 0
            want = fk.fanout_plain(torch.from_numpy(x), n, bucket, scatter,
                                   builtin)
            assert out.raw == want.numpy().tobytes(), (n, bucket, scatter,
                                                       builtin)
            cases += 1
st = rpc.device_stats()
assert st["executions"] == cases and st["errors"] == 0, st
assert st["launches"]["fanout"] == 0  # the CPU backend launches nothing
leaked = sorted(m for m in sys.modules
                if m in ("jax", "tbus") or m.startswith(("jax.", "tbus.")))
assert not leaked, leaked
print("CHILD-OK", flush=True)
"""


def test_cpu_backend_program_matches_fanout_plain():
    proc = subprocess.run(
        [sys.executable, "-c", CPU_BACKEND_CHILD % {"root": ROOT}],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
