"""The port's row transform against tbus.parallel.runtime._row_transform.

Inputs come from numpy and go through both sides; the tolerance is exact
bytes (the data is u8). The plain version is compared with JAX on the
CPU; test_torch_row_transform_cuda.py holds the CUDA kernel to the plain
version on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbus.parallel import runtime as jrt
from tbus_torch.kernels import row_transform as rt
from tbus_torch.parallel import runtime as trt

_JAX_BUILTINS = {"echo": None, "xor255": jrt.BUILTINS["xor255"],
                 "add_peer_index": jrt.BUILTINS["add_peer_index"]}


def _rows(rng, length, lengths):
    """u8[len(lengths), length] of random bytes, each row's u32 prefix
    set to its entry of `lengths`."""
    rows = rng.integers(0, 256, (len(lengths), length), dtype=np.uint8)
    for b, n in enumerate(lengths):
        rows[b, :4] = np.frombuffer(np.uint32(n).tobytes(), dtype=np.uint8)
    return rows


@functools.lru_cache(maxsize=None)
def _jax_fn(builtin, rpp, length):
    """The reference's per-position body, vmapped over the batch as
    _build_batch does; the position is traced so one compile serves all."""
    handler = _JAX_BUILTINS[builtin]
    return jax.jit(lambda rows_b, p: jax.vmap(
        lambda r: jrt._row_transform(handler, r, p, rpp, length))(rows_b))


def _jax_rows(builtin, rows, pos, rpp):
    f = _jax_fn(builtin, rpp, rows.shape[1])
    return np.asarray(f(jnp.asarray(rows), jnp.int32(pos)))


@pytest.mark.parametrize("length", [128, 192, 6144])
@pytest.mark.parametrize("builtin", ["echo", "xor255", "add_peer_index"])
def test_reference_matches_jax(builtin, length):
    rng = np.random.default_rng(length)
    # n = 0, 1 and L-4 as the runtime writes them, plus prefixes past the
    # row and one whose 4 + n wraps in u32 (the reference's arithmetic).
    rows = _rows(rng, length, [0, 1, length - 4, length + 100, 0xFFFFFFFE])
    for rpp in (1, 2, 3):
        for pos in (0, 1, 3):
            want = _jax_rows(builtin, rows, pos, rpp)
            got = rt.row_transform_reference(
                torch.from_numpy(rows), pos, rpp, builtin).numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"rpp={rpp} pos={pos}")


def test_pad_len_matches_jax():
    for n in range(20001):
        assert trt._pad_len(n) == jrt._pad_len(n), n


def test_wrapper_on_cpu_uses_plain_version_without_launch():
    rows = _rows(np.random.default_rng(0), 128, [10, 124])
    before = rt.launches
    got = rt.row_transform(torch.from_numpy(rows), 2, 3, "add_peer_index")
    want = rt.row_transform_reference(torch.from_numpy(rows), 2, 3,
                                      "add_peer_index")
    assert torch.equal(got, want)
    assert rt.launches == before


@pytest.mark.parametrize("bad", [
    dict(shape=(2, 100)),                    # L not a multiple of 16
    dict(shape=(2, 128), dtype=torch.int32),
    dict(shape=(128,)),
    dict(shape=(2, 128), builtin="nope"),
    dict(shape=(2, 128), rpp=0),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rows = torch.zeros(bad["shape"], dtype=bad.get("dtype", torch.uint8))
    with pytest.raises((ValueError, KeyError)):
        rt.row_transform(rows, 0, bad.get("rpp", 1),
                         bad.get("builtin", "echo"))
