"""The row-transform CUDA kernel against its plain version, on the card.

The kernel has no CPU mode, so these tests skip without an NVIDIA card.
This file imports no JAX, so it runs on GPU hosts without JAX; run it
there without tests/conftest.py, which imports JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_row_transform_cuda.py

The tolerance is exact bytes (the data is u8).
"""

import numpy as np
import pytest
import torch

from tbus_torch.kernels import row_transform as rt


def _rows(rng, length, lengths):
    rows = rng.integers(0, 256, (len(lengths), length), dtype=np.uint8)
    for b, n in enumerate(lengths):
        rows[b, :4] = np.frombuffer(np.uint32(n).tobytes(), dtype=np.uint8)
    return rows


# The main path's (B, rpp, L): 4 KiB, 1 MiB x8 batched, a full kMaxBatch.
_CARD_SHAPES = [(1, 8, 6144), (8, 8, 1572864), (16, 8, 6144)]


@pytest.mark.cuda
@pytest.mark.parametrize("builtin", ["echo", "xor255", "add_peer_index"])
def test_kernel_matches_plain_version_on_card(builtin):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(7)
    for b, rpp, length in _CARD_SHAPES:
        lengths = [int(x) for x in rng.integers(0, length - 3, b)]
        lengths[0] = length - 4
        rows = torch.from_numpy(_rows(rng, length, lengths)).cuda()
        before = rt.launches
        got = rt.row_transform(rows, 1, rpp, builtin)
        torch.cuda.synchronize()
        assert rt.launches == before + 1
        want = rt.row_transform_reference(rows, 1, rpp, builtin)
        assert torch.equal(got, want), (b, rpp, length)


@pytest.mark.cuda
def test_kernel_edge_prefixes_on_card():
    """Prefixes 0, 1, L-4, past the row, and one whose 4 + n wraps in
    u32, at several positions and rows per position."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(11)
    for length in (128, 192, 6144):
        rows = torch.from_numpy(_rows(
            rng, length, [0, 1, length - 4, length + 100, 0xFFFFFFFE])).cuda()
        for builtin in ("echo", "xor255", "add_peer_index"):
            for pos, rpp in ((0, 1), (3, 2), (40, 7)):
                got = rt.row_transform(rows, pos, rpp, builtin)
                want = rt.row_transform_reference(rows, pos, rpp, builtin)
                assert torch.equal(got, want), (length, builtin, pos, rpp)


@pytest.mark.cuda
def test_runtime_device_kind_matches_host_kind_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    from tbus_torch.parallel import runtime

    rng = np.random.default_rng(12)
    for builtin in ("echo", "xor255", "add_peer_index"):
        runtime.register_builtin("CardParity", builtin, builtin, "v1")
        for n_peers in (1, 3, 8, 13):
            p = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
            assert (runtime.broadcast_gather(
                "CardParity", builtin, p, n_peers, 0, mesh="device") ==
                runtime.broadcast_gather(
                    "CardParity", builtin, p, n_peers, 0, mesh="host"))
        ps = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (0, 1, 123, 4096, 5000)]
        assert (runtime.broadcast_gather_batch(
            "CardParity", builtin, ps, 8, 0, mesh="device") ==
            runtime.broadcast_gather_batch(
                "CardParity", builtin, ps, 8, 0, mesh="host"))
