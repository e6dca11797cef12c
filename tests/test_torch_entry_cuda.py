"""dryrun_multichip on four cards (NCCL ranks, the kernels) against four gloo
ranks on the CPU (the plain versions), element by element.

The multi-rank collectives of the fan-out step and ring attention on
NCCL: dp 2 x tp 2 for the step, a 4-position ring for attention. It
skips on a host with fewer than four cards. This file imports no JAX;
run it on the card without tests/conftest.py:

    python -m pytest -m cuda --noconftest tests/test_torch_entry_cuda.py

Tolerances are those the gloo ranks are held to against the reference in
tests/test_torch_collectives.py: loss rtol 1e-6, w1 atol 1e-8, ring
attention 2e-5 abs and rel (f32). The card and the CPU multiply the same
bf16 operands and differ only in the order of f32 sums.
"""

import numpy as np
import pytest
import torch

from tbus_torch import entry

N_CARDS = 4


@pytest.mark.cuda
def test_dryrun_on_four_cards_equals_four_gloo_ranks():
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < N_CARDS:
        pytest.skip(f"needs {N_CARDS} NVIDIA cards")
    card = entry.dryrun_multichip(N_CARDS, "cuda", rpc=False)
    cpu = entry.dryrun_multichip(N_CARDS, "cpu", rpc=False)
    assert [r["rank"] for r in card] == list(range(N_CARDS))
    for c, p in zip(card, cpu):
        assert c["rank"] == p["rank"]
        assert c["ring_rotations"] == N_CARDS - 1
        w1c, w1p = np.asarray(c["w1"]), np.asarray(p["w1"])
        atc, atp = np.asarray(c["attn"]), np.asarray(p["attn"])
        assert w1c.shape == (16, 16) and atc.shape == (8, 16)
        print(f"rank {c['rank']}: loss rel err "
              f"{abs(c['loss'] - p['loss']) / abs(p['loss']):.3g}, w1 max "
              f"abs err {np.abs(w1c - w1p).max():.3g}, attention max abs "
              f"err {np.abs(atc - atp).max():.3g}")
        np.testing.assert_allclose(c["loss"], p["loss"], rtol=1e-6)
        np.testing.assert_allclose(w1c, w1p, rtol=0, atol=1e-8)
        np.testing.assert_allclose(atc, atp, rtol=2e-5, atol=2e-5)
