"""K7, the fused fan-out kernel, against its plain version, and the CUDA
backend's DMA registration (cudaHostRegister), on the card.

The kernel has no CPU mode, so these tests skip without an NVIDIA card.
This file imports no JAX, so it runs on GPU hosts without JAX; run it
there without tests/conftest.py, which imports JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_fanout_cuda.py

Tolerance: exact bytes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tbus_torch.kernels import fanout as fk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("builtin", sorted(fk.BUILTINS))
@pytest.mark.parametrize("scatter", [False, True], ids=["bcast", "scatter"])
def test_fanout_matches_plain_version(builtin, scatter):
    _need_card()
    rng = np.random.default_rng(5)
    # Buckets of the length classes, one ragged (the scalar path), and an
    # unaligned input (a view one byte in).
    for n in (1, 8, 64, 300):
        for bucket in (128, 4096, 6144, 1000, 1 << 20):
            if n * bucket > (64 << 20):
                continue
            size = n * bucket if scatter else bucket
            raw = torch.from_numpy(rng.integers(0, 256, size + 1,
                                                dtype=np.uint8)).cuda()
            for x in (raw[:size], raw[1:]):
                before = fk.launches
                got = fk.fanout(x, n, bucket, scatter, builtin)
                assert fk.launches == before + 1
                want = fk.fanout_plain(x, n, bucket, scatter, builtin)
                assert torch.equal(got, want), (n, bucket, scatter, builtin)


REGISTER_CHILD = r"""
import ctypes, mmap, sys
sys.path.insert(0, %(root)r)
import tbus_torch as tt
from tbus_torch import rpc
tt.device_enable_dma()
tt.init()
tt.device_init("cuda")
B = rpc._device_bridge()
st = rpc.device_dma_stats()
hr = st["host_registered"]
# The pool's regions, carved before the runtime, were bound at init.
assert st["regions"] >= 1 and hr["ranges"] == st["regions"], st
assert hr["failures"] == 0, st
# A range the table registers is bound by cudaHostRegister, and unbound
# with it.
buf = mmap.mmap(-1, 1 << 20)
base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
assert B.tbus_torch_dma_register_range(base, 1 << 20) == 0
assert rpc.device_dma_stats()["host_registered"]["ranges"] == hr["ranges"] + 1
assert B.tbus_torch_dma_unregister(base) == 0
assert rpc.device_dma_stats()["host_registered"]["ranges"] == hr["ranges"]
# 1 MiB through the runtime from a pool block into a fresh pool block:
# donated and aliased, not one staged byte.
n = 1 << 20
data = bytes(range(256)) * (n // 256)
out = ctypes.create_string_buffer(n)
got = ctypes.c_longlong()
st0 = rpc.device_dma_stats()
assert B.tbus_torch_device_run_mode(b"xor255", data, n, 0, 0, out, n, 30000,
                                    ctypes.byref(got)) == 0
assert out.raw == bytes(b ^ 0xFF for b in data)
st1 = rpc.device_dma_stats()
assert st1["h2d_copy_bytes"] == st0["h2d_copy_bytes"], st1
assert st1["d2h_copy_bytes"] == st0["d2h_copy_bytes"], st1
assert st1["donation_hits"] == st0["donation_hits"] + 1, st1
assert st1["alias_hits"] == st0["alias_hits"] + 1, st1
# A read-only mapping (a peer's region is one): bound read-only where the
# card supports it and then donated, else left unbound and staged,
# counted; the bytes are right either way.
ro = mmap.mmap(-1, n, prot=mmap.PROT_READ)
import numpy as np
ro_base = np.frombuffer(ro, dtype=np.uint8).ctypes.data
hr = rpc.device_dma_stats()["host_registered"]  # the pool may have grown
assert B.tbus_torch_dma_register_range(ro_base, n) == 0
hr2 = rpc.device_dma_stats()["host_registered"]
bound = hr2["ranges"] == hr["ranges"] + 1
assert bound or hr2["failures"] == hr["failures"] + 1, (hr, hr2)
st2 = rpc.device_dma_stats()
assert B.tbus_torch_device_run_mode(b"xor255", ro_base, n, 2, 0, out, n,
                                    30000, ctypes.byref(got)) == 0
assert out.raw == b"\xff" * n
st3 = rpc.device_dma_stats()
staged = st3["h2d_copy_bytes"] - st2["h2d_copy_bytes"]
assert staged == (0 if bound else n), (bound, staged)
assert B.tbus_torch_dma_unregister(ro_base) == 0
print("READ-ONLY MAPPING", "bound" if bound else "unbound",
      "read-only" if hr2["read_only"] > hr["read_only"] else "", flush=True)
assert rpc.device_stats()["launches"]["u8_transform"] == 2
print("CHILD-OK", flush=True)
"""


@pytest.mark.cuda
def test_host_register_binds_and_unbinds():
    _need_card()
    proc = subprocess.run(
        [sys.executable, "-c", REGISTER_CHILD % {"root": ROOT}],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
