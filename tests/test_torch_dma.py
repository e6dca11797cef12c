"""DMA registration of the block pool in the port's device runtime, on the
CPU backend: twins of cpp/tests/pjrt_dma_test.cc.

The table is the reference's (cpp/tpu/pjrt_dma.h), armed by
tbus_torch.rpc.device_enable_dma() before the pool comes up. The CPU
backend takes the table as its view of host memory, as the reference's
fake device does: a registered range is read (donated) or written
(aliased) in place, pinned for the execution; anything else crosses
through the plan's staging buffers and is counted by the
tbus_pjrt_{h2d,d2h}_copy_bytes tripwires. Held here:
- registration lifecycle (:153), the donation round trip (:173), output
  aliasing (:222), the deferred unregister while pinned (:252), refused
  registrations degrading to counted staging (:273) and a peer dying
  while the device reads its region (:421);
- every byte staged and counted with the table off;
- the abandon guard with an aliased output: a 300 ms job against a 30 ms
  deadline leaves the caller's block untouched;
- device_enable_dma() raising once the pool is up;
- the tripwires and the donation/alias counts of device-method calls
  (tpu:// and tcp, 1 KiB to 1 MiB, ragged lengths too) equal those of the
  reference's own runtime on its fake PJRT device over the same calls,
  with the table armed and off.

The runtime and the table are one per process, so each case runs in a
child that ends by asserting that neither jax nor the JAX package was
imported.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import ctypes, os, signal, subprocess, sys, time
sys.path.insert(0, %(root)r)
import numpy as np
import tbus_torch as tt
from tbus_torch import rpc
B = rpc._device_bridge()
LEN = 64 * 1024

def dma():
    return rpc.device_dma_stats()

def run(transform, data, in_kind, keyed=0, out=None, timeout_ms=30000):
    n = len(data) if isinstance(data, bytes) else LEN
    buf = out if out is not None else ctypes.create_string_buffer(n)
    got = ctypes.c_longlong(-1)
    rc = B.tbus_torch_device_run_mode(transform.encode(), data, n, in_kind,
                                      keyed, buf, n, timeout_ms,
                                      ctypes.byref(got))
    return rc, buf, got.value

def pattern(n):
    raw = bytearray(b"q" * n)
    for i in range(0, n, 257):
        raw[i] = i & 0xFF
    return bytes(raw)
"""

_EPILOGUE = r"""
leaked = sorted(m for m in sys.modules
                if m in ("jax", "tbus") or m.startswith(("jax.", "tbus.")))
assert not leaked, leaked
print("CHILD-OK", flush=True)
"""


def _run_child(body, env=None, timeout=180):
    proc = subprocess.run(
        [sys.executable, "-c",
         _PRELUDE % {"root": ROOT} + body + _EPILOGUE],
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, **(env or {})))
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])


OFF_CHILD = r"""
tt.init()
tt.device_init("cpu")
data = pattern(LEN)
st0 = dma()
assert not st0["enabled"]
rc, out, got = run("xor255", data, 0)
assert rc == 0 and out.raw == bytes(b ^ 0xFF for b in data)
st = dma()
# Table off: both directions staged, every byte counted.
assert st["h2d_copy_bytes"] - st0["h2d_copy_bytes"] == LEN, st
assert st["d2h_copy_bytes"] - st0["d2h_copy_bytes"] == LEN, st
assert st["donation_hits"] == 0 and st["alias_hits"] == 0, st
"""


def test_table_off_stages_and_counts_every_byte():
    _run_child(OFF_CHILD)


LIFECYCLE_CHILD = r"""
tt.device_enable_dma()
tt.init()
st = dma()
assert st["enabled"] and st["regions"] >= 1, st  # the pool's first region
assert tt.var_value("tbus_pjrt_registered_regions") == str(st["regions"])
manual = ctypes.create_string_buffer(8192)
base = ctypes.addressof(manual)
count0 = B.tbus_torch_dma_region_count()
assert B.tbus_torch_dma_register_range(base, 8192) == 0
assert B.tbus_torch_dma_is_registered(base, 8192) == 1
assert B.tbus_torch_dma_is_registered(base + 100, 1000) == 1
assert B.tbus_torch_dma_is_registered(base, 8193) == 0
assert B.tbus_torch_dma_region_count() == count0 + 1
assert B.tbus_torch_dma_unregister(base) == 0
assert B.tbus_torch_dma_is_registered(base, 1) == 0
assert B.tbus_torch_dma_region_count() == count0
assert B.tbus_torch_dma_unregister(base) == -1  # unknown now
"""


def test_registration_lifecycle():
    _run_child(LIFECYCLE_CHILD)


ROUNDTRIP_CHILD = r"""
tt.device_enable_dma()
tt.init()
tt.device_init("cpu")
data = pattern(LEN)
want = bytes(b ^ 0xFF for b in data)
st0 = dma()
# Donated: one registered pool block of exactly the program's length;
# the reply is a fresh pool block, aliased. No staged byte either way.
rc, out, got = run("xor255", data, 0)
assert rc == 0 and got == LEN and out.raw == want
st = dma()
assert st["h2d_copy_bytes"] == st0["h2d_copy_bytes"], st
assert st["d2h_copy_bytes"] == st0["d2h_copy_bytes"], st
assert st["donation_hits"] == st0["donation_hits"] + 1, st
assert st["alias_hits"] == st0["alias_hits"] + 1, st
assert st["pins"] == 0, st  # every pin released with the execution
# Staged contrast: 4 KiB fragments pay counted staging, same bytes.
rc, out, got = run("xor255", data, 1)
assert rc == 0 and out.raw == want
st2 = dma()
assert st2["h2d_copy_bytes"] - st["h2d_copy_bytes"] == LEN, st2
assert st2["donation_misses"] == st["donation_misses"] + 1, st2
"""


def test_donation_round_trip():
    _run_child(ROUNDTRIP_CHILD)


ALIAS_CHILD = r"""
tt.device_enable_dma()
tt.init()
tt.device_init("cpu")
data = b"A" * LEN
pool_out = B.tbus_torch_pool_alloc(LEN)
assert B.tbus_torch_dma_is_registered(pool_out, LEN) == 1
st0 = dma()
rc, _, got = run("incr", data, 0, keyed=1, out=pool_out)
assert rc == 0 and got == LEN
assert ctypes.string_at(pool_out, LEN) == b"B" * LEN
st = dma()
assert st["d2h_copy_bytes"] == st0["d2h_copy_bytes"], st  # aliased
# An unregistered destination: the same bytes, staged and counted.
heap = ctypes.create_string_buffer(LEN)
rc, _, got = run("incr", data, 0, keyed=1, out=heap)
assert rc == 0 and got == LEN and heap.raw == b"B" * LEN
st2 = dma()
assert st2["d2h_copy_bytes"] - st["d2h_copy_bytes"] == LEN, st2
assert st2["alias_misses"] == st["alias_misses"] + 1, st2
# Capacity guard: a block one byte short is refused.
got = ctypes.c_longlong(-1)
rc = B.tbus_torch_device_run_mode(b"incr", data, LEN, 0, 1, heap, LEN - 1,
                                  30000, ctypes.byref(got))
assert rc == 1003, rc  # EREQUEST

# The abandon guard with an aliased output: the job takes 300 ms, the
# caller waits 30; the block is never written after ERPCTIMEDOUT.
ctypes.memset(pool_out, 0xAA, LEN)
os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "300000"
rc, _, _ = run("xor255", data, 0, keyed=1, out=pool_out, timeout_ms=30)
assert rc == 1008, rc  # ERPCTIMEDOUT
time.sleep(0.6)  # the abandoned job has finished by now
assert ctypes.string_at(pool_out, LEN) == b"\xaa" * LEN
os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "0"
assert dma()["pins"] == 0
B.tbus_torch_pool_free(pool_out)
"""


def test_output_aliasing_and_the_abandon_guard():
    _run_child(ALIAS_CHILD)


DEFERRED_CHILD = r"""
tt.device_enable_dma()
tt.init()
buf = ctypes.create_string_buffer(16384)
base = ctypes.addressof(buf)
assert B.tbus_torch_dma_register_range(base, 16384) == 0
pin = B.tbus_torch_dma_pin(base + 64, 128)
assert pin >= 0
deferred0 = dma()["deferred_unregisters"]
assert B.tbus_torch_dma_unregister(base) == 1  # deferred, not gone
assert B.tbus_torch_dma_is_registered(base, 1) == 1
assert dma()["deferred_unregisters"] == deferred0 + 1
# A dying registration refuses new pins.
assert B.tbus_torch_dma_pin(base, 64) == -1
B.tbus_torch_dma_unpin(pin)  # the last pin drains: the unregister lands
assert B.tbus_torch_dma_is_registered(base, 1) == 0
assert B.tbus_torch_dma_unregister(base) == -1
"""


def test_unregister_deferred_while_pinned():
    _run_child(DEFERRED_CHILD)


REG_FAIL_CHILD = r"""
tt.device_enable_dma()
tt.init()
tt.device_init("cpu")
tt.fi_set("pjrt_reg_fail", 1000)
fail0 = dma()["reg_failures"]
# Exhaust the 1 MiB slot class so a new region is carved while refusal
# is armed (16 MiB regions hold 15 such slots).
MIB = 1 << 20
blocks, unregistered = [], None
for _ in range(64):
    p = B.tbus_torch_pool_alloc(MIB)
    assert p  # no allocation is lost
    blocks.append(p)
    if not B.tbus_torch_dma_is_registered(p, MIB):
        unregistered = p
        break
assert unregistered is not None
assert dma()["reg_failures"] >= fail0 + 1
# A call through the unregistered block still completes, staged.
ctypes.memset(unregistered, ord("u"), MIB)
st0 = dma()
out = ctypes.create_string_buffer(MIB)
got = ctypes.c_longlong(-1)
rc = B.tbus_torch_device_run_mode(b"xor255", unregistered, MIB, 2, 0, out,
                                  MIB, 30000, ctypes.byref(got))
assert rc == 0 and got.value == MIB
assert out.raw == bytes([ord("u") ^ 0xFF]) * MIB
st = dma()
assert st["h2d_copy_bytes"] - st0["h2d_copy_bytes"] == MIB, st
assert st["donation_misses"] == st0["donation_misses"] + 1, st
tt.fi_set("pjrt_reg_fail", 0)
for p in blocks:
    B.tbus_torch_pool_free(p)
"""


def test_refused_registration_degrades_to_counted_staging():
    _run_child(REG_FAIL_CHILD)


_GEN_SERVER = r'''
import sys, time
sys.path.insert(0, %(root)r)
import tbus_torch as tt
tt.init()
s = tt.Server()

def gen(_body):
    blob = bytearray(b"g" * (1 << 20))
    for i in range(0, len(blob), 4096):
        blob[i] = ord("a") + (i // 4096) %% 26
    return bytes(blob)

s.add_method("X", "Gen", gen)
print(s.start(0), flush=True)
time.sleep(120)
'''

LINK_DEATH_CHILD = r"""
tt.device_enable_dma()
tt.init()
tt.device_init("cpu")
server = subprocess.Popen([sys.executable, "-c", GEN_SERVER],
                          stdout=subprocess.PIPE, text=True)
try:
    port = int(server.stdout.readline())
    inp = ctypes.create_string_buffer(1 << 20)
    n = ctypes.c_longlong(0)
    st0 = dma()
    # Every execution takes 200 ms, and the device reads its input after
    # it: the server dies while the view into its region is in flight.
    os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "200000"
    ticket = B.tbus_torch_device_submit_peer_view(
        f"tpu://127.0.0.1:{port}".encode(), b"X", b"Gen", b"xor255", inp,
        len(inp), ctypes.byref(n))
    assert ticket >= 0, ticket  # -2: the reply was not a peer-region view
    time.sleep(0.05)
    server.kill()
    server.wait()
    out = ctypes.create_string_buffer(1 << 20)
    got = ctypes.c_longlong(-1)
    rc = B.tbus_torch_device_wait(ticket, 30000, out, len(out),
                                  ctypes.byref(got))
    os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "0"
    assert rc == 0 and got.value == n.value > 0, (rc, got.value, n.value)
    want = bytes(b ^ 0xFF for b in inp.raw[:n.value])
    assert out.raw[:n.value] == want
    st = dma()
    # The peer's region was registered on attach and read in place,
    # pinned until the device was done with it.
    assert st["donation_hits"] == st0["donation_hits"] + 1, st
    assert st["h2d_copy_bytes"] == st0["h2d_copy_bytes"], st
    assert st["pins"] == 0, st
finally:
    if server.poll() is None:
        server.kill()
"""


def test_peer_dies_while_the_device_reads_its_region():
    _run_child("GEN_SERVER = " + repr(_GEN_SERVER % {"root": ROOT})
               + "\n" + LINK_DEATH_CHILD)


RAISES_CHILD = r"""
tt.init()  # the block pool is up now
try:
    tt.device_enable_dma()
    raise AssertionError("armed DMA after the pool came up")
except RuntimeError as e:
    assert "already up" in str(e), e
assert not dma()["enabled"]
"""


def test_enable_dma_raises_once_the_pool_is_up():
    _run_child(RAISES_CHILD)


# Device-method calls through the server's runtime, the same for the port
# and the reference (`t` is the package, `stats` its DMA counters): the
# tripwire and hit/miss deltas of every (link, length) pair, as one
# RESULT line.
_CALLS = r"""
import json
s = t.Server()
s.add_device_method("DevSvc", "Xor", "xor255")
s.add_device_method("DevSvc", "Echo", "echo")
port = s.start(0)
KEYS = ("h2d_copy_bytes", "d2h_copy_bytes", "donation_hits",
        "donation_misses", "alias_hits", "alias_misses")
out = {}
for scheme in ("tpu://", ""):
    ch = t.Channel(f"{scheme}127.0.0.1:{port}", timeout_ms=10000)
    for n in (1024, 4096, 5000, 65536, 1 << 20):
        body = bytes((i * 7) & 0xFF for i in range(n))
        st0 = stats()
        for m in ("Xor", "Echo", "Xor", "Echo"):
            got = ch.call("DevSvc", m, body)
            assert got == (bytes(b ^ 255 for b in body) if m == "Xor"
                           else body), (m, n)
        st1 = stats()
        out[f"{scheme}{n}"] = {k: st1[k] - st0[k] for k in KEYS}
s.stop()
print("RESULT " + json.dumps(out), flush=True)
"""

PORT_CALLS_CHILD = r"""
import sys
sys.path.insert(0, %(root)r)
import tbus_torch as t
from tbus_torch import rpc
if %(dma)r:
    t.device_enable_dma()
t.init()
t.device_init("cpu")
stats = rpc.device_dma_stats
assert stats()["enabled"] == %(dma)r
""" + _CALLS + _EPILOGUE

# The reference arms through TBUS_PJRT_DMA=1 in its environment: its
# pjrt_enable_dma() calls tbus_init() first, which brings the block pool
# up, so the pool's first region would be carved before the table is
# armed and never registered.
REFERENCE_CALLS_CHILD = r"""
import sys
sys.path.insert(0, %(root)r)
import tbus as t
t.init()
assert t.pjrt_init()
stats = t.pjrt_dma_stats
assert stats()["enabled"] == %(dma)r
""" + _CALLS + r"""
print("CHILD-OK", flush=True)
"""


def _calls(source, dma, env):
    proc = subprocess.run(
        [sys.executable, "-c", source % {"root": ROOT, "dma": dma}],
        capture_output=True, text=True, timeout=180,
        env=dict(os.environ, **env))
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[0][len("RESULT "):])


@pytest.mark.parametrize("dma", [True, False], ids=["armed", "off"])
def test_device_method_tripwires_match_the_reference(dma):
    port = _calls(PORT_CALLS_CHILD, dma, {"TBUS_PJRT_DMA": "0"})
    ref = _calls(REFERENCE_CALLS_CHILD, dma, {
        "TBUS_PJRT_FAKE": "1", "TBUS_PJRT_DMA": "1" if dma else "0",
        "JAX_PLATFORMS": "cpu"})
    assert port == ref
    if dma:  # the table armed: the 64 KiB and 1 MiB calls stage nothing
        assert port["tpu://65536"]["h2d_copy_bytes"] == 0
        assert port["tpu://1048576"]["donation_hits"] == 4
    else:
        assert all(v["donation_hits"] == 0 and v["alias_hits"] == 0
                   for v in port.values())
