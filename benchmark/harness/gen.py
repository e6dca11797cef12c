"""Builds and binds the benchmark's load generator (benchmark/gen/
loadgen.cc) against the tbus core this process has loaded.

The library lands in benchmark/_build/, named by a hash of its source, its
flags and the core it links (path, size and time), so a run in a checkout
builds it once and every later run finds it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import time
from typing import Sequence, Tuple

import numpy as np

from harness.spec import BENCH_DIR

BUILD_DIR = os.path.join(BENCH_DIR, "_build")
SOURCE = os.path.join(BENCH_DIR, "gen", "loadgen.cc")
# The core's own flags (cpp/CMakeLists.txt, RelWithDebInfo): the generator
# shares IOBuf and Channel with libtbus.so, so their layouts must match.
GXX_FLAGS = ["-std=c++17", "-O2", "-g", "-DNDEBUG", "-fPIC", "-shared",
             "-Wall", "-Wextra", "-Wno-unused-parameter"]

_VP, _LL, _I, _D, _CP = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_double, ctypes.c_char_p)
_SIGNATURES = [
    ("lg_new_channel", [_CP, _CP, _CP, _I, _I, _LL, _VP, _LL, _VP, _LL],
     _VP),
    ("lg_new_pchan", [_VP, _I, _CP, _CP, _I, _I, _LL, _VP, _LL, _VP, _LL],
     _VP),
    ("lg_run", [_VP, _LL, _D, _D], _I),
    ("lg_calls", [_VP], _LL),
    ("lg_latencies", [_VP, _VP], None),
    ("lg_summary", [_VP, _VP], None),
    ("lg_free", [_VP], None),
]

_lib = None


def build() -> Tuple[str, float]:
    """The generator's library path, built if missing, and the seconds the
    build took (0 when found)."""
    from tbus_torch import _native

    core = os.path.abspath(_native.build())
    _native.lib()
    flags = GXX_FLAGS + _native.core_include_flags()
    st = os.stat(core)
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update("\0".join(flags + [core, str(st.st_size),
                                str(st.st_mtime_ns)]).encode())
    out = os.path.join(BUILD_DIR, f"libloadgen-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "loadgen.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out, 0.0
        t0 = time.monotonic()
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run(
            ["g++", *flags, "-o", tmp, SOURCE, core,
             f"-Wl,-rpath,{os.path.dirname(core)}", "-lpthread"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the load generator failed:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return out, time.monotonic() - t0


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        L = ctypes.CDLL(path)
        for name, args, res in _SIGNATURES:
            getattr(L, name).argtypes = args
            getattr(L, name).restype = res
        _lib = L
    return _lib


class Result:
    """One run of the loop: every call's latency (ns, -1 a miss), client
    by client, and the counts. Every reply that came was compared byte for
    byte."""

    def __init__(self, latencies_ns: np.ndarray, failed: int, wrong: int,
                 first_error: int, t_start_ns: int, t_end_ns: int) -> None:
        self.latencies_ns = latencies_ns
        self.failed = failed
        self.wrong = wrong
        self.first_error = first_error
        self.t_start_ns = t_start_ns
        self.t_end_ns = t_end_ns

    @property
    def attempted(self) -> int:
        return len(self.latencies_ns)

    @property
    def compared(self) -> int:
        return self.attempted - self.failed

    @property
    def ok(self) -> int:
        return int((self.latencies_ns >= 0).sum())

    def as_dict(self) -> dict:
        return {"attempted": self.attempted, "ok": self.ok,
                "failed": self.failed, "wrong": self.wrong,
                "first_error": self.first_error,
                "t_start_ns": self.t_start_ns, "t_end_ns": self.t_end_ns,
                "compared": self.compared}


class Loop:
    """A generator context: the clients' channels, payloads and the answers
    the reference owes them. Each client calls over a channel to `addr`,
    or, given `subs`, over a combo channel (a ParallelChannel) to those
    addresses, whose merged reply is what `expected` holds. `payloads` and
    `expected` are kept here for as long as the context lives (the C side
    holds their pointers)."""

    def __init__(self, payloads: np.ndarray, expected: np.ndarray,
                 service: str, method: str, timeout_ms: int,
                 addr: str = "", subs: Sequence[str] = ()) -> None:
        if bool(addr) == bool(subs):
            raise ValueError("load generator: give one of addr and subs")
        L = lib()
        self.payloads = np.ascontiguousarray(payloads, dtype=np.uint8)
        self.expected = np.ascontiguousarray(expected, dtype=np.uint8)
        clients, per_client, n = self.payloads.shape
        tail = (service.encode(), method.encode(), clients, per_client,
                timeout_ms, self.payloads.ctypes.data, n,
                self.expected.ctypes.data, self.expected.shape[2])
        if subs:
            addrs = (ctypes.c_char_p * len(subs))(*(a.encode() for a in subs))
            self._h = L.lg_new_pchan(addrs, len(subs), *tail)
        else:
            self._h = L.lg_new_channel(addr.encode(), *tail)
        if not self._h:
            raise RuntimeError(f"load generator: no channel to "
                               f"{addr or ', '.join(subs)}")

    def run(self, calls: int = 0, seconds: float = 0.0,
            rate: float = 0.0) -> Result:
        L = lib()
        if L.lg_run(self._h, calls, seconds, rate) != 0:
            raise RuntimeError("load generator: a client fiber did not start")
        lat = np.empty(L.lg_calls(self._h), dtype=np.int64)
        L.lg_latencies(self._h, lat.ctypes.data)
        s = np.zeros(5, dtype=np.int64)
        L.lg_summary(self._h, s.ctypes.data)
        return Result(lat, *(int(v) for v in s))

    def close(self) -> None:
        if self._h:
            lib().lg_free(self._h)
            self._h = None
