"""ctypes loader for the native tbus core (cpp/ -> libtbus.so).

The port's own copy of the JAX package's loader: it loads the same
framework-neutral C++ core, builds it on demand with cmake+ninja when it
is missing or stale, and annotates only the C API the port calls. The C
ABI is defined in cpp/capi/tbus_c.h.

Two flavours of the core, from the same sources (core_flavor() says which
one this process loaded):
- "protobuf": the standard cpp/build/libtbus.so (cpp/CMakeLists.txt),
  built where the compiler finds google/protobuf/service.h;
- "protobuf-free": tbus_torch/_build/core/libtbus.so
  (tbus_torch/csrc/core/CMakeLists.txt), built where it does not (the
  H100 machine): protobuf's abstract RPC classes come from
  tbus_torch/csrc/pb_shim and typed protobuf calls fail
  (tbus_torch/csrc/pb_absent.cc).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import List

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPP = os.path.join(_REPO, "cpp")
_BUILD = os.path.join(_CPP, "build")
_LIB = os.path.join(_BUILD, "libtbus.so")
_PORT_CSRC = os.path.join(_REPO, "tbus_torch", "csrc")
_PB_SHIM = os.path.join(_PORT_CSRC, "pb_shim")
_PB_FREE_BUILD = os.path.join(_REPO, "tbus_torch", "_build", "core")
_PB_FREE_LIB = os.path.join(_PB_FREE_BUILD, "libtbus.so")
# Cross-process build lock: pytest-xdist workers and chip_smoke's
# processes may all find the library missing at once.
_LOCK_FILE = os.path.join(_REPO, "tbus_torch", "_build", "core.lock")

_lock = threading.Lock()
_lib = None

# TBUS_LIB points at a prebuilt libtbus.so and skips the cmake/ninja
# staleness build entirely (installs without the toolchain, child
# processes that must share the parent's exact binary).
_ENV_LIB = "TBUS_LIB"

# req arg is c_void_p, NOT c_char_p: ctypes converts c_char_p callback
# args to NUL-truncated bytes, corrupting binary payloads.
HANDLER_FN = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p
)
# Progressive-reader piece callback (tbus_call_progressive): data is a
# c_void_p for the same reason.
PIECE_FN = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t
)


def _stale(lib: str, sources: List[str]) -> bool:
    if not os.path.exists(lib):
        return True
    lib_mtime = os.path.getmtime(lib)
    for top in sources:
        if os.path.isfile(top):
            if os.path.getmtime(top) > lib_mtime:
                return True
            continue
        for root, _dirs, files in os.walk(top):
            if root.startswith(os.path.join(_CPP, "build")):
                continue
            for f in files:
                if f.endswith((".h", ".cc", ".cpp", ".S", ".txt")):
                    if os.path.getmtime(os.path.join(root, f)) > lib_mtime:
                        return True
    return False


def _compiles(header: str) -> bool:
    """Whether the C++ compiler finds `header`."""
    try:
        proc = subprocess.run(
            ["g++", "-x", "c++", "-fsyntax-only", "-"],
            input=f"#include <{header}>\n", capture_output=True, text=True)
    except OSError:
        return False
    return proc.returncode == 0


_has_protobuf = None


def has_protobuf() -> bool:
    """Whether this host can build the standard core (protobuf headers)."""
    global _has_protobuf
    if _has_protobuf is None:
        _has_protobuf = _compiles("google/protobuf/service.h")
    return _has_protobuf


def _build_core(lib: str, sources: List[str], configure: List[str],
                build_dir: str) -> str:
    with _lock:
        if not _stale(lib, sources):
            return lib
        os.makedirs(os.path.dirname(_LOCK_FILE), exist_ok=True)
        with open(_LOCK_FILE, "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if not _stale(lib, sources):  # another process built it
                return lib
            subprocess.run(configure, cwd=_REPO, check=True,
                           capture_output=True, text=True)
            subprocess.run(["ninja", "-C", build_dir, "tbus"], cwd=_REPO,
                           check=True, capture_output=True, text=True)
    return lib


def build() -> str:
    """Builds libtbus.so if needed (the standard core where protobuf's
    headers are found, else the protobuf-free one); returns its path."""
    override = os.environ.get(_ENV_LIB)
    if override:
        return override
    if has_protobuf():
        return _build_core(
            _LIB, [_CPP],
            ["cmake", "-S", _CPP, "-B", _BUILD, "-G", "Ninja",
             "-DCMAKE_BUILD_TYPE=RelWithDebInfo"], _BUILD)
    # The bridges build with `g++` (tbus_torch/kernels/_build.py), so the
    # core does too, whatever CXX says: one compiler's headers on both
    # sides, and its libstdc++ linked as a shared library. (On the H100
    # machine CXX names a GCC that links libstdc++ statically; a core
    # carrying its own copy, loaded into a PyTorch process, crashed on
    # its first LOG of a number.)
    return _build_core(
        _PB_FREE_LIB,
        [_CPP, os.path.join(_PORT_CSRC, "core"), _PB_SHIM,
         os.path.join(_PORT_CSRC, "pb_absent.cc")],
        ["cmake", "-S", os.path.join(_PORT_CSRC, "core"), "-B",
         _PB_FREE_BUILD, "-G", "Ninja", "-DCMAKE_BUILD_TYPE=RelWithDebInfo",
         f"-DCMAKE_CXX_COMPILER={shutil.which('g++') or 'g++'}"],
        _PB_FREE_BUILD)


def core_flavor() -> str:
    """"protobuf" or "protobuf-free": the flavour of the core this process
    loaded (building it if needed)."""
    return ("protobuf-free" if hasattr(lib(), "tbus_core_without_protobuf")
            else "protobuf")


def core_include_flags() -> List[str]:
    """The include path a library linked to the loaded core must be built
    with: the same headers the core was built with."""
    cpp = ["-I", _CPP]
    return (["-I", _PB_SHIM] + cpp if core_flavor() == "protobuf-free"
            else cpp)


def loaded():
    """The CDLL if this process has loaded it already, else None (never
    builds)."""
    with _lock:
        return _lib


def lib() -> ctypes.CDLL:
    """Returns the loaded, signature-annotated CDLL (singleton)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
    path = build()
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(path)
            _annotate(_lib)
        return _lib


def has_symbol(L: ctypes.CDLL, name: str) -> bool:
    """Whether the loaded core exports `name` (a prebuilt core named by
    TBUS_LIB may predate it)."""
    return getattr(L, name, None) is not None


def _annotate(L: ctypes.CDLL) -> None:
    c_void_p, c_char_p, c_int = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    L.tbus_init.argtypes = [c_int]
    L.tbus_init.restype = None
    L.tbus_buf_free.argtypes = [c_char_p]
    L.tbus_buf_free.restype = None

    L.tbus_server_new.argtypes = []
    L.tbus_server_new.restype = c_void_p
    L.tbus_server_add_echo.argtypes = [c_void_p, c_char_p, c_char_p]
    L.tbus_server_add_echo.restype = c_int
    L.tbus_server_add_method.argtypes = [
        c_void_p, c_char_p, c_char_p, HANDLER_FN, c_void_p]
    L.tbus_server_add_method.restype = c_int
    L.tbus_server_start.argtypes = [c_void_p, c_int]
    L.tbus_server_start.restype = c_int
    L.tbus_server_port.argtypes = [c_void_p]
    L.tbus_server_port.restype = c_int
    L.tbus_server_stop.argtypes = [c_void_p]
    L.tbus_server_stop.restype = c_int
    L.tbus_server_free.argtypes = [c_void_p]
    L.tbus_server_free.restype = None
    L.tbus_response_append.argtypes = [c_void_p, c_char_p, ctypes.c_size_t]
    L.tbus_response_append.restype = None
    L.tbus_response_set_error.argtypes = [c_void_p, c_int, c_char_p]
    L.tbus_response_set_error.restype = None

    L.tbus_channel_new2.argtypes = [
        c_char_p, ctypes.c_int64, c_int, c_char_p, c_char_p,
        ctypes.c_uint32, c_char_p]
    L.tbus_channel_new2.restype = c_void_p
    L.tbus_call2.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, ctypes.c_size_t,
        ctypes.c_int64, ctypes.POINTER(c_void_p),
        ctypes.POINTER(ctypes.c_size_t), c_char_p]
    L.tbus_call2.restype = c_int
    L.tbus_channel_free.argtypes = [c_void_p]
    L.tbus_channel_free.restype = None

    L.tbus_pchan_new.argtypes = [c_int]
    L.tbus_pchan_new.restype = c_void_p
    L.tbus_pchan_add.argtypes = [c_void_p, c_char_p]
    L.tbus_pchan_add.restype = c_int
    L.tbus_pchan_eligible.argtypes = [c_void_p]
    L.tbus_pchan_eligible.restype = c_int
    L.tbus_pchan_call.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, ctypes.c_size_t,
        ctypes.c_int64, ctypes.POINTER(c_void_p),
        ctypes.POINTER(ctypes.c_size_t)]
    L.tbus_pchan_call.restype = c_int
    L.tbus_pchan_free.argtypes = [c_void_p]
    L.tbus_pchan_free.restype = None

    L.tbus_partchan_new.argtypes = [c_int, c_char_p, c_char_p, c_int, c_int]
    L.tbus_partchan_new.restype = c_void_p
    L.tbus_partchan_eligible.argtypes = [c_void_p]
    L.tbus_partchan_eligible.restype = c_int
    L.tbus_partchan_call.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, ctypes.c_size_t,
        ctypes.c_int64, ctypes.POINTER(c_void_p),
        ctypes.POINTER(ctypes.c_size_t)]
    L.tbus_partchan_call.restype = c_int
    L.tbus_partchan_free.argtypes = [c_void_p]
    L.tbus_partchan_free.restype = None

    ull, ll, dbl = ctypes.c_ulonglong, ctypes.c_longlong, ctypes.c_double
    L.tbus_stream_create.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, ctypes.c_size_t, ll, c_char_p]
    L.tbus_stream_create.restype = ull
    L.tbus_stream_write.argtypes = [ull, c_char_p, ctypes.c_size_t, ll]
    L.tbus_stream_write.restype = c_int
    L.tbus_stream_read.argtypes = [
        ull, ctypes.POINTER(c_void_p), ctypes.POINTER(ctypes.c_size_t), ll]
    L.tbus_stream_read.restype = c_int
    L.tbus_stream_close.argtypes = [ull]
    L.tbus_stream_close.restype = c_int

    L.tbus_serve_stats_json.argtypes = []
    L.tbus_serve_stats_json.restype = c_void_p
    L.tbus_bench_serve.argtypes = [
        c_char_p, c_char_p, c_char_p, c_int, c_int, ll, ll, dbl, ll,
        *[ctypes.POINTER(dbl)] * 6, *[ctypes.POINTER(ll)] * 4, c_char_p]
    L.tbus_bench_serve.restype = c_int

    L.tbus_advertise_device_method.argtypes = [c_char_p, c_char_p, c_char_p]
    L.tbus_advertise_device_method.restype = None
    L.tbus_set_device_impl_id.argtypes = [c_char_p, c_char_p, c_char_p]
    L.tbus_set_device_impl_id.restype = None

    L.tbus_pjrt_enable_dma.argtypes = []
    L.tbus_pjrt_enable_dma.restype = c_int
    L.tbus_flag_set.argtypes = [c_char_p, c_char_p]
    L.tbus_flag_set.restype = c_int
    L.tbus_var_value.argtypes = [c_char_p]
    L.tbus_var_value.restype = c_void_p
    L.tbus_fi_set.argtypes = [c_char_p, ll, ll, ll]
    L.tbus_fi_set.restype = c_int
    L.tbus_fi_disable_all.argtypes = []
    L.tbus_fi_disable_all.restype = None
    L.tbus_fi_set_seed.argtypes = [ull]
    L.tbus_fi_set_seed.restype = None
    L.tbus_fi_get_seed.argtypes = []
    L.tbus_fi_get_seed.restype = ull
    L.tbus_fi_injected.argtypes = [c_char_p]
    L.tbus_fi_injected.restype = ll
    L.tbus_fi_probe.argtypes = [c_char_p, c_int,
                                ctypes.POINTER(ctypes.c_ubyte)]
    L.tbus_fi_probe.restype = c_int
    L.tbus_fi_dump.argtypes = []
    L.tbus_fi_dump.restype = c_void_p
    L.tbus_flag_get.argtypes = [c_char_p, ctypes.POINTER(ll)]
    L.tbus_flag_get.restype = ll
    L.tbus_flag_domain_json.argtypes = []
    L.tbus_flag_domain_json.restype = c_void_p
    L.tbus_connections_dump.argtypes = []
    L.tbus_connections_dump.restype = c_void_p
    L.tbus_budget_breakdown_json.argtypes = [c_char_p, ctypes.c_size_t]
    L.tbus_budget_breakdown_json.restype = c_void_p

    # Per-stage timing and tracing: rpcz spans, the tpu:// stage clock,
    # mesh-wide span export.
    L.tbus_rpcz_enable.argtypes = [c_int]
    L.tbus_rpcz_enable.restype = None
    for name in ("tbus_rpcz_dump", "tbus_rpcz_dump_json",
                 "tbus_stage_stats_json", "tbus_timeline_dump",
                 "tbus_trace_perfetto_json", "tbus_trace_stats_json"):
        getattr(L, name).argtypes = []
        getattr(L, name).restype = c_void_p
    L.tbus_trace_set_collector.argtypes = [c_char_p]
    L.tbus_trace_set_collector.restype = c_int
    L.tbus_trace_flush.argtypes = []
    L.tbus_trace_flush.restype = c_int
    L.tbus_trace_query_json.argtypes = [c_char_p]
    L.tbus_trace_query_json.restype = c_void_p

    # Transport counters: shm lanes and zero-copy frames, fd loops.
    L.tbus_shm_lanes.argtypes = []
    L.tbus_shm_lanes.restype = c_int
    L.tbus_shm_zero_copy_frames.argtypes = []
    L.tbus_shm_zero_copy_frames.restype = ll
    L.tbus_shm_payload_copy_bytes.argtypes = []
    L.tbus_shm_payload_copy_bytes.restype = ll
    L.tbus_fd_loops.argtypes = []
    L.tbus_fd_loops.restype = c_int
    L.tbus_fd_rtc_max_bytes.argtypes = []
    L.tbus_fd_rtc_max_bytes.restype = ll

    # Server options and mounts beyond echo and Python methods.
    L.tbus_server_add_sleep.argtypes = [c_void_p, c_char_p, c_char_p, ll]
    L.tbus_server_add_sleep.restype = c_int
    L.tbus_server_enable_ssl.argtypes = [c_void_p, c_char_p, c_char_p]
    L.tbus_server_enable_ssl.restype = None
    L.tbus_server_usercode_in_pthread.argtypes = [c_void_p]
    L.tbus_server_usercode_in_pthread.restype = None
    L.tbus_server_set_limiter.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p]
    L.tbus_server_set_limiter.restype = c_int
    L.tbus_server_set_limiter_ex.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, c_char_p]
    L.tbus_server_set_limiter_ex.restype = c_int
    L.tbus_server_enable_trace_sink.argtypes = [c_void_p]
    L.tbus_server_enable_trace_sink.restype = c_int
    L.tbus_server_drain.argtypes = [c_void_p, ll]
    L.tbus_server_drain.restype = c_int
    L.tbus_server_add_stream_sink.argtypes = [
        c_void_p, c_char_p, c_char_p, c_int]
    L.tbus_server_add_stream_sink.restype = c_int
    L.tbus_stream_accept.argtypes = [c_void_p, ll, c_int]
    L.tbus_stream_accept.restype = ull
    L.tbus_call_progressive.argtypes = [
        c_void_p, c_char_p, c_char_p, c_char_p, ctypes.c_size_t, ll,
        PIECE_FN, c_void_p, c_char_p]
    L.tbus_call_progressive.restype = c_int

    # The core's load generators (no Python on their hot loops).
    p_dbl, p_ll = ctypes.POINTER(dbl), ctypes.POINTER(ll)
    L.tbus_bench_echo.argtypes = [
        c_char_p, ctypes.c_size_t, c_int, c_int, *[p_dbl] * 4]
    L.tbus_bench_echo.restype = c_int
    L.tbus_bench_echo_ex.argtypes = [
        c_char_p, ctypes.c_size_t, c_int, c_int, dbl, *[p_dbl] * 5]
    L.tbus_bench_echo_ex.restype = c_int
    if has_symbol(L, "tbus_bench_echo_proto"):
        L.tbus_bench_echo_proto.argtypes = [
            c_char_p, c_char_p, c_char_p, c_char_p, ctypes.c_size_t, c_int,
            c_int, dbl, *[p_dbl] * 5]
        L.tbus_bench_echo_proto.restype = c_int
    L.tbus_bench_echo_overload.argtypes = [
        c_char_p, c_char_p, c_char_p, ctypes.c_size_t, c_int, c_int, dbl,
        ll, *[p_dbl] * 3, *[p_ll] * 4]
    L.tbus_bench_echo_overload.restype = c_int
    L.tbus_bench_stream.argtypes = [
        c_char_p, c_char_p, c_char_p, ll, ll, *[p_dbl] * 3, p_ll, c_char_p]
    L.tbus_bench_stream.restype = c_int
