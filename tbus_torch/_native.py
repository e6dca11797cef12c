"""ctypes loader for the native tbus core (cpp/ -> libtbus.so).

The port's own copy of the JAX package's loader: it loads the same
framework-neutral C++ core, builds it on demand with cmake+ninja when it
is missing or stale, and annotates only the C API the port calls. The C
ABI is defined in cpp/capi/tbus_c.h.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPP = os.path.join(_REPO, "cpp")
_BUILD = os.path.join(_CPP, "build")
_LIB = os.path.join(_BUILD, "libtbus.so")
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


def _stale() -> bool:
    if not os.path.exists(_LIB):
        return True
    lib_mtime = os.path.getmtime(_LIB)
    for root, _dirs, files in os.walk(_CPP):
        if root.startswith(os.path.join(_CPP, "build")):
            continue
        for f in files:
            if f.endswith((".h", ".cc", ".cpp", ".S", ".txt")):
                if os.path.getmtime(os.path.join(root, f)) > lib_mtime:
                    return True
    return False


def build() -> str:
    """Builds libtbus.so if needed; returns its path."""
    override = os.environ.get(_ENV_LIB)
    if override:
        return override
    with _lock:
        if not _stale():
            return _LIB
        os.makedirs(os.path.dirname(_LOCK_FILE), exist_ok=True)
        with open(_LOCK_FILE, "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if not _stale():  # another process built it meanwhile
                return _LIB
            subprocess.run(
                ["cmake", "-B", _BUILD, "-G", "Ninja",
                 "-DCMAKE_BUILD_TYPE=RelWithDebInfo"],
                cwd=_CPP, check=True, capture_output=True, text=True)
            subprocess.run(["ninja", "-C", _BUILD, "tbus"], cwd=_CPP,
                           check=True, capture_output=True, text=True)
    return _LIB


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

    L.tbus_advertise_device_method.argtypes = [c_char_p, c_char_p, c_char_p]
    L.tbus_advertise_device_method.restype = None
    L.tbus_set_device_impl_id.argtypes = [c_char_p, c_char_p, c_char_p]
    L.tbus_set_device_impl_id.restype = None
