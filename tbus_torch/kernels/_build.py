"""Builds the port's native pieces at first use into tbus_torch/_build/.

- the CUDA kernels, one ``nvcc`` per source: ``row_transform.cu``,
  ``gemm_bf16.cu`` (K1, K2), ``ring_fold.cu`` (K3) and
  ``device_programs.cu`` (K4-K7), each into its own ``lib<name>.so`` with
  a plain C interface, loaded with ctypes (seconds to build;
  :func:`build_kernels` starts them all together);
- the device runtime's CUDA backend: ``nvcc`` -> ``libcuda_backend.so``
  (``cuda_backend.cu``), linked to ``libdevice_programs.so``;
- the two bridges to the C++ core, ``g++`` against its ``libtbus.so`` with
  the headers that core was built with (no CUDA): the fan-out bridge
  ``libtbus_torch_fanout.so`` and the device runtime with its mounts
  ``libtbus_torch_device.so`` (``cuda_runtime.cc``, ``cuda_fanout.cc``,
  ``serve_engine.cc``, ``device_bridge.cc``);
- the C++ core itself, through :func:`tbus_torch._native.build`, when it is
  missing (the protobuf-free flavour where protobuf's headers are absent).

Each output's file name carries a hash of its sources and flags (for a
kernel, the ``.cu`` and every local header it includes), so a changed
source or header builds anew and a stale library is never loaded. Builds
are safe when several processes (pytest-xdist workers) race: a file lock
serialises them, and the kernel and bridge libraries appear by an atomic
rename.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Tuple

from tbus_torch import _native

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Wall seconds of each build this process ran (name -> seconds); a
# library found already built costs 0.
build_seconds: Dict[str, float] = {}
# The compiler's report of each build this process ran (name -> stderr):
# with -Xptxas=-v, every kernel's registers, shared memory and spills.
# Every build also keeps it beside its output, as <output>.log.
build_logs: Dict[str, str] = {}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# The core's own flags (cpp/CMakeLists.txt, RelWithDebInfo): the bridge
# shares IOBuf and friends with libtbus.so, so their layouts must match.
GXX_FLAGS = ["-std=c++17", "-O2", "-g", "-DNDEBUG", "-fPIC", "-shared",
             "-Wall", "-Wextra", "-Wno-unused-parameter"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(paths: List[str], flags: List[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def _build(name: str, out_name: str, cmd_for: Callable[[str], List[str]],
           key: Tuple[List[str], List[str]]) -> str:
    """Runs cmd_for(tmp_path) under the build lock unless the hashed
    output exists; returns the output path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem, ext = os.path.splitext(out_name)
    out = os.path.join(BUILD_DIR, f"{stem}-{_digest(*key)}{ext}")
    if os.path.exists(out):
        return out
    with open(os.path.join(BUILD_DIR, f"{stem}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.tmp{os.getpid()}"
        t0 = time.monotonic()
        proc = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed:\n{proc.stdout}\n{proc.stderr}")
        with open(f"{out}.log", "w") as f:  # before out: a cached out
            f.write(proc.stderr)            # always has its report
        os.replace(tmp, out)
        build_seconds[name] = time.monotonic() - t0
        build_logs[name] = proc.stderr
    return out


def _load(name: str, path: str,
          signatures: List[Tuple[str, list, object]]) -> ctypes.CDLL:
    """Loads `path` once, sets each (function, argtypes, restype), and
    only then publishes it to the fast path."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            for fn, args, res in signatures:
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _loaded[name] = lib
        return lib


def core() -> str:
    """Path of the C++ core's libtbus.so, built if missing or stale."""
    try:
        return _native.build()
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building libtbus.so failed: {e.cmd[:2]}\n"
                           f"{e.stdout}\n{e.stderr}") from e


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def cuda_sources(name: str, csrc: str = _CSRC) -> List[str]:
    """csrc/<name>.cu and the local headers it includes ("..."), with
    theirs in turn: what the build of lib<name>.so depends on."""
    todo, seen = [os.path.join(csrc, f"{name}.cu")], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path) as f:
            text = f.read()
        todo += [os.path.join(os.path.dirname(path), inc)
                 for inc in _INCLUDE.findall(text)
                 if os.path.exists(os.path.join(os.path.dirname(path), inc))]
    return seen


def cuda_digest(name: str, csrc: str = _CSRC) -> str:
    """The hash in lib<name>.so's file name: its sources and NVCC_FLAGS."""
    return _digest(cuda_sources(name, csrc), NVCC_FLAGS)


def _cuda_lib(name: str, signatures: List[Tuple[str, list, object]]
              ) -> ctypes.CDLL:
    """csrc/<name>.cu built with nvcc into lib<name>.so at first use."""
    lib = _loaded.get(name)  # the per-launch fast path
    if lib is not None:
        return lib
    srcs = cuda_sources(name)
    path = _build(name, f"lib{name}.so",
                  lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, srcs[0]],
                  (srcs, NVCC_FLAGS))
    return _load(name, path, signatures)


def _sass_sections(lib_path: str) -> Dict[str, str]:
    """Each kernel's SASS in lib_path (mangled name -> text), from
    cuobjdump beside nvcc."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True)
    out: Dict[str, str] = {}
    for part in proc.stdout.split("Function : ")[1:]:
        head, _, body = part.partition("\n")
        out[head.strip()] = body
    return out


def gemm_sass(name: str, kernel: str = "gemm_sm90_kernel"
              ) -> Dict[str, Dict[str, int]]:
    """For each kernel of lib<name>.so (built and loaded) whose name holds
    `kernel`: how many HGMMA (wgmma) and HMMA (mma.sync) instructions its
    SASS has."""
    lib = _loaded.get(name)
    if lib is None:
        raise RuntimeError(f"lib{name}.so is not loaded")
    return {fn: {"HGMMA": len(re.findall(r"\bHGMMA\.", body)),
                 "HMMA": len(re.findall(r"\bHMMA\.", body))}
            for fn, body in _sass_sections(lib._name).items()
            if kernel in fn}


def ptxas_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel of lib<name>.so (built and
    loaded) from its build's -Xptxas=-v report, kept beside the library,
    whether this process built it or found it built."""
    lib = _loaded.get(name)
    if lib is None:
        raise RuntimeError(f"lib{name}.so is not loaded")
    try:
        with open(f"{lib._name}.log") as f:
            return parse_ptxas(f.read())
    except FileNotFoundError:
        raise RuntimeError(f"no build report beside {lib._name}") from None


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Each kernel's registers and spill bytes in a -Xptxas=-v report."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)


def row_transform_lib() -> ctypes.CDLL:
    """The row-transform kernel (csrc/row_transform.cu)."""
    return _cuda_lib("row_transform", [
        ("tbus_row_transform", [_VP, _VP, _LL, _LL, _I, _I, _I, _VP], _I)])


def gemm_lib() -> ctypes.CDLL:
    """The fan-out step's K1 and K2 (csrc/gemm_bf16.cu)."""
    return _cuda_lib("gemm_bf16", [
        ("tbus_gemm_padded", [_LL, _LL, _LL, ctypes.POINTER(_LL)], None),
        ("tbus_matmul_bf16_f32", [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _LL,
                                  _LL, _LL, _I, _I, _VP], _I),
        ("tbus_dw_f32_bf16", [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _LL, _LL,
                              _LL, _I, _VP], _I)])


def ring_fold_lib() -> ctypes.CDLL:
    """Ring attention's fold, K3 (csrc/ring_fold.cu)."""
    return _cuda_lib("ring_fold", [
        ("tbus_ring_fold_scratch_bytes", [_I, _I, _I, _I], _LL),
        ("tbus_ring_fold",
         [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F,
          _I, _VP], _I)])


def device_programs_lib() -> ctypes.CDLL:
    """The device plane's programs, K4-K7 (csrc/device_programs.cu)."""
    return _cuda_lib("device_programs", [
        ("tbus_u8_transform", [_VP, _VP, _LL, _I, _VP], _I),
        ("tbus_u8_transform_v1", [_VP, _VP, _LL, _I, _VP], _I),
        ("tbus_k4_floor_empty", [_LL, _VP], _I),
        ("tbus_k4_floor_copy16", [_VP, _VP, _LL, _VP], _I),
        ("tbus_dot128_weight_bytes", [], _LL),
        ("tbus_dot128_weight", [_VP, _VP], _I),
        ("tbus_dot128", [_VP, _VP, _LL, _VP, _VP], _I),
        ("tbus_dot128_v1", [_VP, _VP, _LL, _VP], _I),
        ("tbus_dotbench_padded", [_LL], _LL),
        ("tbus_dotbench_partial_bytes", [], _LL),
        ("tbus_dotbench",
         [_VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _F, _VP], _I),
        ("tbus_fanout", [_VP, _VP, _LL, _LL, _I, _I, _VP], _I)])


def cuda_backend() -> str:
    """Path of the device runtime's CUDA backend (csrc/cuda_backend.cu),
    built with nvcc and linked to libdevice_programs.so; the runtime
    loads it itself (CudaRuntime::Init("cuda"))."""
    programs = device_programs_lib()._name
    src = os.path.join(_CSRC, "cuda_backend.cu")
    link = [programs, "-Xlinker", "-rpath", "-Xlinker",
            os.path.dirname(programs)]
    return _build("cuda_backend", "libcuda_backend.so",
                  lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, src, *link],
                  ([src], NVCC_FLAGS + [programs]))


def build_kernels() -> None:
    """Builds every kernel library at once, one nvcc per source (the
    device runtime's backend right after its kernels)."""
    libs = (row_transform_lib, gemm_lib, ring_fold_lib, cuda_backend)
    errors: List[BaseException] = []

    def run(fn: Callable[[], ctypes.CDLL]) -> None:
        try:
            fn()
        except (RuntimeError, OSError) as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def fanout_bridge_lib() -> ctypes.CDLL:
    """The C++ CollectiveFanout bridge, built with g++ against the core.

    Loaded after libtbus.so (through _native.lib()), so the dynamic
    loader binds the bridge's NEEDED libtbus.so to that same instance:
    one collective-fan-out registry, one device registry."""
    lib = _loaded.get("torch_fanout")  # the per-call fast path
    if lib is not None:
        return lib
    src = os.path.join(_CSRC, "torch_fanout.cc")
    hdrs = [os.path.join(_REPO, "cpp", p) for p in (
        "rpc/fanout_hooks.h", "tpu/device_registry.h", "tpu/native_fanout.h",
        "base/iobuf.h", "fiber/sync.h")]
    path = _core_bridge("torch_fanout", "libtbus_torch_fanout.so", [src],
                        hdrs)
    vp, ll, i, cp = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_char_p)
    return _load("torch_fanout", path, [
        ("tbus_torch_fanout_enable", [vp], i),
        ("tbus_torch_fanout_lowered_calls", [], ctypes.c_long),
        ("tbus_torch_batch_size", [vp], i),
        ("tbus_torch_batch_service", [vp], cp),
        ("tbus_torch_batch_method", [vp], cp),
        ("tbus_torch_batch_n_peers", [vp], ll),
        ("tbus_torch_batch_timeout_ms", [vp], ll),
        ("tbus_torch_batch_all_local", [vp], i),
        ("tbus_torch_batch_payload", [vp, i, ctypes.POINTER(vp)], ll),
        ("tbus_torch_batch_set_response", [vp, i, ll, cp, ll], i),
        ("tbus_torch_batch_done", [vp, i], i)])


def _core_bridge(name: str, out_name: str, srcs: List[str],
                 hdrs: List[str]) -> str:
    """g++ builds `srcs` into a library linked to the loaded core, with
    the include path that core was built with. Loaded after libtbus.so
    (through _native.lib()), so the dynamic loader binds the bridge's
    NEEDED libtbus.so to that same instance: one registry of each kind."""
    core_lib = os.path.abspath(core())
    _native.lib()
    flags = GXX_FLAGS + _native.core_include_flags()
    link = [core_lib, f"-Wl,-rpath,{os.path.dirname(core_lib)}", "-lpthread",
            "-ldl"]
    return _build(name, out_name,
                  lambda tmp: ["g++", *flags, "-o", tmp, *srcs, *link],
                  (srcs + hdrs, flags + [core_lib]))


def device_bridge_lib() -> ctypes.CDLL:
    """The device runtime, its collective fan-out engine and its server
    mounts (csrc/cuda_runtime.cc, cuda_fanout.cc, serve_engine.cc,
    device_bridge.cc), built with g++ against the core."""
    lib = _loaded.get("torch_device")
    if lib is not None:
        return lib
    srcs = [os.path.join(_CSRC, f) for f in (
        "cuda_runtime.cc", "cuda_fanout.cc", "serve_engine.cc",
        "device_bridge.cc")]
    hdrs = [os.path.join(_CSRC, f) for f in (
        "cuda_runtime.h", "cuda_fanout.h", "serve_engine.h")] + [
        os.path.join(_REPO, "cpp", p) for p in (
            "rpc/serve_batch.h", "rpc/server.h", "rpc/stream.h",
            "rpc/fanout_hooks.h", "rpc/transport_hooks.h",
            "base/iobuf.h", "fiber/sync.h",
            "tpu/pjrt_dma.h", "tpu/block_pool.h", "tpu/device_registry.h",
            "tpu/native_fanout.h", "tpu/tpu_endpoint.h")]
    path = _core_bridge("torch_device", "libtbus_torch_device.so", srcs, hdrs)
    vp, ll, i, cp = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_char_p)
    pll, pd = ctypes.POINTER(ll), ctypes.POINTER(ctypes.c_double)
    return _load("torch_device", path, [
        ("tbus_torch_device_init", [cp, cp, cp, i], i),
        ("tbus_torch_device_available", [], i),
        ("tbus_torch_device_stats_json", [], vp),
        ("tbus_torch_device_reset_launches", [], None),
        ("tbus_torch_server_add_device_method", [vp, cp, cp, cp], i),
        ("tbus_torch_server_add_generate_method",
         [vp, cp, cp, cp, ll, ll, i, ll, cp], i),
        ("tbus_torch_serve_engines_json", [], vp),
        ("tbus_torch_device_burst", [cp, ll, i, ctypes.POINTER(i)], i),
        ("tbus_torch_block_pool_enabled", [], i),
        ("tbus_torch_dma_stats_json", [], vp),
        ("tbus_torch_dma_register_range", [vp, ll], i),
        ("tbus_torch_dma_unregister", [vp], i),
        ("tbus_torch_dma_is_registered", [vp, ll], i),
        ("tbus_torch_dma_region_count", [], ll),
        ("tbus_torch_shm_links_json", [], vp),
        ("tbus_torch_dma_pin", [vp, ll], i),
        ("tbus_torch_dma_unpin", [i], None),
        ("tbus_torch_pool_alloc", [ll], vp),
        ("tbus_torch_pool_free", [vp], None),
        ("tbus_torch_device_run_mode",
         [cp, vp, ll, i, i, vp, ll, ll, pll], i),
        ("tbus_torch_device_run_fanout",
         [i, ll, ll, i, cp, ll, vp, ll], i),
        ("tbus_torch_device_submit_peer_view",
         [cp, cp, cp, cp, vp, ll, pll], i),
        ("tbus_torch_device_wait", [i, ll, vp, ll, pll], i),
        ("tbus_torch_cuda_fanout_enable", [], i),
        ("tbus_torch_cuda_fanout_installed", [], i),
        ("tbus_torch_cuda_fanout_register", [cp, cp, cp, cp], i),
        ("tbus_torch_cuda_fanout_register_echo", [cp, cp], i),
        ("tbus_torch_cuda_fanout_lowered_calls", [], ctypes.c_long),
        ("tbus_torch_cuda_fanout_reset_for_test", [], None),
        ("tbus_torch_cuda_fanout_stats_json", [], vp),
        ("tbus_torch_fanout_step_stats_json", [], vp),
        ("tbus_torch_server_add_device_stream_sink", [vp, cp, cp, cp, i], i),
        ("tbus_torch_stream_sink_stats_json", [], vp),
        ("tbus_torch_bench_device_stream",
         [cp, cp, cp, ll, ll, cp, pd, pd, pd, pll, cp], i)])
