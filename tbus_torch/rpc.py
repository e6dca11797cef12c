"""Pythonic wrappers over the native tbus core, for the PyTorch port.

The port's own subset of tbus/rpc.py: servers, channels and the
ParallelChannel whose all-tpu:// fan-outs lower onto the port's runtime
once :func:`enable_torch_fanout` has installed the C++ bridge
(tbus_torch/csrc/torch_fanout.cc). Server handlers registered from
Python run inside fibers on the native worker fleet; ctypes re-acquires
the GIL per callback.
"""

from __future__ import annotations

import ctypes
import threading
import traceback
from typing import Callable

from tbus_torch import _native


class RpcError(Exception):
    def __init__(self, code: int, text: str):
        super().__init__(f"rpc error {code}: {text}")
        self.code = code
        self.text = text


def init(nworkers: int = 0) -> None:
    _native.lib().tbus_init(nworkers)


# ---- the torch collective fan-out backend ----

# The bridge's run callback: int run(void* batch).
_RUN_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
_enable_lock = threading.Lock()
_run_cb = None  # keepalive: the bridge holds this pointer for good


def _bridge() -> ctypes.CDLL:
    from tbus_torch.kernels import _build

    return _build.fanout_bridge_lib()


def _run_batch(batch: int) -> int:
    """Serves one executor batch (runs on the bridge's executor thread,
    under the GIL): reads the queued calls, runs them through the runtime,
    writes every peer's response back."""
    from tbus_torch.parallel import runtime

    B = _bridge()
    try:
        size = B.tbus_torch_batch_size(batch)
        service = B.tbus_torch_batch_service(batch).decode()
        method = B.tbus_torch_batch_method(batch).decode()
        n_peers = B.tbus_torch_batch_n_peers(batch)
        timeout_ms = B.tbus_torch_batch_timeout_ms(batch)
        all_local = bool(B.tbus_torch_batch_all_local(batch))
        payloads = []
        for b in range(size):
            data = ctypes.c_void_p()
            n = B.tbus_torch_batch_payload(batch, b, ctypes.byref(data))
            payloads.append(ctypes.string_at(data.value, n) if n > 0
                            else b"")
        if size == 1:
            results = [runtime.broadcast_gather(
                service, method, payloads[0], n_peers, timeout_ms,
                all_local)]
        else:
            results = runtime.broadcast_gather_batch(
                service, method, payloads, n_peers, timeout_ms, all_local)
        for b, per_peer in enumerate(results):
            if len(per_peer) != n_peers:
                continue  # bad arity: the job stays failed
            for i, r in enumerate(per_peer):
                B.tbus_torch_batch_set_response(batch, b, i, r, len(r))
            B.tbus_torch_batch_done(batch, b)
        return 0
    except Exception:  # the executor must keep serving: report, fail jobs
        traceback.print_exc()
        return -1


def enable_torch_fanout() -> bool:
    """Installs the PyTorch collective backend for ParallelChannel fan-out
    (builds the bridge on first use). Selection order native -> torch ->
    p2p: an installed native backend is never displaced."""
    from tbus_torch.parallel import runtime

    global _run_cb
    bridge = _bridge()
    runtime.sync_native()  # methods registered before the core loaded
    with _enable_lock:
        if _run_cb is None:
            _run_cb = _RUN_FN(_run_batch)
    return bridge.tbus_torch_fanout_enable(_run_cb) == 0


def torch_lowered_calls() -> int:
    """Calls the torch backend has served (a fused batch counts each)."""
    return _bridge().tbus_torch_fanout_lowered_calls()


def register_device_echo(service: str, method: str) -> bool:
    """Marks a method as device-lowerable with identity (echo) semantics
    AND advertises it (for processes that are both client and servers).
    Only registered methods lower; unregistered ones always take the p2p
    path (the collective never contacts the remote servers)."""
    if not register_device_method(service, method, "echo", "echo/v1"):
        return False
    advertise_device_method(service, method, "echo/v1")
    return True


def register_device_method(service: str, method: str, builtin: str,
                           impl_id: str) -> bool:
    """CLIENT half of the lowering contract: registers a named builtin
    device transform ("echo", "xor255", "add_peer_index" — see
    tbus_torch.parallel.runtime.BUILTINS) for the method under `impl_id`.
    Lowering additionally requires every peer's server to have advertised
    the same impl id (advertise_device_method) during its transport
    handshake — a mismatched peer forces the p2p path."""
    from tbus_torch.parallel import runtime

    _native.lib()  # loaded first, so the registration reaches CanLower
    try:
        runtime.register_builtin(service, method, builtin, impl_id)
    except KeyError:
        return False
    return True


def advertise_device_method(service: str, method: str,
                            impl_id: str) -> None:
    """SERVER half: declare that this process's servers implement the
    method with device twin `impl_id`. Call BEFORE starting servers (the
    advertisement rides the tpu:// transport handshake)."""
    _native.lib().tbus_advertise_device_method(
        service.encode(), method.encode(), impl_id.encode())


# Server-handler twins of runtime.BUILTINS: handlers a server can mount so
# its p2p behavior is byte-identical to the lowered device transform.
def builtin_handler(builtin: str, peer_index: int = 0):
    if builtin == "echo":
        return lambda body: body
    if builtin == "xor255":
        return lambda body: bytes(b ^ 0xFF for b in body)
    if builtin == "add_peer_index":
        return lambda body: bytes((b + peer_index) & 0xFF for b in body)
    raise KeyError(f"unknown builtin {builtin!r}")


class ParallelChannel:
    """Fan one call out to N sub-channels; all-tpu:// fan-outs lower to a
    single device execution when the torch backend is enabled."""

    def __init__(self, fail_limit: int = 0) -> None:
        self._L = _native.lib()
        self._L.tbus_init(0)
        self._h = self._L.tbus_pchan_new(fail_limit)

    def add(self, addr: str) -> None:
        if self._L.tbus_pchan_add(self._h, addr.encode()) != 0:
            raise RuntimeError(f"pchan add failed: {addr}")

    @property
    def collective_eligible(self) -> bool:
        return bool(self._L.tbus_pchan_eligible(self._h))

    def call(self, service: str, method: str, payload: bytes,
             timeout_ms: int = 10000) -> bytes:
        out = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        rc = self._L.tbus_pchan_call(
            self._h, service.encode(), method.encode(), payload,
            len(payload), timeout_ms, ctypes.byref(out),
            ctypes.byref(out_len))
        if rc != 0:
            raise RpcError(rc, "parallel call failed")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._L.tbus_buf_free(ctypes.cast(out, ctypes.c_char_p))

    def __del__(self):
        try:
            self._L.tbus_pchan_free(self._h)
        except Exception:
            pass


class Server:
    """A tbus RPC server bound to a TCP port (0 = ephemeral)."""

    def __init__(self) -> None:
        self._L = _native.lib()
        self._L.tbus_init(0)
        self._h = self._L.tbus_server_new()
        self._callbacks = []  # keepalive for CFUNCTYPE thunks
        self._running = False

    def add_echo(self, service: str = "EchoService",
                 method: str = "Echo") -> None:
        rc = self._L.tbus_server_add_echo(
            self._h, service.encode(), method.encode())
        if rc != 0:
            raise RuntimeError(f"add_echo failed: {rc}")

    def add_method(self, service: str, method: str,
                   fn: Callable[[bytes], bytes]) -> None:
        L = self._L

        @_native.HANDLER_FN
        def thunk(_user, req, req_len, resp_ctx):
            try:
                body = ctypes.string_at(req, req_len) if req_len else b""
                out = fn(body)
                if out:
                    L.tbus_response_append(resp_ctx, out, len(out))
            except RpcError as e:
                L.tbus_response_set_error(resp_ctx, e.code, e.text.encode())
            except Exception as e:  # handler bug -> internal error
                L.tbus_response_set_error(resp_ctx, 2001, str(e).encode())

        self._callbacks.append(thunk)
        rc = L.tbus_server_add_method(
            self._h, service.encode(), method.encode(), thunk, None)
        if rc != 0:
            raise RuntimeError(f"add_method failed: {rc}")

    def start(self, port: int = 0) -> int:
        rc = self._L.tbus_server_start(self._h, port)
        if rc != 0:
            raise RuntimeError(f"server start failed: {rc}")
        self._running = True
        return self.port

    @property
    def port(self) -> int:
        return self._L.tbus_server_port(self._h)

    def stop(self) -> None:
        if self._running:
            self._L.tbus_server_stop(self._h)
            self._running = False

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __del__(self) -> None:
        try:
            self.stop()
            self._L.tbus_server_free(self._h)
        except Exception:
            pass


class Channel:
    """Client stub for one target address ("host:port", "tpu://..."),
    with the core's default protocol and connection type."""

    def __init__(self, addr: str, timeout_ms: int = 500,
                 max_retry: int = 3) -> None:
        self._L = _native.lib()
        self._L.tbus_init(0)
        self._h = self._L.tbus_channel_new2(
            addr.encode(), timeout_ms, max_retry, b"", b"", 0, b"")
        if not self._h:
            raise RuntimeError(f"channel init failed for {addr!r}")

    def call(self, service: str, method: str, request: bytes,
             timeout_ms: int = 0) -> bytes:
        """One synchronous RPC. timeout_ms > 0 overrides the channel's
        default deadline for this call only."""
        resp = ctypes.c_void_p()
        resp_len = ctypes.c_size_t()
        err = ctypes.create_string_buffer(256)
        rc = self._L.tbus_call2(
            self._h, service.encode(), method.encode(), request,
            len(request), timeout_ms, ctypes.byref(resp),
            ctypes.byref(resp_len), err)
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        try:
            return ctypes.string_at(resp.value, resp_len.value) \
                if resp_len.value else b""
        finally:
            self._L.tbus_buf_free(ctypes.cast(resp, ctypes.c_char_p))

    def __del__(self) -> None:
        try:
            self._L.tbus_channel_free(self._h)
        except Exception:
            pass
