"""Minimal length-prefixed TCP RPC used by the distributed graph service
and the parameter server (port of ``pgl_tpu/distributed/rpc.py``).

The reference's graph engine speaks brpc from C++ (``pgl/distributed/
dist_graph.py:124``); the hosts are trusted peers on a private network, so
a compact numpy-aware protocol over TCP sockets is the host-side transport.
Each request is ``(method, args, kwargs)``; each response ``(ok,
payload)``.

Framing (zero-copy for arrays): numpy arrays are stripped out of the object
tree and replaced by ``_NpRef`` placeholders before pickling, so only the
small skeleton goes through pickle. Array bytes travel as raw trailing
buffers — sent straight from the array's memory (``sendall(memoryview)``,
no serialization copy) and received straight into a preallocated array
(``recv_into``), so neighbor-id and feature payloads cross the wire with a
single kernel→array copy on each side.

    >II       skeleton_len, num_buffers
    skeleton  pickle of the object tree with arrays replaced by _NpRef
    buffers   raw array bytes, concatenated in _NpRef.index order

The skeleton names this module's ``_NpRef``, so unpickling it imports the
port and never ``pgl_tpu`` (which imports jax). A torch tensor is refused
on the wire (``TypeError``): pickled, a CUDA tensor would unpickle onto a
card on the other side. Arrays cross as numpy; the trainer moves them to
its card.
"""

from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
import traceback
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["RpcServer", "RpcClient"]

_HDR = struct.Struct(">II")


class _NpRef:
    """Placeholder for a numpy array lifted out of the pickled skeleton."""

    __slots__ = ("index", "dtype", "shape")

    def __init__(self, index: int, dtype: str, shape: tuple):
        self.index = index
        self.dtype = dtype
        self.shape = shape

    def __reduce__(self):
        return (_NpRef, (self.index, self.dtype, self.shape))


def _strip(obj: Any, bufs: List[np.ndarray]) -> Any:
    """Replace ndarrays with _NpRef placeholders, appending them to bufs."""
    if isinstance(obj, torch.Tensor):
        raise TypeError(
            "a torch tensor cannot cross the RPC wire; send "
            "tensor.detach().cpu().numpy()")
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        # ascontiguousarray would promote 0-d to (1,); 0-d is always contiguous
        arr = obj if obj.flags.c_contiguous else np.ascontiguousarray(obj)
        ref = _NpRef(len(bufs), arr.dtype.str, arr.shape)
        bufs.append(arr)
        return ref
    if isinstance(obj, tuple):
        vals = [_strip(x, bufs) for x in obj]
        # preserve namedtuples (plain tuple(...) would drop the type)
        return type(obj)(*vals) if hasattr(obj, "_fields") \
            else tuple(vals)
    if isinstance(obj, list):
        return [_strip(x, bufs) for x in obj]
    if isinstance(obj, dict):
        return {k: _strip(v, bufs) for k, v in obj.items()}
    return obj


def _fill(obj: Any, arrays: List[np.ndarray]) -> Any:
    """Inverse of _strip: substitute received arrays back into the tree."""
    if isinstance(obj, _NpRef):
        return arrays[obj.index]
    if isinstance(obj, tuple):
        vals = [_fill(x, arrays) for x in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") \
            else tuple(vals)
    if isinstance(obj, list):
        return [_fill(x, arrays) for x in obj]
    if isinstance(obj, dict):
        return {k: _fill(v, arrays) for k, v in obj.items()}
    return obj


def _collect_refs(obj: Any, out: List[_NpRef]) -> None:
    """Gather _NpRefs in deterministic traversal order (== wire order)."""
    if isinstance(obj, _NpRef):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _collect_refs(x, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _collect_refs(v, out)


def _send_msg(sock: socket.socket, obj: Any):
    bufs: List[np.ndarray] = []
    skeleton = pickle.dumps(_strip(obj, bufs),
                            protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(skeleton), len(bufs)) + skeleton)
    for arr in bufs:
        if arr.nbytes:
            sock.sendall(memoryview(arr).cast("B"))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    while view.nbytes:
        n = sock.recv_into(view)
        if not n:
            raise ConnectionError("peer closed")
        view = view[n:]


def _recv_msg(sock: socket.socket) -> Any:
    skel_len, nbufs = _HDR.unpack(_recv_exact(sock, _HDR.size))
    skeleton = pickle.loads(_recv_exact(sock, skel_len))
    if not nbufs:
        return skeleton
    refs: List[_NpRef] = []
    _collect_refs(skeleton, refs)
    arrays: List[np.ndarray] = [None] * nbufs
    for ref in refs:  # traversal order == sender's append order
        arr = np.empty(ref.shape, dtype=np.dtype(ref.dtype))
        if arr.nbytes:
            _recv_into(sock, memoryview(arr).cast("B"))
        arrays[ref.index] = arr
    return _fill(skeleton, arrays)


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def handle(self):
        while True:
            try:
                method, args, kwargs = _recv_msg(self.request)
            except (ConnectionError, EOFError):
                return
            try:
                fn = getattr(self.server.service, method)
                _send_msg(self.request, (True, fn(*args, **kwargs)))
            except Exception:
                _send_msg(self.request, (False, traceback.format_exc()))


class _ThreadedServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class RpcServer:
    """Serves a service object's public methods over TCP."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self._server = _ThreadedServer((host, port), _Handler)
        self._server.service = service
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class RpcClient:
    """Blocking single-connection client (one per worker thread/process).

    Every call runs under a deadline (``timeout`` seconds, overridable
    per-call) so a wedged server raises instead of blocking the trainer
    forever; transport failures are retried ``retries`` times over a fresh
    connection (the request is only retried whole, so methods should be
    idempotent — all graph-engine reads are).
    """

    def __init__(self, address: str, timeout: float = 60.0,
                 retries: int = 2, retry_wait: float = 0.5):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        self._retries = max(int(retries), 0)
        self._retry_wait = retry_wait
        self._sock = socket.create_connection(self._addr, timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def _reconnect(self):
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def call(self, method: str, *args, timeout: float = None,
             retries: int = None, **kwargs):
        """``retries`` overrides the client default per call — pass 0 for
        non-idempotent methods (writes), where a lost reply after the
        server applied the request must not be resent."""
        deadline = timeout if timeout is not None else self._timeout
        n_retries = self._retries if retries is None else max(int(retries),
                                                              0)
        last_err = None
        with self._lock:
            for attempt in range(n_retries + 1):
                try:
                    self._sock.settimeout(deadline)
                    _send_msg(self._sock, (method, args, kwargs))
                    ok, payload = _recv_msg(self._sock)
                    break
                except (ConnectionError, socket.timeout, OSError) as err:
                    last_err = err
                    if attempt == n_retries:
                        raise TimeoutError(
                            f"rpc {method} to {self._addr} failed after "
                            f"{attempt + 1} attempts: {err!r}") from err
                    import time
                    time.sleep(self._retry_wait)
                    self._reconnect()
        if not ok:
            raise RuntimeError(f"remote {method} failed:\n{payload}")
        return payload

    def close(self):
        self._sock.close()
