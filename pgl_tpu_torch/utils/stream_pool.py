"""StreamPool: asynchronous host <-> device row staging.

Port of ``pgl_tpu/utils/stream_pool.py``, whose reference is the original
PGL's ``pgl/utils/stream_pool.py:27-80`` (rotating CUDA streams and pinned
buffers for ``async_pull``/``async_push`` of embedding rows, itself from
PyGAS). The JAX version stands ``jax.device_put`` in a thread pool for
them; on a CUDA device this is the original design again:

* each worker thread owns a side ``torch.cuda.Stream`` and a ring of
  ``RING`` pinned host staging buffers, reused only after the event of
  their last copy has completed;
* :meth:`StreamPool.async_pull` gathers the rows into a pinned buffer
  (``np.take(..., out=)`` on its numpy view; a large gather split over
  the process's gather threads), copies it to the device with
  ``non_blocking=True`` on the worker's stream and records an event; the
  future's ``result()`` makes the caller's current stream wait on that
  event before it hands the tensor over;
* :meth:`StreamPool.async_push` records an event on the producer's stream
  first; the worker's copy waits on it, marks the values as used on the
  side stream (``record_stream``, so the caching allocator does not reuse
  their memory early), copies them into a pinned buffer, waits for that
  copy, and scatters on the host.

On ``device="cpu"`` the same code runs with plain copies. A failed
``pin_memory`` raises: the pool never falls back to pageable copies.
"""

from __future__ import annotations

import concurrent.futures as _fut
import contextlib
import os
import threading

import numpy as np
import torch

from .. import resolve_device

__all__ = ["StreamPool", "check_rows", "take_rows"]

# pinned buffers a worker rotates through: a gather fills one while the
# last copy out of the other may still be in flight
RING = 2
# fewest rows a gather thread takes
GATHER_BLOCK = 16384
# host threads a gather is split over: numpy's ``take`` releases the GIL,
# and one thread gathers a few GB/s of random rows
GATHER_THREADS = min(8, os.cpu_count() or 1)

_gather = (None, None)     # (pid, executor): a forked child makes its own
_gather_lock = threading.Lock()


def _gather_executor() -> _fut.ThreadPoolExecutor:
    """The process's gather threads, started on first use."""
    global _gather
    with _gather_lock:
        if _gather[0] != os.getpid():
            _gather = (os.getpid(),
                       _fut.ThreadPoolExecutor(GATHER_THREADS))
        return _gather[1]


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def check_rows(index: np.ndarray, n: int):
    """Raise unless every id of ``index`` lies in ``[-n, n)``."""
    if index.size:
        lo, hi = int(index.min()), int(index.max())
        if lo < -n or hi >= n:
            raise IndexError(f"rows [{lo}, {hi}] of a table of {n}")


def take_rows(host_array, index, out):
    """``out[:] = host_array[index]``, split over ``GATHER_THREADS`` threads
    in blocks of at least ``GATHER_BLOCK`` rows. The caller checks the
    range (:func:`check_rows`): ``mode="wrap"`` writes straight into
    ``out``, where the default mode buffers it (four times slower)."""
    n = len(index)
    parts = min(GATHER_THREADS, n // GATHER_BLOCK)
    if parts < 2:
        np.take(host_array, index, axis=0, out=out, mode="wrap")
        return
    cuts = np.linspace(0, n, parts + 1).astype(np.int64)
    list(_gather_executor().map(
        lambda i: np.take(host_array, index[cuts[i]:cuts[i + 1]], axis=0,
                          out=out[cuts[i]:cuts[i + 1]], mode="wrap"),
        range(parts)))


class _Staging:
    """One worker thread's side stream and staging buffers."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.bufs = [None] * RING
        self.events = [None] * RING
        self.turn = 0

    def take(self, shape, dtype):
        """The next buffer of the ring as ``(slot, tensor, numpy view)`` of
        ``shape`` and numpy ``dtype``, once its last copy has completed;
        grown (pinned on a CUDA device) when too small."""
        slot, self.turn = self.turn, (self.turn + 1) % RING
        if self.events[slot] is not None:
            self.events[slot].synchronize()
            self.events[slot] = None
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        buf = self.bufs[slot]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=self.cuda)
            self.bufs[slot] = buf
        t = buf[:nbytes].view(_torch_dtype(dtype)).view(shape)
        return slot, t, t.numpy()


class _Pulled:
    """The future of a pull. ``result()`` gives the device tensor, once the
    caller's current stream waits on the copy's event."""

    def __init__(self, inner: _fut.Future, cuda: bool):
        self._inner = inner
        self._cuda = cuda

    def result(self, timeout=None) -> torch.Tensor:
        out = self._inner.result(timeout)
        if not self._cuda:
            return out
        tensor, event = out
        stream = torch.cuda.current_stream(tensor.device)
        stream.wait_event(event)
        tensor.record_stream(stream)
        return tensor


class StreamPool:
    """
    Args:
      pool_size: worker threads, each with its side stream and staging
        buffers (transfers in flight at once).
      device: the device rows go to and come from (default: the CUDA card;
        raises without one unless ``"cpu"``).
    """

    def __init__(self, pool_size: int = 2, device=None):
        self.device = resolve_device(device)
        self._pool = _fut.ThreadPoolExecutor(max_workers=pool_size)
        self._local = threading.local()
        self._pending = []

    def _staging(self) -> _Staging:
        st = getattr(self._local, "staging", None)
        if st is None:
            st = self._local.staging = _Staging(self.device)
        return st

    def _submit(self, fn, *args, **kwargs) -> _fut.Future:
        # a finished transfer leaves the list unless it failed: a pull's
        # future holds its tensor, which must not outlive the caller's use
        self._pending = [f for f in self._pending
                         if not f.done() or f.exception() is not None]
        fut = self._pool.submit(fn, *args, **kwargs)
        self._pending.append(fut)
        return fut

    # -- host -> device ------------------------------------------------------

    def async_pull(self, host_array: np.ndarray, index=None,
                   lock=None) -> _Pulled:
        """Gather ``host_array[index]`` (the whole array when ``index`` is
        None) and send it to the device asynchronously; ``lock`` is held
        around the host gather. Returns a future of the device tensor."""
        index = None if index is None else np.asarray(index)
        if index is not None:
            check_rows(index, host_array.shape[0])

        def work():
            st = self._staging()
            n = host_array.shape[0] if index is None else len(index)
            shape = (n,) + tuple(host_array.shape[1:])
            slot, t, view = st.take(shape, host_array.dtype)
            with lock or contextlib.nullcontext():
                if index is None:
                    np.copyto(view, host_array)
                else:
                    take_rows(host_array, index, view)
            if not st.cuda:
                return t.clone()
            with torch.cuda.stream(st.stream):
                rows = torch.empty(shape, dtype=t.dtype, device=self.device)
                rows.copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(st.stream)
            st.events[slot] = event
            return rows, event

        return _Pulled(self._submit(work), self.device.type == "cuda")

    # -- device -> host ------------------------------------------------------

    def async_push(self, host_array: np.ndarray, index, values,
                   lock=None) -> _fut.Future:
        """Scatter ``values`` (a tensor on the pool's device, or host rows)
        into ``host_array[index]`` asynchronously (``index`` may be a
        slice); ``lock`` is held around the host scatter."""
        if not isinstance(index, slice):
            index = np.asarray(index)
        on_card = (isinstance(values, torch.Tensor)
                   and values.device.type == "cuda")
        ready = None
        if on_card:
            values = values.detach()
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(values.device))

        def work():
            if on_card:
                st = self._staging()
                slot, t, rows = st.take(tuple(values.shape),
                                        host_array.dtype)
                with torch.cuda.stream(st.stream):
                    st.stream.wait_event(ready)
                    values.record_stream(st.stream)
                    t.copy_(values, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(st.stream)
                done.synchronize()
            elif isinstance(values, torch.Tensor):
                rows = values.detach().numpy()
            else:
                rows = np.asarray(values)
            with lock or contextlib.nullcontext():
                host_array[index] = rows
            return True

        return self._submit(work)

    # -- generic -------------------------------------------------------------

    def submit(self, fn, *args, **kwargs) -> _fut.Future:
        """Queue any callable on the pool (tracked by :meth:`synchronize`
        like the built-in pull and push)."""
        return self._submit(fn, *args, **kwargs)

    def synchronize(self):
        """Wait for every queued transfer (reference ``sync_push``); raises
        the first failure."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self):
        try:
            self.synchronize()
        finally:
            self._pool.shutdown()
