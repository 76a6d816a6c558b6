"""SharedEmbedding — mmap-backed embedding table with an asynchronous
adagrad updater process.

The port's own copy of ``pgl_tpu/utils/shared_embedding.py``, numpy only.
The updater is a spawned process, not a forked one, so it inherits no CUDA
context from a parent that trains on the card, and it makes no CUDA call
(importing the package imports torch, which starts no context).

Capability parity with the reference ``pgl/utils/shared_embedding.py``
(mmap weight+moment arrays ``:62-64``, spawn-process updater consuming an
(index, grad) queue ``:49-80``): tables larger than device HBM live in host
RAM / on disk; training pulls rows to device, pushes sparse grads to the
updater, and the updater applies adagrad off the critical path — the
host-side half of the Graph4KG "mix_cpu_gpu" embedding scheme.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["SharedEmbedding"]

_STOP = "__STOP__"


def _stop_updater(state):
    proc = state.get("proc")
    if proc is None:
        return
    if proc.is_alive():
        state["queue"].put(_STOP)
    proc.join()
    state["proc"] = None


def _updater_loop(weight_path, moment_path, shape, lr, queue):
    import traceback
    try:
        weight = np.load(weight_path, mmap_mode="r+")
        moment = np.load(moment_path, mmap_mode="r+")
        while True:
            item = queue.get()
            if isinstance(item, str) and item == _STOP:
                weight.flush()
                moment.flush()
                return
            index, grad = item
            # adagrad: G += g^2 ; w -= lr * g / sqrt(G + eps)
            g2 = grad * grad
            np.add.at(moment, index, g2)
            denom = np.sqrt(moment[index] + 1e-10)
            np.add.at(weight, index, -lr * grad / denom)
    except BaseException:
        # died abnormally: print so the parent's liveness check in push()
        # has a traceback to point at
        traceback.print_exc()
        raise


class SharedEmbedding:
    """
    Args:
      num_embeddings / embedding_dim: table shape.
      path: directory for the mmap ``weight.npy`` / ``moment.npy`` files.
      lr: adagrad learning rate.
      init_scale: uniform init range (ignored when files already exist).
    """

    def __init__(self, num_embeddings: int, embedding_dim: int, path: str,
                 lr: float = 0.1, init_scale: Optional[float] = None,
                 seed: int = 0):
        os.makedirs(path, exist_ok=True)
        self.shape = (num_embeddings, embedding_dim)
        self.lr = lr
        self.weight_path = os.path.join(path, "weight.npy")
        self.moment_path = os.path.join(path, "moment.npy")
        if not os.path.exists(self.weight_path):
            scale = init_scale if init_scale is not None \
                else 1.0 / np.sqrt(embedding_dim)
            rng = np.random.default_rng(seed)
            np.save(self.weight_path,
                    rng.uniform(-scale, scale, self.shape).astype(np.float32))
        if not os.path.exists(self.moment_path):
            np.save(self.moment_path, np.zeros(self.shape, np.float32))
        self.weight = np.load(self.weight_path, mmap_mode="r+")
        if self.weight.shape != self.shape \
                or self.weight.dtype != np.float32:
            raise ValueError(
                f"existing {self.weight_path} has shape "
                f"{self.weight.shape} dtype {self.weight.dtype}, "
                f"requested {self.shape} float32 — delete the directory "
                "or match the stored table")
        self.moment = np.load(self.moment_path, mmap_mode="r+")
        # updater state lives in a dict the finalizer holds directly: a
        # plain atexit-bound method would pin the instance (and its open
        # mmaps) for the life of the process, and a weakref-to-self
        # callback would already be dead when finalization runs
        self._state = {"proc": None, "queue": None}
        import weakref
        self._finalizer = weakref.finalize(self, _stop_updater,
                                           self._state)

    # -- reads --------------------------------------------------------------

    def __getitem__(self, index):
        return np.asarray(self.weight[np.asarray(index)])

    def pull(self, index):
        """Gather rows as a fresh array (safe to device_put)."""
        return self[index]

    # -- async updates (reference ``:49-80``) --------------------------------

    def start_async_update(self):
        if self._state["proc"] is not None:
            return
        ctx = mp.get_context("spawn")
        self._state["queue"] = ctx.Queue(maxsize=256)
        self._state["proc"] = ctx.Process(
            target=_updater_loop,
            args=(self.weight_path, self.moment_path, self.shape, self.lr,
                  self._state["queue"]),
            daemon=True)
        self._state["proc"].start()

    @property
    def _proc(self):
        return self._state["proc"]

    @property
    def _queue(self):
        return self._state["queue"]

    def push(self, index, grad):
        """Send a sparse gradient; applied asynchronously (or inline when
        the updater isn't running)."""
        index = np.asarray(index)
        grad = np.asarray(grad, dtype=np.float32)
        if self._proc is None:
            np.add.at(self.moment, index, grad * grad)
            denom = np.sqrt(self.moment[index] + 1e-10)
            np.add.at(self.weight, index, -self.lr * grad / denom)
            self.moment.flush()
        else:
            if not self._proc.is_alive():
                raise RuntimeError(
                    "async updater process died (see its traceback "
                    "above); queued gradients were lost — restart with "
                    "start_async_update()")
            self._queue.put((index, grad))

    def finish_async_update(self):
        """Drain the queue and stop the updater (reference ``:75-80``)."""
        _stop_updater(self._state)
        self._state["queue"] = None
        # re-open to observe the updater's writes
        self.weight = np.load(self.weight_path, mmap_mode="r+")
        self.moment = np.load(self.moment_path, mmap_mode="r+")

    def flush(self):
        self.weight.flush()
