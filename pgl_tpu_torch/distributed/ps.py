"""Asynchronous parameter-server sharded embeddings (distributed CPU; port
of ``pgl_tpu/distributed/ps.py``).

The reference trains walk models with N trainer processes pushing sparse
gradients to fleet parameter servers under ``a_sync=True``
(``apps/Graph4Rec/env_run/src/dist_cpu_train.py:51-66``,
``examples/deepwalk/train_distributed_cpu.py``). The same topology from
the framework's own primitives:

  * :class:`EmbeddingShardService` — one process per shard, holds the rows
    with ``row % num_shards == shard_id`` and applies **adagrad server-side**
    on push (the async update semantics: trainers never wait for each other,
    gradients land whenever they arrive — bounded staleness like fleet's
    async SGD). Its initial rows are numpy's ``default_rng(seed * 1000 +
    shard_id)`` draw, as ``pgl_tpu``'s.
  * :class:`PSEmbedding` — the trainer-side view of one logical table:
    ``pull(ids)`` gathers rows across shards, ``push(ids, grads)`` ships
    sparse grads on a background thread so the train step never blocks on
    the network (fire-and-forget like fleet async mode).

Rows and gradients are numpy on the host: a trainer on the card copies its
pulled rows up and its gradients down. Transport is the zero-copy numpy RPC
(``distributed/rpc.py``). Row striping (``id % S``) matches the reference
graph engine's shard rule (``pgl/distributed/dist_graph.py`` shard_num
semantics).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from .rpc import RpcClient, RpcServer

__all__ = ["EmbeddingShardService", "PSEmbedding", "start_shard_server",
           "run_shard_server"]


class EmbeddingShardService:
    """Holds the ``row % num_shards == shard_id`` stripe of every table.

    All methods take/return numpy arrays; the RPC layer frames them
    zero-copy. Writes serialize under a per-table lock (the RPC server is
    threaded) — pushes from different trainers interleave at row
    granularity, which is exactly the async-PS contract.
    """

    def __init__(self, shard_id: int, num_shards: int):
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)
        self._tables: Dict[str, dict] = {}
        self._locks: Dict[str, threading.Lock] = {}

    # -- lifecycle ----------------------------------------------------------

    def ping(self):
        return (self.shard_id, self.num_shards)

    def create_table(self, name: str, num_rows: int, dim: int,
                     lr: Optional[float] = None,
                     init_scale: Optional[float] = None,
                     seed: int = 0):
        """Idempotent: every trainer calls this; the first one wins.

        ``lr=None`` means "attach, accept the existing table's lr" (or
        0.05 when creating); an explicit lr that mismatches an existing
        table raises — trainers configured inconsistently would otherwise
        silently train with the first caller's value."""
        if name in self._tables:
            t = self._tables[name]
            if t["num_rows"] != num_rows or t["weight"].shape[1] != dim:
                raise ValueError(
                    f"table {name!r} exists with rows={t['num_rows']} "
                    f"dim={t['weight'].shape[1]}, requested {num_rows}/"
                    f"{dim}")
            if lr is not None and t["lr"] != float(lr):
                raise ValueError(
                    f"table {name!r} exists with lr={t['lr']}, "
                    f"requested {lr}")
            return False
        local = (num_rows - self.shard_id + self.num_shards - 1) \
            // self.num_shards
        scale = init_scale if init_scale is not None else 1.0 / np.sqrt(dim)
        rng = np.random.default_rng(seed * 1000 + self.shard_id)
        self._tables[name] = {
            "num_rows": int(num_rows),
            "lr": float(lr) if lr is not None else 0.05,
            "weight": rng.uniform(-scale, scale,
                                  (local, dim)).astype(np.float32),
            "moment": np.zeros((local, dim), np.float32),
        }
        self._locks[name] = threading.Lock()
        return True

    # -- data path ----------------------------------------------------------

    def pull(self, name: str, local_rows: np.ndarray) -> np.ndarray:
        t = self._tables[name]
        return np.ascontiguousarray(t["weight"][np.asarray(local_rows)])

    def push(self, name: str, local_rows: np.ndarray,
             grads: np.ndarray):
        """Sparse adagrad apply (duplicate rows accumulate via add.at)."""
        t = self._tables[name]
        rows = np.asarray(local_rows)
        grads = np.asarray(grads, np.float32)
        with self._locks[name]:
            np.add.at(t["moment"], rows, grads * grads)
            denom = np.sqrt(t["moment"][rows] + 1e-10)
            np.add.at(t["weight"], rows, -t["lr"] * grads / denom)
        return True

    def dump(self, name: str) -> np.ndarray:
        """Full local stripe (rank-0 gathers these to export embeddings)."""
        return self._tables[name]["weight"]

    def stats(self, name: str):
        t = self._tables[name]
        return {"local_rows": int(t["weight"].shape[0]),
                "norm": float(np.linalg.norm(t["weight"]))}


def run_shard_server(shard_id: int, num_shards: int, port: int,
                     host: str = "127.0.0.1", ready_queue=None):
    """Blocking server entry point (run it in its own process)."""
    svc = EmbeddingShardService(shard_id, num_shards)
    server = RpcServer(svc, host=host, port=port)
    server.start()
    if ready_queue is not None:
        ready_queue.put((shard_id, server.port))
    server._thread.join()


def start_shard_server(shard_id: int, num_shards: int,
                       host: str = "127.0.0.1", port: int = 0):
    """In-process variant (tests / single-host): returns the RpcServer."""
    svc = EmbeddingShardService(shard_id, num_shards)
    return RpcServer(svc, host=host, port=port).start()


class PSEmbedding:
    """Trainer-side sharded embedding table.

    ``pull`` is synchronous (the step needs the rows); ``push`` enqueues to
    a background sender thread per shard, so the hot loop never waits on
    gradient application — the fleet ``a_sync`` analog. ``flush()`` drains
    the queues (call before evaluating / exporting).
    """

    def __init__(self, addresses: Sequence[str], name: str, num_rows: int,
                 dim: int, lr: Optional[float] = None,
                 init_scale: Optional[float] = None, seed: int = 0,
                 async_push: bool = True):
        self.name = name
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.S = len(addresses)
        self._pull_clients = [RpcClient(a) for a in addresses]
        self._push_clients = [RpcClient(a) for a in addresses]
        for c in self._pull_clients:
            c.call("create_table", name, num_rows, dim, lr=lr,
                   init_scale=init_scale, seed=seed)
        self._async = bool(async_push)
        if self._async:
            self._queues: List[queue.Queue] = [queue.Queue(maxsize=64)
                                               for _ in range(self.S)]
            self._errs: List[Optional[BaseException]] = [None] * self.S
            self._senders = []
            for s in range(self.S):
                th = threading.Thread(target=self._sender, args=(s,),
                                      daemon=True)
                th.start()
                self._senders.append(th)

    # -- sharding -----------------------------------------------------------

    def _split(self, ids: np.ndarray):
        ids = np.asarray(ids)
        shard = ids % self.S
        local = ids // self.S
        return shard, local

    # -- reads --------------------------------------------------------------

    def pull(self, ids) -> np.ndarray:
        ids = np.asarray(ids).reshape(-1)
        shard, local = self._split(ids)
        out = np.empty((len(ids), self.dim), np.float32)
        for s in range(self.S):
            m = shard == s
            if m.any():
                out[m] = self._pull_clients[s].call("pull", self.name,
                                                    local[m])
        return out

    def dump(self) -> np.ndarray:
        """Reassemble the full table (eval/export on rank 0)."""
        full = np.zeros((self.num_rows, self.dim), np.float32)
        for s in range(self.S):
            stripe = self._pull_clients[s].call("dump", self.name)
            rows = np.arange(s, self.num_rows, self.S)
            full[rows] = stripe[:len(rows)]
        return full

    # -- writes -------------------------------------------------------------

    def _sender(self, s: int):
        while True:
            item = self._queues[s].get()
            if item is None:
                self._queues[s].task_done()
                return
            local, grads = item
            try:
                # retries=0: push is not idempotent (adagrad applies twice)
                self._push_clients[s].call("push", self.name, local, grads,
                                           retries=0)
            except BaseException as e:   # surfaced on next push/flush
                self._errs[s] = e
            finally:
                # task_done AFTER the push lands: flush() joins on this,
                # so a dequeued-but-unsent item can never slip past it
                self._queues[s].task_done()

    def push(self, ids, grads):
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        shard, local = self._split(ids)
        for s in range(self.S):
            m = shard == s
            if not m.any():
                continue
            if not self._async:
                self._push_clients[s].call("push", self.name, local[m],
                                           grads[m], retries=0)
                continue
            if self._errs[s] is not None:
                raise RuntimeError(
                    f"async push to shard {s} failed earlier"
                ) from self._errs[s]
            self._queues[s].put((local[m], np.ascontiguousarray(grads[m])))

    def flush(self):
        """Wait until every queued push has been applied: ``Queue.join``
        blocks until the sender has called ``task_done`` for every item —
        which it does only after the RPC returns, so there is no window
        where a dequeued-but-unsent gradient escapes the fence (a bare
        ``empty()`` poll had exactly that race)."""
        if not self._async:
            return
        for s in range(self.S):
            self._queues[s].join()
            if self._errs[s] is not None:
                raise RuntimeError(
                    f"async push to shard {s} failed"
                ) from self._errs[s]

    def close(self):
        if self._async:
            for q in self._queues:
                q.put(None)
            for th in self._senders:
                th.join(timeout=5)
        for c in self._pull_clients + self._push_clients:
            c.close()
