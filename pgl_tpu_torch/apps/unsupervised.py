"""Unsupervised large-graph representation engine — the PGLBox-analog.

Port of ``pgl_tpu/apps/unsupervised.py``, itself of ``apps/PGLBox``'s
pass-based training (the next pass's walks and pairs are generated while
the current pass trains — ``src/dataset.py:199-282`` preload threads and
semaphores; an id embedding with an optional neighbour-aggregation encoder
and in-batch shuffled negatives — ``src/models/gnn_model.py:122-161``).

Walks and pairs come from the C++ host kernels in a background thread
(double-buffered passes); the device trains an embedding table, and with
``neighbor_samples`` a mean-aggregation encoder over neighbours drawn by
``sample_neighbors_padded`` from the card-resident CSC, with a skip-gram
objective and ``torch.optim.Adam``. Each step draws from one generator on
the device (seeded ``seed + 7``): the neighbour uniforms, then the
negatives' permutation (:meth:`UnsupervisedGraphTrainer._draws`); the step
itself is a function of those draws.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..native.graph_kernel import skip_gram_gen_pair
from ..sampling import random_walk
from ..sampling.sage import _neighbors_from_uniforms
from .common import _inbatch_skipgram_loss

__all__ = ["UnsupervisedGraphTrainer"]


class _PassGenerator:
    """Background producer of (src, dst) positive-pair passes (the preload
    thread + semaphore design of PGLBox's BaseDataset)."""

    def __init__(self, graph, walk_len: int, win_size: int,
                 batch_nodes: int, max_passes_ahead: int = 1):
        self.graph = graph
        self.walk_len = walk_len
        self.win_size = win_size
        self.batch_nodes = batch_nodes
        self._q = queue_mod.Queue(maxsize=max_passes_ahead)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _produce(self, epochs: int, seed: int):
        # finally-sentinel: if walk/pair generation raises, the consumer
        # must see the end marker instead of blocking on get() forever
        try:
            for epoch in range(epochs):
                for i, nodes in enumerate(self.graph.node_batch_iter(
                        self.batch_nodes, seed=seed + epoch)):
                    if self._stop.is_set():
                        return
                    s = seed * 9973 + epoch * 131 + i
                    walks = random_walk(self.graph, nodes, self.walk_len,
                                        seed=s)
                    src, dst = skip_gram_gen_pair(walks, self.win_size,
                                                  seed=s)
                    self._q.put((src, dst))
        except BaseException:
            import traceback
            traceback.print_exc()
            raise
        finally:
            self._q.put(None)

    def start(self, epochs: int, seed: int = 0):
        self._thread = threading.Thread(
            target=self._produce, args=(epochs, seed), daemon=True)
        self._thread.start()
        return self

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def stop(self):
        self._stop.set()


class UnsupervisedGraphTrainer:
    """
    Args:
      graph: host (numpy) Graph.
      embed_dim: embedding width.
      neighbor_samples: if set (e.g. 5), adds a mean-aggregation encoder over
        that many sampled neighbors (PGLBox 'sage' layer analog); None =
        pure id embedding (deepwalk-style).
      neg_num: in-batch negatives per positive.
      pair_batch: pairs per train step (fixed shape).
      device: where the tables train (default: the card; raises without
        one unless ``"cpu"``).

    ``params`` holds the tensors by the JAX version's names (``emb``,
    ``ctx``, and with the encoder ``w_self``, ``w_neigh``), drawn from a
    generator seeded ``seed`` (``emb`` and the encoder's normal times 0.1,
    ``ctx`` zeros).
    """

    def __init__(self, graph, embed_dim: int = 64,
                 neighbor_samples: Optional[int] = None, neg_num: int = 5,
                 pair_batch: int = 4096, lr: float = 5e-3, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.graph = graph.numpy()
        self.embed_dim = embed_dim
        self.neg_num = neg_num
        self.pair_batch = pair_batch
        self.neighbor_samples = neighbor_samples
        N = self.graph.num_nodes
        gen = torch.Generator().manual_seed(seed)
        init = {"emb": torch.randn(N, embed_dim, generator=gen) * 0.1,
                "ctx": torch.zeros(N, embed_dim)}
        if neighbor_samples:
            idx = self.graph.adj_dst_index
            self._indptr = torch.as_tensor(
                np.asarray(idx.indptr, np.int32)).to(self.device)
            self._sorted_v = torch.as_tensor(
                np.asarray(idx.sorted_v, np.int32)).to(self.device)
            for name in ("w_self", "w_neigh"):
                init[name] = torch.randn(embed_dim, embed_dim,
                                         generator=gen) * 0.1
        self.params = {k: torch.nn.Parameter(v.to(self.device))
                       for k, v in init.items()}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=lr)

    def _encode(self, ids, uniforms):
        h = self.params["emb"][ids]
        if not self.neighbor_samples:
            return h
        neigh, mask = _neighbors_from_uniforms(self._indptr, self._sorted_v,
                                               ids, uniforms)
        # a node without in-edges reads a fill id; its mask zeroes the row
        emb = self.params["emb"]
        nh = emb[neigh.long().clamp(0, emb.shape[0] - 1)] * mask[..., None]
        denom = mask.sum(-1, keepdim=True).to(h.dtype).clamp(min=1.0)
        agg = nh.sum(1) / denom
        return torch.relu(h @ self.params["w_self"]
                          + agg @ self.params["w_neigh"])

    def _draws(self, generator: torch.Generator, n: int):
        """One step's draws: the neighbour uniforms ``[n, k]`` (None
        without the encoder), then the negatives' permutation of ``n *
        neg_num``."""
        u = None
        if self.neighbor_samples:
            u = torch.rand((n, self.neighbor_samples), generator=generator,
                           device=self.device)
        return u, torch.randperm(n * self.neg_num, generator=generator,
                                 device=self.device)

    def _step(self, src, dst, valid, uniforms, perm) -> torch.Tensor:
        h = self._encode(src, uniforms)
        loss = _inbatch_skipgram_loss(h, self.params["ctx"][dst], perm,
                                      self.neg_num, valid)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train(self, epochs: int = 5, walk_len: int = 20, win_size: int = 5,
              batch_nodes: int = 512, seed: int = 0,
              log_every: int = 0) -> float:
        """Run pass-based training; returns final mean loss per pass."""
        gen = _PassGenerator(self.graph, walk_len, win_size,
                             batch_nodes).start(epochs, seed)
        draw = torch.Generator(device=self.device).manual_seed(seed + 7)
        last = 0.0
        bp = self.pair_batch
        for pass_id, (src, dst) in enumerate(gen):
            total, steps = 0.0, 0
            for lo in range(0, max(len(src), 1), bp):
                bs, bd = src[lo:lo + bp], dst[lo:lo + bp]
                if len(bs) == 0:
                    break
                valid = np.ones(len(bs), np.float32)
                if len(bs) < bp:   # masked tail
                    pad = bp - len(bs)
                    bs, bd = np.pad(bs, (0, pad)), np.pad(bd, (0, pad))
                    valid = np.pad(valid, (0, pad))
                bs, bd, valid = (torch.as_tensor(a).to(self.device)
                                 for a in (bs, bd, valid))
                loss = self._step(bs, bd, valid, *self._draws(draw, bp))
                total += float(loss)
                steps += 1
            last = total / max(steps, 1)
            if log_every and pass_id % log_every == 0:
                from ..utils.logger import log
                log.info("pass %d: loss %.4f (%d steps)", pass_id, last,
                         steps)
        return last

    def embeddings(self) -> np.ndarray:
        return self.params["emb"].detach().cpu().numpy()
