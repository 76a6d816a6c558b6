"""GNNAutoScale (GAS): training full-graph GNNs one partition at a time
with historical embeddings.

Port of ``pgl_tpu/apps/gnn_autoscale.py``, itself of the reference's
``apps/GNNAutoScale``: per-layer ``History`` buffers (``history.py:25-46``),
the push/pull orchestration of ``ScalableGNN``
(``gnn_models/base_model.py:31-210``), and METIS or random partition
batching (``graph_partition.py``).

Histories live in pinned host RAM; the card holds only the current
partition's rows. One training step a partition:

  1. pull each history's rows for the partition's out-of-batch
     neighbours (the halo),
  2. run layer k on [batch ∪ halo] with exact in-batch features and
     historical halo features,
  3. push the fresh in-batch activations back into history k.

Pull and push overlap the compute through a
:class:`~pgl_tpu_torch.utils.stream_pool.StreamPool` (side CUDA streams and
pinned buffers, the reference's ``StreamPool`` rotation): while batch ``k``
trains, batch ``k+1``'s halo rows are already on their way to the card and
batch ``k-1``'s fresh rows on their way back (:meth:`ScalableGNN.
iter_batches`, :meth:`ScalableGNN.push_fresh_async`).

The JAX version takes ``(params_list, layer_fns)`` with ``fn(params, sg,
x)``; this one takes ``torch.nn.Module`` layers called ``layer(sg, x)``,
which hold their parameters, so ``forward_batch`` and ``inference_full``
take no ``params_list``. Each batch's subgraph is put on the device once
and kept (the JAX version calls ``tensor()`` on every step).

A stock ``GCNConv`` normalises a batch by the subgraph's own in-degrees, as
the JAX version's does: a halo node has no in-edge in its batch's
subgraph, so its messages go out unnormalised. Each batch's subgraph also
carries the full graph's ``deg^-1/2`` of its nodes as ``node_feat[
FULL_NORM]`` (GAS's GCN normalises by the full graph); a layer takes it
as ``conv(sg, x, norm=sg.node_feat.get(FULL_NORM))``, and a graph without
it (the full graph in ``inference_full``) normalises by its own degrees.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..partition import metis_partition, random_partition
from ..sampling.custom import subgraph as extract_subgraph
from ..utils.stream_pool import (StreamPool, _torch_dtype, check_rows,
                                 take_rows)

__all__ = ["FULL_NORM", "History", "ScalableGNN", "partition_batches"]

# the node feature of a batch's subgraph that holds the full graph's
# in-degree norm of its nodes
FULL_NORM = "full_norm"


class History:
    """Host-RAM per-layer activation history (reference ``history.py:25``):
    a ``[num_embs, emb_dim]`` CPU tensor, pinned when ``device`` is a card;
    ``emb`` is its numpy view.

    A per-history lock serializes concurrent pull and push of the same
    buffer (the reference orders them with CUDA stream events): GAS reads
    may be one step staler, never torn.
    """

    def __init__(self, num_embs: int, emb_dim: int, dtype=np.float32,
                 device=None):
        self.device = resolve_device(device)
        self._pinned = self.device.type == "cuda"
        self.table = torch.zeros((num_embs, emb_dim),
                                 dtype=_torch_dtype(dtype),
                                 pin_memory=self._pinned)
        self.emb = self.table.numpy()
        self._lock = threading.Lock()

    def pull(self, index) -> torch.Tensor:
        """Host → device gather of history rows: gathered under the lock
        into a fresh pinned tensor, copied on the current stream."""
        index = np.asarray(index)
        check_rows(index, len(self.emb))
        rows = torch.empty((len(index),) + tuple(self.emb.shape[1:]),
                           dtype=self.table.dtype, pin_memory=self._pinned)
        with self._lock:
            take_rows(self.emb, index, rows.numpy())
        return rows.to(self.device, non_blocking=True)

    def push(self, index, values):
        """Device → host scatter of fresh activations (blocking)."""
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()   # readback, no lock
        with self._lock:
            self.emb[np.asarray(index)] = values

    def async_pull(self, index, pool: StreamPool):
        """Queue :meth:`pull` on the pool's side streams; returns a future
        of the device tensor (reference ``async_pull``,
        ``stream_pool.py:40``)."""
        return pool.async_pull(self.emb, index, lock=self._lock)

    def async_push(self, index, values, pool: StreamPool):
        """Queue :meth:`push` on the pool (reference ``async_push``)."""
        return pool.async_push(self.emb, np.asarray(index), values,
                               lock=self._lock)

    def reset(self):
        with self._lock:
            self.emb[:] = 0


def partition_batches(graph, num_parts: int, method: str = "metis",
                      seed: int = 0, parts=None):
    """Partition nodes and build per-part [batch ∪ halo] subgraphs.

    ``parts`` takes a partition already made (``[num_nodes]`` part ids),
    in place of ``method`` and ``seed``.

    Returns a list of dicts with keys:
      ``nodes``      — global ids, batch nodes first then halo,
      ``batch_size`` — number of in-batch nodes,
      ``subgraph``   — reindexed host Graph over ``nodes`` containing every
                       edge whose dst is in-batch (src may be halo), with
                       ``node_feat[FULL_NORM]``: ``clip(deg, 1)^-1/2`` of
                       ``nodes`` by the full graph's in-degrees, ``[n, 1]``
                       float32.
    A part with no nodes gives a batch of 0 nodes and 0 edges.
    """
    g = graph.numpy() if graph.is_tensor else graph
    if parts is None:
        parts = (metis_partition(g, num_parts, seed) if method == "metis"
                 else random_partition(g, num_parts, seed))
    edges = np.asarray(g.edges)
    norm = (np.maximum(np.bincount(edges[:, 1], minlength=g.num_nodes), 1)
            .astype(np.float32) ** -0.5)[:, None]
    out = []
    for p in range(num_parts):
        batch_nodes = np.nonzero(parts == p)[0]
        in_batch = np.zeros(g.num_nodes, bool)
        in_batch[batch_nodes] = True
        emask = in_batch[edges[:, 1]]
        sub_edges = edges[emask]
        halo = np.setdiff1d(np.unique(sub_edges[:, 0]), batch_nodes)
        nodes = np.concatenate([batch_nodes, halo])
        sg = extract_subgraph(g, nodes=nodes, eid=np.nonzero(emask)[0])
        sg.node_feat[FULL_NORM] = norm[nodes]
        out.append({"nodes": nodes, "batch_size": len(batch_nodes),
                    "subgraph": sg})
    return out


class ScalableGNN:
    """Orchestrates a layer stack over partition batches with histories.

    Args:
      num_nodes: global node count.
      layers: one ``torch.nn.Module`` (or callable) a layer, called
        ``layer(subgraph, x)``; the caller owns the modules, this class the
        histories.
      hidden_dims: output dim of each non-final layer (history shapes).
      pool_size: the stream pool's workers.
      device: where the batches run (default: the card; raises without
        one unless ``"cpu"``).
    """

    def __init__(self, num_nodes: int, layers: Sequence,
                 hidden_dims: Sequence[int], pool_size: int = 2,
                 device=None):
        if len(hidden_dims) != len(layers) - 1:
            raise ValueError(f"{len(layers)} layers need "
                             f"{len(layers) - 1} hidden dims, got "
                             f"{len(hidden_dims)}")
        self.device = resolve_device(device)
        self.layers = list(layers)
        self.histories = [History(num_nodes, d, device=self.device)
                          for d in hidden_dims]
        self.pool = StreamPool(pool_size, self.device)
        self._graphs = {}

    def batch_graph(self, batch):
        """The batch's subgraph on the device, put there on first use and
        kept."""
        sg = batch["subgraph"]
        if sg.is_tensor:
            return sg
        held = self._graphs.get(id(sg))
        if held is None or held[0] is not sg:
            held = self._graphs[id(sg)] = (sg, sg.tensor(self.device))
        return held[1]

    def pull_halo(self, batch):
        """Each layer's historical rows for the batch's halo nodes, on the
        device (blocking gathers)."""
        halo = batch["nodes"][batch["batch_size"]:]
        return [h.pull(halo) for h in self.histories]

    def prefetch_halo(self, batch):
        """Async :meth:`pull_halo`: every layer's halo rows queued on the
        stream pool; returns a list of futures."""
        halo = batch["nodes"][batch["batch_size"]:]
        return [h.async_pull(halo, self.pool) for h in self.histories]

    def push_fresh_async(self, batch, fresh):
        """Async :meth:`push_fresh`: the device → host scatter of each
        layer's fresh rows overlaps the next batch's compute."""
        in_batch = batch["nodes"][:batch["batch_size"]]
        for hist, values in zip(self.histories, fresh):
            hist.async_push(in_batch, values, self.pool)

    def iter_batches(self, batches):
        """Double-buffered epoch iterator: yields ``(batch, halo_inputs)``
        with batch ``k+1``'s history pull already in flight while batch
        ``k`` trains (reference overlap at ``base_model.py:31-100``).
        Combine with :meth:`push_fresh_async`; call
        ``self.pool.synchronize()`` at epoch end before evaluation.
        """
        if not batches:
            return
        nxt = self.prefetch_halo(batches[0])
        for i, b in enumerate(batches):
            cur = [f.result() for f in nxt]
            if i + 1 < len(batches):
                nxt = self.prefetch_halo(batches[i + 1])
            yield b, cur

    def forward_batch(self, batch, x, halo_inputs):
        """One partition's forward.

        ``x`` is the device feature block for ``batch['nodes']`` and
        ``halo_inputs`` what :meth:`pull_halo` gives. Returns ``(out_batch,
        fresh)`` where ``fresh[k]`` are the in-batch activations to push
        into history ``k``.
        """
        bs = batch["batch_size"]
        sg = self.batch_graph(batch)
        fresh = []
        for k, layer in enumerate(self.layers):
            x = layer(sg, x)
            if k < len(self.layers) - 1:
                fresh.append(x[:bs])
                # out-of-batch rows come from history (stale, full-graph)
                x = torch.cat([x[:bs], halo_inputs[k]], dim=0)
        return x[:bs], fresh

    def push_fresh(self, batch, fresh):
        """Write the fresh in-batch activations back (device → host)."""
        in_batch = batch["nodes"][:batch["batch_size"]]
        for hist, values in zip(self.histories, fresh):
            hist.push(in_batch, values)

    @torch.no_grad()
    def inference_full(self, graph, x):
        """Exact full-graph layer-by-layer inference (no histories)."""
        gt = graph if graph.is_tensor else graph.tensor(self.device)
        h = torch.as_tensor(x).to(self.device)
        for layer in self.layers:
            h = layer(gt, h)
        return h
