"""Edge-partitioned graphs, one rank a process: the counterpart of the
reference's ``DistGPUGraph``.

Port of ``pgl_tpu/parallel/dist_graph.py`` onto ``torch.distributed``.
Edges are split on the host (:func:`shard_edges`, the reference's three
strategies and padding, bit for bit); each rank keeps its own ``[E_pad,
2]`` shard, node features are replicated (``[N, ...]`` on every rank),
and an aggregation is this rank's partial sum over its edges followed by
an all-reduce:

* sum and mean are K1 (``ops/kernels/segment_kernels.py``) over this
  rank's real edges (a layout of ``N`` rows), then ``comm.all_reduce_sum``;
* max and min are a segment max (min) whose empty rows are -inf (+inf),
  an all-reduce max (min), then 0 where no rank had an edge;
* ``edge_softmax`` all-reduces each destination's max and sum (the
  blockwise softmax), and ``send_uv`` stays in this rank's edge layout.

The gradient convention: the all-reduces' backward sums the cotangents
over the ranks, so the global loss is the sum of the ranks' losses. A loss
that every rank computes whole on the replicated output is divided by the
world size by the trainer, and replicated parameters' gradients are summed
over the ranks (each rank's feature gradient is its share; their sum is
the single-device gradient).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import dispatch
from ..ops import message_passing as mp
from ..ops import segment as S
from ..ops.kernels.segment_kernels import build_spmm_layout, spmm
from ..utils.edge_index import EdgeIndex
from . import comm

__all__ = ["ShardedGraph", "shard_edges"]


def shard_edges(edges: np.ndarray, num_shards: int, num_nodes: int,
                strategy: str = "dst_range",
                edge_feat: Optional[dict] = None):
    """Partition edges into ``num_shards`` padded groups (the reference's
    arrays): ``(stacked [S, E_pad, 2], mask [S, E_pad], perm [S, E_pad])``,
    ``perm`` the original edge id of each slot. ``strategy``: "dst_range"
    (contiguous destination blocks), "dst_mod" (``dst % S``, the original
    PGL's) or "round_robin" (edge id striping)."""
    edges = np.asarray(edges)
    E = edges.shape[0]
    if strategy == "dst_mod":
        assign = edges[:, 1] % num_shards
    elif strategy == "round_robin":
        assign = np.arange(E) % num_shards
    elif strategy == "dst_range":
        bound = (num_nodes + num_shards - 1) // num_shards
        assign = np.minimum(edges[:, 1] // max(bound, 1), num_shards - 1)
    else:
        raise ValueError(f"unknown strategy {strategy}")
    order = np.lexsort((edges[:, 1], assign))
    counts = np.bincount(assign, minlength=num_shards)
    e_pad = int(counts.max()) if E else 1
    e_pad = ((e_pad + 127) // 128) * 128
    stacked = np.zeros((num_shards, e_pad, 2), dtype=np.int32)
    mask = np.zeros((num_shards, e_pad), dtype=np.float32)
    perm = np.zeros((num_shards, e_pad), dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for s in range(num_shards):
        idx = order[offsets[s]:offsets[s + 1]]
        k = len(idx)
        stacked[s, :k] = edges[idx]
        mask[s, :k] = 1.0
        perm[s, :k] = idx
    return stacked, mask, perm


class ShardedGraph:
    """This rank's edge shard of a graph whose node values are replicated.

    ``edges`` ``[E_pad, 2]``, ``mask`` ``[E_pad]`` and ``perm`` ``[E_pad]``
    are this rank's rows of :func:`shard_edges` (numpy or tensors).
    ``perm_scope`` "global": ``perm`` indexes the whole graph's edge order;
    "local": each shard's own order (the multi-host loaders'), where
    :meth:`shard_edge_values` raises.
    """

    def __init__(self, edges, mask, perm, num_nodes: int, group=None,
                 device=None, node_feat=None, edge_feat=None,
                 perm_scope: str = "global"):
        self.group, _, self.rank = comm.world(group)
        self.device = comm.rank_device(device)
        edges = np.asarray(edges).astype(np.int64)
        mask = np.asarray(mask)
        self._host_perm = np.asarray(perm)
        self._host_mask = mask
        self._num_nodes = int(num_nodes)
        self.perm_scope = perm_scope
        self.e_pad = edges.shape[0]
        self.k = int(mask.sum())
        real = edges[:self.k]
        if not (mask[:self.k] > 0).all():
            raise ValueError("a shard's real edges come first")
        dev = self.device
        self.edges = torch.as_tensor(edges, device=dev)
        self.mask = torch.as_tensor(mask, device=dev)
        self.perm = torch.as_tensor(self._host_perm, device=dev)
        self.src = self.edges[:self.k, 0].contiguous()
        self.dst = self.edges[:self.k, 1].contiguous()
        N = self._num_nodes
        csc = EdgeIndex.from_edges(real[:, 1], real[:, 0], N)
        csr = EdgeIndex.from_edges(real[:, 0], real[:, 1], N)
        self._layouts = (
            build_spmm_layout(csc.indptr, csc.sorted_v, N, kind="shard",
                              device=dev, edge_id=csc.sorted_eid),
            build_spmm_layout(csr.indptr, csr.sorted_v, N, kind="shard_t",
                              device=dev, edge_id=csr.sorted_eid))
        self._degrees = {}
        self.node_feat = dict(node_feat or {})
        self.edge_feat = dict(edge_feat or {})

    @classmethod
    def from_graph(cls, graph, group=None, strategy: str = "dst_range",
                   device=None) -> "ShardedGraph":
        """Partition a graph's edges over the ranks of ``group`` (every rank
        passes the same graph); node features replicated on this rank's
        device, edge features following their edges."""
        g = graph.numpy() if graph.is_tensor else graph
        group, size, rank = comm.world(group)
        stacked, mask, perm = shard_edges(np.asarray(g.edges), size,
                                          g.num_nodes, strategy)
        dev = comm.rank_device(device)
        node_feat = {k: torch.as_tensor(np.asarray(v), device=dev)
                     for k, v in g.node_feat.items()}
        obj = cls(stacked[rank], mask[rank], perm[rank], g.num_nodes, group,
                  dev, node_feat)
        obj.edge_feat = {k: obj.shard_edge_values(v)
                         for k, v in g.edge_feat.items()}
        return obj

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    @property
    def num_shards(self) -> int:
        return comm.world(self.group)[1]

    # -- message passing ----------------------------------------------------

    def _partial_extreme(self, msg, reduce_op):
        """Per-node max (min) of this rank's ``msg`` rows, -inf (+inf) where
        it has none."""
        fill = float("-inf") if reduce_op == "max" else float("inf")
        out = msg.new_full((self._num_nodes,) + tuple(msg.shape[1:]), fill)
        idx = self.dst.reshape((-1,) + (1,) * (msg.ndim - 1)).expand_as(msg)
        return out.scatter_reduce(0, idx, msg, "amax" if reduce_op == "max"
                                  else "amin", include_self=True)

    def _combine_extreme(self, msg, reduce_op):
        """The global max (min) of ``msg`` at each destination, 0 where no
        rank has an in-edge. A tie's gradient is shared evenly over the
        tied edges of every rank, as on one graph: each rank's share is its
        count of tied edges over the ranks' total."""
        partial = self._partial_extreme(msg, reduce_op)
        idx = self.dst.reshape((-1,) + (1,) * (msg.ndim - 1)).expand_as(msg)
        tied = (msg.detach() == partial.detach().gather(0, idx)).to(
            msg.dtype)
        counts = torch.zeros_like(partial).scatter_add_(0, idx, tied)
        out = comm.all_reduce_extreme(partial, reduce_op, counts,
                                      self.group)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))

    def send_u_recv(self, feature, reduce_op: str = "sum"):
        """``out[v]`` = reduce over every rank's in-edges of ``feature[u]``,
        ``[N, ...]`` on every rank: this rank's partial (K1 for a float32
        sum or mean) and an all-reduce (sum; max or min for those)."""
        if reduce_op not in ("sum", "mean", "max", "min"):
            raise ValueError(reduce_op)
        if reduce_op in ("max", "min"):
            msg = feature.index_select(0, self.src)
            return self._combine_extreme(msg, reduce_op)
        if dispatch.plain_on_cuda(feature):
            partial = S.segment_sum(feature.index_select(0, self.src),
                                    self.dst, self._num_nodes)
        else:
            flat = feature.reshape(feature.shape[0], -1).contiguous()
            partial = spmm(flat, *self._layouts).reshape(
                (self._num_nodes,) + tuple(feature.shape[1:]))
        out = comm.all_reduce_sum(partial, self.group)
        if reduce_op == "mean":
            deg = self.indegree().clamp(min=1).to(out.dtype)
            out = out / deg.reshape((-1,) + (1,) * (out.ndim - 1))
        return out

    send_recv = send_u_recv

    def send_ue_recv(self, feature, edge_feat, message_op: str = "mul",
                     reduce_op: str = "sum"):
        """Edge-weighted aggregation; ``edge_feat`` is this rank's ``[E_pad,
        ...]`` (:meth:`shard_edge_values`). add/sub/mul/div ×
        sum/mean/max/min: sum and mean all-reduce the partial sums (mean
        divides by the global in-degree), max and min the partial
        extremes."""
        mp._check_op(message_op)
        if reduce_op not in ("sum", "mean", "max", "min"):
            raise ValueError(reduce_op)
        msg = feature.index_select(0, self.src)
        w = edge_feat[:self.k]
        msg = mp._COMBINE[message_op](msg, mp._broadcast_edge(w, msg.ndim))
        if reduce_op in ("max", "min"):
            return self._combine_extreme(msg, reduce_op)
        out = comm.all_reduce_sum(
            S.segment_sum(msg, self.dst, self._num_nodes), self.group)
        if reduce_op == "mean":
            deg = self.indegree().clamp(min=1).to(out.dtype)
            out = out / deg.reshape((-1,) + (1,) * (out.ndim - 1))
        return out

    def _to_edges(self, vals):
        tail = tuple(vals.shape[1:])
        return torch.cat([vals, vals.new_zeros((self.e_pad - self.k,)
                                               + tail)])

    def send_uv(self, src_feat, dst_feat, message_op: str = "add"):
        """Per-edge ``op(src_feat[u], dst_feat[v])`` in this rank's
        ``[E_pad, ...]`` layout (no collective; pads 0)."""
        mp._check_op(message_op)
        return self._to_edges(mp._COMBINE[message_op](
            src_feat.index_select(0, self.src),
            dst_feat.index_select(0, self.dst)))

    def edge_softmax(self, logits):
        """Softmax of this rank's ``[E_pad, ...]`` logits over each
        destination's in-edges on every rank: the destinations' max and
        sum all-reduced."""
        x = logits[:self.k]
        N = self._num_nodes
        m = comm.all_reduce_(self._partial_extreme(x.detach(), "max"),
                             dist.ReduceOp.MAX, self.group)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        ex = torch.exp(x - m.index_select(0, self.dst))
        den = comm.all_reduce_sum(S.segment_sum(ex, self.dst, N), self.group)
        den = den.clamp(min=torch.finfo(ex.dtype).tiny)
        return self._to_edges(ex / den.index_select(0, self.dst))

    def _degree(self, column):
        if column not in self._degrees:
            ids = self.edges[:self.k, column]
            deg = torch.bincount(ids, minlength=self._num_nodes)
            self._degrees[column] = comm.all_reduce_(
                deg, group=self.group).to(torch.int32)
        return self._degrees[column]

    def indegree(self):
        """``[N]`` int32 over every rank's edges (all-reduced once)."""
        return self._degree(1)

    def outdegree(self):
        """``[N]`` int32 over every rank's edges (all-reduced once)."""
        return self._degree(0)

    def shard_edge_values(self, values):
        """This rank's ``[E_pad, ...]`` rows of per-edge ``values`` in the
        original edge order (pads take edge ``perm``'s 0)."""
        if self.perm_scope != "global":
            raise ValueError(
                "this graph was built from per-host edge shards, so no "
                "global edge order exists; pass per-shard edge values via "
                "multihost.shard_edge_values_from_host_shards instead")
        values = np.asarray(values)
        return torch.as_tensor(np.ascontiguousarray(values[self._host_perm]),
                               device=self.device)

    def __repr__(self):
        return (f"ShardedGraph(num_nodes={self._num_nodes}, "
                f"shards={self.num_shards}x{self.e_pad} edges, "
                f"rank={self.rank})")
