"""Graph — host (numpy) or device (torch) graph with node/edge features.

Port of ``pgl_tpu/graph.py:51-348,512-628`` for the main path: construction,
degrees, the CSC/CSR indexes, ``tensor``/``numpy`` conversion and the
copy-send reductions. As in the reference, edges are sorted by destination
once, at conversion time, so every receive is a sorted segment reduce; and
``tensor()`` returns a new Graph instead of mutating this one.

``send_u_recv`` with sum or mean runs the dedup SpMM of
``ops/kernels/dedup_kernels.py`` when ``tensor()`` built its layouts (the
rule of ``pgl_tpu/graph.py:580-637``, with the gates of
``ops/dispatch.py``), and the SpMM of ``ops/kernels/segment_kernels.py``
otherwise: the CUDA kernels for CUDA tensors, their plain versions for CPU
tensors. Max and min run plain segment ops, as the reference does.

``send_ue_recv`` (``pgl_tpu/graph.py:350-431``) runs K1w, the weighted SpMM
of ``segment_kernels``, for mul or add with sum and a scalar or per-head
edge feature, and the weighted K6 of ``dedup_kernels`` for a scalar mul on
a graph with dedup layouts; everything else gathers, combines and runs a
segment op. ``send_uv`` is the reference's gathers (``:433-437``).

The attention layouts of ``ops/kernels/attention_kernels.py`` (K9/K10) and
the count-matrix attention's work lists of ``ops/kernels/dedup_attention.py``
(K7/K8, with the fold ``red``) are built on the first attention call that
needs them and kept on the device graph: ``tensor()`` alone does not build
them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import resolve_device
from .ops import dispatch
from .ops import message_passing as mp
from .ops import segment as S
from .ops.kernels import dedup_kernels as dk
from .ops.kernels.attention_kernels import build_attention_layouts
from .ops.kernels.dedup_attention import build_dedup_attention
from .ops.kernels.segment_kernels import (build_spmm_layout, spmm,
                                          spmm_weighted)
from .utils.edge_index import EdgeIndex

__all__ = ["Graph"]


def _check_feat_dict(feat, name):
    if feat is None:
        return {}
    if not isinstance(feat, dict):
        raise TypeError(f"{name} must be a dict of arrays, got {type(feat)}")
    return dict(feat)


def _kernel_weights(feature, edge_feat):
    """``edge_feat`` as the [E, H] weights of K1w on ``feature`` flattened to
    [N, D], or None where the combine is not one weight a head: [E] or
    [E, H] with H | D on an [N, D] feature, [E, H] or [E, H, 1] on an
    [N, H, Dh] one."""
    if edge_feat.ndim == 0:
        return None
    E, trail = edge_feat.shape[0], tuple(edge_feat.shape[1:])
    if feature.ndim == 2:
        if not trail:
            return edge_feat.reshape(E, 1)
        D = feature.shape[1]
        if len(trail) == 1 and trail[0] >= 1 and D % trail[0] == 0:
            return edge_feat
        return None
    if feature.ndim == 3 and trail in ((feature.shape[1],),
                                       (feature.shape[1], 1)):
        return edge_feat.reshape(E, feature.shape[1])
    return None


class Graph:
    """A directed graph with node/edge feature dicts."""

    def __init__(self, edges, num_nodes: Optional[int] = None,
                 node_feat: Optional[Dict] = None,
                 edge_feat: Optional[Dict] = None, **kwargs):
        if edges is None:
            raise ValueError("edges is required")
        is_tensor = isinstance(edges, torch.Tensor)
        if not is_tensor:
            edges = np.asarray(edges)
        if edges.ndim != 2 or edges.shape[1] != 2:
            raise ValueError(f"edges must be [E, 2], got {tuple(edges.shape)}")
        self._edges = edges
        self._is_tensor = is_tensor
        if num_nodes is None:
            if is_tensor:
                raise ValueError(
                    "num_nodes must be given explicitly for device graphs")
            num_nodes = int(edges.max()) + 1 if edges.size else 0
        self._num_nodes = int(num_nodes)
        self._num_edges = int(edges.shape[0])
        self._node_feat = _check_feat_dict(node_feat, "node_feat")
        self._edge_feat = _check_feat_dict(edge_feat, "edge_feat")
        self._adj_src_index = kwargs.get("adj_src_index", None)
        self._adj_dst_index = kwargs.get("adj_dst_index", None)
        self._spmm_layouts = kwargs.get("_spmm_layouts", None)
        self._dedup_layouts = kwargs.get("_dedup_layouts", None)
        self._attn_layouts = None
        self._dedup_attn = None

    # -- basic accessors ----------------------------------------------------

    @property
    def edges(self):
        """[E, 2] (src, dst) pairs in original order."""
        return self._edges

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    @property
    def num_edges(self) -> int:
        return self._num_edges

    @property
    def node_feat(self) -> Dict:
        return self._node_feat

    @property
    def edge_feat(self) -> Dict:
        return self._edge_feat

    @property
    def is_tensor(self) -> bool:
        return self._is_tensor

    # -- adjacency indexes --------------------------------------------------

    @property
    def adj_src_index(self) -> EdgeIndex:
        """CSR: neighbors grouped by src (successors)."""
        if self._adj_src_index is None:
            self._adj_src_index = self._build_index(by="src")
        return self._adj_src_index

    @property
    def adj_dst_index(self) -> EdgeIndex:
        """CSC: neighbors grouped by dst (predecessors) — the recv layout."""
        if self._adj_dst_index is None:
            self._adj_dst_index = self._build_index(by="dst")
        return self._adj_dst_index

    def _build_index(self, by: str) -> EdgeIndex:
        edges = self._edges.cpu().numpy() if self._is_tensor else self._edges
        src, dst = edges[:, 0], edges[:, 1]
        u, v = (src, dst) if by == "src" else (dst, src)
        idx = EdgeIndex.from_edges(u, v, self._num_nodes)
        return idx.tensor(self._edges.device) if self._is_tensor else idx

    # -- degree -------------------------------------------------------------

    def indegree(self, nodes=None):
        deg = self.adj_dst_index.degree
        return deg if nodes is None else deg[nodes]

    def outdegree(self, nodes=None):
        deg = self.adj_src_index.degree
        return deg if nodes is None else deg[nodes]

    # -- message passing ----------------------------------------------------

    def _require_tensor(self):
        if not self._is_tensor:
            raise ValueError("You must call Graph.tensor() first")

    def send_recv(self, feature, reduce_func: str = "sum"):
        """Fused copy-send + built-in reduce."""
        return self.send_u_recv(feature, reduce_op=reduce_func)

    def send_u_recv(self, feature, reduce_op: str = "sum"):
        """SpMM: ``out[d]`` = ``reduce_op`` over incoming edges of
        ``feature[s]``; nodes with no incoming edge give 0."""
        self._require_tensor()
        idx = self.adj_dst_index
        if reduce_op in ("sum", "mean"):
            if self._spmm_layouts is None:
                self._spmm_layouts = self._build_spmm_layouts(
                    self._edges.device)
            flat = feature.reshape(feature.shape[0], -1).contiguous()
            if self._dedup_layouts is not None:
                out = dk.spmm_dedup(flat, *self._dedup_layouts)
            else:
                out = spmm(flat, *self._spmm_layouts)
            out = out.reshape(
                (self._num_nodes,) + feature.shape[1:])
            if reduce_op == "mean":
                deg = idx.degree.clamp(min=1).to(out.dtype)
                out = out / deg.reshape((-1,) + (1,) * (out.ndim - 1))
            return out
        return S.segment_pool(mp.gather_rows(feature, idx.sorted_v),
                              idx.segment_ids, reduce_op,
                              num_segments=self._num_nodes)

    def send_ue_recv(self, feature, edge_feat, message_op: str = "mul",
                     reduce_op: str = "sum"):
        """Edge-weighted SpMM: ``out[d]`` = ``reduce_op`` over the incoming
        edges e of ``feature[s] message_op edge_feat[e]`` (``edge_feat`` in
        the original edge order, broadcast against the gathered rows);
        nodes with no incoming edge give 0.

        mul and add with sum, on a scalar edge feature (``[E]``, ``[E,
        1]``) or one weight a head (``[E, H]`` with H | D on ``[N, D]``;
        ``[E, H]`` or ``[E, H, 1]`` on ``[N, H, Dh]``), run K1w (the CUDA
        kernel, or its plain version on the CPU);
        a scalar mul on a graph with dedup layouts runs the weighted K6.
        Two departures from the reference's rule (``pgl_tpu/graph.py:
        358-419``), each the same function: no ``D % 128`` gate or lane
        padding, and an ``[N, H, Dh]`` feature takes K1w (the reference
        sends every 3-D feature to its segment path)."""
        self._require_tensor()
        mp._check_op(message_op)
        w = None
        if message_op in ("mul", "add") and reduce_op == "sum":
            w = _kernel_weights(feature, edge_feat)
        if w is not None:
            if self._spmm_layouts is None:
                self._spmm_layouts = self._build_spmm_layouts(
                    self._edges.device)
            flat = feature.reshape(feature.shape[0], -1).contiguous()
            w = w.to(flat.dtype).contiguous()
            if (self._dedup_layouts is not None and message_op == "mul"
                    and w.shape[1] == 1):
                out = dk.spmm_dedup_weighted(flat, w.reshape(-1),
                                             *self._dedup_layouts,
                                             self._spmm_layouts[1])
            else:
                out = spmm_weighted(flat, w, *self._spmm_layouts,
                                    message_op)
            return out.reshape((self._num_nodes,) + feature.shape[1:])
        idx = self.adj_dst_index
        ef = edge_feat.index_select(0, idx.sorted_eid)
        msg = mp._COMBINE[message_op](
            mp.gather_rows(feature, idx.sorted_v),
            mp._broadcast_edge(ef, feature.ndim))
        return S.segment_pool(msg, idx.segment_ids, reduce_op,
                              num_segments=self._num_nodes)

    def send_uv(self, src_feat, dst_feat, message_op: str = "add"):
        """Per-edge combine of ``src_feat[src]`` and ``dst_feat[dst]`` by
        ``message_op`` (add/sub/mul/div), in the original edge order."""
        self._require_tensor()
        return mp.send_uv(src_feat, dst_feat, self._edges[:, 0],
                          self._edges[:, 1], message_op=message_op)

    def _attention_layouts(self):
        """``(csc, csr)`` work lists of the attention kernels (K9/K10),
        built from the host indexes on the first call and kept on this
        device graph."""
        self._require_tensor()
        if self._attn_layouts is None:
            self._attn_layouts = build_attention_layouts(
                self.adj_dst_index.numpy(), self.adj_src_index.numpy(),
                self._num_nodes, device=self._edges.device)
        return self._attn_layouts

    def _dedup_attn_aux(self):
        """The count-matrix attention's view of the CSC dedup layout (K7/K8's
        cell lists and ``red``, the fold of K8's slot rows), built from the
        layout on the first call and kept on this device graph; None when
        the graph has no dedup layouts."""
        self._require_tensor()
        if self._dedup_layouts is None:
            return None
        if self._dedup_attn is None:
            self._dedup_attn = build_dedup_attention(self._dedup_layouts[0],
                                                     self._num_nodes)
        return self._dedup_attn

    # -- conversion ---------------------------------------------------------

    def tensor(self, device=None) -> "Graph":
        """Device copy on ``device`` (default: the CUDA card; raises when
        there is none). Builds the CSC/CSR indexes, the K1 SpMM layouts and,
        where ``ops/dispatch.py`` admits the graph, the dedup layouts with
        their counts (K4)."""
        device = resolve_device(device)
        host = self.numpy()
        dst_idx, src_idx = host.adj_dst_index, host.adj_src_index

        def put(x):
            return torch.as_tensor(np.asarray(x), device=device)

        return Graph(
            put(np.asarray(host.edges, dtype=np.int64)),
            num_nodes=self._num_nodes,
            node_feat={k: put(v) for k, v in host.node_feat.items()},
            edge_feat={k: put(v) for k, v in host.edge_feat.items()},
            adj_src_index=src_idx.tensor(device),
            adj_dst_index=dst_idx.tensor(device),
            _spmm_layouts=host._build_spmm_layouts(device),
            _dedup_layouts=host._build_dedup_layouts(device))

    def _build_spmm_layouts(self, device):
        """The SpMM layouts on ``device``: CSC for the forward, CSR for the
        transposed backward (built on the host), with the original edge
        ids that K1w reads its weights through."""
        return tuple(
            build_spmm_layout(idx.indptr, idx.sorted_v, self._num_nodes,
                              kind=kind, device=device,
                              edge_id=idx.sorted_eid)
            for kind, idx in (("csc", self.adj_dst_index.numpy()),
                              ("csr", self.adj_src_index.numpy())))

    def _build_dedup_layouts(self, device):
        """(csc_d, csr_d) on ``device``, or None: both layouts pass the
        band and ratio gates, or neither is kept (``pgl_tpu/graph.py:
        580-604``). Their counts are materialised when both fit the budget
        (``:612-627``); each layout skips it when bf16 cannot hold its
        counts exactly."""
        if not (dispatch.DEDUP and dispatch.DEDUP_MIN_EDGES
                <= self._num_edges <= dispatch.DEDUP_MAX_EDGES):
            return None
        lays = []
        for kind, idx in (("csc", self.adj_dst_index.numpy()),
                          ("csr", self.adj_src_index.numpy())):
            lay = dk.build_dedup_layout(idx.indptr, idx.sorted_v,
                                        self._num_nodes, kind=kind,
                                        max_ratio=dispatch.DEDUP_MAX_RATIO,
                                        device=device,
                                        edge_id=idx.sorted_eid)
            if lay is None:
                return None
            lays.append(lay)
        if sum(lay.counts_bytes for lay in lays) \
                <= dispatch.COUNTS_BUDGET_BYTES:
            lays = [dk.materialize_counts(lay) for lay in lays]
        return tuple(lays)

    def numpy(self) -> "Graph":
        """Host copy (numpy arrays); the indexes carry over."""
        if not self._is_tensor:
            return self

        def get(x):
            return x.detach().cpu().numpy()

        return Graph(
            get(self._edges), num_nodes=self._num_nodes,
            node_feat={k: get(v) for k, v in self._node_feat.items()},
            edge_feat={k: get(v) for k, v in self._edge_feat.items()},
            adj_src_index=(self._adj_src_index.numpy()
                           if self._adj_src_index is not None else None),
            adj_dst_index=(self._adj_dst_index.numpy()
                           if self._adj_dst_index is not None else None))

    def __repr__(self):
        mode = "tensor" if self._is_tensor else "numpy"
        return (f"Graph(num_nodes={self._num_nodes}, "
                f"num_edges={self._num_edges}, mode={mode})")
