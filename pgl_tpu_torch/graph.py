"""Graph — host (numpy) or device (torch) graph with node/edge features.

Port of ``pgl_tpu/graph.py``: construction, degrees, the CSC/CSR indexes
(built by the native counting sort), the host neighbour queries and
sampling, ``tensor``/``numpy`` conversion, the message passing (the UDF
``send``/``recv`` with :class:`~pgl_tpu_torch.message.Message`, the
built-in sends and ``sddmm_csc``), batching (``disjoint``,
``node_batch_iter``), the out-of-core ``streamed_send_u_recv`` over a host
table, and persistence (``dump``/``to_mmap``/``load``, the reference's
directory format). As in the reference, edges are sorted by destination
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
``sddmm_csc`` runs the dedup SDDMM of ``ops/kernels/sddmm_kernels.py``
(K11) on the slot layout ``sddmm_layout()`` builds once from the CSC index.

The attention layouts of ``ops/kernels/attention_kernels.py`` (K9/K10) and
the count-matrix attention's work lists of ``ops/kernels/dedup_attention.py``
(K7/K8: cell lists in row, column and node order, and the additive mode's
fold ``red``) are built on the first attention call that needs them and
kept on the device graph: ``tensor()`` alone does not build them.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .message import Message
from .native import graph_kernel as native
from .ops import dispatch
from .ops import message_passing as mp
from .ops import segment as S
from .ops.kernels import dedup_kernels as dk
from .ops.kernels.attention_kernels import build_attention_layouts
from .ops.kernels.dedup_attention import build_dedup_attention
from .ops.kernels.sddmm_kernels import build_sddmm_layout, sddmm_dedup
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
    """A (possibly batched) directed graph with node/edge feature dicts."""

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
        self._graph_node_index = kwargs.get("_graph_node_index", None)
        self._graph_edge_index = kwargs.get("_graph_edge_index", None)
        self._num_graph = int(kwargs.get("_num_graph", 1))
        self._attn_layouts = None
        self._dedup_attn = None
        self._sddmm_layout = None        # (layout,) once built
        self._streamed = None            # (key, StreamedSpMM) once built

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
    def num_graph(self) -> int:
        """Number of disjoint subgraphs batched into this Graph."""
        return self._num_graph

    @property
    def nodes(self):
        if self._is_tensor:
            return torch.arange(self._num_nodes, device=self._edges.device)
        return np.arange(self._num_nodes)

    @property
    def graph_node_id(self):
        """[N] the subgraph each node belongs to."""
        return _subgraph_ids(self._graph_node_index, self._num_nodes,
                             self._edges)

    @property
    def graph_edge_id(self):
        """[E] the subgraph each edge belongs to."""
        return _subgraph_ids(self._graph_edge_index, self._num_edges,
                             self._edges)

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

    def sorted_edges(self, sort_by: str = "src"):
        """(src, dst, eid) sorted by ``sort_by`` ("src" or "dst")."""
        if sort_by == "src":
            idx = self.adj_src_index
            return idx.sorted_u, idx.sorted_v, idx.sorted_eid
        if sort_by != "dst":
            raise ValueError(f"sort_by must be 'src' or 'dst', got "
                             f"{sort_by!r}")
        idx = self.adj_dst_index
        return idx.sorted_v, idx.sorted_u, idx.sorted_eid

    # -- degree -------------------------------------------------------------

    def indegree(self, nodes=None):
        deg = self.adj_dst_index.degree
        return deg if nodes is None else deg[nodes]

    def outdegree(self, nodes=None):
        deg = self.adj_src_index.degree
        return deg if nodes is None else deg[nodes]

    # -- host-side neighbour queries (numpy mode) ---------------------------

    def _require_numpy(self, what):
        if self._is_tensor:
            raise ValueError(f"{what} is a host-side query; call .numpy() "
                             "first")

    def successor(self, nodes=None, return_eids: bool = False):
        """Each node's successors (a list of arrays; all nodes by default),
        and with ``return_eids`` their edge ids."""
        self._require_numpy("successor")
        idx = self.adj_src_index
        if return_eids:
            return idx.view_v(nodes), idx.view_eid(nodes)
        return idx.view_v(nodes)

    def predecessor(self, nodes=None, return_eids: bool = False):
        """Each node's predecessors, and with ``return_eids`` their edge
        ids."""
        self._require_numpy("predecessor")
        idx = self.adj_dst_index
        if return_eids:
            return idx.view_v(nodes), idx.view_eid(nodes)
        return idx.view_v(nodes)

    def sample_successor(self, nodes, max_degree, return_eids: bool = False,
                         seed: int = 0):
        """At most ``max_degree`` successors of each node, uniformly without
        replacement (the native sampler, seeded by ``seed``)."""
        self._require_numpy("sample_successor")
        return _sample_from_index(self.adj_src_index, nodes, max_degree,
                                  return_eids, seed)

    def sample_predecessor(self, nodes, max_degree, return_eids: bool = False,
                           seed: int = 0):
        """At most ``max_degree`` predecessors of each node."""
        self._require_numpy("sample_predecessor")
        return _sample_from_index(self.adj_dst_index, nodes, max_degree,
                                  return_eids, seed)

    # -- message passing ----------------------------------------------------

    def _require_tensor(self):
        if not self._is_tensor:
            raise ValueError("You must call Graph.tensor() first")

    def send(self, message_func: Callable, src_feat=None, dst_feat=None,
             edge_feat=None, node_feat=None) -> Dict:
        """UDF message: ``message_func(src, dst, edge)`` receives dicts of
        ``[E, ...]`` rows gathered at each edge's endpoints (``node_feat``
        feeds both sides) and the edge features, and returns a dict of
        ``[E, ...]`` messages in the original edge order."""
        self._require_tensor()
        if (src_feat is not None or dst_feat is not None) \
                and node_feat is not None:
            raise ValueError(
                "Can not use src/dst feat and node feat at the same time")
        if node_feat is not None:
            src_in = dst_in = dict(node_feat)
        else:
            src_in, dst_in = dict(src_feat or {}), dict(dst_feat or {})
        src, dst = self._edges[:, 0], self._edges[:, 1]
        msg = message_func({k: mp.gather_rows(v, src)
                            for k, v in src_in.items()},
                           {k: mp.gather_rows(v, dst)
                            for k, v in dst_in.items()},
                           dict(edge_feat or {}))
        if not isinstance(msg, dict):
            raise TypeError("message_func must return a dict of tensors")
        return msg

    def recv(self, reduce_func, msg: Dict, recv_mode: str = "dst"):
        """Aggregate per-edge messages onto nodes: by their destination
        (``recv_mode="dst"``) or source ("src"). ``reduce_func`` is "sum",
        "mean", "max" or "min" (applied to every entry; one entry gives a
        tensor, several a dict), or a function of a
        :class:`~pgl_tpu_torch.message.Message`. A node that receives no
        message gives 0."""
        self._require_tensor()
        if not isinstance(msg, dict):
            raise TypeError("msg must be a dict")
        if recv_mode not in ("dst", "src"):
            raise ValueError(f"recv_mode must be 'dst' or 'src', got "
                             f"{recv_mode!r}")
        index = self.adj_dst_index if recv_mode == "dst" \
            else self.adj_src_index
        bucketed = Message(msg, index.segment_ids, self._num_nodes,
                           eid=index.sorted_eid)
        if callable(reduce_func):
            return reduce_func(bucketed)
        if len(msg) > 1:
            return {k: bucketed.reduce(bucketed[k], reduce_func)
                    for k in msg}
        return bucketed.reduce(bucketed[next(iter(msg))], reduce_func)

    def send_recv(self, feature, reduce_func: str = "sum"):
        """Fused copy-send + built-in reduce."""
        return self.send_u_recv(feature, reduce_op=reduce_func)

    def send_u_recv(self, feature, reduce_op: str = "sum"):
        """SpMM: ``out[d]`` = ``reduce_op`` over incoming edges of
        ``feature[s]``; nodes with no incoming edge give 0. sum and mean
        run the SpMM (the CUDA kernel, or its plain version on the CPU)
        except on an integer, float16 or float64 CUDA feature
        (``dispatch.plain_on_cuda``), which takes the segment path as max
        and min do."""
        self._require_tensor()
        idx = self.adj_dst_index
        if reduce_op in ("sum", "mean") and not dispatch.plain_on_cuda(
                feature):
            if self._spmm_layouts is None:
                self._spmm_layouts = self._build_spmm_layouts(
                    self._edges.device)
            flat = _rows(feature)
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
        kernel, or its plain version on the CPU); a scalar mul on a graph
        with dedup layouts runs the weighted K6. The weights take the
        feature's dtype there, so the feature alone decides: an integer,
        float16 or float64 CUDA feature (``dispatch.plain_on_cuda``) takes
        the segment path, and a bf16 one runs K1w's bf16 instantiation (on
        a graph with dedup layouts the weighted K6's). Two
        departures from the reference's rule
        (``pgl_tpu/graph.py:358-419``), each the same function: no ``D %
        128`` gate or lane padding, and an ``[N, H, Dh]`` feature takes
        K1w (the reference sends every 3-D feature to its segment path)."""
        self._require_tensor()
        mp._check_op(message_op)
        w = None
        if (message_op in ("mul", "add") and reduce_op == "sum"
                and not dispatch.plain_on_cuda(feature)):
            w = _kernel_weights(feature, edge_feat)
        if w is not None:
            if self._spmm_layouts is None:
                self._spmm_layouts = self._build_spmm_layouts(
                    self._edges.device)
            flat = _rows(feature)
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

    def sddmm_csc(self, src_feat, dst_feat, message_op: str = "mul",
                  layout=None):
        """Dedup SDDMM (``ops/kernels/sddmm_kernels.py``; K11 on a CUDA
        graph, its plain version on the CPU): the per-edge combine of
        ``src_feat[src]`` and ``dst_feat[dst]`` by ``message_op``
        (add/sub/mul/div), [N, D] float32 each.

        Returns ``[S, D]`` float32 in the layout's **slot order** (the dedup
        edge order, destination-block-major like CSC; pads are 0). Map a
        real slot back with ``g.sddmm_layout().eid`` (slot → CSC edge
        position) and ``g.adj_dst_index.sorted_eid`` (→ original edge id);
        ``send_uv`` keeps the original edge order. ``layout`` takes a layout
        ``sddmm_layout()`` built earlier. The reference's ``interpret``
        argument (the Pallas kernel's interpret mode on a TPU host) has no
        counterpart here and is dropped."""
        self._require_tensor()
        lay = layout if layout is not None else self.sddmm_layout()
        if lay is None:                 # no edges
            return torch.zeros((0,) + tuple(src_feat.shape[1:]),
                               dtype=torch.float32, device=src_feat.device)
        return sddmm_dedup(src_feat, dst_feat, lay, message_op)

    def sddmm_layout(self):
        """The dedup SDDMM's slot layout, built once on the host from the
        CSC index and kept on this device graph (None without edges)."""
        self._require_tensor()
        if self._sddmm_layout is None:
            idx = self.adj_dst_index.numpy()
            self._sddmm_layout = (build_sddmm_layout(
                idx.indptr, idx.sorted_v, self._num_nodes,
                device=self._edges.device),)
        return self._sddmm_layout[0]

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
        cell lists and ``red``, the fold of the additive K8's slot rows),
        built from the layout on the first call and kept on this device
        graph; None when the graph has no dedup layouts."""
        self._require_tensor()
        if self._dedup_layouts is None:
            return None
        if self._dedup_attn is None:
            self._dedup_attn = build_dedup_attention(self._dedup_layouts[0],
                                                     self._num_nodes)
        return self._dedup_attn

    def streamed_send_u_recv(self, feature_host, reduce_op: str = "sum",
                             chunk_rows: int = 1 << 18, device=None):
        """The SpMM of a host-resident table (numpy or memmap ``[N, D]``)
        that need not fit on the card (the reference's UVA graphs,
        ``pgl/graph.py:227-247``): ``ops/kernels/streaming.py``'s
        :class:`~pgl_tpu_torch.ops.kernels.streaming.StreamedSpMM` runs it
        destination chunk by chunk on ``device`` (default: the card),
        staging each chunk's source rows and writing its rows back. Returns
        a host array. "sum" or "mean" (divided by ``max(in-degree, 1)``);
        anything else raises ``NotImplementedError``, as in the reference.
        The chunks' layouts are built once and kept on the numpy graph
        under ``(chunk_rows, device, dispatch.DEDUP)``, one entry at a
        time (a tensor graph's ``numpy()`` copy is new on every call)."""
        if reduce_op not in ("sum", "mean"):
            raise NotImplementedError(
                "the streamed path supports sum and mean (the SpMM is a sum "
                "machine; stage max and min through the device path)")
        from .ops.kernels.streaming import StreamedSpMM
        g = self.numpy()
        device = resolve_device(device)
        key = (int(chunk_rows), str(device), bool(dispatch.DEDUP))
        if g._streamed is None or g._streamed[0] != key:
            idx = g.adj_dst_index
            g._streamed = (key, StreamedSpMM(idx.indptr, idx.sorted_v,
                                             g.num_nodes, chunk_rows,
                                             device))
        out = g._streamed[1](feature_host)
        if reduce_op == "mean":
            deg = np.maximum(np.asarray(g.adj_dst_index.degree), 1)
            out /= deg[:, None].astype(out.dtype)
        return out

    # -- conversion ---------------------------------------------------------

    def tensor(self, device=None, build_adj: bool = True) -> "Graph":
        """Device copy on ``device`` (default: the CUDA card; raises when
        there is none). float64 features become float32, integer features
        keep their dtype. Builds the CSC/CSR indexes, the K1 SpMM layouts
        and, where ``ops/dispatch.py`` admits the graph, the dedup layouts
        with their counts (K4). With ``build_adj=False`` it builds none of
        them: the indexes already built on this graph go over, and the
        first message passing builds what it needs."""
        device = resolve_device(device)
        host = self.numpy()
        if build_adj:
            dst_idx, src_idx = host.adj_dst_index, host.adj_src_index
            layouts = dict(_spmm_layouts=host._build_spmm_layouts(device),
                           _dedup_layouts=host._build_dedup_layouts(device))
        else:
            dst_idx, src_idx = host._adj_dst_index, host._adj_src_index
            layouts = {}

        return Graph(
            _put(host.edges, device, np.int64),
            num_nodes=self._num_nodes,
            node_feat={k: _put_feat(v, device)
                       for k, v in host.node_feat.items()},
            edge_feat={k: _put_feat(v, device)
                       for k, v in host.edge_feat.items()},
            adj_src_index=None if src_idx is None else src_idx.tensor(device),
            adj_dst_index=None if dst_idx is None else dst_idx.tensor(device),
            _graph_node_index=_put_index(host._graph_node_index, device),
            _graph_edge_index=_put_index(host._graph_edge_index, device),
            _num_graph=self._num_graph, **layouts)

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

        return Graph(
            _get(self._edges), num_nodes=self._num_nodes,
            node_feat={k: _get(v) for k, v in self._node_feat.items()},
            edge_feat={k: _get(v) for k, v in self._edge_feat.items()},
            adj_src_index=(self._adj_src_index.numpy()
                           if self._adj_src_index is not None else None),
            adj_dst_index=(self._adj_dst_index.numpy()
                           if self._adj_dst_index is not None else None),
            _graph_node_index=_get_index(self._graph_node_index),
            _graph_edge_index=_get_index(self._graph_edge_index),
            _num_graph=self._num_graph)

    # -- batching -----------------------------------------------------------

    @classmethod
    def disjoint(cls, graph_list: Sequence["Graph"]) -> "Graph":
        """Merge graphs (all numpy or all on one device) into one
        block-diagonal graph: node ids offset, features concatenated (the
        keys every graph has), ``graph_node_id``/``graph_edge_id`` kept."""
        if not graph_list:
            raise ValueError("graph_list is empty")
        is_tensor = graph_list[0]._is_tensor
        if any(g._is_tensor != is_tensor for g in graph_list):
            raise ValueError("graph_list mixes numpy and tensor graphs")
        node_off = np.cumsum([0] + [g.num_nodes for g in graph_list])
        edge_off = np.cumsum([0] + [g.num_edges for g in graph_list])
        shifted = [g.edges + int(off)
                   for g, off in zip(graph_list, node_off[:-1])]
        cat = torch.cat if is_tensor else np.concatenate
        edges = cat(shifted)
        if is_tensor:
            gni = torch.as_tensor(node_off, device=edges.device)
            gei = torch.as_tensor(edge_off, device=edges.device)
        else:
            gni, gei = node_off.astype(np.int32), edge_off.astype(np.int32)
        return cls(edges, num_nodes=int(node_off[-1]),
                   node_feat=_concat_feats([g.node_feat for g in graph_list],
                                           cat),
                   edge_feat=_concat_feats([g.edge_feat for g in graph_list],
                                           cat),
                   _graph_node_index=gni, _graph_edge_index=gei,
                   _num_graph=len(graph_list))

    batch = disjoint

    def node_batch_iter(self, batch_size: int, shuffle: bool = True,
                        seed: Optional[int] = None):
        """Yield batches of node ids (host), shuffled by
        ``np.random.default_rng(seed)`` unless ``shuffle`` is False."""
        nodes = np.arange(self._num_nodes)
        if shuffle:
            np.random.default_rng(seed).shuffle(nodes)
        for start in range(0, self._num_nodes, batch_size):
            yield nodes[start:start + batch_size]

    # -- persistence --------------------------------------------------------

    def dump(self, path: str):
        """Save as a directory of ``.npy`` files (the reference's format:
        ``edges.npy``, ``meta.json``, ``node_feat/``, ``edge_feat/``, the
        indexes built so far under ``adj_src/`` and ``adj_dst/``, and a
        batched graph's ``graph_node_index.npy`` and
        ``graph_edge_index.npy``)."""
        g = self.numpy()
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "edges.npy"), np.asarray(g._edges))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"num_nodes": g._num_nodes,
                       "num_graph": g._num_graph}, f)
        for sub, feats in (("node_feat", g._node_feat),
                           ("edge_feat", g._edge_feat)):
            d = os.path.join(path, sub)
            os.makedirs(d, exist_ok=True)
            for k, v in feats.items():
                np.save(os.path.join(d, f"{k}.npy"), np.asarray(v))
        for name, idx in (("adj_src", g._adj_src_index),
                          ("adj_dst", g._adj_dst_index)):
            if idx is not None:
                idx.dump(os.path.join(path, name))
        if g._graph_node_index is not None:
            np.save(os.path.join(path, "graph_node_index.npy"),
                    np.asarray(g._graph_node_index))
            np.save(os.path.join(path, "graph_edge_index.npy"),
                    np.asarray(g._graph_edge_index))

    def to_mmap(self, path: str) -> "Graph":
        """Dump to ``path``, then load it back memory-mapped."""
        self.dump(path)
        return Graph.load(path, mmap_mode="r")

    @classmethod
    def load(cls, path: str, mmap_mode: Optional[str] = "r") -> "Graph":
        """Load a dumped graph as a numpy graph, its arrays memory-mapped
        unless ``mmap_mode`` is None."""
        def load(*parts):
            return np.load(os.path.join(path, *parts), mmap_mode=mmap_mode)

        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        feats = {}
        for sub in ("node_feat", "edge_feat"):
            d = os.path.join(path, sub)
            names = sorted(os.listdir(d)) if os.path.isdir(d) else []
            feats[sub] = {fn[:-4]: load(sub, fn) for fn in names
                          if fn.endswith(".npy")}
        kwargs = {}
        for name, key in (("adj_src", "adj_src_index"),
                          ("adj_dst", "adj_dst_index")):
            d = os.path.join(path, name)
            if os.path.isdir(d):
                kwargs[key] = EdgeIndex.load(d, mmap_mode=mmap_mode)
        if os.path.exists(os.path.join(path, "graph_node_index.npy")):
            kwargs["_graph_node_index"] = load("graph_node_index.npy")
            kwargs["_graph_edge_index"] = load("graph_edge_index.npy")
            kwargs["_num_graph"] = len(kwargs["_graph_node_index"]) - 1
        return cls(load("edges.npy"), num_nodes=meta["num_nodes"],
                   node_feat=feats["node_feat"],
                   edge_feat=feats["edge_feat"], **kwargs)

    def __repr__(self):
        mode = "tensor" if self._is_tensor else "numpy"
        return (f"Graph(num_nodes={self._num_nodes}, "
                f"num_edges={self._num_edges}, num_graph={self._num_graph}, "
                f"mode={mode}, node_feat={list(self._node_feat)}, "
                f"edge_feat={list(self._edge_feat)})")


def _rows(feature):
    """``feature`` as a contiguous ``[N, D]`` tensor (N may be 0)."""
    return feature.reshape(feature.shape[0],
                           int(np.prod(feature.shape[1:]))).contiguous()


def _subgraph_ids(indptr, total, like):
    """Subgraph ids from an indptr over subgraphs: int64 on ``like``'s
    device where ``like`` is a tensor, as the indexes, int32 numpy
    otherwise."""
    if isinstance(like, torch.Tensor):
        device = like.device
        if indptr is None:
            return torch.zeros(total, dtype=torch.int64, device=device)
        pos = torch.arange(total, device=device)
        return torch.searchsorted(indptr, pos, right=True) - 1
    if indptr is None:
        return np.zeros(total, dtype=np.int32)
    counts = np.diff(np.asarray(indptr))
    return np.repeat(np.arange(len(counts), dtype=np.int32), counts)


def _put(x, device, dtype=None):
    """A host array as a tensor on ``device`` (a copy of a read-only memory
    map, as ``load`` gives)."""
    a = np.asarray(x, dtype=dtype)
    if not a.flags.writeable:
        a = np.array(a)
    return torch.as_tensor(a, device=device)


def _put_index(indptr, device):
    return None if indptr is None else _put(indptr, device, np.int64)


def _put_feat(x, device):
    """A feature on ``device``: float64 becomes float32, as the reference's
    ``jnp.asarray`` gives in JAX's 32-bit mode; integers keep their dtype
    (int64 stays int64, where the reference gives int32: torch's losses and
    index ops take int64)."""
    a = np.asarray(x)
    return _put(a, device, np.float32 if a.dtype == np.float64 else None)


def _get(x):
    return x.detach().cpu().numpy()


def _get_index(indptr):
    return None if indptr is None else _get(indptr).astype(np.int32)


def _concat_feats(feat_dicts, cat):
    """The features every dict has, concatenated along the first axis by
    ``cat`` (``np.concatenate`` or ``torch.cat``)."""
    keys = set(feat_dicts[0])
    for fd in feat_dicts[1:]:
        keys &= set(fd)
    return {k: cat([fd[k] for fd in feat_dicts]) for k in sorted(keys)}


def _sample_from_index(index: EdgeIndex, nodes, max_degree, return_eids,
                       seed):
    nodes = np.asarray(nodes).reshape(-1)
    out_indptr, out_v, out_eid = native.sample_subset_with_eid(
        index.indptr, index.sorted_v, index.sorted_eid, nodes, max_degree,
        seed)
    neighbors = [out_v[out_indptr[i]:out_indptr[i + 1]]
                 for i in range(len(nodes))]
    if return_eids:
        return neighbors, [out_eid[out_indptr[i]:out_indptr[i + 1]]
                           for i in range(len(nodes))]
    return neighbors
