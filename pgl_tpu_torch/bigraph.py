"""BiGraph — a bipartite graph whose edges run from a source node space to a
different destination node space.

Port of ``pgl_tpu/bigraph.py``: construction, the src and dst feature
dicts, ``graph_{src,dst}_node_id`` and ``graph_edge_id``, the two indexes
(``adj_src_index`` by source, ``adj_dst_index`` by destination), degrees,
the host queries and sampling of each side, the UDF ``send``/``recv``,
``send_recv``, ``disjoint`` and ``dump``/``load`` in the reference's
directory format. The reference's pytree hooks have no counterpart.

``send_recv`` with sum or mean runs K1 (``ops/kernels/segment_kernels.py``:
the CUDA kernel for CUDA tensors, its plain version for CPU tensors) over a
rectangular layout: the forward's rows are the destination nodes and it
gathers the source table; its gradient runs the same kernel over the
layout grouped by source, whose rows are the source nodes. Max and min run
plain segment ops. A BiGraph has no attention work lists, so the attention
layers never take their fused kernels on one
(``ops/dispatch.fused_attention_graph``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .graph import (_check_feat_dict, _concat_feats, _get, _get_index,
                    _put, _put_feat, _put_index, _rows, _sample_from_index,
                    _subgraph_ids)
from .message import Message
from .ops import dispatch
from .ops import message_passing as mp
from .ops import segment as S
from .ops.kernels.segment_kernels import build_spmm_layout, spmm
from .utils.edge_index import EdgeIndex

__all__ = ["BiGraph"]

_INDEXES = ("_graph_src_node_index", "_graph_dst_node_index",
            "_graph_edge_index")


class BiGraph:
    """Edges src -> dst between ``src_num_nodes`` source and
    ``dst_num_nodes`` destination nodes."""

    def __init__(self, edges, src_num_nodes: Optional[int] = None,
                 dst_num_nodes: Optional[int] = None,
                 src_node_feat: Optional[Dict] = None,
                 dst_node_feat: Optional[Dict] = None,
                 edge_feat: Optional[Dict] = None, **kwargs):
        is_tensor = isinstance(edges, torch.Tensor)
        if not is_tensor:
            edges = np.asarray(edges)
        if edges.ndim != 2 or edges.shape[1] != 2:
            raise ValueError(f"edges must be [E, 2], got {tuple(edges.shape)}")
        if src_num_nodes is None or dst_num_nodes is None:
            if is_tensor:
                raise ValueError("src/dst_num_nodes must be given for "
                                 "device graphs")
            src_num_nodes = src_num_nodes or (
                int(edges[:, 0].max()) + 1 if edges.size else 0)
            dst_num_nodes = dst_num_nodes or (
                int(edges[:, 1].max()) + 1 if edges.size else 0)
        self._edges = edges
        self._is_tensor = is_tensor
        self._src_num_nodes = int(src_num_nodes)
        self._dst_num_nodes = int(dst_num_nodes)
        self._num_edges = int(edges.shape[0])
        self._src_node_feat = _check_feat_dict(src_node_feat, "src_node_feat")
        self._dst_node_feat = _check_feat_dict(dst_node_feat, "dst_node_feat")
        self._edge_feat = _check_feat_dict(edge_feat, "edge_feat")
        self._adj_src_index = kwargs.get("adj_src_index")
        self._adj_dst_index = kwargs.get("adj_dst_index")
        for name in _INDEXES:
            setattr(self, name, kwargs.get(name))
        self._num_graph = int(kwargs.get("_num_graph", 1))
        self._spmm_layouts = kwargs.get("_spmm_layouts")

    # -- accessors ----------------------------------------------------------

    @property
    def edges(self):
        return self._edges

    @property
    def num_edges(self) -> int:
        return self._num_edges

    @property
    def src_num_nodes(self) -> int:
        return self._src_num_nodes

    @property
    def dst_num_nodes(self) -> int:
        return self._dst_num_nodes

    @property
    def num_graph(self) -> int:
        return self._num_graph

    def _arange(self, n):
        if self._is_tensor:
            return torch.arange(n, device=self._edges.device)
        return np.arange(n)

    @property
    def src_nodes(self):
        return self._arange(self._src_num_nodes)

    @property
    def dst_nodes(self):
        return self._arange(self._dst_num_nodes)

    @property
    def src_node_feat(self) -> Dict:
        return self._src_node_feat

    @property
    def dst_node_feat(self) -> Dict:
        return self._dst_node_feat

    @property
    def edge_feat(self) -> Dict:
        return self._edge_feat

    @property
    def is_tensor(self) -> bool:
        return self._is_tensor

    @property
    def graph_src_node_id(self):
        """[src_num_nodes] the subgraph each source node belongs to."""
        return _subgraph_ids(self._graph_src_node_index, self._src_num_nodes,
                             self._edges)

    @property
    def graph_dst_node_id(self):
        return _subgraph_ids(self._graph_dst_node_index, self._dst_num_nodes,
                             self._edges)

    @property
    def graph_edge_id(self):
        return _subgraph_ids(self._graph_edge_index, self._num_edges,
                             self._edges)

    # -- adjacency ----------------------------------------------------------

    def _build_index(self, by: str) -> EdgeIndex:
        edges = _get(self._edges) if self._is_tensor else self._edges
        if by == "src":
            idx = EdgeIndex.from_edges(edges[:, 0], edges[:, 1],
                                       self._src_num_nodes)
        else:
            idx = EdgeIndex.from_edges(edges[:, 1], edges[:, 0],
                                       self._dst_num_nodes)
        return idx.tensor(self._edges.device) if self._is_tensor else idx

    @property
    def adj_src_index(self) -> EdgeIndex:
        """Grouped by source: each source's destinations."""
        if self._adj_src_index is None:
            self._adj_src_index = self._build_index("src")
        return self._adj_src_index

    @property
    def adj_dst_index(self) -> EdgeIndex:
        """Grouped by destination: each destination's sources (the recv
        layout)."""
        if self._adj_dst_index is None:
            self._adj_dst_index = self._build_index("dst")
        return self._adj_dst_index

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

    # -- degree / neighbours ------------------------------------------------

    def indegree(self, nodes=None):
        """In-degree over the destination nodes."""
        deg = self.adj_dst_index.degree
        return deg if nodes is None else deg[nodes]

    def outdegree(self, nodes=None):
        """Out-degree over the source nodes."""
        deg = self.adj_src_index.degree
        return deg if nodes is None else deg[nodes]

    def _require_numpy(self, what):
        if self._is_tensor:
            raise ValueError(f"{what} is a host-side query; call .numpy() "
                             "first")

    def successor(self, nodes=None, return_eids: bool = False):
        """Each source's destinations (and with ``return_eids`` their edge
        ids)."""
        self._require_numpy("successor")
        idx = self.adj_src_index
        if return_eids:
            return idx.view_v(nodes), idx.view_eid(nodes)
        return idx.view_v(nodes)

    def predecessor(self, nodes=None, return_eids: bool = False):
        """Each destination's sources."""
        self._require_numpy("predecessor")
        idx = self.adj_dst_index
        if return_eids:
            return idx.view_v(nodes), idx.view_eid(nodes)
        return idx.view_v(nodes)

    def sample_successor(self, nodes, max_degree, return_eids: bool = False,
                         seed: int = 0):
        self._require_numpy("sample_successor")
        return _sample_from_index(self.adj_src_index, nodes, max_degree,
                                  return_eids, seed)

    def sample_predecessor(self, nodes, max_degree,
                           return_eids: bool = False, seed: int = 0):
        self._require_numpy("sample_predecessor")
        return _sample_from_index(self.adj_dst_index, nodes, max_degree,
                                  return_eids, seed)

    # -- message passing ----------------------------------------------------

    def _require_tensor(self):
        if not self._is_tensor:
            raise ValueError("You must call BiGraph.tensor() first")

    def send(self, message_func: Callable, src_feat=None, dst_feat=None,
             edge_feat=None) -> Dict:
        """UDF message: ``message_func(src, dst, edge)`` gets the rows of
        ``src_feat`` (source space) and ``dst_feat`` (destination space)
        at each edge's ends and the edge features, and returns a dict of
        per-edge messages in the original edge order."""
        self._require_tensor()
        src, dst = self._edges[:, 0], self._edges[:, 1]
        msg = message_func({k: mp.gather_rows(v, src)
                            for k, v in (src_feat or {}).items()},
                           {k: mp.gather_rows(v, dst)
                            for k, v in (dst_feat or {}).items()},
                           dict(edge_feat or {}))
        if not isinstance(msg, dict):
            raise TypeError("message_func must return a dict of tensors")
        return msg

    def recv(self, reduce_func, msg: Dict, recv_mode: str = "dst"):
        """Aggregate per-edge messages onto the destination nodes
        (``recv_mode="dst"``) or the source nodes ("src"): "sum", "mean",
        "max", "min" or a function of a
        :class:`~pgl_tpu_torch.message.Message`."""
        self._require_tensor()
        if not isinstance(msg, dict):
            raise TypeError("msg must be a dict")
        if not msg:
            raise ValueError("msg is empty")
        if recv_mode not in ("dst", "src"):
            raise ValueError(f"recv_mode must be 'dst' or 'src', got "
                             f"{recv_mode!r}")
        dst = recv_mode == "dst"
        index = self.adj_dst_index if dst else self.adj_src_index
        bucketed = Message(msg, index.segment_ids,
                           self._dst_num_nodes if dst
                           else self._src_num_nodes, eid=index.sorted_eid)
        if callable(reduce_func):
            return reduce_func(bucketed)
        if len(msg) > 1:
            return {k: bucketed.reduce(bucketed[k], reduce_func)
                    for k in msg}
        return bucketed.reduce(bucketed[next(iter(msg))], reduce_func)

    def send_recv(self, feature, reduce_func: str = "sum"):
        """``out[d]`` = ``reduce_func`` over the edges s -> d of
        ``feature[s]``: ``feature`` on the source nodes, the output on the
        destination nodes (zeros where none arrives). sum and mean run K1
        over the rectangular layout, except on an integer, float16 or
        float64 CUDA feature (``dispatch.plain_on_cuda``), which takes the segment path
        as max and min do."""
        self._require_tensor()
        idx = self.adj_dst_index
        if reduce_func in ("sum", "mean") and not dispatch.plain_on_cuda(
                feature):
            if self._spmm_layouts is None:
                self._spmm_layouts = self._build_spmm_layouts(
                    self._edges.device)
            flat = _rows(feature)
            out = spmm(flat, *self._spmm_layouts).reshape(
                (self._dst_num_nodes,) + feature.shape[1:])
            if reduce_func == "mean":
                deg = idx.degree.clamp(min=1).to(out.dtype)
                out = out / deg.reshape((-1,) + (1,) * (out.ndim - 1))
            return out
        return S.segment_pool(mp.gather_rows(feature, idx.sorted_v),
                              idx.segment_ids, reduce_func,
                              num_segments=self._dst_num_nodes)

    def _build_spmm_layouts(self, device):
        """K1's layouts on ``device``: by destination (``dst_num_nodes``
        rows gathering source rows) for the forward, by source
        (``src_num_nodes`` rows gathering destination rows) for the
        gradient."""
        dst_idx = self.adj_dst_index.numpy()
        src_idx = self.adj_src_index.numpy()
        return (build_spmm_layout(dst_idx.indptr, dst_idx.sorted_v,
                                  self._dst_num_nodes, kind="csc",
                                  device=device, edge_id=dst_idx.sorted_eid),
                build_spmm_layout(src_idx.indptr, src_idx.sorted_v,
                                  self._src_num_nodes, kind="csr",
                                  device=device, edge_id=src_idx.sorted_eid))

    # -- conversion ---------------------------------------------------------

    def tensor(self, device=None) -> "BiGraph":
        """Device copy on ``device`` (default: the CUDA card; raises when
        there is none), with both indexes and K1's two layouts; float64
        features become float32."""
        device = resolve_device(device)
        host = self.numpy()

        def feats(d):
            return {k: _put_feat(v, device) for k, v in d.items()}

        return BiGraph(
            _put(host._edges, device, np.int64),
            src_num_nodes=self._src_num_nodes,
            dst_num_nodes=self._dst_num_nodes,
            src_node_feat=feats(host._src_node_feat),
            dst_node_feat=feats(host._dst_node_feat),
            edge_feat=feats(host._edge_feat),
            adj_src_index=host.adj_src_index.tensor(device),
            adj_dst_index=host.adj_dst_index.tensor(device),
            _num_graph=self._num_graph,
            _spmm_layouts=host._build_spmm_layouts(device),
            **{name: _put_index(getattr(host, name), device)
               for name in _INDEXES})

    def numpy(self) -> "BiGraph":
        """Host copy (numpy arrays); the indexes carry over."""
        if not self._is_tensor:
            return self

        def feats(d):
            return {k: _get(v) for k, v in d.items()}

        return BiGraph(
            _get(self._edges), src_num_nodes=self._src_num_nodes,
            dst_num_nodes=self._dst_num_nodes,
            src_node_feat=feats(self._src_node_feat),
            dst_node_feat=feats(self._dst_node_feat),
            edge_feat=feats(self._edge_feat),
            adj_src_index=(self._adj_src_index.numpy()
                           if self._adj_src_index is not None else None),
            adj_dst_index=(self._adj_dst_index.numpy()
                           if self._adj_dst_index is not None else None),
            _num_graph=self._num_graph,
            **{name: _get_index(getattr(self, name)) for name in _INDEXES})

    # -- batching -----------------------------------------------------------

    @classmethod
    def disjoint(cls, graph_list: Sequence["BiGraph"]) -> "BiGraph":
        """Merge bigraphs (all numpy or all on one device) into one
        block-diagonal bigraph: source and destination ids offset apart,
        features concatenated (the keys every graph has), the subgraph ids
        kept."""
        if not graph_list:
            raise ValueError("graph_list is empty")
        is_tensor = graph_list[0]._is_tensor
        if any(g._is_tensor != is_tensor for g in graph_list):
            raise ValueError("graph_list mixes numpy and tensor graphs")
        src_off = np.cumsum([0] + [g.src_num_nodes for g in graph_list])
        dst_off = np.cumsum([0] + [g.dst_num_nodes for g in graph_list])
        edge_off = np.cumsum([0] + [g.num_edges for g in graph_list])
        cat = torch.cat if is_tensor else np.concatenate
        parts = []
        for g, so, do in zip(graph_list, src_off[:-1], dst_off[:-1]):
            off = np.asarray([so, do])
            if is_tensor:
                off = torch.as_tensor(off, device=g.edges.device)
            else:
                off = off.astype(g.edges.dtype)
            parts.append(g.edges + off)
        edges = cat(parts)
        indexes = (src_off, dst_off, edge_off)
        if is_tensor:
            indexes = [torch.as_tensor(i, device=edges.device)
                       for i in indexes]
        else:
            indexes = [i.astype(np.int32) for i in indexes]
        return cls(edges, src_num_nodes=int(src_off[-1]),
                   dst_num_nodes=int(dst_off[-1]),
                   src_node_feat=_concat_feats(
                       [g.src_node_feat for g in graph_list], cat),
                   dst_node_feat=_concat_feats(
                       [g.dst_node_feat for g in graph_list], cat),
                   edge_feat=_concat_feats(
                       [g.edge_feat for g in graph_list], cat),
                   _num_graph=len(graph_list), **dict(zip(_INDEXES, indexes)))

    batch = disjoint

    # -- persistence --------------------------------------------------------

    def dump(self, path: str):
        """Save as ``edges.npy``, ``meta.json`` (the node counts, the number
        of subgraphs and their index arrays) and one directory of ``.npy``
        files each for ``src_node_feat``, ``dst_node_feat`` and
        ``edge_feat``: the reference's format."""
        g = self.numpy()
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "edges.npy"), np.asarray(g._edges))
        meta = {"src_num_nodes": g._src_num_nodes,
                "dst_num_nodes": g._dst_num_nodes,
                "num_graph": g._num_graph}
        for name in _INDEXES:
            v = getattr(g, name)
            if v is not None:
                meta[name] = np.asarray(v).tolist()
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        for sub, feats in (("src_node_feat", g._src_node_feat),
                           ("dst_node_feat", g._dst_node_feat),
                           ("edge_feat", g._edge_feat)):
            d = os.path.join(path, sub)
            os.makedirs(d, exist_ok=True)
            for k, v in feats.items():
                np.save(os.path.join(d, f"{k}.npy"), np.asarray(v))

    @classmethod
    def load(cls, path: str, mmap_mode="r") -> "BiGraph":
        """Load a dumped bigraph as a host graph, its arrays memory-mapped
        unless ``mmap_mode`` is None."""
        edges = np.load(os.path.join(path, "edges.npy"), mmap_mode=mmap_mode)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        feats = {}
        for sub in ("src_node_feat", "dst_node_feat", "edge_feat"):
            d = os.path.join(path, sub)
            names = sorted(os.listdir(d)) if os.path.isdir(d) else []
            feats[sub] = {fn[:-4]: np.load(os.path.join(d, fn),
                                           mmap_mode=mmap_mode)
                          for fn in names if fn.endswith(".npy")}
        indexes = {name: np.asarray(meta[name], dtype=np.int64)
                   for name in _INDEXES if name in meta}
        return cls(edges, src_num_nodes=meta["src_num_nodes"],
                   dst_num_nodes=meta["dst_num_nodes"],
                   _num_graph=meta.get("num_graph", 1), **feats, **indexes)

    def __repr__(self):
        mode = "tensor" if self._is_tensor else "numpy"
        return (f"BiGraph(src_num_nodes={self._src_num_nodes}, "
                f"dst_num_nodes={self._dst_num_nodes}, "
                f"num_edges={self._num_edges}, mode={mode})")
