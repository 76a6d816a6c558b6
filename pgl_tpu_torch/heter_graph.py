"""HeterGraph — a heterogeneous graph: one :class:`~pgl_tpu_torch.Graph` per
edge type over one shared node-id space.

Port of ``pgl_tpu/heter_graph.py``: construction, typed node sets
(``num_nodes_by_type``, ``nodes_by_type``), the per-type graphs
(``hg[etype]``), degrees summed over the types, the host queries and
sampling of one type, ``node_batch_iter``, ``tensor``/``numpy`` and
``dump``/``load`` in the reference's directory format, so either package
reads what the other wrote. The reference's pytree hooks (a JAX matter)
have no counterpart.

The node features are one table shared by every edge type's graph:
``tensor()`` puts it on the device once and hands that one copy to each
graph.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from . import resolve_device
from .graph import Graph, _put_feat

__all__ = ["HeterGraph"]


class HeterGraph:
    """A dict of per-edge-type graphs over ``num_nodes`` shared nodes."""

    def __init__(self, edges: Dict, num_nodes: Optional[int] = None,
                 node_types=None, node_feat: Optional[Dict] = None,
                 edge_feat: Optional[Dict] = None, **kwargs):
        """
        Args:
          edges: dict etype -> [E_t, 2] (src, dst) array.
          num_nodes: the shared node count (inferred from the edges and
            ``node_types`` when omitted).
          node_types: (node_id, type) pairs, or an array of types indexed
            by node id.
          node_feat: dict name -> [N, ...], shared by every edge type.
          edge_feat: dict etype -> {name: [E_t, ...]}.
        """
        if not isinstance(edges, dict):
            raise TypeError("edges must be a dict of etype -> [E, 2] array")
        edges = {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                 for k, v in edges.items()}
        if num_nodes is None:
            hi = max((int(v.max()) + 1 for v in edges.values()
                      if v.shape[0]), default=0)
            if node_types is not None:
                hi = max(hi, len(self._normalize_node_types(node_types, hi)))
            num_nodes = hi
        self._num_nodes = int(num_nodes)
        self._node_types = (None if node_types is None else
                            self._normalize_node_types(node_types,
                                                       self._num_nodes))
        self._node_feat = dict(node_feat or {})
        edge_feat = edge_feat or {}
        subgraphs = kwargs.get("_subgraphs")
        if subgraphs is None:
            subgraphs = {etype: Graph(e, num_nodes=self._num_nodes,
                                      node_feat=self._node_feat,
                                      edge_feat=edge_feat.get(etype))
                         for etype, e in edges.items()}
        self._subgraphs = subgraphs

    @staticmethod
    def _normalize_node_types(node_types, num_nodes):
        if isinstance(node_types, np.ndarray) and node_types.ndim == 1 \
                and not isinstance(node_types[0], (tuple, list)):
            return node_types
        pairs = list(node_types)
        hi = max((int(nid) for nid, _ in pairs), default=-1) + 1
        types = np.empty(max(num_nodes, hi), dtype=object)
        for nid, ntype in pairs:
            types[int(nid)] = ntype
        return types

    @classmethod
    def _of(cls, subgraphs, num_nodes, node_types) -> "HeterGraph":
        """A HeterGraph over ``subgraphs`` whose node features are the
        first graph's (the shared table)."""
        first = next(iter(subgraphs.values()), None)
        return cls({}, num_nodes=num_nodes, node_types=node_types,
                   node_feat=first.node_feat if first is not None else {},
                   _subgraphs=subgraphs)

    # -- structure ----------------------------------------------------------

    @property
    def edge_types(self):
        return list(self._subgraphs)

    def edge_types_info(self):
        return self.edge_types

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    @property
    def num_edges(self) -> int:
        return sum(g.num_edges for g in self._subgraphs.values())

    @property
    def node_types(self):
        return self._node_types

    @property
    def nodes(self):
        return np.arange(self._num_nodes)

    @property
    def node_feat(self) -> Dict:
        return self._node_feat

    @property
    def edge_feat(self) -> Dict:
        return {etype: g.edge_feat for etype, g in self._subgraphs.items()}

    def __getitem__(self, edge_type) -> Graph:
        return self._subgraphs[edge_type]

    @property
    def is_tensor(self) -> bool:
        return next(iter(self._subgraphs.values())).is_tensor

    def num_nodes_by_type(self, n_type=None):
        """The count of nodes of ``n_type``, or (type, count) pairs of every
        type."""
        if self._node_types is None:
            raise ValueError("node_types were not provided")
        if n_type is None:
            types, counts = np.unique(
                self._node_types[self._node_types != None],  # noqa: E711
                return_counts=True)
            return list(zip(types.tolist(), counts.tolist()))
        return int((self._node_types == n_type).sum())

    def nodes_by_type(self, n_type):
        if self._node_types is None:
            raise ValueError("node_types were not provided")
        return np.nonzero(self._node_types == n_type)[0]

    # -- per-type queries ---------------------------------------------------

    def _etypes_or(self, edge_type):
        return self.edge_types if edge_type is None else [edge_type]

    def indegree(self, nodes=None, edge_type=None):
        """In-degree over ``edge_type``, or summed over every type."""
        return sum(self._subgraphs[t].indegree(nodes)
                   for t in self._etypes_or(edge_type))

    def outdegree(self, nodes=None, edge_type=None):
        return sum(self._subgraphs[t].outdegree(nodes)
                   for t in self._etypes_or(edge_type))

    def successor(self, edge_type, nodes=None, return_eids=False):
        return self._subgraphs[edge_type].successor(nodes, return_eids)

    def predecessor(self, edge_type, nodes=None, return_eids=False):
        return self._subgraphs[edge_type].predecessor(nodes, return_eids)

    def sample_successor(self, edge_type, nodes, max_degree,
                         return_eids=False, seed: int = 0):
        return self._subgraphs[edge_type].sample_successor(
            nodes, max_degree, return_eids, seed)

    def sample_predecessor(self, edge_type, nodes, max_degree,
                           return_eids=False, seed: int = 0):
        return self._subgraphs[edge_type].sample_predecessor(
            nodes, max_degree, return_eids, seed)

    def node_batch_iter(self, batch_size: int, shuffle: bool = True,
                        n_type=None, seed: Optional[int] = None):
        """Batches of the node ids of every node or of ``n_type``, shuffled
        by ``np.random.default_rng(seed)`` unless ``shuffle`` is False."""
        nodes = np.array(self.nodes if n_type is None
                         else self.nodes_by_type(n_type))
        if shuffle:
            np.random.default_rng(seed).shuffle(nodes)
        for start in range(0, len(nodes), batch_size):
            yield nodes[start:start + batch_size]

    # -- conversion ---------------------------------------------------------

    def tensor(self, device=None) -> "HeterGraph":
        """Device copy on ``device`` (default: the CUDA card; raises when
        there is none): each edge type's graph as ``Graph.tensor`` makes it,
        all of them holding one device copy of the shared node features."""
        device = resolve_device(device)
        shared = {k: v.to(device) if isinstance(v, torch.Tensor)
                  else _put_feat(v, device)
                  for k, v in self._node_feat.items()}
        subgraphs = {}
        for etype, g in self._subgraphs.items():
            g = copy.copy(g)
            if not g.is_tensor:
                g._node_feat = {}          # the table goes over once, below
                g = g.tensor(device)
            g._node_feat = shared
            subgraphs[etype] = g
        return HeterGraph._of(subgraphs, self._num_nodes, self._node_types)

    def numpy(self) -> "HeterGraph":
        return HeterGraph._of({k: g.numpy()
                               for k, g in self._subgraphs.items()},
                              self._num_nodes, self._node_types)

    # -- persistence --------------------------------------------------------

    def dump(self, path: str):
        """Save as ``meta.json``, ``node_types.npy`` (untyped nodes as "")
        and one ``Graph.dump`` directory ``etype_<type>`` a type."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"num_nodes": self._num_nodes,
                       "edge_types": self.edge_types}, f)
        if self._node_types is not None:
            np.save(os.path.join(path, "node_types.npy"),
                    np.asarray(["" if t is None else t
                                for t in self._node_types], dtype=str))
        for etype, g in self._subgraphs.items():
            g.dump(os.path.join(path, f"etype_{etype}"))

    @classmethod
    def load(cls, path: str, mmap_mode="r") -> "HeterGraph":
        """Load a dumped HeterGraph as a host graph."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        node_types = None
        types_path = os.path.join(path, "node_types.npy")
        if os.path.exists(types_path):
            raw = np.load(types_path, allow_pickle=False)
            node_types = np.empty(len(raw), dtype=object)
            for i, t in enumerate(raw):
                node_types[i] = str(t) or None
        subgraphs = {etype: Graph.load(os.path.join(path, f"etype_{etype}"),
                                       mmap_mode)
                     for etype in meta["edge_types"]}
        return cls._of(subgraphs, meta["num_nodes"], node_types)

    def __repr__(self):
        parts = ", ".join(f"{k}: {g.num_edges}"
                          for k, g in self._subgraphs.items())
        return f"HeterGraph(num_nodes={self._num_nodes}, edges={{{parts}}})"
