"""Heterogeneous halo-partitioned graphs: one :class:`HaloGraph` per edge
type over one shared node partition.

Port of ``pgl_tpu/parallel/halo_heter.py``. The node space is partitioned
once (METIS on the union of every relation's edges, so the cut counts each
type's edges), and each relation gets its own HaloGraph from the same
``parts``: ownership, and so ``node_perm`` and ``N_pad``, depend only on
``parts``, so every relation shares one ``[N_pad, ...]`` node layout on
each rank. Node features shard once; ``RGCNConv`` and ``RUniMP`` run on it
as on a ``HeterGraph`` (``graph[etype]`` per relation).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import comm
from .halo_graph import HaloGraph

__all__ = ["HaloHeterGraph"]


class HaloHeterGraph:
    def __init__(self, subgraphs: Dict[str, HaloGraph], node_feat=None):
        if not subgraphs:
            raise ValueError("need at least one edge type")
        self._subgraphs = dict(subgraphs)
        self.node_feat = node_feat or {}

    @classmethod
    def from_heter_graph(cls, graph, group=None,
                         parts: Optional[np.ndarray] = None,
                         partition: str = "metis", halo_dtype=None,
                         device=None) -> "HaloHeterGraph":
        """Partition ``graph`` (a ``HeterGraph``) over the ranks of
        ``group`` with one node assignment: "metis" on the union of every
        relation's edges, "range" by contiguous ids, or an explicit
        ``parts`` (every rank passes the same)."""
        from ..graph import Graph
        from ..partition import metis_partition
        g = graph.numpy() if getattr(graph, "is_tensor", False) else graph
        group, size, _ = comm.world(group)
        num_nodes = g.num_nodes
        etypes = list(g.edge_types)
        if parts is None and partition == "metis":
            union = np.concatenate(
                [np.asarray(g[t].edges).reshape(-1, 2) for t in etypes])
            parts = metis_partition(Graph(union, num_nodes=num_nodes), size)
        subs = {}
        for t in etypes:
            # bare per-relation graphs: the node features shard once below
            bare = Graph(np.asarray(g[t].edges), num_nodes=num_nodes)
            subs[t] = HaloGraph.from_graph(bare, group, parts=parts,
                                           halo_dtype=halo_dtype,
                                           device=device)
        obj = cls(subs)
        obj.node_feat = {k: obj.shard_node_values(np.asarray(v))
                         for k, v in getattr(g, "node_feat", {}).items()}
        return obj

    def __getitem__(self, etype: str) -> HaloGraph:
        return self._subgraphs[etype]

    def __contains__(self, etype: str) -> bool:
        return etype in self._subgraphs

    @property
    def edge_types(self) -> Sequence[str]:
        return list(self._subgraphs)

    @property
    def _any(self) -> HaloGraph:
        return next(iter(self._subgraphs.values()))

    @property
    def num_nodes(self) -> int:
        return self._any.num_nodes

    @property
    def num_shards(self) -> int:
        return self._any.num_shards

    @property
    def halo_size(self) -> int:
        """Boundary rows of one layer in which every relation aggregates."""
        return sum(s.halo_size for s in self._subgraphs.values())

    def shard_node_values(self, values):
        return self._any.shard_node_values(values)

    def unshard_node_values(self, x):
        return self._any.unshard_node_values(x)

    def indegree(self):
        """``[N_pad]`` summed over the relations."""
        return sum(s.indegree() for s in self._subgraphs.values())

    def save(self, directory: str):
        """Every relation's partition (one npz an edge type, the
        reference's files), the shared features and the edge types, written
        by rank 0; every rank calls it."""
        if self._any.rank == 0:
            os.makedirs(directory, exist_ok=True)
        torch.distributed.barrier(self._any.group)
        for t, sub in self._subgraphs.items():
            sub.save(os.path.join(directory, f"{t}.npz"))
        feats = {k: self.unshard_node_values(v)
                 for k, v in self.node_feat.items()}
        if self._any.rank == 0:
            if feats:
                np.savez_compressed(os.path.join(directory, "feats.npz"),
                                    **feats)
            with open(os.path.join(directory, "meta.json"), "w") as f:
                json.dump({"etypes": list(self._subgraphs)}, f)
        torch.distributed.barrier(self._any.group)

    @classmethod
    def load(cls, directory: str, group=None,
             device=None) -> "HaloHeterGraph":
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        subs = {t: HaloGraph.load(os.path.join(directory, f"{t}.npz"),
                                  group, device=device)
                for t in meta["etypes"]}
        obj = cls(subs)
        fp = os.path.join(directory, "feats.npz")
        if os.path.exists(fp):
            z = np.load(fp)
            obj.node_feat = {k: obj.shard_node_values(z[k])
                             for k in z.files}
        return obj

    def __repr__(self):
        return (f"HaloHeterGraph(num_nodes={self.num_nodes}, "
                f"etypes={self.edge_types}, shards={self.num_shards})")
