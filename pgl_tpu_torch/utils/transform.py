"""Graph transforms (port of ``pgl_tpu/utils/transform.py``).

The edge-set rewrites (``to_undirected``, ``add_self_loops``, ``drop_edge``)
take a host (numpy) graph and return a new one, raising on a device graph
as the reference does; ``filter_adj`` is numpy; ``to_dense_batch`` packs a
tensor of node features by subgraph on the features' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["to_undirected", "add_self_loops", "to_dense_batch",
           "filter_adj", "drop_edge"]


def _require_numpy(graph):
    if graph.is_tensor:
        raise TypeError("The input graph should be numpy format.")


def to_undirected(graph, copy_node_feat: bool = True,
                  copy_edge_feat: bool = False):
    """The graph with every edge in both directions, each pair once
    (sorted, as ``np.unique`` gives them)."""
    from ..graph import Graph
    _require_numpy(graph)
    edges = np.asarray(graph.edges)
    all_edges = np.unique(np.vstack([edges, edges[:, ::-1]]), axis=0)
    if copy_edge_feat:
        raise NotImplementedError(
            "edge features cannot be carried through deduplication")
    node_feat = dict(graph.node_feat) if copy_node_feat else None
    return Graph(all_edges, num_nodes=graph.num_nodes, node_feat=node_feat)


def add_self_loops(graph, copy_node_feat: bool = True,
                   copy_edge_feat: bool = False, replace: bool = False):
    """The graph with one self loop a node appended after its edges; with
    ``replace``, its own self loops are dropped first."""
    from ..graph import Graph
    _require_numpy(graph)
    edges = np.asarray(graph.edges)
    if replace:
        edges = edges[edges[:, 0] != edges[:, 1]]
    loops = np.stack([np.arange(graph.num_nodes)] * 2, axis=1)
    all_edges = np.vstack([edges, loops])
    if copy_edge_feat:
        raise NotImplementedError(
            "self-loop edges have no feature values to copy")
    node_feat = dict(graph.node_feat) if copy_node_feat else None
    return Graph(all_edges.astype(edges.dtype if edges.size else np.int64),
                 num_nodes=graph.num_nodes, node_feat=node_feat)


def to_dense_batch(x, graph, fill_value=0.0,
                   max_num_nodes: Optional[int] = None):
    """Pack node features ``x`` [N, ...] into ``[num_graph, max_num_nodes,
    ...]``, each subgraph's nodes in order, ``fill_value`` after them.

    Returns ``(out, mask)``, ``mask`` [num_graph, max_num_nodes] True at
    the padding. ``max_num_nodes`` defaults to the largest subgraph; a
    subgraph with more nodes keeps its first ``max_num_nodes``, and the
    rest are dropped (not written into the next subgraph's rows)."""
    ids = torch.as_tensor(graph.graph_node_id, device=x.device).long()
    batch = graph.num_graph
    counts = torch.bincount(ids, minlength=batch)[:batch]
    if max_num_nodes is None:
        max_num_nodes = int(counts.max()) if counts.numel() else 0
    pos = torch.arange(ids.shape[0], device=x.device) \
        - (torch.cumsum(counts, 0) - counts).index_select(0, ids)
    keep = pos < max_num_nodes
    flat = (ids * max_num_nodes + pos)[keep]
    size = batch * max_num_nodes
    out = x.new_full((size,) + tuple(x.shape[1:]), fill_value).index_copy(
        0, flat, x[keep])
    mask = torch.ones(size, dtype=torch.bool, device=x.device)
    mask[flat] = False
    return (out.reshape((batch, max_num_nodes) + tuple(x.shape[1:])),
            mask.reshape(batch, max_num_nodes))


def filter_adj(edge_index, perm, edge_attr=None,
               num_nodes: Optional[int] = None):
    """The edges of ``edge_index`` [E, 2] whose ends are both in ``perm``,
    renumbered to their positions in ``perm``, and their ``edge_attr``
    rows (or None). Host-side."""
    edge_index = np.asarray(edge_index)
    perm = np.asarray(perm)
    if num_nodes is None:
        hi = int(edge_index.max()) + 1 if edge_index.size else 0
        if perm.size:
            hi = max(hi, int(perm.max()) + 1)
        num_nodes = hi
    lut = np.full(num_nodes, -1, dtype=np.int64)
    lut[perm] = np.arange(len(perm))
    row, col = lut[edge_index[:, 0]], lut[edge_index[:, 1]]
    keep = (row >= 0) & (col >= 0)
    out = np.stack([row[keep], col[keep]], axis=1)
    if edge_attr is not None:
        return out, np.asarray(edge_attr)[keep]
    return out, None


def drop_edge(graph, rate: float = 0.5, seed=None,
              copy_node_feat: bool = True):
    """A new host graph keeping each edge (and its features) where
    ``np.random.default_rng(seed).random(E) >= rate``: about ``(1 - rate)
    E`` edges. ``seed=None`` draws fresh entropy each call."""
    from ..graph import Graph
    _require_numpy(graph)
    keep = np.random.default_rng(seed).random(graph.num_edges) >= rate
    edge_feat = {k: np.asarray(v)[keep] for k, v in graph.edge_feat.items()}
    node_feat = dict(graph.node_feat) if copy_node_feat else None
    return Graph(np.asarray(graph.edges)[keep], num_nodes=graph.num_nodes,
                 node_feat=node_feat, edge_feat=edge_feat)
