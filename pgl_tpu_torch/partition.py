"""Graph partitioning (port of ``pgl_tpu/partition.py``), on the host.

``metis_partition`` runs the port's copy of the reference's C++ multilevel
partitioner (heavy-edge-matching coarsening, greedy-growth initial
partition, boundary refinement), so a seed gives the reference's parts;
``random_partition`` draws numpy's integers. Both return an ``[num_nodes]``
int64 array of part ids; ``partition_to_order`` and ``reorder_graph``
renumber nodes so each part is contiguous.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .native import graph_kernel as native

__all__ = ["metis_partition", "random_partition", "partition_to_order",
           "reorder_graph"]


def metis_partition(graph, npart: int, seed: int = 0,
                    balance: str = "nodes") -> np.ndarray:
    """K-way partition minimizing edge cut with ~8% balance slack.

    The graph is viewed undirected (out-adjacency symmetrized on the fly).

    ``balance="edges"`` balances per-part EDGE mass (degree vertex
    weights) instead of node count — on heavy-tailed graphs a node-
    balanced partition can give one shard 4x the edges of another,
    and sharded-SpMM step time follows the heaviest shard
    (HaloGraph.scaling_report ``edge_skew``).
    """
    g = graph.numpy() if graph.is_tensor else graph
    if npart <= 1:
        return np.zeros(g.num_nodes, dtype=np.int64)
    edges = np.asarray(g.edges)
    # symmetrize for partitioning quality
    und = np.vstack([edges, edges[:, ::-1]])
    und = und[und[:, 0] != und[:, 1]]
    order = np.argsort(und[:, 0], kind="stable")
    u = und[order, 0]
    v = und[order, 1]
    degree = np.bincount(u, minlength=g.num_nodes)
    indptr = np.concatenate([[0], np.cumsum(degree)])
    vwgt = None
    if balance == "edges":
        vwgt = degree.astype(np.int64) + 1       # +1 keeps isolated nodes
    elif balance == "in_edges":
        # dst-partitioned execution (HaloGraph) processes each edge on
        # its DST owner: balance in-degree mass
        vwgt = np.bincount(edges[:, 1], minlength=g.num_nodes
                           ).astype(np.int64) + 1
    elif balance != "nodes":
        raise ValueError(f"balance must be 'nodes', 'edges' or "
                         f"'in_edges', got {balance!r}")
    return native.metis_partition(indptr, v, npart, seed, vwgt=vwgt)


def random_partition(graph, npart: int, seed: int = 0) -> np.ndarray:
    """Uniform random node assignment (reference ``partition.py:94``)."""
    g = graph.numpy() if graph.is_tensor else graph
    rng = np.random.default_rng(seed)
    return rng.integers(0, npart, g.num_nodes).astype(np.int64)


def partition_to_order(parts: np.ndarray):
    """Stable node ordering grouping each part contiguously.

    Returns ``(order, indptr)``: ``order`` lists node ids part by part,
    ``indptr[p]:indptr[p+1]`` delimits part ``p`` — the relabeling used to
    shard a graph with locality (ShardedGraph dst_range strategy after
    renumbering by this order).
    """
    parts = np.asarray(parts)
    order = np.argsort(parts, kind="stable")
    counts = np.bincount(parts, minlength=int(parts.max()) + 1 if parts.size
                         else 0)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return order, indptr


def reorder_graph(graph, parts: Optional[np.ndarray] = None,
                  npart: Optional[int] = None, seed: int = 0):
    """Renumber nodes so partition members are contiguous — improves HBM
    locality of the SpMM gather (hub/community edges hit nearby rows).

    Returns ``(new_graph, order)`` where ``order[new_id] = old_id``; node
    features and labels must be permuted with ``old[order]`` (node features
    attached to the graph are permuted automatically).
    """
    from .graph import Graph
    g = graph.numpy() if graph.is_tensor else graph
    if parts is None:
        if npart is None:
            npart = max(g.num_nodes // 4096, 2)
        parts = metis_partition(g, npart, seed)
    order, _ = partition_to_order(parts)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    edges = inv[np.asarray(g.edges)]
    node_feat = {k: np.asarray(v)[order] for k, v in g.node_feat.items()}
    return Graph(edges, num_nodes=g.num_nodes, node_feat=node_feat,
                 edge_feat=dict(g.edge_feat)), order
