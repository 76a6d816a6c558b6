"""Synthetic graph generators (port of ``pgl_tpu/datasets/synthetic.py``).

Each makes the same numpy RNG calls in the same order as the reference,
so the edges, features and labels are identical for a seed.
"""

from __future__ import annotations

import numpy as np

from ..graph import Graph

__all__ = ["random_graph", "powerlaw_graph", "community_graph",
           "blogcatalog_shaped_graph", "cora_shaped_graph",
           "citation_shaped_graph"]


def random_graph(num_nodes: int, num_edges: int, feat_dim: int = 0,
                 seed: int = 0, weighted: bool = False) -> Graph:
    """Uniform random directed multigraph."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, num_nodes, (num_edges, 2))
    node_feat = {}
    if feat_dim:
        node_feat["h"] = rng.normal(size=(num_nodes, feat_dim)).astype(
            np.float32)
    edge_feat = {}
    if weighted:
        edge_feat["w"] = rng.random(num_edges).astype(np.float32)
    return Graph(edges, num_nodes=num_nodes, node_feat=node_feat,
                 edge_feat=edge_feat)


def powerlaw_graph(num_nodes: int, avg_degree: int = 10, alpha: float = 1.5,
                   feat_dim: int = 0, seed: int = 0) -> Graph:
    """Destinations drawn from a Zipf-like law, so in-degree is heavy-tailed
    (node 0 is the largest hub); sources uniform."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** -alpha
    probs /= probs.sum()
    dst = rng.choice(num_nodes, size=num_edges, p=probs)
    src = rng.integers(0, num_nodes, num_edges)
    edges = np.stack([src, dst], axis=1)
    node_feat = {}
    if feat_dim:
        node_feat["h"] = rng.normal(size=(num_nodes, feat_dim)).astype(
            np.float32)
    return Graph(edges, num_nodes=num_nodes, node_feat=node_feat)


def community_graph(num_nodes: int = 400, num_classes: int = 2,
                    feat_dim: int = 16, avg_degree: int = 8,
                    noise: float = 0.9, p_inter: float = 0.1,
                    seed: int = 0):
    """Planted-partition graph with class-correlated features; returns
    ``(graph, labels)``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes)
    src = np.repeat(np.arange(num_nodes), avg_degree)
    dst = rng.integers(0, num_nodes, num_nodes * avg_degree)
    keep = (labels[src] == labels[dst]) | (rng.random(len(src)) < p_inter)
    edges = np.stack([src[keep], dst[keep]], axis=1)
    feat = (np.eye(num_classes)[labels] @
            rng.normal(size=(num_classes, feat_dim)) +
            noise * rng.normal(size=(num_nodes, feat_dim))).astype(np.float32)
    g = Graph(edges, num_nodes=num_nodes, node_feat={"h": feat})
    return g, labels.astype(np.int32)


# (nodes, undirected edges, feature dim, classes, train split) of the
# three citation benchmarks the reference publishes speed rows for
# (`legacy/docs/source/md/introduction.md:46-63`; Planetoid splits)
_CITATION_SHAPES = {
    "cora": (2708, 5278, 1433, 7, 140),
    "citeseer": (3327, 4552, 3703, 6, 120),
    "pubmed": (19717, 44324, 500, 3, 60),
}


def citation_shaped_graph(name: str = "cora", seed: int = 0):
    """A synthetic simple symmetric graph with the exact node/edge/feature
    shape of a Planetoid citation dataset (no dataset files exist in this
    environment), class-correlated features for learnability. Returns
    ``(graph, labels, train_index)``.

    Edges lean intra-community (70%), are deduplicated and symmetrized —
    like the real citation graphs, the result is a simple graph, which
    keeps the count-matrix attention kernels on their fast path.
    """
    n, m, d, c, n_train = _CITATION_SHAPES[name]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n)
    order = np.argsort(labels)
    counts = np.bincount(labels, minlength=c)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    k = int(m * 1.3)
    src = rng.integers(0, n, k)
    dst_same = order[starts[labels[src]] +
                     rng.integers(0, np.maximum(counts[labels[src]], 1))]
    dst_rand = rng.integers(0, n, k)
    dst = np.where(rng.random(k) < 0.7, dst_same, dst_rand)
    ok = src != dst
    pairs = np.sort(np.stack([src[ok], dst[ok]], 1), axis=1)
    pairs = np.unique(pairs, axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:m]]
    edges = np.concatenate([pairs, pairs[:, ::-1]])
    feat = (np.eye(c)[labels] @ rng.normal(size=(c, d)) +
            1.2 * rng.normal(size=(n, d))).astype(np.float32)
    g = Graph(edges, num_nodes=n, node_feat={"h": feat})
    train_index = rng.choice(n, size=n_train, replace=False).astype(np.int32)
    return g, labels.astype(np.int32), train_index


def cora_shaped_graph(seed: int = 0):
    """Cora-shaped graph (2708 nodes, 10556 directed edges, 1433-d
    features, 7 classes). Returns (graph, labels, train_index)."""
    return citation_shaped_graph("cora", seed=seed)


def blogcatalog_shaped_graph(num_nodes: int = 2000, num_groups: int = 12,
                             avg_degree: int = 16, p_inter: float = 0.05,
                             seed: int = 0):
    """Multi-label planted-community graph shaped like BlogCatalog (the
    reference's distributed-deepwalk benchmark, ``examples/deepwalk/
    README.md``): each node joins 1-3 overlapping groups; edges prefer
    group-mates. Returns ``(graph, labels)`` with ``labels`` a
    [num_nodes, num_groups] 0/1 multi-label matrix (BlogCatalog is
    evaluated with multi-label MacroF1)."""
    rng = np.random.default_rng(seed)
    labels = np.zeros((num_nodes, num_groups), np.int32)
    primary = rng.integers(0, num_groups, num_nodes)
    labels[np.arange(num_nodes), primary] = 1
    extra = rng.random(num_nodes) < 0.4
    labels[np.arange(num_nodes)[extra],
           rng.integers(0, num_groups, int(extra.sum()))] = 1
    src = np.repeat(np.arange(num_nodes), avg_degree)
    dst = rng.integers(0, num_nodes, num_nodes * avg_degree)
    share = (labels[src] & labels[dst]).any(axis=1)
    keep = share | (rng.random(len(src)) < p_inter)
    e = np.stack([src[keep], dst[keep]], axis=1)
    e = np.concatenate([e, e[:, ::-1]], axis=0)          # undirected
    g = Graph(e, num_nodes=num_nodes)
    return g, labels
