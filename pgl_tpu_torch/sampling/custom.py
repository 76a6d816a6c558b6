"""Subgraph extraction and the custom samplers (port of
``pgl_tpu/sampling/custom.py``): host-side numpy over the port's C++ host
kernels, the same draws in the same order, so a seed gives the reference's
subgraphs."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..graph import Graph
from ..native import graph_kernel as native

__all__ = ["subgraph", "graph_saint_node_sample",
           "graph_saint_random_walk_sample", "pinsage_sample",
           "random_walk_with_restart"]


def subgraph(graph, nodes, eid=None, edges=None, with_node_feat: bool = True,
             with_edge_feat: bool = True) -> Graph:
    """Induce a reindexed subgraph on ``nodes``.

    ``eid`` (edge ids into the parent) or ``edges`` (global (src,dst) pairs)
    selects the edge set; endpoints must all be contained in ``nodes``.
    Features are sliced from the parent. Host-side (numpy graphs only).
    """
    if graph.is_tensor:
        raise ValueError("You must call Graph.numpy() first.")
    if eid is None and edges is None:
        raise ValueError("Eid and edges can't be None at the same time.")
    nodes = np.asarray(nodes, dtype=np.int64)
    if eid is not None:
        eid = np.asarray(eid, dtype=np.int64)   # [] defaults to float64
    if edges is None:
        edges = np.asarray(graph.edges)[eid]
    else:
        edges = np.asarray(edges, dtype=np.int64)

    sub_edge_feat = {}
    if with_edge_feat and graph.edge_feat:
        if eid is None:
            raise ValueError("Eid can not be None with edge features.")
        for key, value in graph.edge_feat.items():
            sub_edge_feat[key] = np.asarray(value)[eid]

    if edges.size:
        flat = native.map_nodes(nodes, edges.reshape(-1))
        if (flat < 0).any():
            raise ValueError("All edge endpoints must be included in nodes")
        sub_edges = flat.reshape(-1, 2)
    else:
        sub_edges = np.zeros((0, 2), dtype=np.int64)

    sub_node_feat = {}
    if with_node_feat:
        for key, value in graph.node_feat.items():
            sub_node_feat[key] = np.asarray(value)[nodes]

    return Graph(sub_edges, num_nodes=len(nodes), node_feat=sub_node_feat,
                 edge_feat=sub_edge_feat)


def graph_saint_node_sample(graph, batch_nodes):
    """GraphSAINT-style node-induced subgraph: keep all edges whose endpoints
    both fall in ``batch_nodes`` (reference ``extract_edges_from_nodes``
    usage, ``pgl/graph_kernel.pyx:396-432`` + Graph4Rec's graphsaint
    sampler). Deterministic given ``batch_nodes`` — the randomness lives
    in how the caller draws the batch. Returns a reindexed subgraph plus
    the kept nodes."""
    if graph.is_tensor:
        raise ValueError("You must call Graph.numpy() first.")
    nodes = np.unique(np.asarray(batch_nodes, dtype=np.int64))
    idx = graph.adj_src_index
    eids = native.extract_edges_from_nodes(
        np.asarray(idx.indptr), np.asarray(idx.sorted_v),
        np.asarray(idx.sorted_eid), graph.num_nodes, nodes)
    return subgraph(graph, nodes=nodes, eid=np.sort(eids)), nodes


def random_walk_with_restart(graph, nodes, depth: int, proba: float = 0.5,
                             seed: int = 0) -> np.ndarray:
    """Vectorized restart walk (reference Graph4Rec
    ``sampling.py:401-447``): each step >= 1 first teleports back to the
    origin with probability ``proba``, then takes a uniform out-neighbor
    step (dead ends stay put). Returns ``[B, depth]`` visited nodes
    (origin excluded; -1 where a dead end produced no step)."""
    g = graph.numpy() if graph.is_tensor else graph
    idx = g.adj_src_index
    indptr = np.asarray(idx.indptr)
    sorted_v = np.asarray(idx.sorted_v)
    rng = np.random.default_rng(seed)
    origin = np.asarray(nodes, dtype=np.int64)
    cur = origin.copy()
    out = np.full((len(origin), depth), -1, dtype=np.int64)
    for l in range(depth):
        if l >= 1:
            back = rng.random(len(cur)) < proba
            cur[back] = origin[back]
        deg = indptr[cur + 1] - indptr[cur]
        alive = deg > 0
        if alive.any():
            offs = np.floor(rng.random(int(alive.sum()))
                            * deg[alive]).astype(np.int64)
            nxt = sorted_v[indptr[cur[alive]] + offs]
            cur[alive] = nxt
            out[alive, l] = nxt
    return out


def pinsage_sample(graph, nodes, samples: Sequence[int], top_k: int = 10,
                   proba: float = 0.5, norm_bias: float = 1.0,
                   seed: int = 0):
    """PinSage importance-based layered sampling (reference Graph4Rec
    ``sampling.py:448-541``): per layer, restart walks from the frontier
    estimate visit counts, the ``top_k`` most-visited nodes become that
    node's weighted in-neighbors (weight = (count + norm_bias) /
    normalizer), and the union feeds the next layer.

    Returns a list over layers (outermost first, like the reference) of
    ``(subgraph, sample_index, node_index)`` where ``subgraph`` carries
    ``edge_feat['weight']``, ``sample_index`` maps local→global node ids
    and ``node_index`` locates the query nodes.
    """
    g = graph.numpy() if graph.is_tensor else graph
    rng = np.random.default_rng(seed)
    nodes = np.asarray(nodes, dtype=np.int64)
    num_layers = len(samples)
    layer_edges: list = []     # per layer: ([E,2] global, [E] weights)
    all_nodes = nodes.copy()
    start_nodes = nodes.copy()
    edges_acc = np.zeros((0, 2), np.int64)
    w_acc = np.zeros((0,), np.float64)

    for layer_idx in reversed(range(num_layers)):
        if len(start_nodes):
            walks = random_walk_with_restart(
                g, start_nodes, samples[layer_idx], proba=proba,
                seed=int(rng.integers(1 << 31)))
            new_e, new_w, new_n = [], [], []
            for node, walk in zip(start_nodes, walks):
                visited = walk[walk >= 0]
                if not len(visited):
                    continue
                uniq, counts = np.unique(visited, return_counts=True)
                order = np.argsort(counts, kind="stable")[-top_k:]
                uniq, counts = uniq[order], counts[order]
                denom = counts.sum() + len(counts) * norm_bias
                ws = (counts + norm_bias) / denom
                new_n.append(uniq)
                new_e.append(np.stack(
                    [uniq, np.full(len(uniq), node)], axis=1))
                new_w.append(ws)
            if new_e:
                prev = set(map(int, all_nodes))
                edges_acc = np.concatenate([edges_acc] + new_e)
                w_acc = np.concatenate([w_acc] + new_w)
                all_nodes = np.unique(np.concatenate(
                    [all_nodes] + new_n))
                start_nodes = np.asarray(
                    [n for n in all_nodes if int(n) not in prev],
                    dtype=np.int64)
            else:
                start_nodes = np.zeros(0, np.int64)
        layer_edges.insert(0, (edges_acc.copy(), w_acc.copy()))

    out = []
    sample_index = all_nodes
    node_pos = {int(n): i for i, n in enumerate(sample_index)}
    node_index = np.asarray([node_pos[int(n)] for n in nodes],
                            dtype=np.int64)
    for edges, ws in layer_edges:
        local = native.map_nodes(sample_index, edges.reshape(-1)) \
            .reshape(-1, 2) if edges.size else np.zeros((0, 2), np.int64)
        sub = Graph(local, num_nodes=len(sample_index),
                    edge_feat={"weight": ws.astype(np.float32)})
        out.append((sub, sample_index, node_index))
    return out


def graph_saint_random_walk_sample(graph, nodes, max_depth: int,
                                   seed: int = 0):
    """GraphSAINT random-walk sampler (reference Graph4Rec
    ``sampling.py:551-581``, paper 1907.04931): walk from the roots, take
    the union of visited nodes, induce the subgraph on them (all internal
    edges). Returns ``(subgraph, sample_nodes)``."""
    from .walk import random_walk
    g = graph.numpy() if graph.is_tensor else graph
    walks = random_walk(g, np.asarray(nodes, dtype=np.int64), max_depth,
                        seed=seed)
    sample_nodes = np.unique(np.asarray(walks).reshape(-1))
    sample_nodes = sample_nodes[sample_nodes >= 0]
    return graph_saint_node_sample(g, sample_nodes)
