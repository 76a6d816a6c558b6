"""Random-walk sampling on the host (port of ``pgl_tpu/sampling/walk.py``).

``random_walk``, ``node2vec_walk`` and ``node2vec_walk_plus`` run on the
port's C++ host kernels, ``metapath_randomwalk`` on numpy's generator; each
returns a dense ``[num_starts, walk_len]`` int64 array padded with -1 from a
dead end on (or ragged lists with ``as_list=True``), the reference's walks
for a seed. ``metapath_randomwalk_dist`` walks through a distributed graph
client and comes with the distributed layer.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..native import graph_kernel as native

__all__ = ["random_walk", "node2vec_walk", "node2vec_walk_plus",
           "walks_to_lists", "metapath_randomwalk"]


def _csr(graph):
    idx = graph.adj_src_index
    return np.asarray(idx.indptr), np.asarray(idx.sorted_v)


def random_walk(graph, nodes, walk_len: int, seed: int = 0,
                as_list: bool = False):
    """Uniform first-order walks from ``nodes``; -1-padded matrix
    (or ragged lists with ``as_list=True``, matching the reference)."""
    if graph.is_tensor:
        raise ValueError("You must call Graph.numpy() first.")
    indptr, sorted_v = _csr(graph)
    walks = native.random_walk(indptr, sorted_v, np.asarray(nodes),
                               walk_len, seed)
    return walks_to_lists(walks) if as_list else walks


def node2vec_walk(graph, nodes, walk_len: int, p: float = 1.0,
                  q: float = 1.0, seed: int = 0, as_list: bool = False):
    """Second-order biased walks (return parameter ``p``, in-out ``q``) via
    rejection sampling (O(1) per step vs the reference's per-step alias
    rebuild, ``pgl/graph_kernel.pyx:142-224``)."""
    if graph.is_tensor:
        raise ValueError("You must call Graph.numpy() first.")
    indptr, sorted_v = _csr(graph)
    walks = native.node2vec_walk(indptr, sorted_v, np.asarray(nodes),
                                 walk_len, p, q, seed)
    return walks_to_lists(walks) if as_list else walks


def node2vec_walk_plus(graph, nodes, walk_len: int, p: float = 1.0,
                       q: float = 1.0, seed: int = 0, as_list: bool = False):
    """node2vec+ walks (reference ``pgl/sampling/walk.py:125``): like
    :func:`node2vec_walk` but the distance-1 class accumulates the
    neighborhoods of every node visited so far in the walk, so revisiting a
    well-explored region is never penalised by ``q``. ``p==q==1`` degrades
    to a uniform first-order walk, as in the reference."""
    if graph.is_tensor:
        raise ValueError("You must call Graph.numpy() first.")
    if p == 1.0 and q == 1.0:
        return random_walk(graph, nodes, walk_len, seed=seed, as_list=as_list)
    indptr, sorted_v = _csr(graph)
    walks = native.node2vec_walk_plus(indptr, sorted_v, np.asarray(nodes),
                                      walk_len, p, q, seed)
    return walks_to_lists(walks) if as_list else walks


def walks_to_lists(walks: np.ndarray) -> List[List[int]]:
    """Strip -1 padding into ragged python lists."""
    out = []
    for row in walks:
        stop = np.argmax(row < 0) if (row < 0).any() else len(row)
        out.append(row[:stop].tolist())
    return out


def metapath_randomwalk(graph, start_nodes, metapath, walk_length: int,
                        seed: int = 0):
    """Metapath-guided random walk over a HeterGraph (reference:
    ``examples/metapath2vec`` sampling at
    ``examples/metapath2vec/datasets/sampling.py:285-400``).

    ``metapath`` is a string like ``"c2p-p2a-a2p-p2c"`` (edge types joined
    by '-'); the walk repeats the metapath until ``walk_length``. Returns an
    int64 [num_starts, walk_length] array padded with -1 at dead ends.
    """
    rng = np.random.default_rng(seed)
    etypes = metapath.split("-")
    starts = np.asarray(start_nodes, dtype=np.int64)
    W = len(starts)
    walks = np.full((W, walk_length), -1, dtype=np.int64)
    walks[:, 0] = starts
    cur = starts.copy()
    alive = np.ones(W, dtype=bool)
    for step in range(1, walk_length):
        etype = etypes[(step - 1) % len(etypes)]
        idx = graph[etype].adj_src_index
        indptr = np.asarray(idx.indptr)
        sorted_v = np.asarray(idx.sorted_v)
        # vectorized uniform-neighbor step over the live walkers (same
        # deg/offset form as random_walk_with_restart in custom.py)
        live = np.nonzero(alive)[0]
        if live.size == 0:
            break
        lo = indptr[cur[live]]
        deg = indptr[cur[live] + 1] - lo
        has = deg > 0
        alive[live[~has]] = False
        sel = live[has]
        if sel.size:
            offs = rng.integers(0, deg[has])
            cur[sel] = sorted_v[lo[has] + offs]
            walks[sel, step] = cur[sel]
    return walks
