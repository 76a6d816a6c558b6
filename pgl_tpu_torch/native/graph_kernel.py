"""ctypes bindings for the C++ host graph kernels (``graph_kernel.cc``).

Port of ``pgl_tpu/native/graph_kernel.py``: :func:`build_index`,
:func:`map_nodes`, :func:`sample_subset_with_eid`, the walks
(:func:`random_walk`, :func:`node2vec_walk`, :func:`node2vec_walk_plus`),
:func:`skip_gram_gen_pair`, the alias tables
(:func:`alias_sample_build_table`, :func:`alias_sample`),
:func:`extract_edges_from_nodes` and :func:`metis_partition`. The library is
compiled with ``g++`` at first use (never at import) into
``build/libgraph_kernel-<hash>.so``, where the hash covers the source and
the flags; a temporary name renamed atomically lets several processes build
at once. A failed build raises with the compiler's output. The reference
falls back to numpy when its build fails (a BFS partition for
``metis_partition``, ``pgl_tpu/native/graph_kernel.py:409-436``), and
partitions without vertex weights when its library predates the weighted
partitioner; the port does neither, so a sample or a partition never
depends on whether the compiler ran. :func:`build_index_reference` is the
plain numpy version the tests hold the native build against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["build_index", "build_index_reference", "map_nodes",
           "sample_subset_with_eid", "random_walk", "node2vec_walk",
           "node2vec_walk_plus", "skip_gram_gen_pair",
           "alias_sample_build_table", "alias_sample",
           "extract_edges_from_nodes", "metis_partition", "build", "CXX",
           "CXX_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "graph_kernel.cc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()

_i64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_ll = ctypes.c_longlong
_d = ctypes.c_double

# each symbol's (argument types, result type)
_SIGNATURES = {
    "build_index": ([_i64, _i64, _ll, _ll, _i64, _i64, _i64, _i64], None),
    "map_nodes": ([_i64, _ll, _i64, _ll, _i64], None),
    "sample_subset_with_eid": (
        [_i64, _i64, _i64, _i64, _ll, _ll, _ll, _i64, _i64, _i64], None),
    "random_walk": ([_i64, _i64, _i64, _ll, _ll, _ll, _i64], None),
    "node2vec_walk": ([_i64, _i64, _i64, _ll, _ll, _d, _d, _ll, _i64], None),
    "node2vec_walk_plus": (
        [_i64, _i64, _i64, _ll, _ll, _d, _d, _ll, _i64], None),
    "skip_gram_gen_pair": ([_i64, _ll, _ll, _ll, _ll, _i64, _i64], _ll),
    "alias_sample_build_table": ([_f64, _ll, _f64, _i64], None),
    "extract_edges_from_nodes": (
        [_i64, _i64, _i64, _ll, _i64, _ll, _i64], _ll),
    "metis_style_partition": ([_i64, _i64, _ll, _ll, _ll, _i64], None),
    "metis_style_partition_w": (
        [_i64, _i64, _i64, _ll, _ll, _ll, _i64], None),
}


def build() -> Path:
    """Compile ``graph_kernel.cc`` unless its library exists; returns the
    library's path. Raises with the compiler's output when it fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    target = BUILD_DIR / f"libgraph_kernel-{digest[:16]}.so"
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"host kernel build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host kernel build failed ({CXX} exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)   # atomic: concurrent builds agree
    return target


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
        return _lib


def _c(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _check_ids(name, ids, n):
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"{name} ids in [{ids.min()}, {ids.max()}] out of "
                         f"range for {n} nodes")


def build_index(u, v, num_nodes):
    """O(E + N) CSR build by a counting sort on ``u``. Returns (degree,
    sorted_v, sorted_eid, indptr), all int64."""
    u, v = _c(u), _c(v)
    E, N = len(u), int(num_nodes)
    if len(v) != E:
        raise ValueError(f"{E} sources and {len(v)} destinations")
    _check_ids("edge source", u, N)
    lib = _load()
    degree = np.empty(N, dtype=np.int64)
    sorted_v = np.empty(E, dtype=np.int64)
    sorted_eid = np.empty(E, dtype=np.int64)
    indptr = np.empty(N + 1, dtype=np.int64)
    lib.build_index(u, v, E, N, degree, sorted_v, sorted_eid, indptr)
    return degree, sorted_v, sorted_eid, indptr


def build_index_reference(u, v, num_nodes):
    """The plain numpy version of :func:`build_index` (a stable argsort):
    the same four arrays."""
    u, v = _c(u), _c(v)
    N = int(num_nodes)
    degree = np.bincount(u, minlength=N).astype(np.int64)
    indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(degree, out=indptr[1:])
    order = np.argsort(u, kind="stable")
    return degree, v[order], order.astype(np.int64), indptr


def sample_subset_with_eid(indptr, sorted_v, sorted_eid, query, max_degree,
                           seed=0):
    """Uniform ≤ ``max_degree`` neighbour sample of each query node, without
    replacement. Returns (out_indptr [Q+1], out_v, out_eid), packed ragged
    arrays."""
    indptr, sorted_v, sorted_eid, query = map(_c, (indptr, sorted_v,
                                                   sorted_eid, query))
    if int(max_degree) < 0:
        raise ValueError(f"max_degree must be >= 0, got {max_degree}")
    if len(sorted_v) != len(sorted_eid) or indptr[-1] != len(sorted_v):
        raise ValueError("indptr, sorted_v and sorted_eid do not describe "
                         "one index")
    _check_ids("query", query, len(indptr) - 1)
    lib = _load()
    Q = len(query)
    cap = Q * int(max_degree)
    out_indptr = np.empty(Q + 1, dtype=np.int64)
    out_v = np.empty(cap, dtype=np.int64)
    out_eid = np.empty(cap, dtype=np.int64)
    lib.sample_subset_with_eid(indptr, sorted_v, sorted_eid, query, Q,
                               int(max_degree), int(seed), out_indptr, out_v,
                               out_eid)
    n = out_indptr[-1]
    return out_indptr, out_v[:n], out_eid[:n]


def map_nodes(nodes, query):
    """Position of each ``query`` id in ``nodes`` (the first one when an id
    repeats), -1 where it is absent."""
    nodes, query = _c(nodes), _c(query)
    out = np.empty(len(query), dtype=np.int64)
    _load().map_nodes(nodes, len(nodes), query, len(query), out)
    return out


def _check_walk_len(walk_len):
    if int(walk_len) < 1:
        raise ValueError(f"walk_len must be >= 1, got {walk_len}")


def _walk(name, indptr, sorted_v, starts, walk_len, *args):
    _check_walk_len(walk_len)
    indptr, sorted_v, starts = map(_c, (indptr, sorted_v, starts))
    _check_ids("start", starts, len(indptr) - 1)
    lib = _load()
    W = len(starts)
    walks = np.empty(W * int(walk_len), dtype=np.int64)
    getattr(lib, name)(indptr, sorted_v, starts, W, int(walk_len), *args,
                       walks)
    return walks.reshape(W, int(walk_len))


def random_walk(indptr, sorted_v, starts, walk_len, seed=0):
    """First-order uniform walks ``[num_starts, walk_len]`` over the CSR
    (``indptr``, ``sorted_v``); -1 from a dead end on."""
    return _walk("random_walk", indptr, sorted_v, starts, walk_len,
                 int(seed))


def node2vec_walk(indptr, sorted_v, starts, walk_len, p=1.0, q=1.0, seed=0):
    """Second-order walks biased by the return parameter ``p`` and the
    in-out parameter ``q``, by rejection sampling."""
    return _walk("node2vec_walk", indptr, sorted_v, starts, walk_len,
                 float(p), float(q), int(seed))


def node2vec_walk_plus(indptr, sorted_v, starts, walk_len, p=1.0, q=1.0,
                       seed=0):
    """node2vec+ walks: the distance-1 class is the union of every
    neighbourhood the walk has seen so far, not the previous node's
    alone."""
    return _walk("node2vec_walk_plus", indptr, sorted_v, starts, walk_len,
                 float(p), float(q), int(seed))


def skip_gram_gen_pair(walks, max_win, seed=0):
    """(src, dst) positive pairs of ``walks`` [W, L], each centre drawing
    its window in [1, ``max_win``]; a walk stops at its first -1."""
    walks = _c(walks)
    W, L = walks.shape
    cap = W * L * int(max_win)
    src = np.empty(cap, dtype=np.int64)
    dst = np.empty(cap, dtype=np.int64)
    n = _load().skip_gram_gen_pair(walks.reshape(-1), W, L, int(max_win),
                                   int(seed), src, dst)
    return src[:n], dst[:n]


def alias_sample_build_table(weights):
    """O(n) alias table of ``weights``: (events float64 [n], alias int64
    [n])."""
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    n = len(weights)
    events = np.empty(n, dtype=np.float64)
    alias = np.empty(n, dtype=np.int64)
    _load().alias_sample_build_table(weights, n, events, alias)
    return events, alias


def alias_sample(events, alias, num, seed=0):
    """``num`` indices drawn from an alias table (numpy's generator, as the
    reference draws them)."""
    rng = np.random.default_rng(seed)
    n = len(events)
    idx = rng.integers(0, n, size=num)
    coin = rng.random(num)
    return np.where(coin < events[idx], idx, alias[idx])


def extract_edges_from_nodes(indptr, sorted_v, sorted_eid, num_nodes_graph,
                             nodes):
    """Ids of the edges whose two endpoints both lie in ``nodes`` (the
    induced subgraph), in the CSR's order."""
    indptr, sorted_v, sorted_eid, nodes = map(_c, (indptr, sorted_v,
                                                   sorted_eid, nodes))
    _check_ids("node", nodes, len(indptr) - 1)
    cap = int((indptr[nodes + 1] - indptr[nodes]).sum())
    out = np.empty(max(cap, 1), dtype=np.int64)
    n = _load().extract_edges_from_nodes(indptr, sorted_v, sorted_eid,
                                         int(num_nodes_graph), nodes,
                                         len(nodes), out)
    return out[:n]


def metis_partition(indptr, adj, nparts, seed=0, vwgt=None):
    """Multilevel k-way partition of the symmetric adjacency (``indptr``,
    ``adj``): heavy-edge-matching coarsening, greedy growth, boundary
    refinement. ``vwgt``: optional int64 [num_nodes] balance weights.
    Returns the part of each node, int64 [num_nodes]."""
    indptr, adj = _c(indptr), _c(adj)
    n = len(indptr) - 1
    parts = np.empty(n, dtype=np.int64)
    lib = _load()
    if vwgt is not None:
        vwgt = _c(vwgt)
        if vwgt.shape != (n,):
            raise ValueError(f"vwgt of shape {vwgt.shape} for {n} nodes")
        lib.metis_style_partition_w(indptr, adj, vwgt, n, int(nparts),
                                    int(seed), parts)
    else:
        lib.metis_style_partition(indptr, adj, n, int(nparts), int(seed),
                                  parts)
    return parts
