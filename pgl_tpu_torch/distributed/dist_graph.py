"""Distributed CPU graph service: sharded hetero graph store + sampling RPC
(port of ``pgl_tpu/distributed/dist_graph.py``).

Capability parity with the reference graph engine wrappers
(``pgl/distributed/dist_graph.py``): ``DistGraphServer`` (``:75``) holding a
node-sharded typed graph, ``DistGraphClient`` (``:134``) with ``load_edges``
(+auto reverse etypes, ``:208-216``), ``sample_successor/predecessor``
(``:225-316``), ``random_sample_nodes`` (``:318``), ``node_batch_iter`` with
stream shuffle (``:35-72,366-402``) and ``get_node_feat`` (``:404``).

A self-contained host-side service: each server owns the out-adjacency of
the nodes hashed to it (``node_id % num_servers``), per edge type; clients
fan requests out by shard and merge. Uniform draws run on the port's C++
host kernel (``native/graph_kernel``: ``sample_subset_with_eid``), weighted
edges on its alias tables, seeded from numpy's ``default_rng`` as the
``pgl_tpu`` service seeds them: the same files and seeds give the same
samples bit for bit. Everything here is numpy on the host; a trainer moves
what it gets to its card. ``parallel.ShardedGraph`` is the full-batch path.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import helper
from .rpc import RpcClient, RpcServer
from ..native import graph_kernel as native

__all__ = ["DistGraphServer", "DistGraphClient", "stream_shuffle_generator"]


class _GraphShard:
    """Per-server storage: etype → CSR over the locally-owned srcs, typed
    node sets as sorted id arrays, features as sorted parallel arrays.

    Array-backed on purpose: ingestion appends numpy chunks (no per-edge
    python objects, ~12 bytes/edge vs ~100 for dict-of-lists) and the CSR
    compacts lazily on first query after a mutation — the same
    store-then-index shape as the reference's C++ engine
    (``pgl/distributed/dist_graph.py:124-131`` scale posture)."""

    def __init__(self, server_id: int, num_servers: int,
                 edge_types: List[str], node_types: List[str]):
        import threading
        # one coarse lock: handler threads (ThreadingTCPServer) may mutate
        # and compact concurrently; compaction's read-build-store must not
        # overwrite a concurrent invalidation
        self._lock = threading.RLock()
        self.server_id = server_id
        self.num_servers = num_servers
        # etype → list of (src, dst, w|None) pending numpy chunks
        self._pending: Dict[str, list] = {e: [] for e in edge_types}
        # etype → (ids [U] sorted unique srcs, indptr [U+1], nbrs [E], w|None)
        self._csr: Dict[str, Optional[tuple]] = {e: None for e in edge_types}
        self._alias: Dict[str, dict] = defaultdict(dict)  # etype → {pos: tbl}
        self._node_chunks: Dict[str, list] = {t: [] for t in node_types}
        self._nodes: Dict[str, Optional[np.ndarray]] = \
            {t: None for t in node_types}
        # (ntype, name) → list of (ids, values) chunks / compacted pair
        self._feat_chunks: Dict[tuple, list] = defaultdict(list)
        self._feat: Dict[tuple, Optional[tuple]] = defaultdict(lambda: None)

    # -- ingestion ----------------------------------------------------------

    def add_edges(self, etype: str, src, dst, weights=None):
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        mine = (src % self.num_servers) == self.server_id
        ws = (np.asarray(weights, dtype=np.float64)[mine]
              if weights is not None else None)
        with self._lock:
            self._pending[etype].append((src[mine], dst[mine], ws))
            self._csr[etype] = None
            self._alias[etype].clear()
        return int(mine.sum())

    def add_nodes(self, ntype: str, nodes):
        nodes = np.asarray(nodes, dtype=np.int64)
        mine = nodes[(nodes % self.num_servers) == self.server_id]
        with self._lock:
            self._node_chunks[ntype].append(mine)
            self._nodes[ntype] = None
            self._all_nodes = None
        return len(mine)

    def set_node_feat(self, ntype: str, name: str, nodes, values):
        nodes = np.asarray(nodes, dtype=np.int64)
        mine = (nodes % self.num_servers) == self.server_id
        vals = np.asarray(values, dtype=object)[mine]
        with self._lock:
            self._feat_chunks[(ntype, name)].append((nodes[mine], vals))
            self._feat[(ntype, name)] = None
        return True

    # -- lazy compaction -----------------------------------------------------

    def _ensure_csr(self, etype: str):
        with self._lock:
            csr = self._csr.get(etype)
            if csr is not None:
                return csr
            chunks = self._pending.get(etype, [])
            if not chunks:
                empty = (np.zeros(0, np.int64), np.zeros(1, np.int64),
                         np.zeros(0, np.int64), None)
                self._csr[etype] = empty
                return empty
            src = np.concatenate([c[0] for c in chunks])
            dst = np.concatenate([c[1] for c in chunks])
            has_w = any(c[2] is not None for c in chunks)
            w = (np.concatenate([
                c[2] if c[2] is not None else np.ones(len(c[0]))
                for c in chunks]) if has_w else None)
            order = np.argsort(src, kind="stable")
            src_s = src[order]
            ids, counts = np.unique(src_s, return_counts=True)
            indptr = np.zeros(len(ids) + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            csr = (ids, indptr, dst[order],
                   w[order] if w is not None else None)
            self._csr[etype] = csr
            return csr

    def _ensure_nodes(self, ntype: Optional[str]) -> np.ndarray:
        with self._lock:
            if ntype is None:
                # cached like the typed pools (invalidated in add_nodes) —
                # rebuilding the union per page made untyped iteration
                # quadratic per epoch
                if getattr(self, "_all_nodes", None) is None:
                    pools = [self._ensure_nodes(t)
                             for t in self._node_chunks]
                    self._all_nodes = (
                        np.unique(np.concatenate(pools)) if pools
                        else np.zeros(0, np.int64))
                return self._all_nodes
            pool = self._nodes.get(ntype)
            if pool is None:
                chunks = self._node_chunks.get(ntype, [])
                pool = (np.unique(np.concatenate(chunks)) if chunks
                        else np.zeros(0, np.int64))
                self._nodes[ntype] = pool
            return pool

    def _ensure_feat(self, ntype: str, name: str):
      with self._lock:
        key = (ntype, name)
        tab = self._feat.get(key)
        if tab is None:
            chunks = self._feat_chunks.get(key, [])
            if not chunks:
                tab = (np.zeros(0, np.int64), np.zeros(0, object))
            else:
                ids = np.concatenate([c[0] for c in chunks])
                vals = np.concatenate([c[1] for c in chunks])
                # later chunks win on duplicates (last write)
                order = np.arange(len(ids))[::-1]
                uids, first = np.unique(ids[order], return_index=True)
                tab = (uids, vals[order][first])
            self._feat[key] = tab
        return tab

    # -- queries ------------------------------------------------------------

    def get_neighbors(self, etype: str, nodes, cap: int = 0):
        """Full adjacency (and weights) per node — the client-side LRU
        cache's fill method (reference ``use_neighbors_sample_cache``,
        ``dist_graph.py:208-456``). ``cap`` > 0 returns None for nodes with
        degree above it (too big to cache — client falls back to server
        sampling)."""
        ids, indptr, nbrs, w = self._ensure_csr(etype)
        out_n, out_w = [], []
        for n in np.asarray(nodes, dtype=np.int64):
            pos = np.searchsorted(ids, n)
            if pos >= len(ids) or ids[pos] != n:
                out_n.append(np.zeros(0, np.int64))
                out_w.append(None)
                continue
            lo, hi = indptr[pos], indptr[pos + 1]
            if cap and hi - lo > cap:
                out_n.append(None)
                out_w.append(None)
                continue
            out_n.append(nbrs[lo:hi].copy())
            out_w.append(w[lo:hi].copy() if w is not None else None)
        return out_n, out_w

    def sample_neighbors(self, etype: str, nodes, max_degree: int,
                         seed=None):
        """Uniform (or weighted when weights were loaded) neighbor sample.
        ``seed=None`` (the default) draws fresh entropy per request —
        repeated calls then differ, as sampling should; pass a seed for
        reproducibility."""
        rng = np.random.default_rng(seed)
        ids, indptr, nbrs, w = self._ensure_csr(etype)
        nodes = np.asarray(nodes, dtype=np.int64)
        if len(ids) == 0:
            return [np.zeros(0, np.int64)] * len(nodes)
        pos_all = np.minimum(np.searchsorted(ids, nodes), len(ids) - 1)
        valid = ids[pos_all] == nodes

        if w is None:
            # one native partial-Fisher-Yates call for the whole batch
            # (per-node python loops were the server hot path)
            out = [np.zeros(0, np.int64)] * len(nodes)
            q = pos_all[valid]
            if q.size:
                out_indptr, out_v, _ = native.sample_subset_with_eid(
                    indptr, nbrs, nbrs, q, max_degree,
                    seed=int(rng.integers(1 << 31)))
                pieces = np.split(out_v, out_indptr[1:-1])
                for i, piece in zip(np.flatnonzero(valid), pieces):
                    out[i] = piece
            return out

        out = []
        for n, pos, ok in zip(nodes, pos_all, valid):
            if not ok:
                out.append(np.zeros(0, dtype=np.int64))
                continue
            pos = int(pos)
            lo, hi = int(indptr[pos]), int(indptr[pos + 1])
            deg = hi - lo
            if deg <= max_degree:
                out.append(nbrs[lo:hi].copy())
                continue
            tbl = self._alias[etype].get(pos)
            if tbl is None:
                tbl = native.alias_sample_build_table(w[lo:hi])
                self._alias[etype][pos] = tbl
            idx = native.alias_sample(tbl[0], tbl[1], max_degree,
                                      seed=rng.integers(1 << 31))
            out.append(nbrs[lo:hi][idx])
        return out

    def sample_neighbors_packed(self, etype: str, nodes,
                                max_degree: int, seed=None):
        """Like :meth:`sample_neighbors` but returns ``(values, counts)``
        — ONE concatenated neighbor array plus per-node counts in request
        order. Framing B tiny arrays dominated the reply cost at batch
        sizes that matter (the wire layer is per-array); packing makes a
        reply two arrays regardless of B."""
        rng = np.random.default_rng(seed)
        ids, indptr, nbrs, w = self._ensure_csr(etype)
        nodes = np.asarray(nodes, dtype=np.int64)
        counts = np.zeros(len(nodes), np.int32)
        if len(ids) == 0:
            return np.zeros(0, np.int64), counts
        pos_all = np.minimum(np.searchsorted(ids, nodes), len(ids) - 1)
        valid = ids[pos_all] == nodes
        if w is None:
            q = pos_all[valid]
            if not q.size:
                return np.zeros(0, np.int64), counts
            out_indptr, out_v, _ = native.sample_subset_with_eid(
                indptr, nbrs, nbrs, q, max_degree,
                seed=int(rng.integers(1 << 31)))
            counts[valid] = np.diff(out_indptr).astype(np.int32)
            return out_v, counts
        pieces = self.sample_neighbors(etype, nodes, max_degree, seed=seed)
        counts = np.asarray([len(p) for p in pieces], np.int32)
        vals = (np.concatenate(pieces) if counts.sum()
                else np.zeros(0, np.int64))
        return vals, counts

    def random_sample_nodes(self, node_type: Optional[str], size: int,
                            seed=None):
        pool = self._ensure_nodes(node_type)
        if not len(pool):
            return np.zeros(0, dtype=np.int64)
        rng = np.random.default_rng(seed)
        return rng.choice(pool, size=min(size, len(pool)), replace=False)

    def iter_nodes(self, node_type: Optional[str], start: int, count: int):
        pool = self._ensure_nodes(node_type)
        return pool[start:start + count]

    def get_node_feat(self, ntype: str, name: str, nodes, packed=False):
        """Per-node feature lookup. ``packed=True`` (numeric fixed-dim
        features) returns ``(mask [Q] bool, matrix [Q, dim])`` — one
        zero-copy frame instead of Q pickled objects (the per-row object
        path capped feature pulls at ~50k rows/s)."""
        ids, vals = self._ensure_feat(ntype, name)
        nodes = np.asarray(nodes, dtype=np.int64)
        if len(ids) == 0:
            if packed:
                return np.zeros(len(nodes), bool), np.zeros((len(nodes), 0),
                                                            np.float32)
            return [None] * len(nodes)
        pos = np.minimum(np.searchsorted(ids, nodes), len(ids) - 1)
        mask = ids[pos] == nodes
        if packed:
            try:
                present = [np.asarray(vals[p], np.float32).reshape(-1)
                           for p in pos[mask]]
                dim = len(present[0]) if present else 0
                mat = np.zeros((len(nodes), dim), np.float32)
                if present:
                    mat[mask] = np.stack(present)
                return mask, mat
            except (ValueError, TypeError):
                pass          # ragged/string features: object path below
        return [vals[p] if ok else None for p, ok in zip(pos, mask)]

    def ping(self):
        return "pong"


class DistGraphServer:
    """One shard server (reference ``dist_graph.py:75``)."""

    def __init__(self, config, shard_num: int, ip_config, server_id: int,
                 is_block: bool = False):
        self.config = helper.load_config(config)
        self.server_id = server_id
        self.ip_addr = helper.load_ip_addr(ip_config)
        num_servers = len(self.ip_addr)
        self.etype2files = helper.parse_files(self.config.etype2files)
        symmetry = bool(self.config.symmetry)
        self.edge_types = helper.get_all_edge_type(self.etype2files, symmetry)
        self.ntype2files = helper.parse_files(self.config.ntype2files)
        self.node_types = list(self.ntype2files.keys())
        self.shard = _GraphShard(server_id, num_servers, self.edge_types,
                                 self.node_types)
        host, port = self.ip_addr[server_id].rsplit(":", 1)
        self._rpc = RpcServer(self.shard, host, int(port)).start()
        if is_block:
            while True:
                time.sleep(3600)

    def stop(self):
        self._rpc.stop()


def stream_shuffle_generator(iterator, batch_size: int, shuffle_size: int,
                             seed: int = 0):
    """Reservoir-style stream shuffle of node batches
    (reference ``dist_graph.py:35-72``)."""
    rng = np.random.default_rng(seed)
    buf: List[np.ndarray] = []
    for batch in iterator:
        buf.append(batch)
        if len(buf) * batch_size >= shuffle_size:
            merged = np.concatenate(buf)
            rng.shuffle(merged)
            for i in range(0, len(merged), batch_size):
                yield merged[i:i + batch_size]
            buf = []
    if buf:
        merged = np.concatenate(buf)
        rng.shuffle(merged)
        for i in range(0, len(merged), batch_size):
            yield merged[i:i + batch_size]


class DistGraphClient:
    """Client routing queries across shard servers
    (reference ``dist_graph.py:134``)."""

    def __init__(self, config, shard_num: int, ip_config, client_id: int,
                 use_cache: bool = False, cache_size: int = 100_000,
                 cache_degree_cap: int = 512):
        self.config = helper.load_config(config)
        self.client_id = client_id
        self.ip_addr = helper.load_ip_addr(ip_config)
        self.num_servers = len(self.ip_addr)
        self.etype2files = helper.parse_files(self.config.etype2files)
        self.symmetry = bool(self.config.symmetry)
        self.edge_types = helper.get_all_edge_type(self.etype2files,
                                                   self.symmetry)
        self.ntype2files = helper.parse_files(self.config.ntype2files)
        self.node_types = list(self.ntype2files.keys())
        self._conns = [RpcClient(addr) for addr in self.ip_addr]
        self._nfeat_info = {}
        for item in (self.config.nfeat_info or []):
            ntype, name, dtype, dim = item
            self._nfeat_info[(ntype, name)] = (dtype, int(dim))
        # neighbor-adjacency LRU (reference use_neighbors_sample_cache,
        # pgl/distributed/dist_graph.py:208-456): cache each node's full
        # neighbor list (degree <= cache_degree_cap) and sample locally —
        # repeat walks over hot nodes skip the RPC entirely.
        self.use_cache = bool(use_cache)
        self._cache_size = int(cache_size)
        self._cache_degree_cap = int(cache_degree_cap)
        from collections import OrderedDict
        self._nbr_cache: "OrderedDict" = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0

    # -- data loading (reference ``:208-223``) -------------------------------

    def load_edges(self):
        for etype, files in self.etype2files.items():
            for path in files:
                data = np.loadtxt(path, dtype=str, ndmin=2)
                src = data[:, 0].astype(np.int64)
                dst = data[:, 1].astype(np.int64)
                w = (data[:, 2].astype(np.float64)
                     if data.shape[1] > 2 else None)
                self._broadcast("add_edges", etype, src, dst, w)
                if self.symmetry:
                    self._broadcast("add_edges", helper.reverse_etype(etype),
                                    dst, src, w)

    def load_node_types(self):
        for ntype, files in self.ntype2files.items():
            for path in files:
                data = np.loadtxt(path, dtype=str, ndmin=2)
                # lines: "<ntype> <node_id> [feat kv...]"
                mask = data[:, 0] == ntype
                nodes = data[mask, 1].astype(np.int64)
                self._broadcast("add_nodes", ntype, nodes)

    def set_node_feat(self, ntype, name, nodes, values):
        self._broadcast("set_node_feat", ntype, name, nodes, values)

    def _broadcast(self, method, *args):
        # writes are not idempotent: a reply lost after the server applied
        # the request must not be resent (it would duplicate edges/nodes)
        return [c.call(method, *args, retries=0) for c in self._conns]

    @property
    def _pool(self):
        """Per-client fan-out pool: per-server RPCs of one query run
        concurrently (socket I/O and the servers' numpy both release the
        GIL, so a query's latency is max over shards, not the sum —
        measured 3-4x at 8 servers, experiments/engine_bench/)."""
        pool = getattr(self, "_fanout_pool", None)
        if pool is None:
            import concurrent.futures as _fut
            pool = _fut.ThreadPoolExecutor(max_workers=self.num_servers)
            self._fanout_pool = pool
        return pool

    def _fanout(self, calls):
        """Run ``calls`` (list of 0-arg closures, one per contacted server)
        concurrently; returns results in order."""
        if len(calls) <= 1:
            return [fn() for fn in calls]
        return list(self._pool.map(lambda fn: fn(), calls))

    def _shard_of(self, node: int) -> int:
        return int(node) % self.num_servers

    # -- sampling (reference ``:225-316``) -----------------------------------

    def sample_successor(self, nodes, max_degree: int, edge_type: str,
                         seed=None, packed: bool = False):
        """``packed=False``: list of per-node neighbor arrays (reference
        API shape, ``pgl/distributed/dist_graph.py:225-316``).
        ``packed=True``: ``(values, counts)`` — one concatenated array +
        per-node counts; the high-throughput form (walks, samplers)."""
        nodes = np.asarray(nodes, dtype=np.int64)
        if self.use_cache:
            res = self._sample_cached(nodes, max_degree, edge_type, seed)
            if not packed:
                return res
            counts = np.asarray([len(r) for r in res], np.int32)
            vals = (np.concatenate(res) if counts.sum()
                    else np.zeros(0, np.int64))
            return vals, counts
        vals, counts = self._sample_rpc(nodes, max_degree, edge_type, seed)
        if packed:
            return vals, counts
        bounds = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=bounds[1:])
        return np.split(vals, bounds[1:-1])

    def _sample_rpc(self, nodes, max_degree, edge_type, seed):
        """Packed fan-out: per contacted server ONE (values, counts)
        reply, re-interleaved into request order without per-node loops."""
        owners = nodes % self.num_servers
        counts = np.zeros(len(nodes), np.int32)
        plan = []
        for s in range(self.num_servers):
            idx = np.nonzero(owners == s)[0]
            if idx.size == 0:
                continue
            plan.append((idx, lambda s=s, idx=idx: self._conns[s].call(
                "sample_neighbors_packed", edge_type, nodes[idx],
                max_degree, None if seed is None else seed + s)))
        parts = list(zip([idx for idx, _ in plan],
                         self._fanout([fn for _, fn in plan])))
        for idx, (vals_s, counts_s) in parts:
            counts[idx] = counts_s
        off = np.zeros(len(nodes) + 1, np.int64)
        np.cumsum(counts, out=off[1:])
        values = np.empty(int(off[-1]), np.int64)
        for idx, (vals_s, counts_s) in parts:
            if not len(vals_s):
                continue
            lens = counts_s.astype(np.int64)
            starts = off[:-1][idx]
            # positions = starts repeated + within-run offsets
            pos = np.repeat(starts, lens) + (
                np.arange(lens.sum()) - np.repeat(
                    np.concatenate([[0], np.cumsum(lens)[:-1]]), lens))
            values[pos] = vals_s
        return values, counts

    def _sample_cached(self, nodes, max_degree, edge_type, seed):
        rng = np.random.default_rng(seed)
        cache = self._nbr_cache
        results: List = [None] * len(nodes)
        misses: List[int] = []
        for i, n in enumerate(nodes):
            key = (edge_type, int(n))
            hit = cache.get(key)
            if hit is None:
                misses.append(i)
                continue
            cache.move_to_end(key)
            self.cache_hits += 1
            results[i] = self._local_sample(hit, max_degree, rng)
        if misses:
            self.cache_misses += len(misses)
            miss_nodes = nodes[np.asarray(misses)]
            owners = miss_nodes % self.num_servers
            for s in range(self.num_servers):
                sel = np.nonzero(owners == s)[0]
                if sel.size == 0:
                    continue
                nbrs, wts = self._conns[s].call(
                    "get_neighbors", edge_type, miss_nodes[sel],
                    self._cache_degree_cap)
                big = [int(miss_nodes[sel][j]) for j, nb in enumerate(nbrs)
                       if nb is None]
                big_res = {}
                if big:
                    # over-cap hubs: sample on the server, don't cache
                    res = self._conns[s].call(
                        "sample_neighbors", edge_type, np.asarray(big),
                        max_degree, None if seed is None else seed + s)
                    big_res = dict(zip(big, res))
                for j, (nb, w) in enumerate(zip(nbrs, wts)):
                    i = misses[int(sel[j])]
                    n = int(miss_nodes[sel[j]])
                    if nb is None:
                        results[i] = big_res[n]
                        continue
                    cache[(edge_type, n)] = (nb, w)
                    while len(cache) > self._cache_size:
                        cache.popitem(last=False)
                    results[i] = self._local_sample((nb, w), max_degree, rng)
        return results

    @staticmethod
    def _local_sample(entry, max_degree, rng):
        nbrs, w = entry
        if len(nbrs) <= max_degree:
            return nbrs.copy()
        if w is not None:
            p = w / w.sum()
            sel = rng.choice(len(nbrs), size=max_degree, replace=True, p=p)
        else:
            sel = rng.choice(len(nbrs), size=max_degree, replace=False)
        return nbrs[sel]

    def sample_predecessor(self, nodes, max_degree: int, edge_type: str,
                           seed=None):
        if not self.symmetry:
            raise ValueError(
                "sample_predecessor needs reverse edges, which are only "
                "loaded when the config sets symmetry: true — with "
                "symmetry: false every node would silently get zero "
                "predecessors")
        return self.sample_successor(nodes, max_degree,
                                     helper.reverse_etype(edge_type), seed)

    def random_sample_nodes(self, node_type=None, size: int = 1,
                            seed=None):
        # ceil quota: floor under-delivered (512 over 3 servers -> 510)
        per = -(-size // self.num_servers)
        parts = self._fanout([
            lambda i=i, c=c: c.call("random_sample_nodes", node_type, per,
                                    None if seed is None else seed + i)
            for i, c in enumerate(self._conns)])
        parts = [p for p in parts if len(p)]
        if not parts:
            return np.zeros(0, np.int64)
        out = np.concatenate(parts)
        if len(out) > size:
            out = np.random.default_rng(seed).choice(out, size,
                                                     replace=False)
        return out

    def node_batch_iter(self, batch_size: int, node_type=None,
                        shuffle: bool = True, shuffle_size: int = 10000,
                        seed: int = 0):
        """Stream all nodes of a type in batches, shard-interleaved with a
        stream shuffle (reference ``:366-402``)."""

        def raw_batches():
            cursors = [0] * self.num_servers
            live = set(range(self.num_servers))
            while live:
                for s in list(live):
                    chunk = self._conns[s].call("iter_nodes", node_type,
                                                cursors[s], batch_size)
                    if len(chunk) == 0:
                        live.discard(s)
                        continue
                    cursors[s] += len(chunk)
                    yield np.asarray(chunk)

        if shuffle:
            yield from stream_shuffle_generator(raw_batches(), batch_size,
                                                shuffle_size, seed)
        else:
            buf = np.zeros(0, dtype=np.int64)
            for b in raw_batches():
                buf = np.concatenate([buf, b])
                while len(buf) >= batch_size:
                    yield buf[:batch_size]
                    buf = buf[batch_size:]
            if len(buf):
                yield buf

    # -- features (reference ``:404-447``) -----------------------------------

    def get_node_feat(self, nodes, node_type: str, feat_names):
        single = isinstance(feat_names, str)
        names = [feat_names] if single else list(feat_names)
        nodes = np.asarray(nodes, dtype=np.int64)
        owners = nodes % self.num_servers
        out = []
        for name in names:
            info = self._nfeat_info.get((node_type, name))
            packed = (info is not None
                      and not np.issubdtype(np.dtype(info[0]), np.str_))
            vals: List = [None] * len(nodes)
            plan = []
            for s in range(self.num_servers):
                idx = np.nonzero(owners == s)[0]
                if idx.size == 0:
                    continue
                plan.append((idx, lambda s=s, idx=idx: self._conns[s].call(
                    "get_node_feat", node_type, name, nodes[idx], packed)))
            for (idx, _), res in zip(plan,
                                     self._fanout([fn for _, fn in plan])):
                if packed and isinstance(res, tuple):
                    mask, mat = res
                    dtype, dim = info
                    mat = mat.astype(dtype)
                    for j, i in enumerate(idx):
                        if mask[j]:
                            vals[i] = (mat[j].reshape(dim) if dim > 1
                                       else mat[j].reshape(()))
                    continue
                for i, r in zip(idx, res):
                    # packed servers fall back to the object path for
                    # ragged/string values — decode those per-row too
                    vals[i] = (self._decode_feat(r, *info)
                               if info is not None else r)
            out.append(vals)
        return out[0] if single else out

    @staticmethod
    def _decode_feat(value, dtype, dim):
        """Apply the dtype/dim declared in nfeat_info (reference client's
        bytes->typed decode, ``dist_graph.py:404-447``); missing values
        stay None."""
        if value is None:
            return None
        if isinstance(value, (bytes, str)):
            txt = value.decode() if isinstance(value, bytes) else value
            return np.asarray(txt.split(), dtype=dtype)
        arr = np.asarray(value, dtype=dtype)
        return arr.reshape(dim) if dim > 1 else arr.reshape(())

    def get_node_types(self):
        return self.node_types

    def get_edge_types(self):
        return self.edge_types

    def stop_server(self):
        pool = getattr(self, "_fanout_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._fanout_pool = None
        for c in self._conns:
            try:
                c.close()
            except Exception:
                pass
