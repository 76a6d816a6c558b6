"""Random walks on the device (port of ``pgl_tpu/sampling/device_walk.py``).

The adjacency lives on the device as the graph's CSR (``indptr``,
``sorted_v``, int64); a walk advances all its walkers one hop at a time,
each hop a few gathers over ``[B]``, so a ``[B, L]`` block is made with no
host round trip.

* heterogeneous metapaths concatenate the per-type CSRs into one
  offset-addressed table and take each hop's type from a cyclic schedule;
* node2vec's p/q bias is rejection sampling, as the C++ walker does it,
  with the is-neighbour test a ``torch.searchsorted`` over the
  neighbour-sorted adjacency keyed ``owner * num_nodes + neighbour``;
* weighted first-order sampling reads per-neighbourhood alias tables built
  once on the host (``native.alias_sample_build_table``);
* :func:`skipgram_pairs` turns a walk block into ``(src, dst, valid)``
  skip-gram pairs.

Every walk draws from an explicit ``torch.Generator``. Each public method
draws its integers and uniforms, then calls an internal function that
takes the draws as tensors (``_random_walk``, ``_metapath_walk``,
``_node2vec_walk``, ``_skipgram_pairs``): the reference draws the same
quantities from ``jax.random`` keys, and fed those, the internal functions
give the reference's walks exactly. Dead ends emit -1 for every later
position, the host walkers' convention.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..native import graph_kernel as native

__all__ = ["DeviceWalker", "skipgram_pairs"]

# the integer draw of a hop: uniform in [0, 2^30), reduced mod the degree
RAND_HIGH = 1 << 30


def _put(a, device, dtype=torch.int64):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


class DeviceWalker:
    """Build once per graph (host), then call the walk methods.

    Args:
      graph: a numpy or tensor homogeneous ``Graph``, or a ``HeterGraph``
        for metapaths.
      neighbor_sorted: sort each neighbourhood by destination id (host,
        once); ``node2vec_walk`` needs it.
      weighted: name of a scalar edge feature to build alias tables from
        (weighted first-order sampling), or None for uniform.
      device: where the tables live and the walks run (default: the CUDA
        card).
    """

    def __init__(self, graph, neighbor_sorted: bool = False,
                 weighted: Optional[str] = None, device=None):
        self.device = device = resolve_device(device)
        self.is_hetero = bool(getattr(graph, "edge_types", None))
        self.neighbor_sorted = False
        self._alias = None
        self._nbr_key = None
        self.num_nodes = graph.num_nodes
        if self.is_hetero:
            if weighted is not None or neighbor_sorted:
                raise ValueError(
                    "weighted / neighbor_sorted walks are not supported "
                    "for HeterGraph metapath walkers (silently ignoring "
                    "them would sample the wrong distribution)")
            self.etypes = list(graph.edge_types)
            ip, sv, off = [], [], [0]
            for et in self.etypes:
                idx = _host_index(graph[et])
                ip.append(np.asarray(idx.indptr, np.int64))
                sv.append(np.asarray(idx.sorted_v, np.int64))
                off.append(off[-1] + len(sv[-1]))
            # one concatenated edge array; per-type indptr stacked [R, N+1]
            self._indptr = _put(np.stack(
                [p + o for p, o in zip(ip, off[:-1])]), device)
            self._sorted_v = _put(np.concatenate(sv) if sv else
                                  np.zeros(1), device)
            return
        idx = _host_index(graph)
        indptr = np.asarray(idx.indptr, np.int64)
        sv = np.asarray(idx.sorted_v, np.int64)
        eid = np.asarray(idx.sorted_eid, np.int64)
        owner = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                          np.diff(indptr))
        if neighbor_sorted:
            if len(sv):
                # sort within each neighbourhood (host, once); eid follows
                # sv, so the alias tables below attach weights to the
                # right slots
                perm = np.argsort(owner * (sv.max() + 2) + sv,
                                  kind="stable")
                sv = sv[perm]
                eid = eid[perm]
            # the searchsorted key of node2vec's is-neighbour test
            self._nbr_key = _put(owner * max(self.num_nodes, 1) + sv,
                                 device)
        self.neighbor_sorted = neighbor_sorted
        self._indptr = _put(indptr, device)[None]
        self._sorted_v = _put(sv if len(sv) else np.zeros(1), device)
        if weighted is not None:
            w = np.asarray(graph.edge_feat[weighted].cpu()
                           if isinstance(graph.edge_feat[weighted],
                                         torch.Tensor)
                           else graph.edge_feat[weighted],
                           np.float64).reshape(-1)[eid]
            probs = np.zeros(len(sv), np.float32)
            alias = np.zeros(len(sv), np.int64)
            for u in range(len(indptr) - 1):
                lo, hi = int(indptr[u]), int(indptr[u + 1])
                if hi > lo:
                    p_, a_ = native.alias_sample_build_table(
                        w[lo:hi] / max(w[lo:hi].sum(), 1e-12))
                    probs[lo:hi] = p_
                    alias[lo:hi] = a_
            self._alias = (_put(probs, device, torch.float32),
                           _put(alias, device))

    # -- public walks: draw, then walk ---------------------------------------

    def _ints(self, shape, generator):
        return torch.randint(0, RAND_HIGH, shape, generator=generator,
                             device=self.device)

    def _unif(self, shape, generator):
        return torch.rand(shape, generator=generator, device=self.device)

    def random_walk(self, starts, walk_len: int,
                    generator: torch.Generator):
        """Uniform (or alias-weighted) first-order walks ``[B, walk_len]``
        int32: one integer (and with alias tables one uniform) a walker a
        hop."""
        starts = _put(starts, self.device)
        shape = (walk_len - 1, starts.shape[0])
        r = self._ints(shape, generator)
        u = self._unif(shape, generator) if self._alias is not None \
            else None
        return _random_walk(self._indptr, self._sorted_v, self._alias,
                            starts, r, u)

    def metapath_walk(self, starts, metapath: Sequence[str], walk_len: int,
                      generator: torch.Generator):
        """Typed walks following the cyclic edge-type schedule
        ``metapath``: one integer a walker a hop."""
        if not self.is_hetero:
            raise ValueError("metapath_walk needs a HeterGraph walker")
        sched = tuple(self.etypes.index(et) for et in metapath)
        starts = _put(starts, self.device)
        r = self._ints((walk_len - 1, starts.shape[0]), generator)
        return _metapath_walk(self._indptr, self._sorted_v, starts, r,
                              sched)

    def node2vec_walk(self, starts, walk_len: int,
                      generator: torch.Generator, p: float = 1.0,
                      q: float = 1.0, tries: int = 8):
        """Second-order p/q-biased walks by rejection sampling: draw a
        uniform neighbour candidate, accept it with weight 1/p (back to the
        previous node), 1 (a neighbour of it) or 1/q, over the largest;
        ``tries`` rounds a hop, then a uniform fallback."""
        if not self.neighbor_sorted:
            raise ValueError("node2vec needs DeviceWalker("
                             "neighbor_sorted=True)")
        starts = _put(starts, self.device)
        B, S, T = starts.shape[0], max(walk_len - 2, 0), tries
        alias = self._alias is not None
        draws = {"first_r": self._ints((B,), generator),
                 "r": self._ints((S, T, B), generator),
                 "acc": self._unif((S, T, B), generator),
                 "fb_r": self._ints((S, B), generator)}
        if alias:
            draws.update(first_u=self._unif((B,), generator),
                         u=self._unif((S, T, B), generator),
                         fb_u=self._unif((S, B), generator))
        return _node2vec_walk(self._indptr, self._sorted_v, self._nbr_key,
                              self.num_nodes, self._alias, starts, draws,
                              p, q)


def _host_index(graph):
    idx = graph.adj_src_index        # successors: u -> out-neighbours
    return idx.numpy() if idx.is_tensor else idx


# -- the walks given their draws ----------------------------------------------


def _hop(indptr, sorted_v, alias, cur, r, u=None, et=0):
    """One uniform (or alias) hop of every walker at ``cur`` given its
    integer draw ``r`` (and uniform ``u``): ``(next, has_edges)``; a
    walker without out-edges stays."""
    ip = indptr[et]
    lo = ip[cur]
    deg = ip[cur + 1] - lo
    r = r % deg.clamp(min=1)
    last = sorted_v.shape[0] - 1
    if alias is not None:
        probs, al = alias
        slot = (lo + r).clamp(max=last)
        r = torch.where(u < probs[slot], r, al[slot])
    nxt = sorted_v[(lo + r).clamp(max=last)]
    return torch.where(deg > 0, nxt, cur), deg > 0


def _finish(starts, tail):
    return torch.cat([starts[None]] + tail).T.to(torch.int32).contiguous()


def _random_walk(indptr, sorted_v, alias, starts, r, u=None):
    """Walks ``[B, L]`` from ``starts`` given ``r`` (and ``u``) [L-1, B];
    -1 from a dead end on."""
    cur = starts
    alive = torch.ones_like(starts, dtype=torch.bool)
    tail = []
    for s in range(r.shape[0]):
        nxt, ok = _hop(indptr, sorted_v, alias, cur, r[s],
                       None if u is None else u[s])
        alive = alive & ok
        cur = torch.where(alive, nxt, cur)
        tail.append(torch.where(alive, cur, -1)[None])
    return _finish(starts, tail)


def _metapath_walk(indptr, sorted_v, starts, r, sched):
    """Typed walks ``[B, L]`` given ``r`` [L-1, B]: hop ``s`` follows edge
    type ``sched[s % len(sched)]``."""
    cur = starts
    alive = torch.ones_like(starts, dtype=torch.bool)
    tail = []
    for s in range(r.shape[0]):
        nxt, ok = _hop(indptr, sorted_v, None, cur, r[s],
                       et=sched[s % len(sched)])
        alive = alive & ok
        cur = torch.where(alive, nxt, cur)
        tail.append(torch.where(alive, cur, -1)[None])
    return _finish(starts, tail)


def _is_neighbor(nbr_key, num_nodes, u, x):
    """Whether ``x`` is an out-neighbour of ``u`` (elementwise), by a
    binary search over the neighbour-sorted adjacency's keys."""
    if nbr_key.shape[0] == 0:
        return torch.zeros_like(u, dtype=torch.bool)
    q = u * max(num_nodes, 1) + x
    pos = torch.searchsorted(nbr_key, q)
    found = nbr_key[pos.clamp(max=max(nbr_key.shape[0] - 1, 0))] == q
    return (pos < nbr_key.shape[0]) & found


def _node2vec_walk(indptr, sorted_v, nbr_key, num_nodes, alias, starts,
                   draws, p, q):
    """node2vec walks ``[B, L]`` given ``draws``: ``first_r`` [B] (the
    first hop), then for each of the L-2 later hops ``r`` and ``acc``
    [L-2, T, B] (each trial's candidate and acceptance draw) and ``fb_r``
    [L-2, B] (the fallback hop); with alias tables also ``first_u``, ``u``
    and ``fb_u`` of the same shapes."""
    f32 = dict(dtype=torch.float32, device=starts.device)
    inv_p, inv_q = 1.0 / p, 1.0 / q
    m = torch.tensor(max(inv_p, inv_q, 1.0), **f32)
    w_back, w_near, w_far = (torch.tensor(v, **f32)
                             for v in (inv_p, 1.0, inv_q))
    au = alias is not None
    first, ok0 = _hop(indptr, sorted_v, alias, starts, draws["first_r"],
                      draws["first_u"] if au else None)
    cur, prev, alive = first, starts, ok0
    tail = [torch.where(ok0, first, -1)[None]]
    for s in range(draws["r"].shape[0]):
        nxt = cur
        accepted = torch.zeros_like(cur, dtype=torch.bool)
        for t in range(draws["r"].shape[1]):
            cand, ok = _hop(indptr, sorted_v, alias, cur, draws["r"][s, t],
                            draws["u"][s, t] if au else None)
            w = torch.where(cand == prev, w_back,
                            torch.where(_is_neighbor(nbr_key, num_nodes, prev,
                                                     cand), w_near, w_far))
            acc = (draws["acc"][s, t] * m < w) & ok
            nxt = torch.where(acc & ~accepted, cand, nxt)
            accepted = accepted | acc
        # unaccepted after all tries: a uniform hop (dead without edges)
        fb, ok = _hop(indptr, sorted_v, alias, cur, draws["fb_r"][s],
                      draws["fb_u"][s] if au else None)
        nxt = torch.where(accepted, nxt, torch.where(ok, fb, cur))
        alive = alive & (accepted | ok)
        nxt = torch.where(alive, nxt, cur)
        cur, prev = nxt, cur
        tail.append(torch.where(alive, nxt, -1)[None])
    return _finish(starts, tail)


def skipgram_pairs(walks, win: int, generator: torch.Generator):
    """Skip-gram pairs of a ``[B, L]`` walk block: each centre draws a
    window in [1, ``win``] and pairs with the positions within it on both
    sides. Returns ``(src, dst, valid)`` flattened to ``[B * L * 2 *
    win]``; ``valid`` masks positions past the walk's ends, outside the
    window, and the -1 of dead ends."""
    B, L = walks.shape
    r = torch.randint(1, win + 1, (B, L), generator=generator,
                      device=walks.device)
    return _skipgram_pairs(walks, win, r)


def _skipgram_pairs(walks, win, r):
    """:func:`skipgram_pairs` given the window draws ``r`` [B, L]."""
    B, L = walks.shape
    idx = torch.arange(L, device=walks.device)
    src, dst, valid = [], [], []
    for sign in (1, -1):
        for o in range(1, win + 1):
            j = idx + sign * o
            ok = (j >= 0) & (j < L) & (o <= r)
            src.append(walks)
            dst.append(walks[:, j.clamp(0, L - 1)])
            valid.append(ok)
    src = torch.stack(src, 2).reshape(-1)
    dst = torch.stack(dst, 2).reshape(-1)
    val = torch.stack(valid, 2).reshape(-1)
    return src, dst, val & (src >= 0) & (dst >= 0)
