"""Port parity for the device walks (``pgl_tpu_torch.sampling.device_walk``)
on the CPU against ``pgl_tpu``'s: each case of the reference's
``tests/test_device_walk.py`` mirrored with a ``torch.Generator``, and the
internal walk functions fed the draws the reference makes from its
``jax.random`` keys, whose walks and pairs must equal the reference's
exactly (uniform and alias-weighted first-order walks, metapaths,
node2vec with and without alias tables, skip-gram pairs).
"""

import numpy as np
import pytest
import torch

import jax

import pgl_tpu
import pgl_tpu.sampling as jsampling
from pgl_tpu_torch import Graph, HeterGraph
from pgl_tpu_torch.datasets import powerlaw_graph
from pgl_tpu_torch.sampling import (DeviceWalker, random_walk,
                                    skipgram_pairs)
from pgl_tpu_torch.sampling import device_walk as dw

# one intra-op thread: the test files run in parallel worker processes
torch.set_num_threads(1)

HIGH = 1 << 30


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _und(edges, n):
    e = np.concatenate([edges, edges[:, ::-1]], 0)
    return Graph(e, num_nodes=n), pgl_tpu.Graph(e, num_nodes=n)


def t(x):
    return torch.as_tensor(np.array(x))


def walker(g, **kw):
    return DeviceWalker(g, device="cpu", **kw)


def edge_set(g):
    return set(map(tuple, np.asarray(g.edges).tolist()))


def assert_follow_edges(walks, es):
    for row in walks:
        for a, b in zip(row[:-1], row[1:]):
            if b < 0:
                break
            assert a == b or (int(a), int(b)) in es


# -- the reference's draws from its keys ------------------------------------

def hop_draws(key, shape):
    """``_hop``'s draws: ``randint(k1, 0, 2^30)``, ``uniform(k2)``."""
    k1, k2 = jax.random.split(key)
    return (jax.random.randint(k1, shape, 0, HIGH),
            jax.random.uniform(k2, shape))


def walk_draws(key, B, L):
    rs, us = zip(*(hop_draws(k, (B,))
                   for k in jax.random.split(key, L - 1)))
    return t(np.stack(rs)), t(np.stack(us))


def node2vec_draws(key, B, L, tries):
    k0, key = jax.random.split(key)
    d = {}
    d["first_r"], d["first_u"] = map(t, hop_draws(k0, (B,)))
    r, u, acc, fb_r, fb_u = [], [], [], [], []
    for kk in jax.random.split(key, max(L - 2, 0)):
        rt, ut, at = [], [], []
        for kt in jax.random.split(kk, tries):
            k1, k2 = jax.random.split(kt)
            a, b = hop_draws(k1, (B,))
            rt.append(a)
            ut.append(b)
            at.append(jax.random.uniform(k2, (B,)))
        r.append(np.stack(rt))
        u.append(np.stack(ut))
        acc.append(np.stack(at))
        a, b = hop_draws(jax.random.fold_in(kk, 7), (B,))
        fb_r.append(a)
        fb_u.append(b)
    for name, x in (("r", r), ("u", u), ("acc", acc), ("fb_r", fb_r),
                    ("fb_u", fb_u)):
        d[name] = t(np.stack(x))
    return d


# -- mirrored cases -----------------------------------------------------------

def test_random_walk_follows_edges():
    g = powerlaw_graph(num_nodes=1000, avg_degree=8, feat_dim=0, seed=0)
    walks = walker(g).random_walk(np.arange(256), 12, gen(0)).numpy()
    assert walks.shape == (256, 12)
    assert_follow_edges(walks, edge_set(g))


def test_random_walk_dead_end_pads_minus_one():
    g = Graph(np.array([[0, 1], [1, 2]]), num_nodes=4)
    walks = walker(g).random_walk(np.array([2, 3, 0]), 5, gen(0)).numpy()
    assert walks[0, 0] == 2 and (walks[0, 1:] == -1).all()
    assert walks[1, 0] == 3 and (walks[1, 1:] == -1).all()
    assert list(walks[2, :3]) == [0, 1, 2] and (walks[2, 3:] == -1).all()
    host = random_walk(g, np.array([2, 3, 0]), 5, seed=0)
    assert ((walks < 0) == (host < 0)).all()


def test_random_walk_uniform_distribution():
    e = np.stack([np.zeros(20, np.int64), np.arange(1, 21)], 1)
    walks = walker(Graph(e, num_nodes=21)).random_walk(
        np.zeros(8000, np.int64), 2, gen(1)).numpy()
    counts = np.bincount(walks[:, 1], minlength=21)[1:]
    assert counts.min() > 8000 / 20 * 0.6
    assert counts.max() < 8000 / 20 * 1.5


def test_weighted_walk_alias_bias():
    g = Graph(np.array([[0, 1], [0, 2]]), num_nodes=3,
              edge_feat={"w": np.array([9.0, 1.0], np.float32)})
    walks = walker(g, weighted="w").random_walk(np.zeros(4000, np.int64),
                                                2, gen(0)).numpy()
    assert 0.85 < np.mean(walks[:, 1] == 1) < 0.95


def test_weighted_walk_neighbor_sorted_alias_bias():
    """With ``neighbor_sorted`` the alias tables follow the re-sorted
    slots (the reference's regression case)."""
    g = Graph(np.array([[0, 2], [0, 1]]), num_nodes=3,
              edge_feat={"w": np.array([999.0, 1.0], np.float32)})
    w = walker(g, neighbor_sorted=True, weighted="w")
    walks = w.random_walk(np.zeros(2000, np.int64), 2, gen(0)).numpy()
    assert np.mean(walks[:, 1] == 2) > 0.99
    walks = w.node2vec_walk(np.zeros(2000, np.int64), 3, gen(1)).numpy()
    assert np.mean(walks[:, 1] == 2) > 0.99


def test_node2vec_p_bias():
    rng = np.random.default_rng(0)
    g, _ = _und(rng.integers(0, 500, (3000, 2)), 500)
    w = walker(g, neighbor_sorted=True)
    back = {}
    for p in (0.1, 10.0):
        n2v = w.node2vec_walk(np.arange(500), 10, gen(1), p=p,
                              q=1.0).numpy()
        back[p] = float(np.mean(n2v[:, 2] == n2v[:, 0]))
        assert_follow_edges(n2v[:50], edge_set(g))
    assert back[0.1] > 5 * back[10.0]


def test_node2vec_requires_sorted():
    g = powerlaw_graph(num_nodes=100, avg_degree=4, feat_dim=0, seed=0)
    with pytest.raises(ValueError):
        walker(g).node2vec_walk(np.arange(4), 5, gen(0))


def _typed():
    rng = np.random.default_rng(0)
    u2i = np.stack([rng.integers(0, 10, 200), rng.integers(10, 20, 200)], 1)
    return {"u2i": u2i, "i2u": u2i[:, ::-1]}


def test_metapath_walk_respects_types():
    w = walker(HeterGraph(_typed(), num_nodes=20))
    walks = w.metapath_walk(np.arange(10), ["u2i", "i2u"], 7,
                            gen(0)).numpy()
    assert (walks[:, 0::2] < 10).all()
    assert (walks[:, 1::2] >= 10).all()


def test_skipgram_pairs_windows_and_masks():
    src, dst, val = map(lambda x: x.numpy(), skipgram_pairs(
        torch.tensor([[1, 2, 3, 4]]), 2, gen(0)))
    assert ((src != dst) | ~val).all()
    pos = {1: 0, 2: 1, 3: 2, 4: 3}
    for s, d, v in zip(src, dst, val):
        if v:
            assert abs(pos[int(s)] - pos[int(d)]) <= 2


def test_matches_host_walk_distribution():
    rng = np.random.default_rng(3)
    g, _ = _und(rng.integers(0, 30, (200, 2)), 30)
    starts = np.repeat(np.arange(30), 200)
    dev = walker(g).random_walk(starts, 2, gen(0)).numpy()
    host = random_walk(g, starts, 2, seed=0)
    for start in range(5):
        a = dev[dev[:, 0] == start][:, 1]
        b = host[host[:, 0] == start][:, 1]
        ca = np.bincount(a, minlength=30) / max(len(a), 1)
        cb = np.bincount(b, minlength=30) / max(len(b), 1)
        assert np.abs(ca - cb).max() < 0.15


# -- the reference's walks, from its own draws -------------------------------

def _weighted_graph(n=200, avg=6, seed=4):
    """A multigraph with dead ends (the top tenth has no out-edges) and a
    weight an edge."""
    rng = np.random.default_rng(seed)
    E = n * avg
    edges = np.stack([rng.integers(0, n - n // 10, E),
                      rng.integers(0, n, E)], 1)
    w = (rng.random(E) ** 2 + 0.01).astype(np.float32)
    return (Graph(edges, num_nodes=n, edge_feat={"w": w}),
            pgl_tpu.Graph(edges, num_nodes=n, edge_feat={"w": w}))


@pytest.mark.parametrize("kw", [dict(), dict(weighted="w"),
                                dict(neighbor_sorted=True, weighted="w")])
def test_random_walk_equals_reference_from_its_draws(kw):
    g, jg = _weighted_graph()
    starts = np.arange(200)
    key = jax.random.key(5)
    want = jsampling.DeviceWalker(jg, **kw).random_walk(starts, 9, key)
    w = walker(g, **kw)
    r, u = walk_draws(key, 200, 9)
    got = dw._random_walk(w._indptr, w._sorted_v, w._alias, t(starts), r,
                          u if w._alias is not None else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got < 0).any() and got.dtype == torch.int32
    assert_follow_edges(got.numpy(), edge_set(g))


def test_metapath_walk_equals_reference_from_its_draws():
    typed = _typed()
    typed["u2i"] = typed["u2i"][typed["u2i"][:, 0] < 8]    # dead ends
    key = jax.random.key(6)
    want = jsampling.DeviceWalker(pgl_tpu.HeterGraph(
        typed, num_nodes=20)).metapath_walk(np.arange(10), ["u2i", "i2u"],
                                            7, key)
    w = walker(HeterGraph(typed, num_nodes=20))
    r = t(np.stack([jax.random.randint(k, (10,), 0, HIGH)
                    for k in jax.random.split(key, 6)]))
    sched = (w.etypes.index("u2i"), w.etypes.index("i2u"))
    got = dw._metapath_walk(w._indptr, w._sorted_v, t(np.arange(10)), r,
                            sched)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got < 0).any()


@pytest.mark.parametrize("kw", [dict(p=0.25, q=4.0), dict(p=2.0, q=0.5),
                                dict(p=1.0, q=1.0, weighted="w")])
def test_node2vec_equals_reference_from_its_draws(kw):
    """node2vec from the reference's keys: each hop's ``tries`` trials (a
    candidate hop and an acceptance uniform) and the ``fold_in(k, 7)``
    fallback; at ``examples/node2vec``'s p = 0.25, q = 4, the reverse, and
    weighted."""
    g, jg = _weighted_graph(n=120, avg=5, seed=7)
    weighted = kw.pop("weighted", None)
    starts = np.arange(120)
    key = jax.random.key(8)
    want = jsampling.DeviceWalker(jg, neighbor_sorted=True,
                                  weighted=weighted).node2vec_walk(
        starts, 8, key, tries=3, **kw)
    w = walker(g, neighbor_sorted=True, weighted=weighted)
    draws = node2vec_draws(key, 120, 8, 3)
    if weighted is None:
        for name in ("first_u", "u", "fb_u"):
            draws.pop(name)
    got = dw._node2vec_walk(w._indptr, w._sorted_v, w._nbr_key,
                            w.num_nodes, w._alias, t(starts), draws,
                            kw["p"], kw["q"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got < 0).any()
    assert_follow_edges(got.numpy(), edge_set(g))


def test_is_neighbor_is_membership():
    """The searchsorted membership test against the edge set, on every
    (node, candidate) pair of a small graph."""
    rng = np.random.default_rng(9)
    g = Graph(rng.integers(0, 25, (120, 2)), num_nodes=25)
    w = walker(g, neighbor_sorted=True)
    u, x = np.meshgrid(np.arange(25), np.arange(25), indexing="ij")
    got = dw._is_neighbor(w._nbr_key, 25, t(u.reshape(-1)),
                          t(x.reshape(-1))).numpy()
    es = edge_set(g)
    want = [(int(a), int(b)) in es for a, b in zip(u.reshape(-1),
                                                   x.reshape(-1))]
    np.testing.assert_array_equal(got, want)


def test_skipgram_pairs_equal_reference_from_its_draws():
    g, jg = _weighted_graph()
    walks = jsampling.DeviceWalker(jg).random_walk(np.arange(50), 7,
                                                   jax.random.key(1))
    key = jax.random.key(2)
    want = jsampling.skipgram_pairs(walks, 3, key)
    r = t(jax.random.randint(key, walks.shape, 1, 4))
    got = dw._skipgram_pairs(t(walks), 3, r)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got[2].all()
