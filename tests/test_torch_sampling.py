"""Port parity for sampling on the CPU against ``pgl_tpu``: the C++ host
kernels, ``graphsage_sample``, ``subgraph`` and the custom samplers, the
host walks, the padded minibatch collate (plain, packed, and with the K1
layouts), the device samplers fed the reference's own draws, and
``BipartiteSAGE``; each case of the reference's ``tests/test_sampling.py``
and ``tests/test_sampled_sage.py`` mirrored.

Host outputs (walks, pairs, alias tables, subgraphs, batches) are compared
exactly. The device samplers draw from a ``torch.Generator``; their
internal functions take the draws as tensors, and fed the draws the
reference makes from its ``jax.random`` keys they give the reference's
neighbours and masks exactly. Models: logits and gradients at rtol 1e-5
(float32 sums in another order), atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")
optax = pytest.importorskip("optax")

import pgl_tpu
import pgl_tpu.models as jmodels
import pgl_tpu.sampling as jsampling
from pgl_tpu.native import graph_kernel as jgk
from pgl_tpu.ops import softmax_cross_entropy_integer as j_ce
from pgl_tpu.utils.edge_index import EdgeIndex as JEdgeIndex
import pgl_tpu_torch
import pgl_tpu_torch.sampling as sampling
from pgl_tpu_torch import Graph, HeterGraph
from pgl_tpu_torch.models import BipartiteSAGE, GraphSage
from pgl_tpu_torch.native import graph_kernel as gk
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.ops.kernels import segment_kernels as sk
from pgl_tpu_torch.sampling import sage as tsage
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _arrays(n=50, e=300, seed=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (e, 2))
    return (edges, {"h": rng.normal(size=(n, 4)).astype(np.float32)},
            {"w": rng.random(e).astype(np.float32)})


def make_graph(n=50, e=300, seed=0, feat=True):
    """The port's graph and the reference's on the same numpy arrays."""
    edges, nf, ef = _arrays(n, e, seed)
    nf = nf if feat else None
    return (Graph(edges, num_nodes=n, node_feat=nf, edge_feat=ef),
            pgl_tpu.Graph(edges, num_nodes=n, node_feat=nf, edge_feat=ef))


def same_graph(got, want):
    assert got.num_nodes == want.num_nodes
    np.testing.assert_array_equal(np.asarray(got.edges),
                                  np.asarray(want.edges))
    for mine, ref in ((got.node_feat, want.node_feat),
                      (got.edge_feat, want.edge_feat)):
        assert set(mine) == set(ref)
        for k in mine:
            np.testing.assert_array_equal(np.asarray(mine[k]),
                                          np.asarray(ref[k]))


def same_layers(got, want):
    assert len(got) == len(want)
    for (g, si, ni), (gw, siw, niw) in zip(got, want):
        same_graph(g, gw)
        np.testing.assert_array_equal(si, siw)
        np.testing.assert_array_equal(ni, niw)


def succ_sets(g):
    return {i: set(v.tolist()) for i, v in enumerate(g.successor())}


def walks_follow_edges(walks, succ):
    for row in walks:
        for a, b in zip(row[:-1], row[1:]):
            if b < 0:
                break
            assert b in succ[int(a)]


# -- the C++ host kernels ----------------------------------------------------

def _csr(seed=0, N=60, E=500):
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, N, E), rng.integers(0, N, E)
    deg, sv, se, ip = gk.build_index(u, v, N)
    return rng, N, u, v, deg, sv, se, ip


HOST_KERNELS = ("map_nodes", "sample_subset_with_eid", "random_walk",
                "node2vec_walk", "node2vec_walk_plus", "skip_gram_gen_pair",
                "alias_sample_build_table", "alias_sample",
                "extract_edges_from_nodes", "metis_partition",
                "metis_partition_weighted")


@pytest.mark.parametrize("name", HOST_KERNELS)
def test_host_kernel_equals_reference(name):
    """Every host kernel gives the reference's output bit for bit on the
    same inputs and seed (walks with dead ends: the top fifth of the nodes
    has no out-edges)."""
    rng, N, u, v, deg, sv, se, ip = _csr()
    keep = u < N - N // 5
    deg, sv, se, ip = gk.build_index(u[keep], v[keep], N)
    starts = np.arange(N)
    nodes = np.unique(rng.integers(0, N, 25))
    w = rng.random(40) ** 3
    walks = gk.random_walk(ip, sv, starts, 9, seed=4)
    calls = {
        "map_nodes": lambda m: m.map_nodes(nodes, np.concatenate(
            [u, nodes[::-1], [N + 5]])),
        "sample_subset_with_eid": lambda m: m.sample_subset_with_eid(
            ip, sv, se, starts[:30], 3, seed=7),
        "random_walk": lambda m: m.random_walk(ip, sv, starts, 9, seed=4),
        "node2vec_walk": lambda m: m.node2vec_walk(ip, sv, starts, 9,
                                                   p=0.25, q=4.0, seed=5),
        "node2vec_walk_plus": lambda m: m.node2vec_walk_plus(
            ip, sv, starts, 9, p=0.5, q=2.0, seed=6),
        "skip_gram_gen_pair": lambda m: m.skip_gram_gen_pair(walks, 3,
                                                             seed=8),
        "alias_sample_build_table": lambda m: m.alias_sample_build_table(w),
        "alias_sample": lambda m: m.alias_sample(
            *jgk.alias_sample_build_table(w), 500, seed=9),
        "extract_edges_from_nodes": lambda m: m.extract_edges_from_nodes(
            ip, sv, se, N, nodes),
        "metis_partition": lambda m: m.metis_partition(ip, sv, 4, seed=1),
        "metis_partition_weighted": lambda m: m.metis_partition(
            ip, sv, 4, seed=1, vwgt=deg + 1),
    }
    got, want = calls[name](gk), calls[name](jgk)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    if name == "random_walk":
        assert (got[0] < 0).any()          # dead ends reached


def test_host_kernels_have_no_fallback(monkeypatch, tmp_path):
    """A failed build raises for every host kernel, where the reference
    answers from numpy (its BFS partition,
    ``pgl_tpu/native/graph_kernel.py:409-436``); the port binds the
    weighted partitioner unconditionally (no stale-library path without
    ``metis_style_partition_w``)."""
    _, N, u, v, deg, sv, se, ip = _csr()
    monkeypatch.setattr(gk, "CXX", "false")
    monkeypatch.setattr(gk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(gk, "_lib", None)
    for call in (lambda: gk.metis_partition(ip, sv, 4),
                 lambda: gk.random_walk(ip, sv, np.arange(3), 4),
                 lambda: gk.map_nodes(np.arange(3), np.arange(2))):
        with pytest.raises(RuntimeError, match="host kernel build failed"):
            call()
    monkeypatch.setattr(jgk, "_lib", None)
    monkeypatch.setattr(jgk, "_build_failed", True)
    parts = jgk.metis_partition(ip, sv, 4)       # the reference's BFS
    assert parts.shape == (N,)
    assert "metis_style_partition_w" in gk._SIGNATURES


# -- subgraph, graphsage_sample ---------------------------------------------

def test_subgraph_reindex():
    kw = dict(num_nodes=6,
              node_feat={"h": np.arange(12, dtype=np.float32).reshape(6, 2)},
              edge_feat={"w": np.arange(4, dtype=np.float32)})
    edges = np.array([[0, 1], [1, 5], [5, 0], [2, 5]])
    sub = sampling.subgraph(Graph(edges, **kw), nodes=[5, 0, 1],
                            eid=[0, 1, 2])
    assert sub.num_nodes == 3
    np.testing.assert_array_equal(np.asarray(sub.edges),
                                  [[1, 2], [2, 0], [0, 1]])
    np.testing.assert_allclose(sub.node_feat["h"][0], [10, 11])
    np.testing.assert_allclose(sub.edge_feat["w"], [0, 1, 2])
    same_graph(sub, jsampling.subgraph(pgl_tpu.Graph(edges, **kw),
                                       nodes=[5, 0, 1], eid=[0, 1, 2]))


def test_subgraph_missing_node_raises():
    g, _ = make_graph()
    with pytest.raises(ValueError):
        sampling.subgraph(g, nodes=[0], edges=np.asarray(g.edges)[:5])


def test_graphsage_sample_structure():
    g, jg = make_graph()
    seeds = np.array([3, 7, 11])
    out = sampling.graphsage_sample(g, seeds, samples=[5, 3])
    assert len(out) == 2
    sg0, sample_index, node_index = out[0]
    np.testing.assert_array_equal(sample_index[node_index], seeds)
    parent_edges = set(map(tuple, np.asarray(g.edges).tolist()))
    for sg, si, _ in out:
        for s, d in np.asarray(sg.edges):
            assert (int(si[s]), int(si[d])) in parent_edges
    assert out[0][0].num_edges >= out[1][0].num_edges
    indeg = out[1][0].indegree()
    np.testing.assert_array_less(indeg[np.asarray(node_index)], 5 + 1)
    same_layers(out, jsampling.graphsage_sample(jg, seeds, samples=[5, 3]))


def test_graphsage_sample_ignore_edges():
    g, jg = make_graph()
    seeds = np.array([3])
    full = sampling.graphsage_sample(g, seeds, samples=[100], seed=1)
    banned = {(int(s), int(d)) for s, d in np.asarray(g.edges) if d == 3}
    out = sampling.graphsage_sample(g, seeds, samples=[100],
                                    ignore_edges=banned, seed=1)
    sg, si, ni = out[0]
    for s, d in np.asarray(sg.edges):
        assert (int(si[s]), int(si[d])) not in banned
    assert sg.num_edges <= full[0][0].num_edges
    same_layers(out, jsampling.graphsage_sample(
        jg, seeds, samples=[100], ignore_edges=banned, seed=1))


def test_graphsage_sample_default_seed_repeats_its_draws():
    """The reference's contract, kept: ``seed`` defaults to 0, so two
    calls on the same seeds draw the same neighbours (a training loop that
    wants fresh neighbours each epoch passes a seed); a hub larger than
    the fan-out shows it."""
    edges = np.stack([np.arange(1, 41), np.zeros(40, np.int64)], 1)
    g = Graph(edges, num_nodes=41)
    a = sampling.graphsage_sample(g, [0], samples=[5])[0]
    b = sampling.graphsage_sample(g, [0], samples=[5])[0]
    c = sampling.graphsage_sample(g, [0], samples=[5], seed=1)[0]
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(np.sort(a[1]), np.sort(c[1]))
    same_layers([a], jsampling.graphsage_sample(
        pgl_tpu.Graph(edges, num_nodes=41), [0], samples=[5]))


# -- host walks ---------------------------------------------------------------

@pytest.mark.parametrize("walk,kw", [
    ("random_walk", dict(seed=2)),
    ("node2vec_walk", dict(p=2.0, q=0.5, seed=3)),
    ("node2vec_walk_plus", dict(p=0.5, q=2.0, seed=3))])
def test_host_walks(walk, kw):
    g, jg = make_graph(n=30, e=400)
    walks = getattr(sampling, walk)(g, np.arange(30), walk_len=8, **kw)
    assert walks.shape == (30, 8)
    np.testing.assert_array_equal(walks[:, 0], np.arange(30))
    walks_follow_edges(walks, succ_sets(g))
    np.testing.assert_array_equal(
        walks, getattr(jsampling, walk)(jg, np.arange(30), walk_len=8, **kw))
    lists = getattr(sampling, walk)(g, np.arange(30), walk_len=8,
                                    as_list=True, **kw)
    assert lists == getattr(jsampling, walk)(jg, np.arange(30), walk_len=8,
                                             as_list=True, **kw)


def test_node2vec_walk_plus_defaults():
    """Deterministic under a seed; p == q == 1 is the uniform first-order
    walk, as in the reference."""
    g, _ = make_graph(n=30, e=400)
    a = sampling.node2vec_walk_plus(g, np.arange(30), 6, p=0.5, q=2.0,
                                    seed=3)
    np.testing.assert_array_equal(a, sampling.node2vec_walk_plus(
        g, np.arange(30), 6, p=0.5, q=2.0, seed=3))
    np.testing.assert_array_equal(
        sampling.node2vec_walk_plus(g, np.arange(5), 4, seed=1),
        sampling.random_walk(g, np.arange(5), 4, seed=1))


def test_metapath_randomwalk():
    edges = {"u2t": np.array([[0, 2], [0, 3], [1, 2]]),
             "t2u": np.array([[2, 0], [2, 1], [3, 0]])}
    walks = sampling.metapath_randomwalk(HeterGraph(edges, num_nodes=4),
                                         [0, 1], "u2t-t2u", walk_length=5,
                                         seed=0)
    assert walks.shape == (2, 5)
    for row in walks:
        for step, node in enumerate(row):
            if node >= 0:
                assert node in ((2, 3) if step % 2 else (0, 1))
    np.testing.assert_array_equal(walks, jsampling.metapath_randomwalk(
        pgl_tpu.HeterGraph(edges, num_nodes=4), [0, 1], "u2t-t2u",
        walk_length=5, seed=0))


# -- the custom samplers ------------------------------------------------------

def test_graph_saint_node_sample():
    g, jg = make_graph(n=40, e=300)
    batch = [1, 5, 9, 13, 17, 21, 25]
    sub, nodes = sampling.graph_saint_node_sample(g, batch)
    assert sub.num_nodes == 7
    parent = np.asarray(g.edges)
    kept = set(map(tuple, parent[np.isin(parent[:, 0], nodes)
                                 & np.isin(parent[:, 1], nodes)].tolist()))
    assert {(int(nodes[s]), int(nodes[d]))
            for s, d in np.asarray(sub.edges)} == kept
    jsub, jnodes = jsampling.graph_saint_node_sample(jg, batch)
    same_graph(sub, jsub)
    np.testing.assert_array_equal(nodes, jnodes)


def test_random_walk_with_restart():
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 50, (400, 2))
    walks = sampling.random_walk_with_restart(
        Graph(edges, num_nodes=50), np.arange(10), depth=8, proba=0.5,
        seed=1)
    assert walks.shape == (10, 8) and int(walks.max()) < 50
    np.testing.assert_array_equal(walks, jsampling.random_walk_with_restart(
        pgl_tpu.Graph(edges, num_nodes=50), np.arange(10), depth=8,
        proba=0.5, seed=1))


def test_pinsage_sample_structure():
    rng = np.random.default_rng(1)
    edges = rng.integers(0, 80, (800, 2))
    nodes = np.array([3, 7, 11])
    layers = sampling.pinsage_sample(Graph(edges, num_nodes=80), nodes,
                                     samples=[6, 4], top_k=3, seed=2)
    assert len(layers) == 2
    np.testing.assert_array_equal(layers[0][1][layers[0][2]], nodes)
    for sub, _, _ in layers:
        w = np.asarray(sub.edge_feat["weight"])
        assert sub.num_edges == len(w)
        if len(w):
            assert (w > 0).all()
            dst = np.asarray(sub.edges)[:, 1]
            for d in np.unique(dst):
                np.testing.assert_allclose(w[dst == d].sum(), 1.0,
                                           rtol=1e-5)
    assert layers[0][0].num_edges >= layers[1][0].num_edges
    same_layers(layers, jsampling.pinsage_sample(
        pgl_tpu.Graph(edges, num_nodes=80), nodes, samples=[6, 4],
        top_k=3, seed=2))


def test_graph_saint_random_walk_sample():
    rng = np.random.default_rng(2)
    edges = rng.integers(0, 60, (600, 2))
    sub, nodes = sampling.graph_saint_random_walk_sample(
        Graph(edges, num_nodes=60), np.arange(5), max_depth=6, seed=3)
    assert sub.num_nodes == len(nodes)
    assert set(range(5)) <= set(nodes.tolist())
    kept = set(map(tuple, edges[np.isin(edges, nodes).all(axis=1)].tolist()))
    assert {(int(nodes[s]), int(nodes[d]))
            for s, d in np.asarray(sub.edges).tolist()} == kept
    jsub, jnodes = jsampling.graph_saint_random_walk_sample(
        pgl_tpu.Graph(edges, num_nodes=60), np.arange(5), max_depth=6,
        seed=3)
    same_graph(sub, jsub)
    np.testing.assert_array_equal(nodes, jnodes)


# -- the device samplers, fed the reference's draws ---------------------------

def _layer_uniforms(key, sizes):
    """The uniforms the reference's ``NeighborSampler.sample`` draws: a key
    split off a layer, ``uniform(sub, (B_l, k_l))``."""
    out = []
    for shape in sizes:
        key, sub = jax.random.split(key)
        out.append(torch.as_tensor(np.asarray(jax.random.uniform(sub,
                                                                 shape))))
    return out


def _same_blocks(got, want):
    for (f, n, m), (fw, nw, mw) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(f), np.asarray(fw))
        np.testing.assert_array_equal(n.numpy(), np.asarray(nw))
        np.testing.assert_array_equal(m.numpy(), np.asarray(mw))


def test_sample_neighbors_padded():
    """Fed the reference's uniforms, the padded sample equals the
    reference's, neighbours of zero-degree nodes (mask 0) included; the
    public function's neighbours are true predecessors."""
    g, jg = make_graph(n=40, e=200)
    idx = jg.tensor().adj_dst_index
    nodes = np.arange(40, dtype=np.int32)      # the top nodes have none
    key = jax.random.key(0)
    want = jsampling.sample_neighbors_padded(idx.indptr, idx.sorted_v,
                                             jnp.asarray(nodes), 4, key)
    ip, sv = tsage._device_csc(g, "cpu")
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, (40, 4))))
    got = tsage._neighbors_from_uniforms(ip, sv, torch.as_tensor(nodes), u)
    assert not np.asarray(want[1]).all()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    neigh, mask = sampling.sample_neighbors_padded(
        ip, sv, torch.arange(10), 4, torch.Generator().manual_seed(0))
    assert neigh.shape == (10, 4) and mask.shape == (10, 4)
    preds = g.predecessor()
    for i in range(10):
        if bool(mask[i, 0]):
            assert set(neigh[i].tolist()) <= set(preds[i].tolist())


def test_sample_offsets_stay_in_their_row():
    """``floor(u * deg)`` in float32, the reference's arithmetic and the
    port's, stays below ``deg`` for the largest draws (``torch.rand`` gives
    at most ``1 - 2^-24``, ``jax.random.uniform`` ``1 - 2^-23``) at every
    degree tried up to 2^31 - 1, around each power of two and past 2^24,
    where float32 rounds the degree up: no sample leaves its row. A
    zero-degree row at the end of the table reads past it: the reference's
    ``jnp.take`` fills ``INT32_MIN`` (mask 0), and so does the port, on a
    synthetic CSC."""
    rng = np.random.default_rng(0)
    around = np.concatenate([2 ** np.arange(1, 31) + d for d in
                             range(-3, 4)])
    degs = np.unique(np.concatenate([
        rng.integers(1, 2 ** 31 - 1, 20000),
        around[(around >= 1) & (around < 2 ** 31)],
        np.arange(2 ** 24 - 64, 2 ** 24 + 64)])).astype(np.int64)
    us = (np.float32(1) - np.arange(1, 33, dtype=np.float32)
          * np.float32(2) ** -24).astype(np.float32)
    u = np.broadcast_to(us, (len(degs), len(us)))
    want = np.floor(u * degs.astype(np.float32)[:, None]).astype(np.int64)
    got = tsage._offsets(torch.as_tensor(degs), torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < degs[:, None]).all()
    assert (np.float32(degs) > degs).any()       # degrees rounded up
    # a synthetic CSC: row 1 empty at the table's end, row 2 past it
    indptr = np.array([0, 3, 3], np.int32)
    sorted_v = np.array([7, 8, 9], np.int32)
    nodes = np.array([0, 1], np.int32)
    u = np.array([[0.0, 0.99999994], [0.5, 0.25]], np.float32)
    ref = jnp.take(jnp.asarray(sorted_v), jnp.take(jnp.asarray(indptr),
                   jnp.asarray(nodes))[:, None] + jnp.floor(
        jnp.asarray(u) * jnp.maximum(jnp.asarray(np.diff(indptr)), 1)[
            :, None]).astype(jnp.int32))
    neigh, mask = tsage._neighbors_from_uniforms(
        torch.as_tensor(indptr), torch.as_tensor(sorted_v),
        torch.as_tensor(nodes), torch.as_tensor(u))
    np.testing.assert_array_equal(neigh.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(neigh[1].numpy(), [tsage.INT32_MIN] * 2)
    np.testing.assert_array_equal(mask.numpy(), [[True] * 2, [False] * 2])


def test_neighbor_sampler_layers():
    g, jg = make_graph(n=40, e=400)
    seeds = np.arange(5, dtype=np.int32)
    sampler = sampling.NeighborSampler(g, samples=[3, 2], device="cpu")
    layers, frontier = sampler.sample(torch.as_tensor(seeds),
                                      torch.Generator().manual_seed(1))
    assert len(layers) == 2
    f1, n1, m1 = layers[-1]
    assert n1.shape == (5, 3) and frontier.shape == (5 * 3 * 2,)
    jsampler = jsampling.NeighborSampler(jg.tensor(), samples=[3, 2])
    key = jax.random.key(1)
    want, wfront = jsampler.sample(jnp.asarray(seeds), key)
    got, front = sampler._from_uniforms(
        torch.as_tensor(seeds), _layer_uniforms(key, [(5, 3), (15, 2)]))
    _same_blocks(got, want)
    np.testing.assert_array_equal(front.numpy(), np.asarray(wfront))


def test_hetero_neighbor_sampler():
    rng = np.random.default_rng(0)
    edges = {"a": rng.integers(0, 30, (100, 2)),
             "b": rng.integers(0, 30, (80, 2))}
    sampler = sampling.HeteroNeighborSampler(
        HeterGraph(edges, num_nodes=30), samples=[3, 2], device="cpu")
    seeds = np.arange(4, dtype=np.int32)
    layers, frontier = sampler.sample(torch.as_tensor(seeds),
                                      torch.Generator().manual_seed(0))
    assert len(layers) == 2
    frontier0, per_etype = layers[-1]
    assert set(per_etype) == {"a", "b"}
    assert per_etype["a"][0].shape == (4, 3)
    jsampler = jsampling.HeteroNeighborSampler(
        pgl_tpu.HeterGraph(edges, num_nodes=30).tensor(), samples=[3, 2])
    key = jax.random.key(0)
    want, wfront = jsampler.sample(jnp.asarray(seeds), key)
    flat = _layer_uniforms(key, [(4, 3), (4, 3), (28, 2), (28, 2)])
    got, front = sampler._from_uniforms(torch.as_tensor(seeds),
                                        [flat[:2], flat[2:]])
    for (f, per), (fw, perw) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(f), np.asarray(fw))
        for et in per:
            for a, b in zip(per[et], perw[et]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(front.numpy(), np.asarray(wfront))


# -- the padded minibatch collate ---------------------------------------------

NB, EB = 1 << 11, 1 << 13


def _batch_fns(pack=False):
    from pgl_tpu.datasets import community_graph as j_cg
    from pgl_tpu_torch.datasets import community_graph as t_cg
    jg, y = j_cg(num_nodes=2000, num_classes=4, feat_dim=8, avg_degree=8,
                 seed=0)
    tg, _ = t_cg(num_nodes=2000, num_classes=4, feat_dim=8, avg_degree=8,
                 seed=0)
    items = [(n, y[n]) for n in range(64)]
    return (sampling.make_padded_batch_fn(tg, (5, 5), NB, EB, pack=pack),
            jsampling.make_padded_batch_fn(jg, (5, 5), NB, EB, pack=pack),
            items, tg, jg, y)


@pytest.mark.parametrize("pack", [False, True])
def test_padded_batch_equals_reference(pack):
    mine, ref, items, *_ = _batch_fns(pack)
    got, want = mine(items), ref(items)
    if pack:
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_packed_batch_round_trip():
    """``pack=True`` and ``unpack_padded_batch`` give the unpacked tuple."""
    plain, _, items, *_ = _batch_fns()
    packed = sampling.make_padded_batch_fn(_batch_fns()[3], (5, 5), NB, EB,
                                           pack=True)
    ref = plain(items)
    got = sampling.unpack_padded_batch(torch.as_tensor(packed(items)), NB,
                                       EB)
    for name, a, b in zip(("edges", "deg", "su", "sv", "se", "indptr",
                           "sidx", "smask", "y", "mask"), ref, got):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_batch_graph_with_host_layouts():
    """``layouts=True`` appends both K1 layouts of the padded graph, built
    in the collate with numpy alone; ``padded_batch_graph`` reads them as
    views of the one buffer. They equal the layouts ``Graph.tensor()``
    builds for the same graph (the sentinel row's pad edges cut into
    pieces like any hub), and the SpMM on them equals the reference's
    ``send_recv`` on its padded graph, sentinel row included. Each array
    starts 16-byte aligned in the buffer (K1 loads its work list in 16-byte
    vectors: a misaligned view faulted on the card)."""
    _, _, items, tg, jg, _ = _batch_fns()
    fn = sampling.make_padded_batch_fn(tg, (5, 5), NB, EB, pack=True,
                                       layouts=True)
    with pytest.raises(ValueError, match="pack=True"):
        sampling.make_padded_batch_fn(tg, (5, 5), NB, EB, layouts=True)
    buf = fn(items)
    plain = sampling.make_padded_batch_fn(tg, (5, 5), NB, EB, pack=True)
    n_packed = len(plain(items))
    np.testing.assert_array_equal(buf[:n_packed], plain(items))
    graph, sidx, smask, y, mask = sampling.padded_batch_graph(
        torch.as_tensor(buf), NB, EB)
    edges = graph.edges.numpy()
    direct = Graph(edges, num_nodes=NB).tensor("cpu")
    for got, want in zip(graph._spmm_layouts, direct._spmm_layouts):
        assert got.kind == want.kind
        for f in ("num_rows", "num_edges", "max_index", "item_partials",
                  "item_packs"):
            assert getattr(got, f) == getattr(want, f), f
        for f in sk._ARRAYS:
            if f != "edge_id":
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              getattr(want, f).numpy(), f)
        assert got.item_split_rows.numel() >= 1      # the sentinel splits
        for f in sk._ARRAYS:      # the kernel loads 16-byte vectors
            assert getattr(got, f).data_ptr() % 16 == 0, f
    # ... and the reference's SpMM on its own padded graph
    jbuf = jsampling.make_padded_batch_fn(jg, (5, 5), NB, EB,
                                          pack=True)(items)
    t = jsampling.unpack_padded_batch(jnp.asarray(jbuf), NB, EB)
    jgraph = pgl_tpu.Graph(t[0], num_nodes=NB, adj_dst_index=JEdgeIndex(
        t[1], t[2], t[3], t[4], t[5]))
    x = np.random.default_rng(3).normal(size=(NB, 8)).astype(np.float32)
    for reduce in ("sum", "mean"):
        np.testing.assert_allclose(
            graph.send_recv(torch.as_tensor(x), reduce).numpy(),
            np.asarray(jgraph.send_recv(jnp.asarray(x), reduce)),
            rtol=RTOL, atol=1e-5)
    for a, b in zip((sidx, smask, y, mask), t[6:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("samples,n_seeds", [((5, 5), 64), ((25, 10), 8),
                                              ((40, 40), 200)])
def test_max_batch_words_holds_every_batch(samples, n_seeds):
    """``max_batch_words`` bounds a ``layouts=True`` batch however its work
    lists come out: few seeds (the sentinel row takes nearly every slot)
    to many (long rows cut into pieces)."""
    _, _, _, tg, _, y = _batch_fns()
    fn = sampling.make_padded_batch_fn(tg, samples, NB, EB, pack=True,
                                       layouts=True)
    for first in (0, 1000):
        items = [(n, y[n]) for n in range(first, first + n_seeds)]
        assert len(fn(items)) <= sampling.max_batch_words(NB, EB)


@pytest.mark.parametrize("case", ["hub", "packs", "empty_rows", "no_edges"])
def test_packed_layout_words_max_bounds_the_packed_layout(case):
    """``packed_layout_words_max`` bounds ``pack_spmm_layout`` on rows of
    every kind: one hub of all the edges, rows just past ``MIN_PIECE``
    (the most pieces an edge), short rows packed, no edge at all."""
    rng = np.random.default_rng(4)
    R, m = 300, sk.MIN_PIECE
    deg = {"hub": np.r_[4000, np.zeros(R - 1, np.int64)],
           "packs": np.r_[np.full(R // 2, m + 1), np.full(R - R // 2, 3)],
           "empty_rows": rng.integers(0, 2, R) * rng.integers(0, 200, R),
           "no_edges": np.zeros(R, np.int64)}[case]
    indptr = np.r_[0, np.cumsum(deg)]
    E = int(indptr[-1])
    lay = sk.build_spmm_layout_host(indptr, rng.integers(0, R, E), R,
                                    edge_id=np.arange(E))
    assert len(sk.pack_spmm_layout(lay)) <= sk.packed_layout_words_max(R, E)


def test_unpack_of_a_device_buffer_needs_its_host_copy():
    """A packed layout off the CPU is read through its host copy: without
    one ``unpack_spmm_layout`` and ``padded_batch_graph`` raise a clear
    ``ValueError`` (not numpy's ``TypeError`` on a device tensor). The
    ``meta`` device stands in for the card."""
    _, _, items, tg, _, _ = _batch_fns()
    buf = sampling.make_padded_batch_fn(tg, (5, 5), NB, EB, pack=True,
                                        layouts=True)(items)
    dev = torch.as_tensor(buf).to("meta")
    o = tsage._layouts_offset(NB, EB)
    with pytest.raises(ValueError, match="host="):
        sk.unpack_spmm_layout(dev, "csc", o)
    with pytest.raises(ValueError, match="host="):
        sampling.padded_batch_graph(dev, NB, EB)
    lay, _ = sk.unpack_spmm_layout(dev, "csc", o, host=buf)
    assert lay.indices.device.type == "meta" and lay.num_rows == NB


def test_collate_builds_no_tensor(monkeypatch):
    """The collate with layouts runs on numpy alone: no torch function is
    called (a forked worker must start no torch parallel region)."""
    _, _, items, tg, _, _ = _batch_fns()
    fn = sampling.make_padded_batch_fn(tg, (5, 5), NB, EB, pack=True,
                                       layouts=True)

    def boom(*a, **k):
        raise AssertionError("the collate called torch")

    for name in ("as_tensor", "tensor", "empty", "zeros", "from_numpy"):
        monkeypatch.setattr(torch, name, boom)
    assert fn(items).dtype == np.int32


def test_host_sampled_step_matches_reference():
    """One minibatch GraphSAGE step end to end: the same padded batch, the
    reference's jitted step (``bench.py``'s: features gathered by ``sidx``
    and masked, the masked mean cross entropy, optax's Adam) against the
    port's on ``padded_batch_graph`` with carried weights: the loss and
    every updated parameter at rtol 1e-5."""
    _, _, items, tg, jg, _ = _batch_fns()
    feat = np.asarray(jg.node_feat["h"])
    buf = sampling.make_padded_batch_fn(tg, (5, 5), NB, EB, pack=True,
                                        layouts=True)(items)
    jbuf = jsampling.make_padded_batch_fn(jg, (5, 5), NB, EB,
                                          pack=True)(items)
    t = jsampling.unpack_padded_batch(jnp.asarray(jbuf), NB, EB)
    jgraph = pgl_tpu.Graph(t[0], num_nodes=NB, adj_dst_index=JEdgeIndex(
        t[1], t[2], t[3], t[4], t[5]))
    sage = jmodels.GraphSage(input_size=8, num_class=4, num_layers=2,
                             hidden_size=16, dropout=0.0)
    x0 = jnp.take(jnp.asarray(feat), t[6], axis=0) * t[7]
    params = sage.init(jax.random.key(0), jgraph, x0)
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p, s):
        def loss_fn(q):
            x = jnp.take(jnp.asarray(feat), t[6], axis=0) * t[7]
            c = j_ce(sage.apply(q, jgraph, x), t[8])
            return (c * t[9]).sum() / jnp.maximum(t[9].sum(), 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    new_params, _, want = step(params, opt.init(params))

    model = GraphSage(8, 4, num_layers=2, hidden_size=16, dropout=0.0,
                      device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                          params), "cpu"))
    topt = torch.optim.Adam(model.parameters(), lr=1e-3)
    graph, sidx, smask, y, mask = sampling.padded_batch_graph(
        torch.as_tensor(buf), NB, EB)
    x = torch.as_tensor(feat).index_select(0, sidx.long()) * smask
    c = ce(model(graph, x), y.long())
    loss = (c * mask).sum() / mask.sum().clamp(min=1.0)
    topt.zero_grad()
    loss.backward()
    topt.step()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    want_sd = flax_to_state_dict(jax.tree.map(np.asarray, new_params),
                                 "cpu")
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_sd[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# -- BipartiteSAGE ------------------------------------------------------------

def _cycle(n, d):
    edges = np.stack([np.arange(n), (np.arange(n) + 1) % n], 1)
    feat = np.arange(n * d, dtype=np.float32).reshape(n, d) / (n * d)
    return edges, feat


def test_bipartite_sage_cycle_matches_hand_computation():
    """On a directed cycle every node has one in-neighbour, so the sample
    is deterministic and the output follows from the weights."""
    n, d, hid, C = 8, 4, 6, 3
    edges, x = _cycle(n, d)
    g = Graph(edges, num_nodes=n)
    sampler = sampling.NeighborSampler(g, samples=(3, 2), device="cpu")
    model = BipartiteSAGE(d, C, num_layers=2, hidden_size=hid, device="cpu")
    seeds = torch.tensor([0, 5])
    sampled, _ = sampler.sample(seeds, torch.Generator().manual_seed(0))
    out = model(torch.as_tensor(x), seeds, sampled).detach().numpy()
    assert out.shape == (2, C)
    p = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def dense(name, h):
        return h @ p[f"{name}.weight"].T + p[f"{name}.bias"]

    def layer0(nodes):
        h = dense("self_0", x[nodes]) + dense("neigh_0", x[(nodes - 1) % n])
        h = np.maximum(h, 0.0)
        return h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True),
                              1e-12)

    s = np.array([0, 5])
    expect = dense("self_1", layer0(s)) + dense("neigh_1",
                                                layer0((s - 1) % n))
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


def test_bipartite_sage_matches_flax():
    """On the reference's own sampled blocks, ``BipartiteSAGE`` with the
    flax tree carried by ``flax_to_state_dict`` gives the reference's
    logits, parameter gradients and (mean cross entropy) loss at rtol 1e-5;
    with zero-degree nodes among the sampled ones."""
    from pgl_tpu.datasets import community_graph as j_cg
    jg, y = j_cg(num_nodes=300, num_classes=4, feat_dim=16, avg_degree=3,
                 seed=1)
    feat = jnp.asarray(np.asarray(jg.node_feat["h"]))
    jsampler = jsampling.NeighborSampler(jg.tensor(), samples=(4, 3))
    seeds = jnp.arange(32, dtype=jnp.int32)
    sampled, _ = jsampler.sample(seeds, jax.random.key(2))
    assert not all(bool(np.asarray(m).all()) for _, _, m in sampled)
    jmodel = jmodels.BipartiteSAGE(input_size=16, num_class=4, num_layers=2,
                                   hidden_size=32)
    params = jax.jit(jmodel.init)(jax.random.key(1), feat, seeds, sampled)
    yj = jnp.asarray(y)[seeds]

    def loss_fn(p):
        logits = jmodel.apply(p, feat, seeds, sampled)
        return j_ce(logits, yj).mean(), logits

    # under jit: flax's eager init, apply and grad took 10 s here
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model = BipartiteSAGE(16, 4, num_layers=2, hidden_size=32, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                          params), "cpu"))
    blocks = [(torch.as_tensor(np.asarray(f)), torch.as_tensor(
        np.asarray(nb)), torch.as_tensor(np.asarray(m)))
        for f, nb, m in sampled]
    out = model(torch.as_tensor(np.asarray(feat)), torch.as_tensor(
        np.asarray(seeds)), blocks)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               rtol=RTOL, atol=ATOL)
    tl = ce(out, torch.as_tensor(np.asarray(yj)).long()).mean()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(loss), rtol=RTOL)
    want = flax_to_state_dict(jax.tree.map(np.asarray, grads), "cpu")
    for name, prm in model.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_bipartite_sage_trains():
    """Device-path training on the CPU: sample, gather, layers, loss and
    gradients in one step; the loss falls and the accuracy passes 0.9 on a
    community graph (the reference's 120-step check, cut to 60)."""
    from pgl_tpu_torch.datasets import community_graph
    n, C, D, B = 1000, 4, 32, 128
    g, y = community_graph(num_nodes=n, num_classes=C, feat_dim=D,
                           avg_degree=10, seed=0)
    sampler = sampling.NeighborSampler(g, samples=(10, 10), device="cpu")
    model = BipartiteSAGE(D, C, num_layers=2, hidden_size=64, device="cpu")
    feat = torch.as_tensor(g.node_feat["h"])
    y = torch.as_tensor(y).long()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    gen = torch.Generator().manual_seed(2)
    losses = []
    for _ in range(60):
        seeds = torch.randint(0, n, (B,), generator=gen)
        sampled, _ = sampler.sample(seeds, gen)
        loss = ce(model(feat, seeds, sampled), y[seeds]).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    seeds = torch.randint(0, n, (512,), generator=gen)
    sampled, _ = sampler.sample(seeds, gen)
    with torch.no_grad():
        acc = (model(feat, seeds, sampled).argmax(-1) == y[seeds]).float()
    assert losses[-1] < losses[0]
    assert acc.mean().item() > 0.9


def test_bipartite_sage_layer_count_mismatch_raises():
    edges, x = _cycle(8, 4)
    sampler = sampling.NeighborSampler(Graph(edges, num_nodes=8),
                                       samples=(2,), device="cpu")
    model = BipartiteSAGE(4, 2, num_layers=2, device="cpu")
    seeds = torch.tensor([0])
    sampled, _ = sampler.sample(seeds, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="blocks"):
        model(torch.as_tensor(x), seeds, sampled)


def test_namespaces_of_sampling():
    """``sampling`` binds every name of the reference's but
    ``metapath_randomwalk_dist`` (the distributed layer's), plus
    ``walks_to_lists``, ``padded_batch_graph`` and ``max_batch_words``;
    ``utils.data`` binds the reference's."""
    import pgl_tpu.utils.data
    ref = set(jsampling.__all__) - {"metapath_randomwalk_dist"}
    assert ref <= set(sampling.__all__)
    assert set(sampling.__all__) - ref == {"walks_to_lists",
                                           "padded_batch_graph",
                                           "max_batch_words"}
    for name in sampling.__all__:
        assert getattr(sampling, name) is not None
    assert set(pgl_tpu_torch.utils.data.__all__) == set(
        pgl_tpu.utils.data.__all__)


def test_bipartite_sage_on_a_fill_id():
    """A departure: a zero-degree node whose row starts at the end of
    ``sorted_v`` samples ``INT32_MIN`` (``jnp.take``'s fill) in both
    packages, mask 0. The reference's ``BipartiteSAGE`` then gathers a NaN
    row there and its ``h * mask`` keeps the NaN, so that seed's logits
    are NaN; the port gathers at a clamped id and drops the masked row:
    finite logits, equal to the reference's on every other seed."""
    edges = np.array([[0, 1], [1, 2], [2, 0], [3, 1]])   # node 3: no in
    feat = np.arange(16, dtype=np.float32).reshape(4, 4) / 16
    jg = pgl_tpu.Graph(edges, num_nodes=4)
    jsampler = jsampling.NeighborSampler(jg.tensor(), samples=(2, 2))
    seeds = jnp.asarray([0, 3, 1], jnp.int32)
    sampled, _ = jsampler.sample(seeds, jax.random.key(0))
    assert (np.asarray(sampled[-1][1])[1] == tsage.INT32_MIN).all()
    jmodel = jmodels.BipartiteSAGE(input_size=4, num_class=3, num_layers=2,
                                   hidden_size=5)
    params = jmodel.init(jax.random.key(1), jnp.asarray(feat), seeds,
                         sampled)
    want = np.asarray(jmodel.apply(params, jnp.asarray(feat), seeds,
                                   sampled))
    assert np.isnan(want[1]).all() and np.isfinite(want[[0, 2]]).all()
    model = BipartiteSAGE(4, 3, num_layers=2, hidden_size=5, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                          params), "cpu"))
    blocks = [tuple(torch.as_tensor(np.array(a)) for a in blk)
              for blk in sampled]
    got = model(torch.as_tensor(feat), torch.as_tensor(np.array(seeds)),
                blocks).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=RTOL,
                               atol=ATOL)
