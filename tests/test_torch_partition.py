"""Port parity for partitioning (``pgl_tpu_torch.partition``) on the CPU
against ``pgl_tpu``'s: each case of the reference's
``tests/test_partition.py`` mirrored, the parts of ``metis_partition`` (each
balance), ``random_partition`` and ``reorder_graph`` equal to the
reference's for a seed, and the ``Graph`` leftovers of this slice:
``tensor(build_adj=False)`` and ``EdgeIndex.from_edges_device``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pgl_tpu
import pgl_tpu.partition as jpartition
from pgl_tpu.datasets import community_graph as j_cg
from pgl_tpu.utils.edge_index import EdgeIndex as JEdgeIndex
from pgl_tpu_torch import Graph
from pgl_tpu_torch.datasets import community_graph, powerlaw_graph, \
    random_graph
from pgl_tpu_torch.partition import (metis_partition, partition_to_order,
                                     random_partition, reorder_graph)
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes
torch.set_num_threads(1)

FIELDS = ("degree", "sorted_u", "sorted_v", "sorted_eid", "indptr")


def edge_cut(graph, parts):
    e = np.asarray(graph.edges)
    return int((parts[e[:, 0]] != parts[e[:, 1]]).sum())


def test_random_partition_balance():
    g = random_graph(1000, 5000, seed=0)
    parts = random_partition(g, 4, seed=0)
    assert np.bincount(parts, minlength=4).min() > 150
    np.testing.assert_array_equal(parts, jpartition.random_partition(
        pgl_tpu.datasets.random_graph(1000, 5000, seed=0), 4, seed=0))


def test_metis_partition_balance_and_cut():
    g, _ = community_graph(num_nodes=600, num_classes=4, avg_degree=12,
                           p_inter=0.02, seed=1)
    parts = metis_partition(g, 4, seed=0)
    counts = np.bincount(parts, minlength=4)
    assert parts.min() >= 0 and parts.max() <= 3
    assert counts.max() <= int(1.25 * 600 / 4)
    assert edge_cut(g, parts) < 0.5 * edge_cut(g, random_partition(g, 4,
                                                                    seed=0))


@pytest.mark.parametrize("balance", ["nodes", "edges", "in_edges"])
def test_metis_partition_equals_reference(balance):
    g, _ = community_graph(num_nodes=500, num_classes=4, avg_degree=8,
                           seed=2)
    jg, _ = j_cg(num_nodes=500, num_classes=4, avg_degree=8, seed=2)
    got = metis_partition(g, 5, seed=3, balance=balance)
    np.testing.assert_array_equal(got, jpartition.metis_partition(
        jg, 5, seed=3, balance=balance))
    assert got.dtype == np.int64
    with pytest.raises(ValueError, match="balance"):
        metis_partition(g, 5, balance="weights")


def test_partition_to_order():
    parts = np.array([2, 0, 1, 0, 2, 1])
    order, indptr = partition_to_order(parts)
    np.testing.assert_array_equal(parts[order], [0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(indptr, [0, 2, 4, 6])


def test_reorder_graph():
    g, _ = community_graph(num_nodes=300, num_classes=3, feat_dim=8,
                           avg_degree=6, seed=0)
    g2, order = reorder_graph(g, npart=4, seed=0)
    assert g2.num_nodes == 300 and g2.num_edges == g.num_edges
    out1 = g.tensor("cpu").send_recv(torch.as_tensor(g.node_feat["h"]),
                                     "sum").numpy()
    out2 = g2.tensor("cpu").send_recv(torch.as_tensor(g2.node_feat["h"]),
                                      "sum").numpy()
    np.testing.assert_allclose(out2, out1[order], rtol=1e-4, atol=1e-5)
    jg2, jorder = jpartition.reorder_graph(
        j_cg(num_nodes=300, num_classes=3, feat_dim=8, avg_degree=6,
             seed=0)[0], npart=4, seed=0)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(g2.edges, np.asarray(jg2.edges))
    np.testing.assert_array_equal(g2.node_feat["h"],
                                  np.asarray(jg2.node_feat["h"]))


def test_metis_cut_quality_vs_planted_structure():
    rng = np.random.default_rng(5)
    npc, S = 64, 8
    n = npc * S
    intra = [rng.integers(0, npc, (500, 2)) + c * npc for c in range(S)]
    inter = np.stack([rng.integers(0, n, 120), rng.integers(0, n, 120)], 1)
    edges = np.concatenate(intra + [inter])
    g = Graph(edges, num_nodes=n)
    truth = np.arange(n) // npc
    planted_cut = int((truth[edges[:, 0]] != truth[edges[:, 1]]).sum())
    for seed in (0, 1):
        parts = metis_partition(g, S, seed=seed)
        assert np.bincount(parts, minlength=S).max() <= int(1.25 * n / S)
        assert edge_cut(g, parts) <= 3 * planted_cut


def test_metis_beats_random_on_powerlaw():
    """The reference's hard case: no planted structure, a hub; a real
    margin over random and the in-edge balance within 15% of the hub-set
    floor."""
    g = powerlaw_graph(num_nodes=20000, avg_degree=8, feat_dim=0, seed=2)
    e = np.asarray(g.edges)
    indeg = np.bincount(e[:, 1], minlength=g.num_nodes)
    rand_cut = edge_cut(g, random_partition(g, 8, seed=0))
    for bal, margin in (("nodes", 0.95), ("in_edges", 0.87)):
        parts = metis_partition(g, 8, seed=0, balance=bal)
        if bal == "nodes":
            assert np.bincount(parts, minlength=8).max() <= int(
                1.5 * g.num_nodes / 8)
        assert edge_cut(g, parts) < margin * rand_cut, bal
    parts = metis_partition(g, 8, seed=0, balance="in_edges")
    mass = np.array([indeg[parts == s].sum() for s in range(8)])
    assert mass.max() <= 1.15 * max(indeg.max(), g.num_edges / 8)


# -- the Graph leftovers ------------------------------------------------------

def test_tensor_without_adjacency():
    """``tensor(build_adj=False)`` builds no index and no layout; indexes
    already built go over; the first ``send_recv`` builds what it needs
    and equals the reference's."""
    g, _ = community_graph(num_nodes=200, num_classes=3, feat_dim=8,
                           avg_degree=5, seed=4)
    t = g.tensor("cpu", build_adj=False)
    assert t._adj_dst_index is None and t._adj_src_index is None
    assert t._spmm_layouts is None and t._dedup_layouts is None
    g.adj_dst_index
    t2 = g.tensor("cpu", build_adj=False)
    assert t2._adj_dst_index is not None and t2._adj_src_index is None
    x = torch.as_tensor(g.node_feat["h"])
    jg = j_cg(num_nodes=200, num_classes=3, feat_dim=8, avg_degree=5,
              seed=4)[0].tensor(build_adj=False)
    want = np.asarray(jg.send_recv(jnp.asarray(g.node_feat["h"]), "mean"))
    for graph in (t, t2):
        np.testing.assert_allclose(graph.send_recv(x, "mean").numpy(), want,
                                   rtol=1e-5, atol=1e-6)
        assert graph._spmm_layouts is not None


@pytest.mark.parametrize("N,E", [(40, 300), (7, 0), (1, 5)])
def test_edge_index_from_edges_device(N, E):
    """The device build (stable sort, bincount, cumsum) gives the host
    build's arrays, and the reference's device build's."""
    rng = np.random.default_rng(N)
    u, v = rng.integers(0, N, E), rng.integers(0, 3 * N, E)
    got = EdgeIndex.from_edges_device(torch.as_tensor(u), torch.as_tensor(v),
                                      N)
    host = EdgeIndex.from_edges(u, v, N)
    ref = JEdgeIndex.from_edges_device(jnp.asarray(u), jnp.asarray(v), N)
    assert got.is_tensor and got.sorted_v.dtype == torch.int64
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(host, f))
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
