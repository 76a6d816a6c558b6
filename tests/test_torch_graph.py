"""Port parity for the graph layer: ``EdgeIndex``, ``Graph.send_u_recv``,
``degree_norm`` and the synthetic generators of ``pgl_tpu_torch`` against
``pgl_tpu`` on the CPU, from the same numpy inputs. Reductions compare at
rtol 1e-5, atol 1e-5 (float32; sums in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack: there this file skips, and the gpu tests still collect
pytest.importorskip("flax")

import pgl_tpu
import pgl_tpu_torch
from pgl_tpu.nn.functional import degree_norm as j_degree_norm
from pgl_tpu.utils.edge_index import EdgeIndex as JEdgeIndex
from pgl_tpu_torch.nn.functional import degree_norm as t_degree_norm
from pgl_tpu_torch.utils.edge_index import EdgeIndex as TEdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

FIELDS = ("degree", "sorted_u", "sorted_v", "sorted_eid", "indptr")


def random_edges(N, E, seed=0):
    rng = np.random.default_rng(seed)
    # skewed destinations: node 0 takes a third, the top half stays empty
    dst = np.where(rng.random(E) < 1 / 3, 0, rng.integers(0, N // 2, E))
    return np.stack([rng.integers(0, N, E), dst], axis=1)


@pytest.mark.parametrize("N,E,seed", [(50, 400, 0), (7, 0, 1), (300, 5000, 2)])
def test_edge_index_matches_reference(N, E, seed):
    edges = random_edges(N, E, seed)
    for u, v in ((edges[:, 0], edges[:, 1]), (edges[:, 1], edges[:, 0])):
        want = JEdgeIndex.from_edges(u, v, N)
        got = TEdgeIndex.from_edges(u, v, N)
        back = got.tensor("cpu").numpy()
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            np.testing.assert_array_equal(getattr(back, f), getattr(want, f))
            assert getattr(back, f).dtype == getattr(got, f).dtype


def test_edge_index_rejects_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        TEdgeIndex.from_edges(np.array([0, 5]), np.array([1, 1]), 5)


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("D", [16, 5])
def test_send_u_recv_matches_reference(reduce_op, D):
    N = 200
    edges = random_edges(N, 3000, seed=3)
    x = np.random.default_rng(4).normal(size=(N, D)).astype(np.float32)
    jg = pgl_tpu.Graph(edges, num_nodes=N).tensor()
    want = np.asarray(jg.send_u_recv(jnp.asarray(x), reduce_op))
    tg = pgl_tpu_torch.Graph(edges, num_nodes=N).tensor("cpu")
    got = tg.send_u_recv(torch.as_tensor(x), reduce_op)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got[N // 2:] == 0).all()          # nodes with no in-edges


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_zero_edge_graph_and_isolated_nodes_give_zeros(reduce_op):
    x = torch.randn(6, 3, requires_grad=True)
    for edges in (np.zeros((0, 2), np.int64), np.array([[0, 1], [2, 1]])):
        g = pgl_tpu_torch.Graph(edges, num_nodes=6).tensor("cpu")
        out = g.send_recv(x, reduce_op)
        assert out.shape == (6, 3)
        assert torch.isfinite(out).all()
        isolated = [i for i in range(6) if i not in set(edges[:, 1])]
        assert (out[isolated] == 0).all()
        out.sum().backward()
        assert torch.isfinite(x.grad).all()
        x.grad = None


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_message_passing_send_u_recv_matches_reference(reduce_op):
    from pgl_tpu.ops import message_passing as jmp
    from pgl_tpu_torch.ops import message_passing as tmp
    edges = random_edges(80, 900, seed=9)
    x = np.random.default_rng(10).normal(size=(80, 6)).astype(np.float32)
    want = jmp.send_u_recv(jnp.asarray(x), jnp.asarray(edges[:, 0]),
                           jnp.asarray(edges[:, 1]), 80, reduce_op)
    got = tmp.send_u_recv(torch.as_tensor(x), torch.as_tensor(edges[:, 0]),
                          torch.as_tensor(edges[:, 1]), 80, reduce_op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_graph_from_tensor_edges_builds_its_layouts():
    edges = random_edges(40, 300, seed=11)
    x = torch.randn(40, 5)
    want = pgl_tpu_torch.Graph(edges, num_nodes=40).tensor("cpu").send_recv(x)
    g = pgl_tpu_torch.Graph(torch.as_tensor(edges), num_nodes=40)
    np.testing.assert_allclose(g.send_recv(x).numpy(), want.numpy())


def test_send_u_recv_keeps_trailing_feature_shape():
    edges = random_edges(40, 300, seed=5)
    g = pgl_tpu_torch.Graph(edges, num_nodes=40).tensor("cpu")
    x = torch.randn(40, 2, 3)
    np.testing.assert_allclose(
        g.send_recv(x, "sum").numpy(),
        g.send_recv(x.reshape(40, 6), "sum").reshape(40, 2, 3).numpy())


def test_mean_of_a_three_dim_feature_divides_each_row():
    """Departure: ``send_u_recv(x, "mean")`` on an ``[N, H, D]`` feature
    divides each node's row by its in-degree (floored at 1) in the port,
    and raises in the reference, whose ``deg[:, None]`` does not broadcast
    against the 3-D sum (``pgl_tpu/graph.py:340-341``)."""
    edges = random_edges(40, 300, seed=7)
    x = np.random.default_rng(8).normal(size=(40, 2, 3)).astype(np.float32)
    with pytest.raises(Exception, match="broadcast"):
        pgl_tpu.Graph(edges, num_nodes=40).tensor().send_recv(
            jnp.asarray(x), "mean")
    g = pgl_tpu_torch.Graph(edges, num_nodes=40).tensor("cpu")
    got = g.send_recv(torch.as_tensor(x), "mean")
    deg = np.maximum(np.bincount(edges[:, 1], minlength=40), 1)
    want = np.zeros((40, 2, 3))
    np.add.at(want, edges[:, 1], x[edges[:, 0]])
    np.testing.assert_allclose(got.numpy(), want / deg[:, None, None],
                               rtol=1e-5, atol=1e-5)


def test_mean_of_a_one_dim_feature_is_per_node():
    """Departure: ``send_u_recv(x, "mean")`` on an ``[N]`` feature gives
    each node's sum over its in-degree (floored at 1), ``[N]``, in the port
    (as the reference's own ``BiGraph.send_recv`` does). The reference's
    ``Graph`` divides the ``[N]`` sum by ``deg[:, None]``
    (``pgl_tpu/graph.py:339-341``), which broadcasts to ``[N, N]``: row i
    is every node's sum over node i's degree."""
    edges = np.array([[0, 1], [1, 1], [2, 0]])
    x = np.array([1.0, 2.0, 4.0], np.float32)
    ref = pgl_tpu.Graph(edges, num_nodes=3).tensor().send_recv(
        jnp.asarray(x), "mean")
    np.testing.assert_allclose(np.asarray(ref), [[4, 3, 0], [2, 1.5, 0],
                                                 [4, 3, 0]])
    got = pgl_tpu_torch.Graph(edges, num_nodes=3).tensor("cpu").send_recv(
        torch.as_tensor(x), "mean")
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), [4, 1.5, 0])


def test_degree_norm_matches_reference():
    edges = random_edges(60, 500, seed=6)
    jg = pgl_tpu.Graph(edges, num_nodes=60).tensor()
    tg = pgl_tpu_torch.Graph(edges, num_nodes=60).tensor("cpu")
    for mode in ("indegree", "outdegree"):
        np.testing.assert_allclose(t_degree_norm(tg, mode).numpy(),
                                   np.asarray(j_degree_norm(jg, mode)),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        t_degree_norm(tg, "both")


def test_tensor_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = pgl_tpu_torch.Graph(random_edges(10, 30), num_nodes=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        g.tensor()
    with pytest.raises(RuntimeError, match="CUDA"):
        pgl_tpu_torch.resolve_device("cuda")
    assert g.tensor("cpu").is_tensor


def test_host_and_tensor_round_trip():
    edges = random_edges(30, 200, seed=7)
    feat = np.random.default_rng(8).normal(size=(30, 4)).astype(np.float32)
    g = pgl_tpu_torch.Graph(edges, num_nodes=30, node_feat={"h": feat})
    with pytest.raises(ValueError, match="tensor"):
        g.send_recv(torch.as_tensor(feat))
    back = g.tensor("cpu").numpy()
    np.testing.assert_array_equal(back.edges, edges)
    np.testing.assert_array_equal(back.node_feat["h"], feat)
    np.testing.assert_array_equal(back.indegree(), g.indegree())
    np.testing.assert_array_equal(back.outdegree(), g.outdegree())


def test_synthetic_graphs_match_reference():
    from pgl_tpu.datasets import (powerlaw_graph as jpl,
                                  community_graph as jcg)
    from pgl_tpu_torch.datasets import (powerlaw_graph as tpl,
                                        community_graph as tcg)
    jg, tg = jpl(500, 8, feat_dim=4, seed=3), tpl(500, 8, feat_dim=4, seed=3)
    np.testing.assert_array_equal(tg.edges, jg.edges)
    np.testing.assert_array_equal(tg.node_feat["h"], jg.node_feat["h"])
    (jg, jy), (tg, ty) = jcg(200, 3, seed=4), tcg(200, 3, seed=4)
    np.testing.assert_array_equal(tg.edges, jg.edges)
    np.testing.assert_array_equal(tg.node_feat["h"], jg.node_feat["h"])
    np.testing.assert_array_equal(ty, jy)
