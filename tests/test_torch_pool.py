"""Port parity for the readouts, pooling, LSTM aggregation and the graph
transforms: ``pgl_tpu_torch.utils.transform``, ``Set2Set``,
``GlobalAttention``, ``SAGPool`` (dynamic and static), the Graph
Multiset Transformer (``MAB``, ``SAB``, ``PMA``), ``LSTMAggregation``,
``lstm_aggregate`` and ``LSTMSage`` against ``pgl_tpu``'s on the CPU, with
flax-initialised parameters carried over by
``pgl_tpu_torch.utils.convert`` (the LSTM cell's eight Denses onto one
``torch.nn.LSTMCell``); mirrors ``tests/test_pool.py`` and
``tests/test_conv.py``'s LSTM aggregation case by case.

The edge rewrites, ``to_dense_batch``'s mask, SAGPool's kept nodes and
pooled edges compare exactly; outputs at rtol/atol 1e-5, gradients at
rtol 1e-4, atol 1e-5 (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

import flax.linen as fnn

import pgl_tpu.nn as jnn
from pgl_tpu import Graph as JGraph
from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.models import LSTMSage as JLSTMSage
from pgl_tpu.nn.gmt_pool import MAB as JMAB
from pgl_tpu.utils import transform as jtr
from pgl_tpu_torch import Graph
from pgl_tpu_torch import nn as tnn
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import LSTMSage
from pgl_tpu_torch.nn.aggregation import lstm_aggregate, lstm_cell
from pgl_tpu_torch.nn.gmt_pool import MAB
from pgl_tpu_torch.utils import transform as tr
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=ATOL)


def _batched(D=16):
    """Three community graphs of 60, 90 and 40 nodes, ``disjoint``: the
    reference's on its device and the port's on the CPU."""
    graphs = [(j_community_graph(n, 2, D, 6, seed=s)[0],
               community_graph(n, 2, D, 6, seed=s)[0])
              for n, s in ((60, 1), (90, 2), (40, 3))]
    return (JGraph.disjoint([j for j, _ in graphs]).tensor(),
            Graph.disjoint([t for _, t in graphs]).tensor("cpu"))


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


def _init(jmodule, *args):
    """flax ``init`` at key 0 under ``jit`` (eager, it compiles op by op)."""
    return jax.jit(lambda key: jmodule.init(key, *args))(jax.random.key(0))


def _parity(jmodule, module, graphs, jcall=None, tcall=None, x_grad=True,
            grad_rtol=1e-4):
    """Carry the flax parameters over, then hold the output, every trained
    parameter's gradient and (``x_grad``) the input's against the
    reference's under a fixed cotangent. ``jcall(params, graph, x)`` and
    ``tcall(graph, x)`` call the modules and return the output compared
    (default ``(graph, x)``). Returns the port's output."""
    gj, gt = graphs
    jcall = jcall or (lambda p, g, x: jmodule.apply(p, g, x))
    tcall = tcall or (lambda g, x: module(g, x))
    xj = gj.node_feat["h"]
    params = {"params": _init(jmodule, gj, xj)["params"]}
    shape = jax.eval_shape(lambda p: jcall(p, gj, xj), params).shape
    cot = np.random.default_rng(0).normal(size=shape).astype(np.float32)

    def loss(p, x):
        out = jcall(p, gj, x)
        return (out * cot).sum(), out

    (_, want), (want_grads, want_dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, xj)
    module.load_state_dict(flax_to_state_dict(_tree(params), "cpu"),
                           strict=True)
    x = gt.node_feat["h"].clone().requires_grad_(x_grad)
    out = tcall(gt, x)
    (out * torch.as_tensor(cot)).sum().backward()
    close(out.detach(), want)
    if x_grad:
        close(x.grad, want_dx, grad_rtol)
    want_grads = flax_to_state_dict(_tree(want_grads), "cpu")
    got = {k: p.grad for k, p in module.named_parameters()
           if p.requires_grad}
    assert set(got) <= set(want_grads)
    for k in want_grads:
        if k not in got:    # an LSTM cell's input bias: 0, flax has none
            assert k.endswith("bias_ih") and not want_grads[k].any()
        elif got[k] is None:    # a parameter the output does not reach
            assert not want_grads[k].any(), k
        else:
            close(got[k], want_grads[k], grad_rtol)
    return out


# -- utils/transform ----------------------------------------------------------

def _host_pair(edges, N, **kw):
    return Graph(edges, num_nodes=N, **kw), JGraph(edges, num_nodes=N, **kw)


def test_to_undirected():
    nf = {"h": np.ones((3, 2), np.float32)}
    g, jg = _host_pair(np.array([[0, 1], [0, 1], [2, 0]]), 3, node_feat=nf)
    got, want = tr.to_undirected(g), jtr.to_undirected(jg)
    np.testing.assert_array_equal(got.edges, np.asarray(want.edges))
    assert set(map(tuple, got.edges.tolist())) == {(0, 1), (1, 0), (2, 0),
                                                   (0, 2)}
    assert "h" in got.node_feat
    with pytest.raises(NotImplementedError):
        tr.to_undirected(g, copy_edge_feat=True)


@pytest.mark.parametrize("replace", [False, True])
def test_add_self_loops(replace):
    g, jg = _host_pair(np.array([[0, 1], [1, 1]]), 3)
    got = tr.add_self_loops(g, replace=replace)
    want = jtr.add_self_loops(jg, replace=replace)
    np.testing.assert_array_equal(got.edges, np.asarray(want.edges))
    assert got.edges.dtype == np.asarray(want.edges).dtype
    assert got.num_edges == (4 if replace else 5)


@pytest.mark.parametrize("cap", [None, 50, 100])
def test_to_dense_batch(cap):
    """The default cap is the largest graph; at 50 the 60- and 90-node
    graphs lose their last nodes, none spilling into the next graph."""
    gj, gt = _batched()
    want, want_mask = jtr.to_dense_batch(gj.node_feat["h"], gj,
                                         max_num_nodes=cap)
    got, mask = tr.to_dense_batch(gt.node_feat["h"], gt, fill_value=0.0,
                                  max_num_nodes=cap)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (3, cap or 90, 16)


def test_to_dense_batch_golden():
    g1 = Graph(np.array([[0, 1], [1, 0]]), num_nodes=2)
    g2 = Graph(np.array([[0, 1], [1, 2], [2, 0]]), num_nodes=3)
    g = Graph.disjoint([g1, g2]).tensor("cpu")
    x = torch.tensor([[1.0, 2], [3, 4], [5, 6], [7, 8], [9, 10]])
    out, mask = tr.to_dense_batch(x, g, fill_value=-1.0)
    np.testing.assert_array_equal(out[0].numpy(), [[1, 2], [3, 4], [-1, -1]])
    np.testing.assert_array_equal(mask.numpy(), [[False, False, True],
                                                 [False, False, False]])


@pytest.mark.parametrize("with_attr,num_nodes", [(True, 4), (False, None)])
def test_filter_adj(with_attr, num_nodes):
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [4, 3]])
    perm = np.array([0, 1, 3, 5])
    attr = np.array([10., 20, 30, 40, 50]) if with_attr else None
    if num_nodes is not None:
        edges, perm = edges[:4], perm[:3]
        attr = attr[:4]
    got = tr.filter_adj(edges, perm, edge_attr=attr, num_nodes=num_nodes)
    want = jtr.filter_adj(edges, perm, edge_attr=attr, num_nodes=num_nodes)
    np.testing.assert_array_equal(got[0], want[0])
    if with_attr:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], [[0, 1], [2, 0]])
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("seed", [1, 7])
def test_drop_edge_keeps_the_reference_edges(seed):
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 20, (400, 2))
    ef = {"w": np.arange(400, dtype=np.float32)}
    nf = {"h": rng.normal(size=(20, 3)).astype(np.float32)}
    g, jg = _host_pair(edges, 20, edge_feat=ef, node_feat=nf)
    got = tr.drop_edge(g, rate=0.5, seed=seed)
    want = jtr.drop_edge(jg, rate=0.5, seed=seed)
    np.testing.assert_array_equal(got.edges, np.asarray(want.edges))
    np.testing.assert_array_equal(got.edge_feat["w"],
                                  np.asarray(want.edge_feat["w"]))
    assert 100 < got.num_edges < 300 and "h" in got.node_feat


def test_host_transforms_raise_on_a_tensor_graph():
    g = Graph(np.array([[0, 1]]), num_nodes=2).tensor("cpu")
    for fn in (tr.to_undirected, tr.add_self_loops, tr.drop_edge):
        with pytest.raises(TypeError, match="numpy"):
            fn(g)


def test_appnp_self_loop_message_names_the_transform():
    g = Graph(np.array([[0, 1]]), num_nodes=2).tensor("cpu")
    for layer in (tnn.APPNP(self_loop=True),
                  tnn.GPRConv(2, 2, 2, self_loop=True, device="cpu")):
        with pytest.raises(ValueError, match="utils.transform"):
            layer(g, torch.ones(2, 2))


# -- readouts -----------------------------------------------------------------

def test_set2set():
    """Two LSTM layers: the first cell takes the 2·D query, the second the
    first's D-wide output."""
    _parity(jnn.Set2Set(input_dim=16, n_iters=3, n_layers=2),
            tnn.Set2Set(16, 3, 2, device="cpu"), _batched())


def test_lstm_cell_mapping():
    """flax's ``OptimizedLSTMCell`` and the converted ``nn.LSTMCell`` give
    the same carry on the same inputs."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 5)).astype(np.float32)
    h, c = (rng.normal(size=(7, 4)).astype(np.float32) for _ in range(2))
    jcell = fnn.OptimizedLSTMCell(4)
    carry = (jnp.asarray(c), jnp.asarray(h))
    params = _init(jcell, carry, jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1, params)      # nonzero biases
    (want_c, want_h), _ = jax.jit(lambda p: jcell.apply(
        p, carry, jnp.asarray(x)))(params)
    cell = lstm_cell(5, 4, torch.Generator().manual_seed(0))
    cell.load_state_dict(flax_to_state_dict(_tree(params), "cpu"))
    got_h, got_c = cell(torch.as_tensor(x), (torch.as_tensor(h),
                                             torch.as_tensor(c)))
    close(got_h.detach(), want_h)
    close(got_c.detach(), want_c)
    assert not cell.bias_ih.requires_grad and not cell.bias_ih.any()


@pytest.mark.parametrize("feat_nn", [False, True])
def test_global_attention(feat_nn):
    j = jnn.GlobalAttention(gate=fnn.Dense(1),
                            feat_nn=fnn.Dense(6) if feat_nn else None)
    t = tnn.GlobalAttention(torch.nn.Linear(16, 1),
                            torch.nn.Linear(16, 6) if feat_nn else None)
    out = _parity(j, t, _batched())
    assert out.shape == (3, 6 if feat_nn else 16)


# -- SAGPool ------------------------------------------------------------------

@pytest.mark.parametrize("min_score", [None, 0.3])
def test_sag_pool_dynamic(min_score):
    """The kept rows, their subgraph ids and the pooled graph (edges,
    ``graph_edge_id``, node counts) equal the reference's; the rows and
    the gradients within tolerance."""
    gj, gt = _batched()
    j = jnn.SAGPool(input_dim=16, ratio=0.5, min_score=min_score)
    t = tnn.SAGPool(16, ratio=0.5, min_score=min_score, device="cpu")
    # the reference's host rebuild does not trace: its parameters are the
    # static mode's, and so is its gradient, at the kept rows in subgraph
    # order as the dynamic mode keeps them
    static = jnn.SAGPool(input_dim=16, ratio=0.5, min_score=min_score,
                         static=True)
    params = _init(static, gj, gj.node_feat["h"])
    jdyn, jbatch, jpooled = j.apply(params, gj, gj.node_feat["h"])
    got = {}

    def tcall(g, x):
        got["out"] = t(g, x)
        return got["out"][0]

    jx, jkeep, _ = jax.jit(lambda p: static.apply(
        p, gj, gj.node_feat["h"]))(params)
    rank = np.flatnonzero(np.asarray(jkeep))
    close(np.asarray(jx)[rank], jdyn)
    _parity(static, t, (gj, gt),
            lambda p, g, x: static.apply(p, g, x)[0][rank], tcall)
    x, batch, pooled = got["out"]
    np.testing.assert_array_equal(batch.numpy(), np.asarray(jbatch))
    np.testing.assert_array_equal(pooled.edges.numpy(),
                                  np.asarray(jpooled.edges))
    np.testing.assert_array_equal(pooled.graph_edge_id.numpy(),
                                  np.asarray(jpooled.graph_edge_id))
    np.testing.assert_array_equal(pooled.graph_node_id.numpy(),
                                  np.asarray(jpooled.graph_node_id))
    assert pooled.is_tensor and pooled.num_graph == 3
    close(pooled.node_feat["attr"], x.detach())
    if min_score is None:
        assert pooled.num_nodes == 30 + 45 + 20


def test_sag_pool_golden():
    g1 = Graph(np.array([[0, 1], [1, 0]]), num_nodes=2)
    g2 = Graph(np.array([[0, 1], [1, 2], [2, 0]]), num_nodes=3)
    g = Graph.disjoint([g1, g2]).tensor("cpu")
    x = torch.tensor([[1.0, 2], [3, 4], [5, 6], [7, 8], [9, 10]])
    out, batch, newg = tnn.SAGPool(2, ratio=0.5, device="cpu")(g, x)
    assert out.shape[0] == 3 and newg.num_graph == 2 and newg.num_nodes == 3
    np.testing.assert_array_equal(batch.numpy(), [0, 1, 1])


def test_sag_pool_static():
    """The keep mask equals the reference's (the dynamic mode's survivors),
    dropped rows are zeroed, rows and gradients within tolerance."""
    gj, gt = _batched()
    j = jnn.SAGPool(input_dim=16, ratio=0.5, static=True)
    t = tnn.SAGPool(16, ratio=0.5, static=True, device="cpu")
    got = {}

    def tcall(g, x):
        got["out"] = t(g, x)
        return got["out"][0]

    _parity(j, t, (gj, gt), lambda p, g, x: j.apply(p, g, x)[0], tcall)
    x, keep, same = got["out"]
    params = _init(j, gj, gj.node_feat["h"])
    _, jkeep, _ = jax.jit(lambda p: j.apply(p, gj, gj.node_feat["h"]))(
        params)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert same is gt and int(keep.sum()) == 30 + 45 + 20
    assert not x.detach()[~keep].any()


# -- Graph Multiset Transformer -----------------------------------------------

@pytest.mark.parametrize("kw", [
    # the default sequence; the 90-node graph is cut at 64
    dict(num_nodes=64, layer_norm=True),
    # GMPool_G last: the first two pools reach no output, no gradient
    dict(num_nodes=96, pool_sequences=["GMPool_I", "SelfAtt", "GMPool_G"],
         pooling_ratio=0.5, num_heads=2)])
def test_gmt(kw):
    j = jnn.GraphMultisetTransformer(input_dim=16, hidden_dim=8,
                                     output_dim=4, **{"num_heads": 4, **kw})
    t = tnn.GraphMultisetTransformer(16, 8, 4, **{"num_heads": 4, **kw},
                                     device="cpu")
    out = _parity(j, t, _batched())
    assert out.shape == (3, 4)


def test_gmt_rejects_a_sequence_ending_in_self_attention():
    with pytest.raises(ValueError, match="GMPool"):
        tnn.GraphMultisetTransformer(4, 8, 2, pool_sequences=["GMPool_G",
                                                              "SelfAtt"],
                                     device="cpu")
    with pytest.raises(ValueError, match="one of"):
        tnn.GraphMultisetTransformer(4, 8, 2, pool_sequences=["Pool"],
                                     device="cpu")


def test_mab_projects_keys_and_values_from_the_raw_input():
    """A dense ``MAB`` with a padding mask; its ``layer_v`` reads the raw
    keys (the reference's reading of upstream)."""
    rng = np.random.default_rng(4)
    Q = rng.normal(size=(2, 3, 6)).astype(np.float32)
    K = rng.normal(size=(2, 5, 6)).astype(np.float32)
    mask = np.zeros((2, 5), bool)
    mask[1, 3:] = True
    j = JMAB(6, 6, 8, 2)
    args = (jnp.asarray(Q), jnp.asarray(K), None, jnp.asarray(mask))
    params = _init(j, *args)
    want = jax.jit(lambda p: j.apply(p, *args))(params)
    t = MAB(6, 6, 8, 2, device="cpu")
    t.load_state_dict(flax_to_state_dict(_tree(params), "cpu"))
    got = t(torch.as_tensor(Q), torch.as_tensor(K), None,
            torch.as_tensor(mask))
    close(got.detach(), want)


# -- LSTM aggregation ---------------------------------------------------------

def _lstm_graphs():
    """A 60-node graph whose destinations take up to ~25 messages (a hub at
    node 2) and whose top fifth receives none, 8 features."""
    rng = np.random.default_rng(0)
    N, E = 60, 300
    dst = rng.integers(0, 48, E)
    dst[:24] = 2
    edges = np.stack([rng.integers(0, N, E), dst], axis=1)
    nf = {"h": rng.normal(size=(N, 8)).astype(np.float32)}
    return (JGraph(edges, num_nodes=N, node_feat=nf).tensor(),
            Graph(edges, num_nodes=N, node_feat=nf).tensor("cpu"))


def test_lstm_aggregation():
    """Messages gathered at each edge's source; the cap of 4 cuts most
    nodes (the hub takes 25 messages); nodes without messages give zeros;
    ``lstm_aggregate`` with the layer's carried-over parameters gives its
    output."""
    from pgl_tpu.nn.aggregation import LSTMAggregation as JLSTMAggregation
    graphs = _lstm_graphs()
    src = np.asarray(graphs[0].edges)[:, 0]
    j = JLSTMAggregation(hidden_size=12, max_degree=4)
    t = tnn.LSTMAggregation(12, 4, input_size=8, device="cpu")
    out = _parity(j, t, graphs,
                  lambda p, g, x: j.apply(p, g, jnp.take(x, src, axis=0)),
                  lambda g, x: t(g, x.index_select(0, g.edges[:, 0])))
    indeg = graphs[1].indegree().numpy()
    assert (indeg == 0).any() and indeg.max() > 20
    assert not out.detach()[indeg == 0].any()
    gt = graphs[1]
    params = t.state_dict()
    msgs = gt.node_feat["h"].index_select(0, gt.edges[:, 0])
    np.testing.assert_array_equal(
        lstm_aggregate(gt, msgs, params, 12, 4).detach(), out.detach())


def test_lstm_sage():
    j = JLSTMSage(input_size=8, num_class=3, hidden_size=6, max_degree=8)
    t = LSTMSage(8, 3, hidden_size=6, max_degree=8, device="cpu")
    _parity(j, t, _lstm_graphs())


# -- the launches chip_smoke.py asserts -------------------------------------

def _readout_cases():
    import chip_smoke
    return sorted(chip_smoke.READOUT_PER_STEP) + ["LSTMSage"]


@pytest.mark.parametrize("name", _readout_cases())
def test_k1_calls_a_step_match_the_chip_table(monkeypatch, name):
    """One training step of each of phase 12's readout models on 8 motif
    graphs, and of ``LSTMSage`` on a small powerlaw graph, calls K1 (its
    plain version here, through the same autograd function)
    ``READOUT_PER_STEP`` times by layout and width (LSTMSage never): the
    launches ``chip_smoke.py`` asserts on the card."""
    import chip_smoke
    from pgl_tpu_torch.datasets import powerlaw_graph
    from pgl_tpu_torch.ops.kernels import segment_kernels

    calls = {}
    real = segment_kernels._spmm_one

    def spy(x, layout):
        key = (layout.kind, x.shape[1])
        calls[key] = calls.get(key, 0) + 1
        return real(x, layout)

    monkeypatch.setattr(segment_kernels, "_spmm_one", spy)
    if name == "LSTMSage":
        host = powerlaw_graph(200, 8, feat_dim=128, seed=0)
        trainer = chip_smoke.lstmsage_trainer(
            np.random.default_rng(0).integers(0, 16, 200))
        want = {}
    else:
        host, labels = chip_smoke.motif_host(num_graphs=8)
        trainer = chip_smoke.readout_trainer(name, labels)
        want = chip_smoke.READOUT_PER_STEP[name]
    _, step = trainer(host.tensor("cpu"))
    calls.clear()
    assert np.isfinite(float(step()))
    assert calls == want
