"""Port parity for the heterogeneous path: ``HeterGraph``, ``BiGraph``,
``RGCNConv``, ``RUniMP`` and ``label_propagation_smooth`` of
``pgl_tpu_torch`` against ``pgl_tpu``'s on the CPU, with flax-initialised
parameters carried over by ``pgl_tpu_torch.utils.convert``; mirrors
``tests/test_hetergraph.py``, ``test_rgcn_golden``
(``tests/test_conv_goldens.py``), ``test_label_propagation_smooth``
(``tests/test_models.py``) and ``test_runimp_hetero``
(``tests/test_apps.py``) case by case.

Structure, indexes, samples and dump/load across the two packages compare
exactly; outputs at rtol/atol 1e-5, gradients at rtol 1e-4, atol 1e-5
(float32 sums in another order). On the CPU every sum and mean runs K1's
plain version over the same layouts the card's kernel walks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

import pgl_tpu
import pgl_tpu.nn as jnn
from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.models import RUniMP as JRUniMP
from pgl_tpu.models import label_propagation_smooth as j_smooth
from pgl_tpu_torch import BiGraph, Graph, HeterGraph
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import RUniMP, label_propagation_smooth
from pgl_tpu_torch.nn import GATConv, RGCNConv, TransformerConv
from pgl_tpu_torch.ops import dispatch
from pgl_tpu_torch.ops.kernels import segment_kernels as sk
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=ATOL)


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- HeterGraph ---------------------------------------------------------------

def heter_args():
    edges = {"click": np.array([[0, 1], [1, 2], [2, 0]]),
             "buy": np.array([[0, 2], [2, 1]])}
    return dict(edges=edges, num_nodes=3,
                node_types=[(0, "user"), (1, "item"), (2, "item")],
                node_feat={"h": np.arange(6, dtype=np.float32).reshape(3, 2)})


def test_heter_structure():
    hg = HeterGraph(**heter_args())
    assert sorted(hg.edge_types) == ["buy", "click"]
    assert hg.num_nodes == 3 and hg.num_edges == 5
    assert hg.num_nodes_by_type("item") == 2
    assert hg.num_nodes_by_type() == [("item", 2), ("user", 1)]
    np.testing.assert_array_equal(hg.nodes_by_type("user"), [0])
    assert HeterGraph(heter_args()["edges"]).num_nodes == 3


@pytest.mark.parametrize("device", [None, "cpu"])
def test_heter_getitem_and_degree(device):
    hg = HeterGraph(**heter_args())
    if device:
        hg = hg.tensor(device)
    assert isinstance(hg["click"], Graph)

    def arr(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)

    np.testing.assert_array_equal(arr(hg["click"].indegree()), [1, 1, 1])
    np.testing.assert_array_equal(arr(hg.indegree(edge_type="buy")),
                                  [0, 1, 1])
    np.testing.assert_array_equal(arr(hg.indegree()), [1, 2, 2])
    np.testing.assert_array_equal(arr(hg.outdegree()), [2, 1, 2])


def test_heter_message_passing():
    hg = HeterGraph(**heter_args()).tensor("cpu")
    h = hg["click"].node_feat["h"]
    out = hg["click"].send_recv(h, "sum")
    feat = np.arange(6, dtype=np.float32).reshape(3, 2)
    exp = np.zeros((3, 2), np.float32)
    for s, d in [(0, 1), (1, 2), (2, 0)]:
        exp[d] += feat[s]
    close(out, exp)


def test_heter_node_batch_iter_and_queries():
    hg, jhg = HeterGraph(**heter_args()), pgl_tpu.HeterGraph(**heter_args())
    batches = list(hg.node_batch_iter(2, shuffle=False, n_type="item"))
    np.testing.assert_array_equal(np.concatenate(batches), [1, 2])
    for got, want in zip(hg.node_batch_iter(2, seed=3),
                         jhg.node_batch_iter(2, seed=3)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(hg.successor("click", [0, 2]),
                         jhg.successor("click", [0, 2])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(hg.sample_predecessor("buy", [1, 2], 1, seed=4),
                         jhg.sample_predecessor("buy", [1, 2], 1, seed=4)):
        np.testing.assert_array_equal(got, want)


def test_heter_tensor_holds_one_feature_table():
    """Every edge type's device graph holds the one device copy of the
    shared features; ``tensor()`` without a device goes to the card."""
    hg = HeterGraph(**heter_args())
    ht = hg.tensor("cpu")
    ptrs = {ht[t].node_feat["h"].data_ptr() for t in ht.edge_types}
    assert len(ptrs) == 1 and ht.node_feat["h"].data_ptr() in ptrs
    assert ht.is_tensor and not hg.is_tensor
    assert not hg["click"].is_tensor and "h" in hg["click"].node_feat
    again = ht.tensor("cpu")
    assert again["buy"].node_feat["h"].data_ptr() in ptrs
    back = ht.numpy()
    np.testing.assert_array_equal(back["buy"].edges, [[0, 2], [2, 1]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hg.tensor()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_heter_dump_load_across_packages(tmp_path, writer):
    args = heter_args()
    args["node_types"] = [(0, "user"), (2, "item")]     # node 1 untyped
    hg, jhg = HeterGraph(**args), pgl_tpu.HeterGraph(**args)
    path = str(tmp_path / "hg")
    if writer == "port":
        hg.tensor("cpu").dump(path)
        got = pgl_tpu.HeterGraph.load(path)
    else:
        jhg.dump(path)
        got = HeterGraph.load(path)
    assert got.edge_types == hg.edge_types and got.num_nodes == 3
    assert list(got.node_types) == ["user", None, "item"]
    for t in hg.edge_types:
        np.testing.assert_array_equal(np.asarray(got[t].edges),
                                      hg[t].edges)
        np.testing.assert_array_equal(np.asarray(got[t].node_feat["h"]),
                                      args["node_feat"]["h"])


# -- BiGraph ------------------------------------------------------------------

def bigraph_args(seed=None):
    """3 users -> 4 items, or a random 40 -> 70 bigraph whose destinations
    past 50 receive nothing and whose source 0 is a hub."""
    if seed is None:
        edges = np.array([[0, 1], [0, 3], [1, 0], [2, 2], [2, 3]])
        S, D, E = 3, 4, 5
    else:
        rng = np.random.default_rng(seed)
        S, D, E = 40, 70, 600
        edges = np.stack([rng.integers(0, S, E), rng.integers(0, 50, E)], 1)
        edges[:100, 0] = 0
    rng = np.random.default_rng(1)
    return dict(edges=edges, src_num_nodes=S, dst_num_nodes=D,
                src_node_feat={"h": rng.normal(size=(S, 6)).astype(
                    np.float32)},
                dst_node_feat={"h": rng.normal(size=(D, 6)).astype(
                    np.float32)},
                edge_feat={"w": np.arange(E, dtype=np.float32)})


def test_bigraph_structure():
    bg = BiGraph(**bigraph_args())
    assert bg.src_num_nodes == 3 and bg.dst_num_nodes == 4
    np.testing.assert_array_equal(bg.outdegree(), [2, 1, 2])
    np.testing.assert_array_equal(bg.indegree(), [1, 1, 1, 2])
    assert sorted(bg.successor()[0].tolist()) == [1, 3]
    assert sorted(bg.predecessor()[3].tolist()) == [0, 2]
    jbg = pgl_tpu.BiGraph(**bigraph_args(seed=2))
    bg = BiGraph(**bigraph_args(seed=2))
    for by in ("src", "dst"):
        for got, want in zip(bg.sorted_edges(by), jbg.sorted_edges(by)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(bg.sample_successor([0, 5], 3, seed=1),
                         jbg.sample_successor([0, 5], 3, seed=1)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_bigraph_send_recv_matches_reference(reduce):
    """Sum and mean run K1 over the rectangular layouts (70 rows gathering
    a 40-row table; the gradient 40 rows gathering 70), output and feature
    gradient against the reference; max and min the segment path."""
    args = bigraph_args(seed=2)
    bg = BiGraph(**args).tensor("cpu")
    jbg = pgl_tpu.BiGraph(**args).tensor()
    xj = jbg.src_node_feat["h"]
    cot = np.random.default_rng(0).normal(size=(70, 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jbg.send_recv(x, reduce), xj)
    x = bg.src_node_feat["h"].clone().requires_grad_()
    sk.reset_launches()
    out = bg.send_recv(x, reduce)
    (out * torch.as_tensor(cot)).sum().backward()
    close(out.detach(), want)
    close(x.grad, vjp(jnp.asarray(cot))[0], 1e-4)
    assert not out.detach()[50:].any()
    csc, csr = bg._spmm_layouts
    assert (csc.num_rows, csc.max_index) == (70, 39)
    assert (csr.num_rows, csr.max_index) == (40, 49)
    assert sk.LAUNCHES == 0         # the plain version on the CPU


def test_bigraph_udf_send_recv():
    bg = BiGraph(**bigraph_args()).tensor("cpu")
    msg = bg.send(lambda s, d, e: {"m": s["h"] * e["w"][:, None]
                                   + d["h"][:, :1]},
                  src_feat={"h": bg.src_node_feat["h"]},
                  dst_feat={"h": bg.dst_node_feat["h"]},
                  edge_feat={"w": bg.edge_feat["w"]})
    args = bigraph_args()
    sf, df, w = (args["src_node_feat"]["h"], args["dst_node_feat"]["h"],
                 args["edge_feat"]["w"])
    exp = np.zeros((4, 6), np.float32)
    exp_src = np.zeros((3, 6), np.float32)
    for eid, (s, d) in enumerate(args["edges"]):
        exp[d] += sf[s] * w[eid] + df[d, :1]
        exp_src[s] += sf[s] * w[eid] + df[d, :1]
    close(bg.recv(lambda m: m.reduce_sum(m["m"]), msg), exp)
    close(bg.recv("sum", msg, recv_mode="src"), exp_src)


def test_bigraph_disjoint_and_dump_load(tmp_path):
    b1 = BiGraph(**bigraph_args())
    b = BiGraph.disjoint([b1, BiGraph(**bigraph_args())])
    assert b.src_num_nodes == 6 and b.dst_num_nodes == 8
    assert b.num_edges == 10 and b.num_graph == 2
    np.testing.assert_array_equal(b.edges[5], [3, 5])
    np.testing.assert_array_equal(b.graph_src_node_id, [0] * 3 + [1] * 3)
    np.testing.assert_array_equal(b.graph_dst_node_id, [0] * 4 + [1] * 4)
    jb = pgl_tpu.BiGraph.disjoint([pgl_tpu.BiGraph(**bigraph_args())] * 2)
    np.testing.assert_array_equal(b.edges, np.asarray(jb.edges))
    # device batching keeps the subgraph ids
    bt = BiGraph.disjoint([b1.tensor("cpu")] * 2)
    np.testing.assert_array_equal(bt.graph_edge_id.numpy(),
                                  [0] * 5 + [1] * 5)
    with pytest.raises(ValueError):
        BiGraph.disjoint([])
    # either package reads what the other wrote, batching state included
    b.tensor("cpu").dump(str(tmp_path / "port"))
    jb.dump(str(tmp_path / "ref"))
    for got, want in ((pgl_tpu.BiGraph.load(str(tmp_path / "port")), jb),
                      (BiGraph.load(str(tmp_path / "ref")), b)):
        assert got.num_graph == 2
        assert (got.src_num_nodes, got.dst_num_nodes) == (6, 8)
        np.testing.assert_array_equal(np.asarray(got.edges),
                                      np.asarray(want.edges))
        for name in ("graph_src_node_id", "graph_dst_node_id",
                     "graph_edge_id"):
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(np.asarray(got.edge_feat["w"]),
                                      np.asarray(want.edge_feat["w"]))


def test_bigraph_stays_off_the_fused_attention():
    """The attention layers take their unfused path on a BiGraph (the
    reference's dispatch, ``pgl_tpu/ops/dispatch.py:51-55``); a Graph has
    the work lists."""
    bg = BiGraph(**bigraph_args()).tensor("cpu")
    g = Graph(np.array([[0, 1]]), num_nodes=2).tensor("cpu")
    assert not dispatch.fused_attention_graph(bg)
    assert dispatch.fused_attention_graph(g)
    conv = GATConv(6, 4, num_heads=2, device="cpu")
    assert conv._route(bg, (torch.ones(1),), 0.0) == "unfused"
    assert conv._route(g, (torch.ones(1),), 0.0) == "additive"
    # a square BiGraph reaches the edge-space composition, which needs a
    # ``num_nodes`` a BiGraph does not have (nor the reference's)
    square = BiGraph(np.array([[0, 1], [2, 1]]), 3, 3).tensor("cpu")
    with pytest.raises(AttributeError, match="num_nodes"):
        TransformerConv(6, 4, 2, device="cpu")(square, torch.ones(3, 6))


# -- RGCN ---------------------------------------------------------------------

def rgcn_graphs(N=50):
    rng = np.random.default_rng(3)
    edges = {"a": rng.integers(0, N, (200, 2)),
             "b": rng.integers(0, N // 2, (120, 2)),
             "c": rng.integers(0, N, (80, 2))}
    nf = {"h": rng.normal(size=(N, 10)).astype(np.float32)}
    return (pgl_tpu.HeterGraph(edges, num_nodes=N, node_feat=nf).tensor(),
            HeterGraph(edges, num_nodes=N, node_feat=nf).tensor("cpu"))


def _parity(jmodule, module, jgraph, graph, jx, x, jcall=None, tcall=None,
            init_args=()):
    """Carry the flax parameters (``init(key, jgraph, jx, *init_args)``)
    over, then hold the output, every parameter's gradient and the input's
    against the reference's under a fixed cotangent. Returns the port's
    output."""
    jcall = jcall or (lambda p, x: jmodule.apply(p, jgraph, x))
    tcall = tcall or (lambda x: module(graph, x))
    params = jax.jit(lambda k: jmodule.init(k, jgraph, jx, *init_args))(
        jax.random.key(0))
    params = {"params": params["params"]}
    shape = jax.eval_shape(lambda p: jcall(p, jx), params).shape
    cot = np.random.default_rng(0).normal(size=shape).astype(np.float32)

    def loss(p, x):
        out = jcall(p, x)
        return (out * cot).sum(), out

    (_, want), (want_grads, want_dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jx)
    module.load_state_dict(flax_to_state_dict(_tree(params), "cpu"),
                           strict=True)
    x = x.clone().requires_grad_()
    out = tcall(x)
    (out * torch.as_tensor(cot)).sum().backward()
    close(out.detach(), want)
    close(x.grad, want_dx, 1e-4)
    want_grads = flax_to_state_dict(_tree(want_grads), "cpu")
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want_grads)
    for k in want_grads:
        close(got[k], want_grads[k], 1e-4)
    return out


@pytest.mark.parametrize("num_bases", [0, 2])
def test_rgcn_matches_reference(num_bases):
    """Three relations, the second over half the nodes; with two bases
    the weights are ``w_comp`` combinations."""
    jhg, hg = rgcn_graphs()
    et = ["a", "b", "c"]
    j = jnn.RGCNConv(10, 7, etypes=et, num_bases=num_bases)
    t = RGCNConv(10, 7, et, num_bases=num_bases, device="cpu")
    assert (t.w_comp is None) == (num_bases == 0)
    sk.reset_launches()
    _parity(j, t, jhg, hg, jhg.node_feat["h"], hg.node_feat["h"])


def test_rgcn_golden():
    """``tests/test_conv_goldens.py``'s: Σ_r mean-aggregation of x·W_r on a
    dict of graphs."""
    rng = np.random.default_rng(0)
    N = 3
    X = rng.normal(size=(N, 2)).astype(np.float32)
    W = rng.normal(size=(2, 2, 2)).astype(np.float32)
    e1, e2 = np.array([[0, 2], [1, 2]]), np.array([[2, 0], [2, 1], [0, 1]])
    layer = RGCNConv(2, 2, ["a", "b"], device="cpu")
    layer.load_state_dict({"weight": torch.as_tensor(W)})
    graphs = {"a": Graph(e1, num_nodes=N).tensor("cpu"),
              "b": Graph(e2, num_nodes=N).tensor("cpu")}
    out = layer(graphs, torch.as_tensor(X))

    def mean_aggr(edges, h):
        acc = np.zeros_like(h)
        np.add.at(acc, edges[:, 1], h[edges[:, 0]])
        return acc / np.maximum(np.bincount(edges[:, 1], minlength=N),
                                1)[:, None]

    close(out.detach(), mean_aggr(e1, X @ W[0]) + mean_aggr(e2, X @ W[1]))


# -- label propagation and R-UniMP ------------------------------------------

def test_label_propagation_smooth():
    """The reference's hops on a community graph, and the accuracy gain
    of ``tests/test_models.py``."""
    jg, labels = j_community_graph(num_nodes=240, num_classes=3,
                                   feat_dim=4, avg_degree=10, seed=2)
    g, _ = community_graph(num_nodes=240, num_classes=3, feat_dim=4,
                           avg_degree=10, seed=2)
    N, C = 240, 3
    rng = np.random.default_rng(0)
    gold = np.eye(C, dtype=np.float32)[np.asarray(labels)]
    probs = gold * 0.4 + rng.random((N, C)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    train = np.zeros(N, np.float32)
    train[rng.choice(N, N // 3, replace=False)] = 1.0
    want = j_smooth(jg.tensor(), jnp.asarray(probs), jnp.asarray(gold),
                    jnp.asarray(train))
    got = label_propagation_smooth(g.tensor("cpu"), torch.as_tensor(probs),
                                   torch.as_tensor(gold),
                                   torch.as_tensor(train > 0), hops=3)
    close(got, want)
    test = train < 0.5
    acc0 = (probs.argmax(-1) == labels)[test].mean()
    acc1 = (got.numpy().argmax(-1) == labels)[test].mean()
    assert acc1 > acc0 + 0.1, (acc0, acc1)


def runimp_graphs(N=50, F=12):
    rng = np.random.default_rng(0)
    writes = np.stack([rng.integers(30, N, 60), rng.integers(0, 30, 60)], 1)
    edges = {"cites": rng.integers(0, 30, (150, 2)), "writes": writes,
             "writed_by": writes[:, ::-1].copy()}
    nf = {"h": rng.normal(size=(N, F)).astype(np.float32)}
    return (pgl_tpu.HeterGraph(edges, num_nodes=N, node_feat=nf).tensor(),
            HeterGraph(edges, num_nodes=N, node_feat=nf).tensor("cpu"))


def test_runimp_matches_reference():
    """Three relations whose ``writes`` and ``writed_by`` leave most rows
    without edges (nodes 30-49 receive no ``writes``, 0-29 no
    ``writed_by``), labels fed on a mask. The first layer's attention is
    the dot-mode K9/K10's plain version, the last layer's the edge-space
    composition."""
    jhg, hg = runimp_graphs()
    et = ["cites", "writes", "writed_by"]
    y = np.random.default_rng(5).integers(0, 3, 50)
    mask = np.random.default_rng(6).random(50) < 0.5
    j = JRUniMP(input_size=12, num_class=3, etypes=et, num_layers=2,
                hidden_size=8, dropout=0.0)
    t = RUniMP(12, 3, et, num_layers=2, hidden_size=8, dropout=0.0,
               device="cpu")
    jy, jm = jnp.asarray(y), jnp.asarray(mask)
    ty, tm = torch.as_tensor(y), torch.as_tensor(mask)
    out = _parity(j, t, jhg, hg, jhg.node_feat["h"], hg.node_feat["h"],
                  lambda p, x: j.apply(p, jhg, x, jy, jm),
                  lambda x: t(hg, x, ty, tm), init_args=(jy, jm))
    assert out.shape == (50, 3) and bool(torch.isfinite(out).all())


# -- the launches chip_smoke.py asserts -------------------------------------

@pytest.mark.parametrize("run", ["R-UniMP", "RGCN", "label propagation"])
def test_calls_a_step_match_the_chip_table(monkeypatch, run):
    """One training step of phase 12's R-UniMP (at hidden 16) and RGCN on a
    small ogbn-mag-shaped graph, and one smoothing, call the dot kernels
    and K1 (their plain versions here, through the same autograd
    functions) as often as ``chip_smoke.py`` asserts on the card:
    ``RUNIMP_PER_STEP`` (one K9, K10-dq and K10-dkv a relation; the last
    layer none), ``RGCN_PER_STEP``, and three K1 at 40 columns."""
    import chip_smoke
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak

    calls = {}

    def spy(name, fn, key=None):
        def wrapped(*args, **kw):
            k = name if key is None else key(*args)
            calls[k] = calls.get(k, 0) + 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(sk, "_spmm_one", spy(None, sk._spmm_one,
                                             lambda x, lay: (lay.kind,
                                                             x.shape[1])))
    for name, kernel in (("dot_attention_reference", "dot_fwd"),
                         ("dot_dq_reference", "dot_dq"),
                         ("dot_dkv_reference", "dot_dkv")):
        monkeypatch.setattr(ak, name, spy(kernel, getattr(ak, name)))
    host, labels, P = chip_smoke.mag_host(num_papers=300, avg_degree=8)
    hg = host.tensor("cpu")
    if run == "label propagation":
        n = hg.num_nodes
        probs = torch.full((n, 40), 1 / 40)
        train = chip_smoke.mag_train_mask(n, P, "cpu")
        label_propagation_smooth(hg["cites"], probs, torch.zeros(n, 40),
                                 train)
        assert calls == {("csc", 40): 3}
        return
    trainer = chip_smoke.runimp_trainer(labels, P, hidden=16) \
        if run == "R-UniMP" else chip_smoke.rgcn_trainer(labels, P)
    _, step = trainer(hg)
    calls.clear()
    assert np.isfinite(float(step()))
    if run == "R-UniMP":
        assert calls == {k[0]: v
                         for k, v in chip_smoke.RUNIMP_PER_STEP.items()}
    else:
        assert calls == chip_smoke.RGCN_PER_STEP
