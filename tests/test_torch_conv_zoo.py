"""Port parity for the conv-layer zoo on ``Graph.send_recv``: ``GraphSageConv``
(each ``aggr_func``), ``APPNP``, ``LightGCNConv``, ``SGCConv`` and
``SSGCConv`` (cached and not), ``gpr_init_weights`` and ``GPRConv`` (each
``init_method``), ``GCNII``, ``GINConv`` (``train_eps`` on and off),
``NGCFConv``, ``BernProp``, ``ChebProp``, ``GraphPool``, ``GraphNorm``,
``graph_pool`` and ``graph_norm`` of ``pgl_tpu_torch`` against
``pgl_tpu``'s on the CPU, with flax-initialised parameters carried over by
``pgl_tpu_torch.utils.convert``; and the goldens of
``tests/test_conv_goldens.py`` for GraphSage, GIN, GCNII, GPR, NGCF and
SSGC.

On the CPU the port's sums and means run K1's plain version, max and min
the segment path. Outputs compare at rtol/atol 1e-5, parameter and input
gradients at rtol 1e-4, atol 1e-5 (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

import pgl_tpu.nn as jnn
from pgl_tpu import Graph as JGraph
from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.nn.functional import graph_norm as j_graph_norm
from pgl_tpu.nn.functional import graph_pool as j_graph_pool
from pgl_tpu_torch import Graph
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.nn import (APPNP, BernProp, ChebProp, GCNII, GINConv,
                              GPRConv, GraphNorm, GraphPool, GraphSageConv,
                              LightGCNConv, NGCFConv, SGCConv, SSGCConv)
from pgl_tpu_torch.nn.conv import gpr_init_weights
from pgl_tpu_torch.nn.functional import graph_norm, graph_pool
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)


def _graphs(seed=5):
    """The reference's and the port's 300-node graph with 16 features."""
    g, _ = j_community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                             avg_degree=8, seed=seed)
    tg, _ = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                            avg_degree=8, seed=seed)
    return g.tensor(), tg.tensor("cpu")


def _batched():
    """Three community graphs of 60, 90 and 40 nodes, ``disjoint``."""
    graphs = [(j_community_graph(n, 2, 16, 6, seed=s)[0],
               community_graph(n, 2, 16, 6, seed=s)[0])
              for n, s in ((60, 1), (90, 2), (40, 3))]
    return (JGraph.disjoint([j for j, _ in graphs]).tensor(),
            Graph.disjoint([t for _, t in graphs]).tensor("cpu"))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _check(jmodule, module, jcall=None, tcall=None, edit=None, graphs=None):
    """Carry the flax parameters over (``edit`` may change them first),
    then hold the output, every parameter's gradient and the input's
    gradient against the reference's, under a fixed cotangent.
    ``jcall(params, graph, x)`` and ``tcall(graph, x)`` call the layers
    (default: ``(graph, x)``)."""
    gj, gt = graphs if graphs is not None else _graphs()
    jcall = jcall or (lambda p, g, x: jmodule.apply(p, g, x))
    tcall = tcall or (lambda g, x: module(g, x))
    xj = gj.node_feat["h"]
    params = jmodule.init(jax.random.key(0), gj, xj)
    # the parameters alone: a cache the init filled would be a constant
    params = {"params": params["params"]} if "params" in params else {}
    if edit is not None:
        params = edit(params)
    shape = jax.eval_shape(lambda p: jcall(p, gj, xj), params).shape
    cot = np.random.default_rng(0).normal(size=shape).astype(np.float32)

    def loss_j(p, x):
        out = jcall(p, gj, x)
        return (out * cot).sum(), out

    (_, want_out), (want_grads, want_dx) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(params, xj)
    module.load_state_dict(flax_to_state_dict(_numpy_tree(params), "cpu"),
                           strict=True)
    x = gt.node_feat["h"].clone().requires_grad_()
    out = tcall(gt, x)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-5)
    want = flax_to_state_dict(_numpy_tree(want_grads), "cpu")
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    return out


def _set_temp(values):
    """An ``edit`` that sets a propagation's ``temp`` (negative entries
    reach the layers' relu)."""
    def edit(params):
        return {"params": {**params["params"],
                           "temp": jnp.asarray(values, jnp.float32)}}
    return edit


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min"])
def test_graphsage_conv_matches_reference(aggr):
    """With relu; sum and mean run K1's plain version, max and min the
    segment path."""
    jm = jnn.GraphSageConv(16, 8, aggr_func=aggr)
    tm = GraphSageConv(16, 8, aggr_func=aggr, device="cpu")
    _check(jm, tm, lambda p, g, x: jm.apply(p, g, x, "relu"),
           lambda g, x: tm(g, x, "relu"))


def test_graphsage_conv_pair_input_without_normalize():
    """A ``(source, self)`` pair of features, no L2 normalisation."""
    jm = jnn.GraphSageConv(16, 8, aggr_func="mean", normalize=False)
    tm = GraphSageConv(16, 8, aggr_func="mean", normalize=False,
                       device="cpu")
    _check(jm, tm, lambda p, g, x: jm.apply(p, g, (x, 2 * x + 1)),
           lambda g, x: tm(g, (x, 2 * x + 1)))


def test_graphsage_conv_rejects_another_aggregation():
    with pytest.raises(ValueError, match="aggr_func"):
        GraphSageConv(4, 4, aggr_func="std", device="cpu")


def test_appnp_matches_reference():
    _check(jnn.APPNP(alpha=0.2, k_hop=4), APPNP(alpha=0.2, k_hop=4))
    _, gt = _graphs()
    with pytest.raises(ValueError, match="self_loop"):
        APPNP(self_loop=True)(gt, gt.node_feat["h"])


def test_lightgcn_conv_matches_reference():
    _check(jnn.LightGCNConv(), LightGCNConv())


@pytest.mark.parametrize("cached", [False, True])
def test_sgc_conv_matches_reference(cached):
    """With ``cached`` the reference fills its ``'cache'`` collection
    (applied with it mutable); the port's first call computes the same."""
    jm = jnn.SGCConv(16, 8, k_hop=3, cached=cached)
    tm = SGCConv(16, 8, k_hop=3, cached=cached, device="cpu")
    _check(jm, tm, lambda p, g, x: jm.apply(p, g, x, mutable=["cache"])[0])


@pytest.mark.parametrize("cached", [False, True])
def test_ssgc_conv_matches_reference(cached):
    """With a bias and an activation; ``cached`` as for SGC."""
    kw = dict(k_hop=4, alpha=0.1, cached=cached, bias=True,
              activation="relu")
    jm = jnn.SSGCConv(16, 8, **kw)

    def edit(params):
        bias = np.random.default_rng(3).normal(size=8).astype(np.float32)
        return {"params": {**params["params"], "bias": jnp.asarray(bias)}}

    _check(jm, SSGCConv(16, 8, device="cpu", **kw),
           lambda p, g, x: jm.apply(p, g, x, mutable=["cache"])[0],
           edit=edit)


@pytest.mark.parametrize("layer", [SGCConv, SSGCConv])
def test_propagation_cache_is_kept_for_its_graph(layer):
    """``cached``: a second call on the same graph reads the kept features
    (a constant: no gradient reaches the input, and another input is not
    read); another graph recomputes them; ``clear_cache()`` drops them."""
    _, gt = _graphs()
    _, other = _graphs(seed=6)
    conv = layer(16, 8, k_hop=2, device="cpu")
    fresh = layer(16, 8, k_hop=2, cached=False, device="cpu")
    fresh.load_state_dict(conv.state_dict())
    x = gt.node_feat["h"]
    first = conv(gt, x)
    x2 = (2 * x).requires_grad_()
    again = conv(gt, x2)
    assert torch.equal(again, first)
    again.sum().backward()
    assert x2.grad is None
    assert torch.equal(conv(other, other.node_feat["h"]),
                       fresh(other, other.node_feat["h"]))
    conv.clear_cache()
    assert torch.equal(conv(gt, 2 * x), fresh(gt, 2 * x))


@pytest.mark.parametrize("method,alpha,gamma", [
    ("SGC", 2, None), ("PPR", 0.1, None), ("NPPR", 0.3, None),
    ("Random", 0.1, None), ("WS", 0.1, (0.5, -0.25, 0.125, 0.0, 1.0))])
def test_gpr_init_weights_match_reference(method, alpha, gamma):
    from pgl_tpu.nn.conv import gpr_init_weights as j_gpr_init_weights
    for seed in (0, 7):
        want = j_gpr_init_weights(method, alpha, 4, gamma, seed=seed)
        got = gpr_init_weights(method, alpha, 4, gamma, seed=seed)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="init_method"):
        gpr_init_weights("Other", alpha, 4)


@pytest.mark.parametrize("method,alpha,gamma", [
    ("SGC", 2, None), ("PPR", 0.1, None), ("NPPR", 0.3, None),
    ("Random", 0.1, None), ("WS", 0.1, (0.5, -0.25, 0.125, 0.0))])
def test_gpr_conv_matches_reference(method, alpha, gamma):
    """Evaluation (no dropout); ``temp`` as each scheme draws it."""
    from pgl_tpu.nn.conv import gpr_init_weights as j_gpr_init_weights
    kw = dict(k_hop=3, alpha=alpha, init_method=method, gamma=gamma)
    tm = GPRConv(16, 12, 8, device="cpu", **kw)
    np.testing.assert_array_equal(
        tm.temp.detach().numpy(),
        j_gpr_init_weights(method, alpha, 3, gamma))
    _check(jnn.GPRConv(16, 12, 8, **kw), tm)


def test_gcnii_matches_reference():
    """Evaluation at dropout 0.6 with relu; the input is hidden-wide."""
    jm = jnn.GCNII(16, activation="relu", lambda_l=0.5, alpha=0.2, k_hop=3,
                   dropout=0.6)
    _check(jm, GCNII(16, activation="relu", lambda_l=0.5, alpha=0.2,
                     k_hop=3, dropout=0.6, device="cpu"))


def test_dropout_layers_are_seeded_by_their_generator():
    """GPRConv and GCNII draw their training dropout from their own
    generator: the same seed gives the same output, and training differs
    from evaluation."""
    _, gt = _graphs()
    x = gt.node_feat["h"]
    for make in (lambda g: GPRConv(16, 12, 8, k_hop=2, generator=g,
                                   device="cpu"),
                 lambda g: GCNII(16, k_hop=2, generator=g, device="cpu")):
        runs = [make(torch.Generator().manual_seed(4))(gt, x, training=True)
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
        evaluated = make(torch.Generator().manual_seed(4))(gt, x)
        assert not torch.equal(runs[0], evaluated)


@pytest.mark.parametrize("train_eps", [False, True])
def test_gin_conv_matches_reference(train_eps):
    jm = jnn.GINConv(16, 8, activation="relu", init_eps=0.3,
                     train_eps=train_eps)
    tm = GINConv(16, 8, activation="relu", init_eps=0.3, train_eps=train_eps,
                 device="cpu")
    assert (tm.epsilon is not None) == train_eps
    _check(jm, tm)


def test_ngcf_conv_matches_reference():
    _check(jnn.NGCFConv(16, 8), NGCFConv(16, 8, device="cpu"))


def test_bern_prop_matches_reference():
    _check(jnn.BernProp(k_hop=4), BernProp(k_hop=4, device="cpu"),
           edit=_set_temp([1.5, -0.2, 0.7, 0.0, 2.0]))


def test_cheb_prop_matches_reference():
    _check(jnn.ChebProp(k_hop=4), ChebProp(k_hop=4, device="cpu"),
           edit=_set_temp([0.9, 1.3, -0.4, 0.2, 1.0]))


@pytest.mark.parametrize("pool_type", ["sum", "mean", "max", "min"])
def test_graph_pool_matches_reference(pool_type):
    gj, gt = _batched()
    assert gt.num_graph == 3
    out = _check(jnn.GraphPool(pool_type), GraphPool(pool_type),
                 graphs=(gj, gt))
    assert out.shape == (3, 16)
    np.testing.assert_allclose(
        graph_pool(gt, gt.node_feat["h"], pool_type).numpy(),
        np.asarray(j_graph_pool(gj, gj.node_feat["h"], pool_type)),
        rtol=1e-5, atol=1e-5)


def test_graph_norm_matches_reference():
    gj, gt = _batched()
    _check(jnn.GraphNorm(), GraphNorm(), graphs=(gj, gt))
    np.testing.assert_allclose(
        graph_norm(gt, gt.node_feat["h"]).numpy(),
        np.asarray(j_graph_norm(gj, gj.node_feat["h"])), rtol=1e-6)


# -- goldens of tests/test_conv_goldens.py ---------------------------------

EDGES = np.array([[0, 2], [1, 2], [1, 0]])
SRC, DST = EDGES[:, 0], EDGES[:, 1]
X = np.array([[1.0, 2.0], [-1.0, 0.5], [0.5, -1.5]], np.float32)
NORM = np.maximum(np.array([1, 0, 2]), 1) ** -0.5
W_A = np.array([[0.3, -0.2], [0.1, 0.4]], np.float32)
W_B = np.array([[-0.5, 0.2], [0.3, 0.1]], np.float32)
B_A = np.array([0.05, -0.1], np.float32)
B_B = np.array([-0.2, 0.3], np.float32)


def _golden(layer, params, *args, **kwargs):
    layer.load_state_dict(flax_to_state_dict(params, "cpu"), strict=True)
    g = Graph(EDGES, num_nodes=3).tensor("cpu")
    return layer(g, torch.as_tensor(X), *args, **kwargs).detach().numpy()


def _seg_sum(vals, ids):
    out = np.zeros((3,) + vals.shape[1:])
    np.add.at(out, ids, vals)
    return out


def _a_hat(f):
    return _seg_sum((f * NORM[:, None])[SRC], DST) * NORM[:, None]


def test_graphsage_golden():
    """``test_graphsage_golden``: self·W1 + Σ neighbours·W2, L2."""
    out = _golden(GraphSageConv(2, 2, aggr_func="sum", device="cpu"),
                  {"self_linear": {"kernel": W_A, "bias": B_A},
                   "neigh_linear": {"kernel": W_B, "bias": B_B}})
    o = (X @ W_A + B_A) + (_seg_sum(X[SRC], DST) @ W_B + B_B)
    want = o / np.sqrt(np.maximum((o * o).sum(1, keepdims=True), 1e-12))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_gin_golden():
    """``test_gin_golden``: ((1+eps)x + Σ_in x_s) → Dense → LayerNorm at
    epsilon 1e-6 → Dense."""
    scale = np.array([1.5, 0.5], np.float32)
    shift = np.array([0.1, -0.1], np.float32)
    out = _golden(GINConv(2, 2, init_eps=0.3, device="cpu"),
                  {"linear1": {"kernel": W_A, "bias": B_A},
                   "linear2": {"kernel": W_B, "bias": B_B},
                   "layer_norm": {"scale": scale, "bias": shift}})
    h = (_seg_sum(X[SRC], DST) + 1.3 * X) @ W_A + B_A
    h = (h - h.mean(1, keepdims=True)) / np.sqrt(h.var(1, keepdims=True)
                                                 + 1e-6)
    want = (h * scale + shift) @ W_B + B_B
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


def test_gcnii_golden():
    """``test_gcnii_golden``: per hop, beta_i = log(λ/(i+1)+1); f ← Âf;
    f ← αh0+(1-α)f; f ← beta·Dense_i(f)+(1-beta)·f."""
    out = _golden(GCNII(2, lambda_l=0.5, alpha=0.2, k_hop=2, dropout=0.0,
                        device="cpu"),
                  {"mlp_0": {"kernel": W_A, "bias": B_A},
                   "mlp_1": {"kernel": W_B, "bias": B_B}})
    f = X.astype(np.float64)
    h0 = f.copy()
    for i, (w, b) in enumerate([(W_A, B_A), (W_B, B_B)]):
        beta = np.log(0.5 / (i + 1) + 1)
        f = 0.2 * h0 + 0.8 * _a_hat(f)
        f = beta * (f @ w + b) + (1 - beta) * f
    np.testing.assert_allclose(out, f, rtol=1e-5, atol=1e-6)


def test_gpr_golden():
    """``test_gpr_golden``: the MLP, then hidden = Σ_k temp_k Â^k f."""
    temp = np.array([0.5, 0.3, 0.2], np.float32)
    out = _golden(GPRConv(2, 2, 2, drop=0.0, dprate=0.0, k_hop=2,
                          init_method="WS", gamma=(0.0, 0.0, 0.0),
                          device="cpu"),
                  {"linear_1": {"kernel": W_A, "bias": B_A},
                   "linear_2": {"kernel": W_B, "bias": B_B}, "temp": temp})
    f = np.maximum(X @ W_A + B_A, 0.0) @ W_B + B_B
    hid = temp[0] * f
    for k in range(2):
        f = _a_hat(f)
        hid = hid + temp[k + 1] * f
    np.testing.assert_allclose(out, hid, rtol=1e-5, atol=1e-6)


def test_ngcf_golden():
    """``test_ngcf_golden``: leaky(W1·((Σ+x)·norm) + W2·(x⊙((Σ+x)·norm)))."""
    out = _golden(NGCFConv(2, 2, device="cpu"),
                  {"linear": {"kernel": W_A, "bias": B_A},
                   "linear2": {"kernel": W_B, "bias": B_B}})
    o0 = (_seg_sum(X[SRC], DST) + X) * NORM[:, None]
    o = (o0 @ W_A + B_A) + ((X * o0) @ W_B + B_B)
    np.testing.assert_allclose(out, np.where(o >= 0, o, 0.2 * o), rtol=1e-5,
                               atol=1e-6)


def test_ssgc_golden():
    """``test_ssgc_golden``: the mean of damped hops + α·x0, then the
    Dense."""
    out = _golden(SSGCConv(2, 2, k_hop=2, alpha=0.1, cached=False,
                           device="cpu"), {"linear": {"kernel": W_A}})
    f = X.astype(np.float64)
    acc = f.copy()
    for _ in range(2):
        f = 0.9 * _a_hat(f)
        acc = acc + f
    np.testing.assert_allclose(out, (acc / 2 + 0.1 * X) @ W_A, rtol=1e-5,
                               atol=1e-6)
