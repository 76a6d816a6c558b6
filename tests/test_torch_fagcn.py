"""Port parity for the layers and models on edge-weighted message passing:
``PinSageConv``, ``FAConv``, ``GATv2Conv``, ``GATConv``'s unfused path,
``FAGCN`` and ``GATv2`` of ``pgl_tpu_torch`` against ``pgl_tpu``'s on the
CPU, with flax-initialised parameters carried over by
``pgl_tpu_torch.utils.convert``; the goldens of
``tests/test_conv_goldens.py`` for GATv2, PinSage and FAConv; and the two
places where ``Graph.send_ue_recv``'s rule departs from the reference's.

On the CPU the port's aggregations run K1w's plain version (and the
weighted K6's on a graph with dedup layouts); the reference's run its
segment path. Tolerances as ``tests/test_torch_gat.py``: outputs at
rtol/atol 1e-5, parameter gradients at rtol 1e-4, atol 1e-5 (float32 sums
in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

from chip_smoke import dispatch_settings
from pgl_tpu import Graph as JGraph
from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.models import FAGCN as JFAGCN
from pgl_tpu.models import GATv2 as JGATv2
from pgl_tpu.nn import FAConv as JFAConv
from pgl_tpu.nn import GATConv as JGATConv
from pgl_tpu.nn import GATv2Conv as JGATv2Conv
from pgl_tpu.nn import PinSageConv as JPinSageConv
from pgl_tpu.ops import softmax_cross_entropy_integer as j_ce
from pgl_tpu_torch import Graph
from pgl_tpu_torch import graph as graph_module
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import FAGCN, GATv2
from pgl_tpu_torch.nn import FAConv, GATConv, GATv2Conv, PinSageConv
from pgl_tpu_torch.nn import conv as conv_module
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

# the first torch.exp of a process on the CPU can differ from later ones
# (tests/test_torch_gat.py): take it before any comparison
torch.exp(torch.zeros(1 << 16))


def _graphs(dedup=False):
    """The reference's and the port's small graph (300 nodes, 3 classes);
    ``dedup`` builds the port's with dedup layouts."""
    g, labels = j_community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    tg, tlabels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    with dispatch_settings(DEDUP=dedup, DEDUP_MIN_EDGES=0):
        gt = tg.tensor("cpu")
    assert (gt._dedup_layouts is not None) == dedup
    return g.tensor(), jnp.asarray(labels), gt, torch.as_tensor(tlabels)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _check(jmodule, module, training=False, dedup=False, extra=None,
           loss="ce"):
    """Carry the flax parameters over, then hold the output and every
    parameter's gradient against the reference's. ``extra`` (numpy) is the
    edge feature argument of PinSage; ``loss`` "ce" over the labels for a
    model, "dot" with a fixed cotangent for a layer."""
    gj, yj, gt, y = _graphs(dedup)
    args_j = (gj, gj.node_feat["h"]) + (() if extra is None
                                        else (jnp.asarray(extra),))
    args_t = (gt, gt.node_feat["h"]) + (() if extra is None
                                        else (torch.as_tensor(extra),))
    kw = {} if extra is not None else {"training": training}
    params = jmodule.init(jax.random.key(0), *args_j)
    shape = jax.eval_shape(lambda p: jmodule.apply(p, *args_j, **kw),
                           params).shape
    cot = np.random.default_rng(0).normal(size=shape).astype(np.float32)

    def loss_j(p):
        out = jmodule.apply(p, *args_j, **kw)
        if loss == "ce":
            return j_ce(out, yj).mean(), out
        return (out * cot).sum(), out

    (_, want_out), want_grads = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(params)
    module.load_state_dict(flax_to_state_dict(_numpy_tree(params), "cpu"),
                           strict=True)
    out = module(*args_t, **kw)
    (ce(out, y).mean() if loss == "ce"
     else (out * torch.as_tensor(cot)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    want = flax_to_state_dict(_numpy_tree(want_grads), "cpu")
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    return gt


@pytest.mark.parametrize("dedup", [False, True])
def test_pinsage_matches_reference(dedup):
    w = np.random.default_rng(1).uniform(0.1, 2.0, size=(
        _graphs()[2].num_edges, 1)).astype(np.float32)
    _check(JPinSageConv(16, 8), PinSageConv(16, 8, device="cpu"),
           dedup=dedup, extra=w, loss="dot")


@pytest.mark.parametrize("dedup", [False, True])
def test_faconv_matches_reference(dedup):
    """FAConv on a 16-wide input (hidden_size 16) at the default drop,
    evaluation; with dedup layouts through the weighted K6."""
    _check(JFAConv(16), FAConv(16, device="cpu"), dedup=dedup, loss="dot")


def test_gatv2conv_matches_reference():
    kw = dict(feat_drop=0.6, attn_drop=0.6, num_heads=4)
    _check(JGATv2Conv(16, 3, **kw), GATv2Conv(16, 3, device="cpu", **kw),
           loss="dot")


@pytest.mark.parametrize("dedup", [False, True])
def test_fagcn_matches_reference(dedup):
    kw = dict(hidden_size=16, num_layer=3, eps=0.2, dropout=0.6)
    _check(JFAGCN(16, 3, **kw), FAGCN(16, 3, device="cpu", **kw),
           dedup=dedup)


def test_gatv2_matches_reference():
    kw = dict(num_heads=8, hidden_size=4, feat_drop=0.6, attn_drop=0.6)
    _check(JGATv2(16, 3, **kw), GATv2(16, 3, device="cpu", **kw))


@pytest.mark.parametrize("training", [False, True])
def test_unfused_gatconv_matches_reference(monkeypatch, training):
    """Attention dropout at 3·H > 128 takes the reference's unfused path
    (send_uv, edge_softmax, send_ue_recv with 48 weights an edge). With the
    dropout itself replaced by the identity it computes the reference's
    function at rate 0 (the reference's CPU path is the same unfused
    composition); at ``training=False`` the layer takes the dot-mode
    kernels, the same function."""
    if training:
        monkeypatch.setattr(conv_module, "_dropout", lambda x, rate, g: x)
    kw = dict(feat_drop=0.0, num_heads=48)
    _check(JGATConv(16, 2, attn_drop=0.0, **kw),
           GATConv(16, 2, attn_drop=0.5, device="cpu", **kw), training,
           loss="dot")


def test_unfused_gatconv_dropout_is_right_in_expectation():
    """The unfused path's dropout keeps each probability with chance 1 - p
    and scales it by 1 / (1 - p): the mean output of 400 dropped runs is
    the undropped output within 6 standard errors everywhere (a seeded,
    deterministic draw), and within 5% in norm."""
    _, _, gt, _ = _graphs()
    x = gt.node_feat["h"][:, :16]
    layer = GATConv(16, 2, feat_drop=0.0, attn_drop=0.5, num_heads=48,
                    generator=torch.Generator().manual_seed(4), device="cpu")
    with torch.no_grad():
        ref = layer(gt, x).double()
        runs = torch.stack([layer(gt, x, training=True).double()
                            for _ in range(400)])
    assert not torch.equal(runs[0], runs[1])
    mean, se = runs.mean(0), runs.std(0) / 20
    assert bool(((mean - ref).abs() <= 6 * se + 1e-6).all())
    assert float((mean - ref).norm() / ref.norm()) < 0.05


def test_fagcn_and_gatv2_training_dropout_is_seeded_and_learns():
    """The default dropouts train: the same generator seed gives the same
    losses, and the loss falls over 15 Adam steps."""
    _, _, gt, y = _graphs()
    x = gt.node_feat["h"]
    for make in (lambda g: FAGCN(16, 3, hidden_size=16, generator=g,
                                 device="cpu"),
                 lambda g: GATv2(16, 3, num_heads=4, hidden_size=4,
                                 generator=g, device="cpu")):
        runs = []
        for _ in range(2):
            model = make(torch.Generator().manual_seed(3))
            opt = torch.optim.Adam(model.parameters(), lr=1e-2)
            losses = []
            for _ in range(15):
                loss = ce(model(gt, x, training=True), y).mean()
                opt.zero_grad()
                loss.backward()
                opt.step()
                losses.append(loss.item())
            runs.append(losses)
        assert runs[0] == runs[1]
        assert runs[0][-1] < runs[0][0]


# -- goldens of tests/test_conv_goldens.py ---------------------------------

EDGES = np.array([[0, 2], [1, 2], [1, 0]])
SRC, DST = EDGES[:, 0], EDGES[:, 1]
X = np.array([[1.0, 2.0], [-1.0, 0.5], [0.5, -1.5]], np.float32)
NORM = np.maximum(np.array([1, 0, 2]), 1) ** -0.5
W_A = np.array([[0.3, -0.2], [0.1, 0.4]], np.float32)
W_B = np.array([[-0.5, 0.2], [0.3, 0.1]], np.float32)
B_A = np.array([0.05, -0.1], np.float32)
B_B = np.array([-0.2, 0.3], np.float32)


def _golden_graph():
    return Graph(EDGES, num_nodes=3).tensor("cpu"), torch.as_tensor(X)


def _seg_sum(vals, ids):
    out = np.zeros((3,) + vals.shape[1:])
    np.add.at(out, ids, vals)
    return out


def _load(layer, params):
    layer.load_state_dict(flax_to_state_dict(params, "cpu"), strict=True)
    return layer


def test_gatv2_golden():
    """``test_gatv2_golden``: alpha = a · leaky(h_s + h_d)."""
    attn = np.array([[[0.4, -0.6]]], np.float32)
    layer = _load(GATv2Conv(2, 2, feat_drop=0.0, attn_drop=0.0,
                            device="cpu"),
                  {"linear": {"kernel": W_A, "bias": B_A}, "attn": attn})
    g, x = _golden_graph()
    h = X @ W_A + B_A
    pre = h[SRC] + h[DST]
    sc = (np.where(pre >= 0, pre, 0.2 * pre) * attn[0, 0]).sum(1)
    alpha = np.zeros_like(sc)
    for d in set(DST.tolist()):
        sel = DST == d
        e = np.exp(sc[sel] - sc[sel].max())
        alpha[sel] = e / e.sum()
    want = _seg_sum(h[SRC] * alpha[:, None], DST)
    np.testing.assert_allclose(layer(g, x).detach().numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_pinsage_golden():
    """``test_pinsage_golden``: the edge-weighted neighbour sum."""
    ew = np.array([2.0, 0.5, -1.0], np.float32)
    layer = _load(PinSageConv(2, 2, device="cpu"),
                  {"self_linear": {"kernel": W_A, "bias": B_A},
                   "neigh_linear": {"kernel": W_B, "bias": B_B}})
    g, x = _golden_graph()
    out = layer(g, x, torch.as_tensor(ew.reshape(-1, 1))).detach().numpy()
    o = (X @ W_A + B_A) + (_seg_sum(X[SRC] * ew[:, None], DST) @ W_B + B_B)
    want = o / np.sqrt(np.maximum((o * o).sum(1, keepdims=True), 1e-12))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_faconv_golden():
    """``test_faconv_golden``: α = tanh(g·[h_s|h_d]) · norm_s · norm_d."""
    wg = np.array([[0.4], [-0.3], [0.2], [0.5]], np.float32)
    bg = np.array([0.1], np.float32)
    layer = _load(FAConv(hidden_size=2, drop=0.0, device="cpu"),
                  {"gate": {"kernel": wg, "bias": bg}})
    g, x = _golden_graph()
    gin = np.concatenate([X[SRC], X[DST]], axis=1)
    alpha = np.tanh(gin @ wg + bg)[:, 0] * NORM[SRC] * NORM[DST]
    want = _seg_sum(X[SRC] * alpha[:, None], DST)
    out = layer(g, x).detach().numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    assert np.allclose(out[1], 0.0)          # no in-edges: zeros


# -- the dispatch departures -----------------------------------------------

def _spy(monkeypatch):
    calls = []
    real = graph_module.spmm_weighted
    monkeypatch.setattr(
        graph_module, "spmm_weighted",
        lambda x, w, *a: calls.append((tuple(x.shape), tuple(w.shape), a[-1]))
        or real(x, w, *a))
    return calls


def test_departure_a_no_lane_gate(monkeypatch):
    """(a) The reference takes its weighted kernel only at D % 128 == 0
    after padding D to the lanes (``pgl_tpu/graph.py:365-366,413-418``);
    the port takes K1w at any D, unpadded: here D = 5, the same function."""
    calls = _spy(monkeypatch)
    edges = np.random.default_rng(0).integers(0, 40, (300, 2))
    gj = JGraph(edges, num_nodes=40).tensor()
    gt = Graph(edges, num_nodes=40).tensor("cpu")
    x = np.random.default_rng(1).normal(size=(40, 5)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=300).astype(np.float32)
    for op in ("mul", "add"):
        out = gt.send_ue_recv(torch.as_tensor(x), torch.as_tensor(w), op)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(gj.send_ue_recv(jnp.asarray(x),
                                                    jnp.asarray(w), op)),
            rtol=1e-5, atol=1e-5)
    assert calls == [((40, 5), (300, 1), "mul"), ((40, 5), (300, 1), "add")]


def test_departure_b_heads_take_k1w(monkeypatch):
    """(b) An [N, H, Dh] feature with [E, H, 1] weights (GATv2's and the
    unfused GATConv's aggregation) takes K1w with H weights an edge on the
    flattened [N, H·Dh]; the reference sends every 3-D feature to its
    segment path (``use_pallas_spmm``'s ``ndim`` check,
    ``pgl_tpu/ops/dispatch.py:29``). The same function; an [N, H, Dh]
    edge feature of another shape keeps the segment path."""
    calls = _spy(monkeypatch)
    edges = np.random.default_rng(3).integers(0, 40, (300, 2))
    gj = JGraph(edges, num_nodes=40).tensor()
    gt = Graph(edges, num_nodes=40).tensor("cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 4, 3)).astype(np.float32)
    for wshape in [(300, 4, 1), (300, 4), (300, 4, 3), (300, 1, 3)]:
        w = rng.normal(size=wshape).astype(np.float32)
        out = gt.send_ue_recv(torch.as_tensor(x), torch.as_tensor(w))
        assert out.shape == (40, 4, 3)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(gj.send_ue_recv(jnp.asarray(x),
                                                    jnp.asarray(w))),
            rtol=1e-5, atol=1e-5)
    assert calls == [((40, 12), (300, 4), "mul"),
                     ((40, 12), (300, 4), "mul")]
