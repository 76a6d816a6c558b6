"""Port parity for GAT training: ``GATConv`` and ``GAT`` of
``pgl_tpu_torch`` against ``pgl_tpu``'s on the CPU with flax-initialised
parameters carried over by ``pgl_tpu_torch.utils.convert``, through the
per-edge attention (K9/K10; in dot mode for 3·H > 128) and, on a graph
with dedup layouts, the count-matrix attention (K7/K8); the 20-step ``gat``
loss golden through both; the route rule of ``GATConv``; and the
activation lookup."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

from chip_smoke import dispatch_settings, skewed_graph
from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.models import GAT as JGAT
from pgl_tpu.nn import GATConv as JGATConv
from pgl_tpu.ops import softmax_cross_entropy_integer as j_ce
from pgl_tpu_torch import Graph
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import GAT
from pgl_tpu_torch.nn import GATConv
from pgl_tpu_torch.nn import conv as conv_module
from pgl_tpu_torch.nn.conv import _resolve_act
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

# The first torch.exp of a process on the CPU can differ from every later
# one by up to ~6e-5 (seen on [6000, 4] float32 inputs, in about one
# process of five), which the tolerances below would flag: take it here,
# before any comparison.
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS_FILE = os.path.join(REPO, "tests", "test_trajectory_goldens_data.npz")
GOLDEN_RTOL = 2e-3          # tests/test_trajectory_goldens.py:30


def _graphs(dedup=False):
    """The reference's and the port's small graph; ``dedup`` builds the
    port's with dedup layouts (the band opened to its size)."""
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


def _check_logits_and_grads(jmodel, model, training, dedup=False):
    """Logits at rtol/atol 1e-5, parameter gradients at rtol 1e-4, atol
    1e-5 (float32; sums in another order), as tests/test_torch_gcn.py. On
    the CPU the JAX layer takes its unfused path, the same function at
    attention rate 0."""
    gj, yj, gt, y = _graphs(dedup)
    params = jmodel.init(jax.random.key(0), gj, gj.node_feat["h"])

    def loss(p):
        logits = jmodel.apply(p, gj, gj.node_feat["h"], training)
        return j_ce(logits, yj).mean(), logits

    (_, want_logits), want_grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    model.load_state_dict(flax_to_state_dict(_numpy_tree(params), "cpu"),
                          strict=True)
    logits = model(gt, gt.node_feat["h"], training)
    ce(logits, y).mean().backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    want = flax_to_state_dict(_numpy_tree(want_grads), "cpu")
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the count-matrix route was taken exactly when the graph has layouts
    assert (gt._dedup_attn is not None) == dedup
    assert (gt._attn_layouts is not None) != dedup


@pytest.mark.parametrize("training", [False, True])
def test_gatconv_matches_reference(training):
    """Evaluation with the default dropouts, and training with both at 0."""
    drop = 0.0 if training else 0.6
    kw = dict(feat_drop=drop, attn_drop=drop, num_heads=3)
    _check_logits_and_grads(JGATConv(16, 8, **kw),
                            GATConv(16, 8, device="cpu", **kw), training)


@pytest.mark.parametrize("training", [False, True])
def test_gat_matches_reference(training):
    drop = 0.0 if training else 0.6
    kw = dict(num_heads=8, hidden_size=8, feat_drop=drop, attn_drop=drop)
    _check_logits_and_grads(JGAT(16, 3, **kw),
                            GAT(16, 3, device="cpu", **kw), training)


@pytest.mark.parametrize("training", [False, True])
def test_gatconv_on_dedup_graph_matches_reference(training):
    """Through K7/K8's plain versions: evaluation with the default
    dropouts, and training with both at 0."""
    drop = 0.0 if training else 0.6
    kw = dict(feat_drop=drop, attn_drop=drop, num_heads=3)
    _check_logits_and_grads(JGATConv(16, 8, **kw),
                            GATConv(16, 8, device="cpu", **kw), training,
                            dedup=True)


@pytest.mark.parametrize("training", [False, True])
def test_gat_on_dedup_graph_matches_reference(training):
    drop = 0.0 if training else 0.6
    kw = dict(num_heads=8, hidden_size=8, feat_drop=drop, attn_drop=drop)
    _check_logits_and_grads(JGAT(16, 3, **kw),
                            GAT(16, 3, device="cpu", **kw), training,
                            dedup=True)


def test_gat_trajectory_matches_golden():
    """The ``gat`` trajectory of tests/test_trajectory_goldens.py: two
    GATConv layers initialised by flax from the same keys, then 20 steps of
    torch Adam at lr 1e-2."""
    _check_gat_golden(dedup=False)


def test_gat_trajectory_through_dedup_matches_golden():
    """The same trajectory through the count-matrix attention (K7/K8)."""
    _check_gat_golden(dedup=True)


def _check_gat_golden(dedup):
    gj, _, gt, y = _graphs(dedup)
    jlayers = [JGATConv(input_size=16, hidden_size=8, num_heads=3,
                        feat_drop=0.0, attn_drop=0.0),
               JGATConv(input_size=24, hidden_size=3, num_heads=1,
                        feat_drop=0.0, attn_drop=0.0)]
    key, h, params = jax.random.key(0), gj.node_feat["h"], []
    for layer in jlayers:
        key, sub = jax.random.split(key)
        p = layer.init(sub, gj, h)
        h = layer.apply(p, gj, h)
        params.append(p)
    layers = torch.nn.ModuleList([
        GATConv(16, 8, num_heads=3, feat_drop=0.0, attn_drop=0.0,
                device="cpu"),
        GATConv(24, 3, num_heads=1, feat_drop=0.0, attn_drop=0.0,
                device="cpu")])
    for layer, p in zip(layers, params):
        layer.load_state_dict(flax_to_state_dict(_numpy_tree(p), "cpu"))
    opt = torch.optim.Adam(layers.parameters(), lr=1e-2)
    losses = []
    for _ in range(20):
        h = gt.node_feat["h"]
        for layer in layers:
            h = layer(gt, h)
        loss = ce(h, y).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, np.load(GOLDENS_FILE)["gat"],
                               rtol=GOLDEN_RTOL)
    assert (gt._dedup_attn is not None) == dedup


def test_training_dropout_is_seeded_and_learns():
    """GAT's defaults (feat_drop = attn_drop = 0.6) train through the
    hash dropout: the same generator seed gives the same losses, and the
    loss falls."""
    _check_seeded_dropout(dedup=False)


def test_dedup_training_dropout_is_seeded_and_learns():
    """The same through the count-matrix attention's cell dropout."""
    gt = _check_seeded_dropout(dedup=True)
    assert gt._dedup_attn is not None and gt._attn_layouts is None


def _check_seeded_dropout(dedup):
    _, _, gt, y = _graphs(dedup)
    runs = []
    for _ in range(2):
        model = GAT(16, 3, generator=torch.Generator().manual_seed(3),
                    device="cpu")
        for layer in (model.gat_0, model.gat_1):
            layer.attn_drop_mode = "cell"
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        losses = []
        for _ in range(15):
            loss = ce(model(gt, gt.node_feat["h"], True), y).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        runs.append(losses)
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]).all() and runs[0][-1] < runs[0][0]
    return gt


def test_tensor_builds_no_attention_layout():
    _, _, gt, _ = _graphs()
    assert gt._attn_layouts is None
    GATConv(16, 8, device="cpu")(gt, gt.node_feat["h"])
    csc, csr = gt._attn_layouts
    assert gt._attention_layouts()[0] is csc


def test_tensor_builds_no_dedup_attention():
    """``tensor()`` builds the dedup layouts but not K7/K8's work lists;
    the first count-matrix call builds them once (both cell orders)."""
    _, _, gt, _ = _graphs(dedup=True)
    assert gt._dedup_attn is None
    GATConv(16, 8, device="cpu")(gt, gt.node_feat["h"])
    att = gt._dedup_attn
    assert att.num_cells == att.node_dst.shape[0] == att.cell_src.shape[0]
    assert gt._attn_layouts is None
    assert gt._dedup_attn_aux() is att


def _dedup_multigraph():
    edges = skewed_graph(400, 6000, seed=2)        # repeats (dst, src) pairs
    with dispatch_settings(DEDUP=True, DEDUP_MIN_EDGES=0):
        gd = Graph(edges, num_nodes=400).tensor("cpu")
    assert gd._dedup_layouts is not None and not gd._dedup_layouts[0].simple
    return edges, gd


def test_route_takes_the_reference_kernels(monkeypatch):
    """K7/K8 on a graph with dedup layouts at rate 0, in cell mode, on a
    simple graph under dropout, and at 3·H > 128 at rate 0; K9/K10 for a
    multigraph under edge-mode dropout and on a graph without dedup
    layouts."""
    calls = []
    for name in ("dedup_gat_attention", "fused_gat_attention"):
        real = getattr(conv_module, name)
        monkeypatch.setattr(conv_module, name,
                            lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    edges, gd = _dedup_multigraph()
    x = torch.randn(400, 16)

    def route(conv, g, training):
        calls.clear()
        conv(g, x, training=training)
        return calls[0].split("_")[0]

    assert route(GATConv(16, 4, num_heads=2, device="cpu"), gd,
                 False) == "dedup"
    assert route(GATConv(16, 4, num_heads=2, device="cpu"), gd,
                 True) == "fused"
    assert route(GATConv(16, 4, num_heads=2, attn_drop_mode="cell",
                         device="cpu"), gd, True) == "dedup"
    assert route(GATConv(16, 2, num_heads=43, device="cpu"), gd,
                 False) == "dedup"
    simple = np.unique(edges, axis=0)
    with dispatch_settings(DEDUP=True, DEDUP_MIN_EDGES=0):
        gs = Graph(simple, num_nodes=400).tensor("cpu")
    assert gs._dedup_layouts[0].simple
    assert route(GATConv(16, 4, num_heads=2, device="cpu"), gs,
                 True) == "dedup"
    g = Graph(edges, num_nodes=400).tensor("cpu")
    assert route(GATConv(16, 4, num_heads=2, device="cpu"), g,
                 True) == "fused"


@pytest.mark.parametrize("training", [False, True])
def test_gatconv_with_many_heads_matches_reference(training):
    """3·H > 128 off the count-matrix route: the reference's many-head
    fallback, K9/K10 in dot mode over ``gat_score_features`` (the plain
    versions here; the reference's unfused path on the CPU computes the
    same function). Evaluation with the default dropouts, and training
    with both at 0."""
    drop = 0.0 if training else 0.6
    kw = dict(feat_drop=drop, attn_drop=drop, num_heads=43)
    _check_logits_and_grads(JGATConv(16, 2, **kw),
                            GATConv(16, 2, device="cpu", **kw), training)


def test_route_raises_where_the_reference_takes_other_kernels(monkeypatch):
    """3·H > 128 at rate 0 without dedup layouts takes the dot-mode
    kernels over ``gat_score_features`` (dsh 2, leaky 0.2); attention
    dropout at 3·H > 128 on any graph takes the reference's unfused path
    (``send_uv``, ``edge_softmax``, ``send_ue_recv`` with 43 weights an
    edge) and no attention kernel."""
    calls, unfused = [], []
    real = conv_module.fused_graph_attention
    monkeypatch.setattr(conv_module, "fused_graph_attention",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    real_ue = Graph.send_ue_recv
    monkeypatch.setattr(
        Graph, "send_ue_recv",
        lambda self, x, w, *a: unfused.append((tuple(x.shape),
                                               tuple(w.shape), a))
        or real_ue(self, x, w, *a))
    edges, gd = _dedup_multigraph()
    x = torch.randn(400, 16)
    g = Graph(edges, num_nodes=400).tensor("cpu")
    assert GATConv(16, 2, num_heads=43, device="cpu")(g, x).shape == (400, 86)
    (args, kw), = calls
    assert args[5:] == (43, 0.2) and kw == {"dsh": 2, "dvh": 2}
    wide = GATConv(16, 2, num_heads=43, attn_drop_mode="cell", device="cpu")
    for graph in (g, gd):
        assert wide(graph, x, training=True).shape == (400, 86)
    assert unfused == [((400, 43, 2), (edges.shape[0], 43, 1),
                        ("mul", "sum"))] * 2
    assert gd._dedup_attn is None                    # no K7/K8 under dropout
    assert wide(gd, x).shape == (400, 86)            # rate 0: K7/K8
    assert len(calls) == 1 and len(unfused) == 2
    with pytest.raises(ValueError, match="attn_drop_mode"):
        GATConv(16, 2, attn_drop_mode="node", device="cpu")


def test_activation_names_resolve():
    x = torch.linspace(-2, 2, 9)
    assert torch.equal(_resolve_act("relu")(x), torch.relu(x))
    assert torch.equal(_resolve_act("elu")(x),
                       torch.nn.functional.elu(x))
    assert _resolve_act(None) is None


def test_gat_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GAT(16, 3)
