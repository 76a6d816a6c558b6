"""Port parity for UniMP training on the CPU: the dot mode of the per-edge
attention (K9/K10, ``fused_graph_attention`` of
``pgl_tpu_torch/ops/kernels/attention_kernels.py``) against ``pgl_tpu``'s
run in interpret mode; ``TransformerConv`` and ``UniMP`` against
``pgl_tpu``'s with flax-initialised parameters carried over by
``pgl_tpu_torch.utils.convert``; the 20-step ``unimp`` loss golden; and the
route rule of ``TransformerConv``. On a graph with dedup layouts the layers
take the count-matrix dot attention (K7/K8, ``dedup_dot_attention``), whose
kernels' plain versions ``tests/test_torch_dedup_dot.py`` holds against the
reference; here ``TransformerConv`` and ``UniMP`` on such a graph."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack: there this file skips
pytest.importorskip("flax")

from chip_smoke import dispatch_settings, skewed_graph
from pgl_tpu import Graph as JGraph
from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.models import UniMP as JUniMP
from pgl_tpu.nn import TransformerConv as JTransformerConv
from pgl_tpu.ops import softmax_cross_entropy_integer as j_ce
from pgl_tpu.ops.pallas.attention_kernels import (
    _fused_attention_fwd, fused_graph_attention as j_fused,
    gat_score_features as j_score_features)
from pgl_tpu.ops.pallas.segment_kernels import build_blocked_layout
from pgl_tpu_torch import Graph
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import UniMP
from pgl_tpu_torch.nn import TransformerConv
from pgl_tpu_torch.nn import conv as conv_module
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.ops.kernels import attention_kernels as ak
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

# The first torch.exp of a process on the CPU can differ from every later
# one by up to ~6e-5 (see tests/test_torch_gat.py): take it here.
torch.exp(torch.zeros(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS_FILE = os.path.join(REPO, "tests", "test_trajectory_goldens_data.npz")
GOLDEN_RTOL = 2e-3          # tests/test_trajectory_goldens.py:30
N = 300


# -- the kernels -----------------------------------------------------------

def _edges(seed, E=3000):
    """A hub destination (node 0, 700 edges: split over pieces of
    ``ak.ET``), a hub source (node 5, 600 out-edges), empty rows 1..149,
    repeated (dst, src) pairs, and the edges in shuffled order."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(700, np.int64),
                          rng.integers(N // 2, N, E - 700)])
    src = rng.integers(0, N, E)
    src[rng.choice(E, 600, replace=False)] = 5
    return np.stack([src, dst], axis=1)[rng.permutation(E)]


def _case(seed, H, dsh, dvh):
    """The port's graph and the reference's layouts (``build_blocked_layout``
    with nb=128, et=256, and the reference graph's ``perm``) of one graph,
    and numpy q, k [N, H·dsh] (scores of unit spread) and v [N, H·dvh]."""
    edges = _edges(seed)
    port = Graph(edges, num_nodes=N).tensor("cpu")
    gj = JGraph(edges, num_nodes=N)
    di, si = gj.adj_dst_index, gj.adj_src_index
    ref = (build_blocked_layout(np.asarray(di.indptr),
                                np.asarray(di.sorted_v), N, 128, 256),
           build_blocked_layout(np.asarray(si.indptr),
                                np.asarray(si.sorted_v), N, 128, 256),
           gj.tensor()._spmm_layouts[2])
    rng = np.random.default_rng(seed + 1)
    q, k = (rng.normal(size=(N, H * dsh)).astype(np.float32)
            * np.float32(dsh ** -0.25) for _ in range(2))
    v = rng.normal(size=(N, H * dvh)).astype(np.float32)
    return port, ref, q, k, v


SHAPES = [(2, 64, 64, 0.0), (3, 8, 8, 0.0), (4, 2, 8, 0.2)]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("H,dsh,dvh,leaky", SHAPES)
def test_dot_forward_and_lse_match_reference(H, dsh, dvh, leaky, rate):
    """rtol 1e-4, atol 1e-5 (tests/test_pallas_kernels.py:430-431)."""
    port, (csc, _, _), q, k, v = _case(7, H, dsh, dvh)
    seed = 12345 if rate else None
    out_j, lse_j, _ = _fused_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), csc.padded_v,
        csc.padded_ids, csc.tile_starts, csc.tile_ends, N, H, leaky, 128,
        256, True, dsh=dsh, dvh=dvh, drop_rate=rate,
        drop_seed=None if seed is None else jnp.int32(seed))
    csc_t, csr_t = port._attention_layouts()
    t = [torch.as_tensor(x) for x in (q, k, v)]
    out = ak.fused_graph_attention(*t, csc_t, csr_t, H, leaky, dsh, dvh,
                                   rate, seed)
    _, lse = ak.dot_attention_reference(*t, csc_t, dsh, dvh, leaky, rate,
                                        seed)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-4,
                               atol=1e-5)
    assert (out[1:N // 2] == 0).all() and (lse[1:N // 2] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("H,dsh,dvh,leaky", SHAPES)
def test_dot_gradients_match_reference_flash_backward(H, dsh, dvh, leaky,
                                                      rate):
    """Gradients of sum((out - tgt)^2) against JAX's analytic backward
    (``bwd_aux=(csr, perm)``) at rtol 2e-3, atol 2e-4
    (tests/test_pallas_kernels.py:457-459)."""
    port, (csc, csr, perm), q, k, v = _case(9, H, dsh, dvh)
    tgt = np.random.default_rng(11).normal(size=(N, H * dvh)).astype(
        np.float32)
    seed = 12345 if rate else None

    def loss_j(q, k, v):
        out = j_fused(q, k, v, csc, (csr, perm), H, leaky, 128, 256, True,
                      dsh, dvh, rate,
                      None if seed is None else jnp.int32(seed))
        return ((out - tgt) ** 2).sum()

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = ak.fused_graph_attention(*t, *port._attention_layouts(), H, leaky,
                                   dsh, dvh, rate, seed)
    ((out - torch.as_tensor(tgt)) ** 2).sum().backward()
    for got, w, name in zip(t, want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_dot_plain_backward_is_autograd_of_plain_forward(rate):
    """The dot-mode K10 plain versions (edge space, the CSR pass through
    ``eidx``) against torch autograd of the plain forward, in float64 at
    1e-10, at dsh != dvh with a leaky relu."""
    H, dsh, dvh = 3, 4, 5
    port, _, q, k, v = _case(5, H, dsh, dvh)
    csc, csr = port._attention_layouts()
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
         for x in (q, k, v)]
    g = torch.randn(N, H * dvh, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    out, lse = ak.dot_attention_reference(*t, csc, dsh, dvh, 0.2, rate, -77)
    want = torch.autograd.grad(out, t, g)
    delta = (g.reshape(N, H, dvh) * out.detach().reshape(N, H, dvh)).sum(-1)
    ins = [x.detach() for x in t] + [g, lse.detach(), delta]
    dq = ak.dot_dq_reference(*ins, csc, dsh, dvh, 0.2, rate, -77)
    dk, dv = ak.dot_dkv_reference(*ins, csr, dsh, dvh, 0.2, rate, -77)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("H", [43, 64])
def test_gat_score_features_match_reference(H):
    """q', k' equal the reference's bit for bit, and their per-head dot is
    the additive score exactly."""
    rng = np.random.default_rng(H)
    a_dst, a_src = (rng.normal(size=(N, H)).astype(np.float32)
                    for _ in range(2))
    want = j_score_features(jnp.asarray(a_dst), jnp.asarray(a_src))
    got = ak.gat_score_features(torch.as_tensor(a_dst),
                                torch.as_tensor(a_src))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dsh = got[0].shape[1] // H
    score = (got[0].reshape(N, H, dsh)
             * got[1].flip(0).reshape(N, H, dsh)).sum(-1)
    np.testing.assert_array_equal(score.numpy(), a_dst + a_src[::-1])


def test_fused_graph_attention_rejects_mismatched_shapes():
    port, *_ = _case(3, 1, 1, 1)
    lays = port._attention_layouts()
    with pytest.raises(ValueError, match="are not"):
        ak.fused_graph_attention(torch.zeros(N, 8), torch.zeros(N, 6),
                                 torch.zeros(N, 8), *lays, 2)
    with pytest.raises(ValueError, match="are not"):
        ak.fused_graph_attention(torch.zeros(N, 8), torch.zeros(N, 8),
                                 torch.zeros(N, 8), *lays, 2, dvh=3)


# -- the layers ------------------------------------------------------------

def _graphs(dedup=False):
    """The reference's and the port's small graph (``community_graph`` as
    in tests/test_trajectory_goldens.py), the port's with dedup layouts
    when asked."""
    g, labels = j_community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    tg, _ = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                            avg_degree=8, seed=5)
    with dispatch_settings(DEDUP=dedup, DEDUP_MIN_EDGES=0):
        gt = tg.tensor("cpu")
    assert (gt._dedup_layouts is not None) == dedup
    return g.tensor(), jnp.asarray(labels), gt, torch.as_tensor(
        labels).long()


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _check_logits_and_grads(jmodel, model, args, jargs, training=False,
                            dedup=False):
    """Logits at rtol/atol 1e-5, parameter gradients at rtol 1e-4, atol
    1e-5 (float32; sums in another order), as tests/test_torch_gat.py;
    ``args``/``jargs`` follow the graph and the features; ``dedup`` gives
    the port's graph dedup layouts. On the CPU the reference takes its
    edge-space composition; at attention rate 0 it is the function the
    port's kernels compute. Returns the port's graph."""
    gj, yj, gt, y = _graphs(dedup)
    params = jmodel.init(jax.random.key(0), gj, gj.node_feat["h"], *jargs)

    def loss(p):
        logits = jmodel.apply(p, gj, gj.node_feat["h"], *jargs,
                              training=training)
        return j_ce(logits, yj).mean(), logits

    (_, want_logits), want_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    model.load_state_dict(flax_to_state_dict(_numpy_tree(params), "cpu"),
                          strict=True)
    logits = model(gt, gt.node_feat["h"], *args, training=training)
    ce(logits, y).mean().backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    want = flax_to_state_dict(_numpy_tree(want_grads), "cpu")
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    return gt


LAYERS = {"default": {}, "gate": {"gate": True},
          "mean": {"concat": False, "gate": True},
          "no_norm": {"layer_norm": False}, "no_skip": {"skip_feat": False}}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("config", sorted(LAYERS))
def test_transformerconv_matches_reference(config, training):
    """Evaluation with the default dropouts, and training with both at 0,
    for 3 heads of 4 classes' width."""
    kw = dict(LAYERS[config], num_heads=3)
    if training:
        kw.update(feat_drop=0.0, attn_drop=0.0)
    gt = _check_logits_and_grads(JTransformerConv(16, 3, **kw),
                                 TransformerConv(16, 3, device="cpu", **kw),
                                 (), (), training)
    # the fused route builds the attention layouts; the edge-space one not
    assert (gt._attn_layouts is not None) == kw.get("concat", True)


def test_transformerconv_with_edge_features_matches_reference():
    """``edge_feat`` [E, H·D] joins k and v on the edge-space route."""
    gj, _, _, _ = _graphs()
    ef = np.random.default_rng(4).normal(
        size=(gj.num_edges, 6)).astype(np.float32)
    _check_logits_and_grads(JTransformerConv(16, 2, num_heads=3),
                            TransformerConv(16, 2, num_heads=3, device="cpu"),
                            (torch.as_tensor(ef),), (jnp.asarray(ef),))


def _unimp_args(num_nodes, seed=2):
    """Labels and a mask feeding about half of them."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 3, num_nodes)
    mask = rng.random(num_nodes) < 0.5
    return label, mask


@pytest.mark.parametrize("training", [False, True])
def test_unimp_matches_reference(training):
    """UniMP with the label embedding fed through a mask: evaluation at its
    default dropout, training at 0."""
    label, mask = _unimp_args(300)
    kw = dict(num_layers=3, hidden_size=8, num_heads=2)
    if training:
        kw["dropout"] = 0.0
    _check_logits_and_grads(
        JUniMP(16, 3, **kw), UniMP(16, 3, device="cpu", **kw),
        (torch.as_tensor(label), torch.as_tensor(mask)),
        (jnp.asarray(label), jnp.asarray(mask)), training)


@pytest.mark.parametrize("training", [False, True])
def test_transformerconv_on_dedup_graph_matches_reference(training):
    """On a graph with dedup layouts, through ``dedup_dot_attention`` (3
    heads of 4: H·D = 12, off the reference's lane gate): evaluation with
    the default dropouts, and training with both at 0."""
    kw = dict(num_heads=3)
    if training:
        kw.update(feat_drop=0.0, attn_drop=0.0)
    gt = _check_logits_and_grads(JTransformerConv(16, 4, **kw),
                                 TransformerConv(16, 4, device="cpu", **kw),
                                 (), (), training, dedup=True)
    assert gt._dedup_attn is not None and gt._attn_layouts is None


def test_unimp_on_dedup_graph_matches_reference():
    """UniMP on a graph with dedup layouts (layers 0 and 1 through
    ``dedup_dot_attention``, the last through the edge-space composition),
    the labels fed through a mask, training at dropout 0."""
    label, mask = _unimp_args(300)
    kw = dict(num_layers=3, hidden_size=8, num_heads=2, dropout=0.0)
    gt = _check_logits_and_grads(
        JUniMP(16, 3, **kw), UniMP(16, 3, device="cpu", **kw),
        (torch.as_tensor(label), torch.as_tensor(mask)),
        (jnp.asarray(label), jnp.asarray(mask)), True, dedup=True)
    assert gt._dedup_attn is not None and gt._attn_layouts is None


def test_unimp_parameters_load_strictly():
    """A JAX UniMP's flax tree (``Embed``, ``Dense``, ``LayerNorm``) loads
    into the port's ``state_dict`` with ``strict=True``, shapes and all;
    the layer norms run at flax's ``eps``."""
    gj, _, _, _ = _graphs()
    label, mask = _unimp_args(300)
    params = JUniMP(16, 3, hidden_size=8).init(
        jax.random.key(1), gj, gj.node_feat["h"], jnp.asarray(label),
        jnp.asarray(mask))
    model = UniMP(16, 3, hidden_size=8, device="cpu")
    state = flax_to_state_dict(_numpy_tree(params), "cpu")
    model.load_state_dict(state, strict=True)
    assert state["label_embed.weight"].shape == (3, 16)
    np.testing.assert_array_equal(
        model.conv_0.ln.weight.detach().numpy(),
        np.asarray(params["params"]["conv_0"]["ln"]["scale"]))
    assert model.conv_0.ln.eps == 1e-6 and model.conv_1.ln.eps == 1e-6
    assert model.conv_2.ln is None and model.conv_2.gate is not None


def test_unimp_trajectory_matches_golden():
    """The ``unimp`` trajectory of tests/test_trajectory_goldens.py: two
    TransformerConv layers (3 heads of 8, then 3 classes, ``concat=False``)
    initialised by flax from the same keys, then 20 steps of torch Adam at
    lr 1e-2. The first layer takes the dot kernels' plain versions, the
    second the edge-space route."""
    gj, _, gt, y = _graphs()
    jlayers = [JTransformerConv(input_size=16, hidden_size=8, num_heads=3,
                                feat_drop=0.0, attn_drop=0.0),
               JTransformerConv(input_size=24, hidden_size=3, num_heads=1,
                                feat_drop=0.0, attn_drop=0.0, concat=False)]
    key, h, params = jax.random.key(0), gj.node_feat["h"], []
    for layer in jlayers:
        key, sub = jax.random.split(key)
        p = layer.init(sub, gj, h)
        h = layer.apply(p, gj, h)
        params.append(p)
    layers = torch.nn.ModuleList([
        TransformerConv(16, 8, num_heads=3, feat_drop=0.0, attn_drop=0.0,
                        device="cpu"),
        TransformerConv(24, 3, num_heads=1, feat_drop=0.0, attn_drop=0.0,
                        concat=False, device="cpu")])
    for layer, p in zip(layers, params):
        layer.load_state_dict(flax_to_state_dict(_numpy_tree(p), "cpu"),
                              strict=True)
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
    np.testing.assert_allclose(losses, np.load(GOLDENS_FILE)["unimp"],
                               rtol=GOLDEN_RTOL)
    assert gt._attn_layouts is not None


def test_unimp_training_dropout_is_seeded_and_learns():
    """UniMP at dropout 0.3, training, through the in-kernel attention
    dropout (layers 0 and 1) and the edge-space route (the last): finite
    logits of the right shape; the same generator seed gives the same
    losses; the loss falls."""
    _, _, gt, y = _graphs()
    label, mask = _unimp_args(300)
    label, mask = torch.as_tensor(label), torch.as_tensor(mask)
    runs = []
    for _ in range(2):
        model = UniMP(16, 3, hidden_size=8, dropout=0.3,
                      generator=torch.Generator().manual_seed(3),
                      device="cpu")
        opt = torch.optim.AdamW(model.parameters(), lr=5e-3,
                                weight_decay=5e-4)
        losses = []
        for _ in range(15):
            logits = model(gt, gt.node_feat["h"], label, mask, training=True)
            assert logits.shape == (300, 3)
            assert bool(torch.isfinite(logits).all())
            loss = ce(logits, y).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        runs.append(losses)
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]


def test_unimp_cell_dropout_on_dedup_graph_is_seeded_and_learns():
    """UniMP at dropout 0.3 on a dedup-layout multigraph, its attention
    layers in cell mode (K7/K8 with the cell mask): finite logits; the same
    generator seed gives the same losses; the loss falls; no per-edge work
    list is built."""
    _, _, gt, y = _graphs(dedup=True)
    assert not gt._dedup_layouts[0].simple
    label, mask = (torch.as_tensor(a) for a in _unimp_args(300))
    runs = []
    for _ in range(2):
        model = UniMP(16, 3, hidden_size=8, dropout=0.3,
                      generator=torch.Generator().manual_seed(3),
                      device="cpu")
        for layer in (model.conv_0, model.conv_1):
            layer.attn_drop_mode = "cell"
        opt = torch.optim.AdamW(model.parameters(), lr=5e-3,
                                weight_decay=5e-4)
        losses = []
        for _ in range(10):
            logits = model(gt, gt.node_feat["h"], label, mask, training=True)
            assert bool(torch.isfinite(logits).all())
            loss = ce(logits, y).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        runs.append(losses)
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]
    assert gt._attn_layouts is None


# -- the route -------------------------------------------------------------

def _spy(monkeypatch, calls):
    real = conv_module.fused_graph_attention
    monkeypatch.setattr(conv_module, "fused_graph_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))


def test_route_takes_the_dot_kernels(monkeypatch):
    """Without edge features and with ``concat``, the layer calls
    ``fused_graph_attention`` with the reference's arguments (dsh = dvh =
    D, no leaky relu; a seed only when training with dropout); with
    ``concat=False`` or ``edge_feat`` it does not."""
    calls = []
    _spy(monkeypatch, calls)
    _, _, gt, _ = _graphs()
    x = gt.node_feat["h"]
    conv = TransformerConv(16, 4, num_heads=2, attn_drop=0.3, device="cpu")
    assert conv(gt, x).shape == (300, 8)
    assert calls[-1]["dsh"] == calls[-1]["dvh"] == 4
    assert calls[-1]["drop_seed"] is None
    conv(gt, x, training=True)
    assert calls[-1]["attn_drop"] == 0.3
    assert calls[-1]["drop_seed"].dtype == torch.int32
    n = len(calls)
    TransformerConv(16, 4, num_heads=2, concat=False, device="cpu")(gt, x)
    TransformerConv(16, 4, num_heads=2, device="cpu")(
        gt, x, torch.zeros(gt.num_edges, 8))
    assert len(calls) == n


def test_route_on_dedup_graphs(monkeypatch):
    """On a graph with dedup layouts the layer takes the count-matrix dot
    attention (``dedup_dot_attention``, K7/K8 in dot mode) with the
    reference's arguments, at rate 0 and in cell mode under dropout; a
    multigraph under edge-mode dropout takes K9/K10, as the reference; and
    ``concat=False`` the edge-space route. H·D = 8 here, which the reference
    keeps off its fused kernels (``(H·D) % 128 != 0``): the port takes
    K7/K8 there, the one deliberate departure."""
    calls, dedup_calls = [], []
    _spy(monkeypatch, calls)
    real = conv_module.dedup_dot_attention
    monkeypatch.setattr(
        conv_module, "dedup_dot_attention",
        lambda *a, **k: dedup_calls.append((a[4:], k)) or real(*a, **k))
    edges = skewed_graph(400, 6000, seed=2)        # repeats (dst, src) pairs
    with dispatch_settings(DEDUP=True, DEDUP_MIN_EDGES=0):
        gd = Graph(edges, num_nodes=400).tensor("cpu")
    assert not gd._dedup_layouts[0].simple
    x = torch.randn(400, 16)
    conv = TransformerConv(16, 4, num_heads=2, device="cpu")
    assert conv(gd, x).shape == (400, 8)
    assert dedup_calls[-1] == ((2, 4, 4, 0.0),
                               {"attn_drop": 0.0, "drop_seed": None})
    assert conv(gd, x, training=True).shape == (400, 8)
    assert len(calls) == 1 and len(dedup_calls) == 1
    cell = TransformerConv(16, 4, num_heads=2, attn_drop_mode="cell",
                           device="cpu")
    assert cell(gd, x, training=True).shape == (400, 8)
    assert dedup_calls[-1][1]["attn_drop"] == 0.6
    assert dedup_calls[-1][1]["drop_seed"].dtype == torch.int32
    mean = TransformerConv(16, 4, num_heads=2, concat=False, device="cpu")
    assert mean(gd, x).shape == (400, 4)
    assert len(calls) == 1 and len(dedup_calls) == 2
    with pytest.raises(ValueError, match="attn_drop_mode"):
        TransformerConv(16, 4, attn_drop_mode="node", device="cpu")
