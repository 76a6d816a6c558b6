"""Port parity for the models on the conv-layer zoo: ``GraphSage``, ``GIN``,
``DeepGCNII``, ``APPNPModel``, ``SGC``, ``SSGC``, ``GPRGNN``, ``BernNet``
and ``ChebNetII`` of ``pgl_tpu_torch`` against ``pgl_tpu``'s on the CPU,
with flax-initialised parameters carried over by
``pgl_tpu_torch.utils.convert`` (logits at rtol/atol 1e-5, parameter
gradients at rtol 1e-4, atol 1e-5); ``remat`` against none, the same bits
forward and backward, under dropout too; 10-step loss trajectories of
``GraphSage`` and ``DeepGCNII`` against the reference's under optax's Adam
(rtol 2e-3, as ``tests/test_torch_gcn.py``'s golden); and the K1 calls a
training step of each model at ``chip_smoke.py``'s widths, the launches
its phase 11 asserts on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")
optax = pytest.importorskip("optax")

import flax.linen
import pgl_tpu.models as jmodels
import pgl_tpu.nn as jnn
from pgl_tpu import Graph as JGraph
from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.ops import softmax_cross_entropy_integer as j_ce
import chip_smoke
import pgl_tpu_torch.models as models
from pgl_tpu_torch import Graph
from pgl_tpu_torch.datasets import community_graph, powerlaw_graph
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.ops.kernels import segment_kernels
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

GOLDEN_RTOL = 2e-3          # tests/test_trajectory_goldens.py:30


def _graphs(batched=False):
    """The reference's and the port's graph with 16 features and labels:
    the 300-node community graph and its node labels, or (``batched``) a
    ``disjoint`` of three community graphs and a label for each."""
    if not batched:
        g, labels = j_community_graph(num_nodes=300, num_classes=3,
                                      feat_dim=16, avg_degree=8, seed=5)
        tg, _ = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
        return g.tensor(), tg.tensor("cpu"), labels
    parts = ((90, 1), (120, 2), (60, 3))
    gj = JGraph.disjoint([j_community_graph(n, 3, 16, 6, seed=s)[0]
                          for n, s in parts])
    gt = Graph.disjoint([community_graph(n, 3, 16, 6, seed=s)[0]
                         for n, s in parts])
    return gj.tensor(), gt.tensor("cpu"), np.array([0, 2, 1], np.int32)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# name: the keyword arguments of both packages' model
MODELS = {
    "GraphSage": dict(num_layers=3, hidden_size=16),
    "GIN": dict(num_layers=3, hidden_size=16),
    "DeepGCNII": dict(hidden_size=16, k_hop=4),
    "APPNPModel": dict(hidden_size=16, k_hop=4),
    "SGC": dict(k_hop=3),
    "SSGC": dict(k_hop=4, alpha=0.1),
    "GPRGNN": dict(hidden_size=16, k_hop=4),
    "BernNet": dict(hidden_size=16, k_hop=3),
    "ChebNetII": dict(hidden_size=16, k_hop=4),
}


def _spread_temp(params):
    """BernNet's and ChebNetII's ``temp`` away from its ones, negative
    entries through the relu."""
    tree = jax.tree.map(lambda v: v, params)
    temp = tree["params"]["prop"]["temp"]
    tree["params"]["prop"]["temp"] = jnp.asarray(
        np.random.default_rng(1).normal(size=temp.shape), jnp.float32)
    return tree


class _JGPRGNN(flax.linen.Module):
    """The reference's ``GPRGNN`` with ``training`` passed by keyword to
    its ``GPRConv`` (the port's ``GPRGNN``; see
    ``test_gprgnn_passes_training_by_keyword``)."""
    hidden_size: int
    k_hop: int

    @flax.linen.compact
    def __call__(self, graph, feature, training: bool = False):
        return jnn.GPRConv(16, self.hidden_size, 3, k_hop=self.k_hop,
                           name="gpr")(graph, feature, training=training)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_reference(name):
    """Evaluation (no dropout); cross-entropy over node labels (GIN: graph
    labels on a batch of three). GPRGNN against the reference's with
    ``training`` reaching its ``GPRConv`` by keyword."""
    gj, gt, labels = _graphs(batched=name == "GIN")
    kw = MODELS[name]
    jmodel = _JGPRGNN(**kw) if name == "GPRGNN" \
        else getattr(jmodels, name)(16, 3, **kw)
    params = jmodel.init(jax.random.key(0), gj, gj.node_feat["h"])
    if name in ("BernNet", "ChebNetII"):
        params = _spread_temp(params)
    yj = jnp.asarray(labels)

    def loss(p):
        logits = jmodel.apply(p, gj, gj.node_feat["h"])
        return j_ce(logits, yj).mean(), logits

    (_, want_logits), want_grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    model = getattr(models, name)(16, 3, device="cpu", **kw)
    model.load_state_dict(flax_to_state_dict(_numpy_tree(params), "cpu"),
                          strict=True)
    logits = model(gt, gt.node_feat["h"])
    ce(logits, torch.as_tensor(labels)).mean().backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    want = flax_to_state_dict(_numpy_tree(want_grads), "cpu")
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_gprgnn_passes_training_by_keyword():
    """Departure: the reference's ``GPRGNN`` calls ``GPRConv(...)(graph,
    feature, training)`` (``pgl_tpu/models/gnn.py:273-276``), so
    ``training`` lands in ``norm``: in evaluation every hop is multiplied
    by a norm of 0 and the output is ``temp[0]`` times the MLP's; in
    training the hops run unnormalised and without dropout. The port's
    passes ``training=training``, as ``GPRConv``'s signature means."""
    gj, gt, _ = _graphs()
    x = gj.node_feat["h"]
    kw = MODELS["GPRGNN"]
    jmodel = jmodels.GPRGNN(16, 3, **kw)
    params = jmodel.init(jax.random.key(0), gj, x)
    conv = jnn.GPRConv(16, 16, 3, k_hop=kw["k_hop"])
    inner = {"params": params["params"]["gpr"]}
    for training in (False, True):
        np.testing.assert_array_equal(
            np.asarray(jmodel.apply(params, gj, x, training,
                                    rngs={"dropout": jax.random.key(1)})),
            np.asarray(conv.apply(inner, gj, x, training)))
    model = models.GPRGNN(16, 3, device="cpu", **kw)
    model.load_state_dict(flax_to_state_dict(_numpy_tree(params), "cpu"))
    np.testing.assert_allclose(
        model(gt, gt.node_feat["h"]).detach().numpy(),
        np.asarray(conv.apply(inner, gj, x, training=False)), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("cls,kw", [
    ("GCN", dict(num_layers=3, hidden_size=8)),
    ("GraphSage", dict(num_layers=2, hidden_size=8)),
    ("DeepGCNII", dict(hidden_size=8, k_hop=3))])
def test_remat_gives_the_same_bits(cls, kw, training):
    """As ``tests/test_models.py``'s ``test_remat_stacks_parity``:
    ``remat=True`` gives the outputs and gradients of ``remat=False`` bit
    for bit, over two steps. ``training`` at dropout 0.6: GCN's and
    GraphSage's masks are drawn outside the checkpointed layers,
    DeepGCNII's inside (its ``GCNII`` generator is set back for the
    recompute), so the recompute draws the forward's masks."""
    g = powerlaw_graph(num_nodes=128, avg_degree=6, feat_dim=8,
                       seed=0).tensor("cpu")
    x = g.node_feat["h"]
    runs = []
    for remat in (False, True):
        model = getattr(models, cls)(
            8, 4, dropout=0.6 if training else 0.0, remat=remat,
            generator=torch.Generator().manual_seed(0), device="cpu", **kw)
        steps = []
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            out = model(g, x, training)
            out.square().sum().backward()
            steps.append((out.detach(), {k: p.grad.clone()
                                         for k, p in model.named_parameters()}))
        runs.append(steps)
    for (o0, g0), (o1, g1) in zip(*runs):
        assert torch.equal(o0, o1)
        assert set(g0) == set(g1)
        for k in g0:
            assert torch.equal(g0[k], g1[k]), k
    if training:
        assert not torch.equal(runs[0][0][0], runs[0][1][0])


def test_remat_without_the_generator_replay_would_differ(monkeypatch):
    """The trap the replay guards: ``torch.utils.checkpoint`` restores the
    global RNG states only, so a recompute that draws GCNII's dropout from
    its generator as it stands gives other masks and other gradients."""
    g = powerlaw_graph(num_nodes=128, avg_degree=6, feat_dim=8,
                       seed=0).tensor("cpu")
    real = models.gnn._remat

    def no_replay(fn, *args, generator=None):
        return real(fn, *args)

    grads = []
    for remat in (False, True):
        model = models.DeepGCNII(8, 4, hidden_size=8, k_hop=3, remat=remat,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
        if remat:
            monkeypatch.setattr(models.gnn, "_remat", no_replay)
        model(g, g.node_feat["h"], True).square().sum().backward()
        grads.append(model.gcnii.mlp_0.weight.grad)
    assert not torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("name,kw", [
    ("GraphSage", dict(num_layers=2, hidden_size=16, dropout=0.0)),
    ("DeepGCNII", dict(hidden_size=16, k_hop=4, dropout=0.0))])
def test_trajectory_matches_reference(name, kw):
    """10 steps at lr 1e-2 from the same flax initialisation: optax's Adam
    on the reference, torch's on the port; the losses at rtol 2e-3."""
    gj, gt, labels = _graphs()
    jmodel = getattr(jmodels, name)(16, 3, **kw)
    params = jmodel.init(jax.random.key(0), gj, gj.node_feat["h"])
    opt = optax.adam(1e-2)
    state = opt.init(params)
    yj = jnp.asarray(labels)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(lambda q: j_ce(jmodel.apply(
            q, gj, gj.node_feat["h"]), yj).mean())(p)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    want = []
    for _ in range(10):
        params_next, state, loss = step(params, state)
        want.append(float(loss))
        params = params_next

    model = getattr(models, name)(16, 3, device="cpu", **kw)
    model.load_state_dict(flax_to_state_dict(_numpy_tree(
        jmodel.init(jax.random.key(0), gj, gj.node_feat["h"])), "cpu"))
    topt = torch.optim.Adam(model.parameters(), lr=1e-2)
    y = torch.as_tensor(labels)
    got = []
    for _ in range(10):
        loss = ce(model(gt, gt.node_feat["h"]), y).mean()
        topt.zero_grad()
        loss.backward()
        topt.step()
        got.append(loss.item())
    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("name", sorted(chip_smoke.ZOO_PER_STEP))
def test_k1_calls_a_step_match_the_chip_table(monkeypatch, name):
    """One training step of each of phase 11's models at its widths (128
    features, 16 classes) on a small graph calls K1 (its plain version
    here, through the same autograd function) ``ZOO_PER_STEP`` times by
    layout and width: the launches ``chip_smoke.py`` asserts on the
    card."""
    calls = {}
    real = segment_kernels._spmm_one

    def spy(x, layout):
        key = (layout.kind, x.shape[1])
        calls[key] = calls.get(key, 0) + 1
        return real(x, layout)

    monkeypatch.setattr(segment_kernels, "_spmm_one", spy)
    if name == "GIN":
        host, labels = chip_smoke.gin_host(num_graphs=4, num_nodes=64)
    else:
        host, labels = powerlaw_graph(200, 8, feat_dim=128, seed=0), None
    _, step = chip_smoke.zoo_trainer(name, labels)(host.tensor("cpu"))
    calls.clear()
    assert np.isfinite(float(step()))
    assert calls == chip_smoke.ZOO_PER_STEP[name]


def test_gcn_dropout_draws_from_its_own_generator():
    """GCN's dropout comes from the model's generator, not the global RNG:
    the same seed gives the same masks whatever the global state, and the
    global state does not move."""
    _, gt, _ = _graphs()
    x = gt.node_feat["h"]
    outs = []
    for global_seed in (1, 2):
        model = models.GCN(16, 3, dropout=0.5, generator=torch.Generator(
            ).manual_seed(3), device="cpu")
        torch.manual_seed(global_seed)
        before = torch.get_rng_state()
        outs.append(model(gt, x, training=True))
        assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], model(gt, x))


def test_models_training_dropout_is_seeded_and_learns():
    """The default dropouts train: the same generator seed gives the same
    losses, and the loss falls over 15 Adam steps."""
    _, gt, labels = _graphs()
    x, y = gt.node_feat["h"], torch.as_tensor(labels)
    for name in ("GraphSage", "DeepGCNII", "APPNPModel", "GPRGNN",
                 "BernNet", "ChebNetII"):
        runs = []
        for _ in range(2):
            model = getattr(models, name)(
                16, 3, generator=torch.Generator().manual_seed(3),
                device="cpu", **{k: v for k, v in MODELS[name].items()
                                 if k != "num_layers"})
            opt = torch.optim.Adam(model.parameters(), lr=1e-2)
            losses = []
            for _ in range(15):
                loss = ce(model(gt, x, training=True), y).mean()
                opt.zero_grad()
                loss.backward()
                opt.step()
                losses.append(loss.item())
            runs.append(losses)
        assert runs[0] == runs[1], name
        assert runs[0][-1] < runs[0][0], name
