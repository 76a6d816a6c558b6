"""Parity of ``examples_torch/`` with ``examples/`` on the CPU.

Each reference script is imported by path (its top-level ``select_platform``
and JAX import run on the CPU, as ``tests/conftest.py`` sets them up), and
so is its port. Held equal:

* the script-level data builders, bit for bit: ``load_data``,
  ``build_synthetic``, ``sample_ego_batch``, ``make_motif`` /
  ``make_batches``, ``synthetic_heter``, ``synthetic_relational``,
  ``synthetic_triples``, ``make_interactions``, the walk-pair stream, the
  splits and the evaluation negatives;
* the metric helpers within 1e-6 on the same inputs: AUC, recall@20, NMI,
  k-means++, ``macro_f1_probe``, the linear probe, the 1-NN agreement;
* one optimiser step of the citation GCN, the ogb UniMP and the LightGCN
  BPR objective: the loss and its gradients at the reference's initial
  parameters, and the parameters after the step (optax against
  ``torch.optim``) within 1e-5, dropout off, the negatives fed to both;
* and no file under ``examples_torch/`` imports ``jax``, ``flax``,
  ``optax``, ``pgl_tpu`` or ``examples``.

The in-script modules are in ``tests/test_torch_examples_modules.py``.
"""

import argparse
import ast

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

flax = pytest.importorskip("flax")
optax = pytest.importorskip("optax")

from pgl_tpu_torch.utils.convert import flax_to_state_dict
from torch_examples_common import (ROOT, close, close_grads, numpy_tree,
                                   port, ref, same_graph)

torch.set_num_threads(1)

BANNED = {"jax", "flax", "optax", "pgl_tpu", "examples"}


# -- imports ------------------------------------------------------------------

def test_no_file_imports_the_reference():
    """Every file under examples_torch/ imports neither JAX, flax, optax,
    ``pgl_tpu`` nor anything of ``examples``; all 21 scripts are there."""
    files = sorted((ROOT / "examples_torch").rglob("*.py"))
    want = sorted(p.relative_to(ROOT / "examples")
                  for p in (ROOT / "examples").rglob("*.py"))
    assert sorted(p.relative_to(ROOT / "examples_torch")
                  for p in files) == want
    assert len(want) == 21
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED, (path, name)
        assert "def main(argv=None)" in path.read_text(), path


# -- data builders ------------------------------------------------------------

def test_citation_load_data():
    args = argparse.Namespace(data_path=None, dataset="cora")
    want = ref("citation_benchmark/train.py").load_data(args)
    got = port("citation_benchmark/train.py").load_data(args)
    same_graph(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ogb_load_data():
    """The 20,000-node stand-in (the reference's import of the ogb package
    fails here, so it falls back to the same graph)."""
    want = ref("ogb/train.py").load_data(False)
    got = port("ogb/train.py").load_data(False)
    same_graph(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_r_unimp_build_synthetic_and_ego_batch():
    r, p = ref("r_unimp/train.py"), port("r_unimp/train.py")
    want, got = r.build_synthetic(), p.build_synthetic()
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    from pgl_tpu import Graph as JGraph
    from pgl_tpu_torch import Graph
    edges, n = want[0], want[1]
    jg = {k: JGraph(v, num_nodes=n) for k, v in edges.items()}
    tg = {k: Graph(v, num_nodes=n) for k, v in edges.items()}
    batch = np.arange(0, 600, 7)[:40]
    for hops, k in ((2, 8), (1, 3)):
        np.testing.assert_array_equal(
            p.sample_ego_batch(tg, batch, k, hops, np.random.default_rng(5)),
            r.sample_ego_batch(jg, batch, k, hops, np.random.default_rng(5)))


@pytest.mark.parametrize("rel", ["gin/train.py", "global_pool/train.py"])
def test_motif_batches(rel):
    want = ref(rel).make_batches(70, 16, seed=3)
    got = port(rel).make_batches(70, 16, seed=3)
    assert len(got) == len(want) == 4
    for (g1, y1), (g2, y2) in zip(got, want):
        same_graph(g1, g2)
        np.testing.assert_array_equal(np.asarray(g1.graph_node_id),
                                      np.asarray(g2.graph_node_id))
        np.testing.assert_array_equal(y1, y2)
    for kind in (0, 1, 2):
        if rel == "gin/train.py" and kind == 2:
            continue
        same_graph(port(rel).make_motif(kind, 9, None),
                   ref(rel).make_motif(kind, 9, None))


def test_sag_pool_batches():
    r, p = ref("sag_pool/train.py"), port("sag_pool/train.py")
    want = r.make_batches(40, 16, 2)
    got = p.make_batches(40, 16, 2, "cpu")
    assert len(got) == len(want) == 2
    for (g1, y1), (g2, y2) in zip(got, want):
        np.testing.assert_array_equal(g1.edges.numpy(), np.asarray(g2.edges))
        np.testing.assert_array_equal(g1.graph_node_id.numpy(),
                                      np.asarray(g2.graph_node_id))
        np.testing.assert_array_equal(y1.numpy(), np.asarray(y2))
    for kind in (0, 1):
        g1, k1 = p.make_motif(kind, 7, None)
        g2, k2 = r.make_motif(kind, 7, None)
        same_graph(g1, g2)
        assert k1 == k2


def test_heterogeneous_builders():
    r, p = ref("metapath2vec/train.py"), port("metapath2vec/train.py")
    (hg1, c1), (hg2, c2) = p.synthetic_heter(), r.synthetic_heter()
    np.testing.assert_array_equal(c1, c2)
    assert sorted(hg1.edge_types) == sorted(hg2.edge_types)
    for t in hg2.edge_types:
        np.testing.assert_array_equal(np.asarray(hg1[t].edges),
                                      np.asarray(hg2[t].edges))
    for nt in ("u", "i"):
        np.testing.assert_array_equal(hg1.nodes_by_type(nt),
                                      hg2.nodes_by_type(nt))
    r, p = ref("rgcn/train.py"), port("rgcn/train.py")
    (hg1, y1), (hg2, y2) = p.synthetic_relational(), r.synthetic_relational()
    np.testing.assert_array_equal(y1, y2)
    for t in hg2.edge_types:
        same_graph(hg1[t], hg2[t])


def test_kg_triples():
    r, p = ref("kg/train.py"), port("kg/train.py")
    kw = dict(num_ents=300, num_rels=3, per_rel=120, seed=2)
    for a, b in zip(p.synthetic_triples(**kw), r.synthetic_triples(**kw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rel", ["lightgcn/train.py", "ngcf/train.py"])
def test_interactions_and_split(rel):
    """``make_interactions``, the one-id-space graph and the 90/10 split
    (``examples/lightgcn/train.py:60-68``, ``examples/ngcf/train.py:
    79-86``)."""
    r, p = ref(rel), port(rel)
    got = p.make_interactions(60, 80, 5, 3, seed=4)
    want = r.make_interactions(60, 80, 5, 3, seed=4)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(a, b)
    if rel == "lightgcn/train.py":
        pairs = want[0]
        g = p.interaction_graph(pairs, 60, 80)
        src, dst = pairs[:, 0], pairs[:, 1] + 60
        np.testing.assert_array_equal(np.asarray(g.edges), np.stack(
            [np.concatenate([src, dst]), np.concatenate([dst, src])], 1))
        rng = np.random.default_rng(1)
        mask = rng.random(len(pairs)) < 0.9
        tr, te = p.split_pairs(pairs)
        np.testing.assert_array_equal(tr, pairs[mask])
        np.testing.assert_array_equal(te, pairs[~mask])


def test_link_prediction_split_and_negatives():
    """The held-out split and the evaluation negatives drawn after it
    (``examples/link_prediction/train.py:60-64, 99``)."""
    from pgl_tpu.datasets import community_graph as j_community_graph
    g, _ = j_community_graph(num_nodes=1000, num_classes=5, feat_dim=32,
                             avg_degree=10, seed=0)
    edges = np.asarray(g.edges)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(edges))
    test_edges = edges[perm[:len(edges) // 10]]
    train_edges = edges[perm[len(edges) // 10:]]
    want_neg = rng.integers(0, g.num_nodes, len(test_edges))
    tr, te, prng = port("link_prediction/train.py").split_edges(g)
    np.testing.assert_array_equal(tr, train_edges)
    np.testing.assert_array_equal(te, test_edges)
    np.testing.assert_array_equal(
        prng.integers(0, g.num_nodes, len(test_edges)), want_neg)


def test_walk_pair_stream():
    """The deepwalk Dataloader's pairs (random and node2vec walks), read
    straight from both datasets."""
    from pgl_tpu.datasets import community_graph as j_community_graph
    from pgl_tpu_torch.datasets import community_graph
    jg, _ = j_community_graph(num_nodes=300, num_classes=4, feat_dim=1,
                              avg_degree=6, seed=0)
    tg, _ = community_graph(num_nodes=300, num_classes=4, feat_dim=1,
                            avg_degree=6, seed=0)
    for p_, q_ in ((1.0, 1.0), (0.5, 2.0)):
        want = list(ref("deepwalk/train.py").WalkPairDataset(
            jg, 8, 3, 256, p_, q_, epoch_seed=2))
        got = list(port("deepwalk/train.py").WalkPairDataset(
            tg, 8, 3, 256, p_, q_, epoch_seed=2))
        assert len(got) == len(want) > 0
        for (s1, d1), (s2, d2) in zip(got, want):
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(d1, d2)


# -- metric helpers -----------------------------------------------------------

def test_auc():
    rng = np.random.default_rng(0)
    pos, neg = rng.normal(0.5, 1, 700), rng.normal(0, 1, 500)
    got = port("link_prediction/train.py").auc_score(pos, neg)
    want = ref("link_prediction/train.py").auc_score(pos, neg)
    assert abs(got - want) <= 1e-6


def _ref_recall(h, U, train_pairs, test_pairs):
    """``examples/lightgcn/train.py:114-126``."""
    users = np.unique(test_pairs[:, 0])
    scores = h[users] @ h[U:].T
    for row, u in enumerate(users):
        seen = train_pairs[train_pairs[:, 0] == u][:, 1]
        scores[row, seen] = -np.inf
    top = np.argsort(-scores, 1)[:, :20]
    hits = total = 0
    for row, u in enumerate(users):
        held = set(test_pairs[test_pairs[:, 0] == u][:, 1].tolist())
        hits += len(held & set(top[row].tolist()))
        total += len(held)
    return hits / total


def test_recall_at_20():
    pairs, _, _ = ref("lightgcn/train.py").make_interactions(
        80, 120, 8, 3, seed=1)
    tr, te = port("lightgcn/train.py").split_pairs(pairs)
    h = np.random.default_rng(2).normal(size=(200, 8)).astype(np.float32)
    got = port("lightgcn/train.py").recall_at_20(h, 80, tr, te)
    assert abs(got - _ref_recall(h, 80, tr, te)) <= 1e-6
    assert 0 < got < 1


def test_nmi_and_kmeans():
    r, p = ref("clustering/train.py"), port("clustering/train.py")
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 4, 500), rng.integers(0, 5, 500)
    b[:300] = a[:300]
    assert abs(p.nmi(a, b) - r.nmi(a, b)) <= 1e-6
    x = rng.normal(size=(400, 6)) + 3 * np.eye(6)[rng.integers(0, 4, 400)]
    np.testing.assert_array_equal(p.kmeans(x, 4, seed=3),
                                  r.kmeans(x, 4, seed=3))


def test_macro_f1_probe():
    rel = "deepwalk/train_distributed_cpu.py"
    rng = np.random.default_rng(0)
    labels = (rng.random((300, 5)) < 0.25).astype(np.int64)
    emb = (labels @ rng.normal(size=(5, 12))
           + rng.normal(size=(300, 12))).astype(np.float32)
    got = port(rel).macro_f1_probe(emb, labels, epochs=60)
    want = ref(rel).macro_f1_probe(emb, labels, epochs=60)
    assert abs(got - want) <= 1e-6
    assert got > 0.2


def _ref_probe(e, y, dim):
    """``examples/node2vec/train.py:90-110``."""
    n = len(e)
    perm = np.random.default_rng(3).permutation(n)
    tr, te = perm[:n // 2], perm[n // 2:]
    w = jnp.zeros((dim, 4))
    popt = optax.adam(0.1)
    pstate = popt.init(w)
    ej, yj = jnp.asarray(e), jnp.asarray(y)

    @jax.jit
    def probe_step(w, pstate):
        def loss_fn(w):
            return optax.softmax_cross_entropy_with_integer_labels(
                ej[tr] @ w, yj[tr]).mean()

        loss, grads = jax.value_and_grad(loss_fn)(w)
        updates, pstate = popt.update(grads, pstate)
        return optax.apply_updates(w, updates), pstate

    for _ in range(200):
        w, pstate = probe_step(w, pstate)
    return float(((ej[te] @ w).argmax(-1) == yj[te]).mean())


def test_linear_probe():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, 240)
    e = (np.eye(4)[y] @ rng.normal(size=(4, 8)) * 0.7
         + rng.normal(size=(240, 8))).astype(np.float32)
    got = port("node2vec/train.py").linear_probe(torch.as_tensor(e), y, 4)
    assert abs(got - _ref_probe(e, y, 8)) <= 1e-6
    assert got > 0.4


def test_nn_agreement():
    """``examples/deepwalk/train.py:115-122``."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, 300)
    emb = (np.eye(4)[labels] + 0.8 * rng.normal(size=(300, 4))).astype(
        np.float32)
    e = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    sample = np.random.default_rng(0).choice(300, 100, replace=False)
    sims = e[sample] @ e.T
    np.put_along_axis(sims, sample[:, None], -np.inf, axis=1)
    want = (labels[sims.argmax(1)] == labels[sample]).mean()
    got = port("deepwalk/train.py").nn_agreement(emb, labels, 100)
    assert abs(got - want) <= 1e-6


# -- one optimiser step -------------------------------------------------------

def _close_step(module, opt, loss, want_loss, grads, want_params):
    """The loss, its gradients (``close_grads``), and the optimiser: torch's
    step on the reference's own gradients against optax's, so that the
    float32 noise of two gradient sums (which Adam's first step divides by
    their size) does not stand in for a difference of the optimisers."""
    close(loss, want_loss)
    loss.backward()
    close_grads(module, grads)
    g = flax_to_state_dict(numpy_tree(grads), "cpu")
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.grad.copy_(g[name])
    opt.step()
    want = flax_to_state_dict(numpy_tree(want_params), "cpu")
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        close(got[k], want[k])


def test_citation_gcn_step():
    """``examples/citation_benchmark/train.py:98-116`` with dropout off:
    the loss at the reference's initial parameters and the parameters
    after one adamw step."""
    from pgl_tpu.models import GCN as JGCN
    r, p = ref("citation_benchmark/train.py"), \
        port("citation_benchmark/train.py")
    args = argparse.Namespace(data_path=None, dataset="cora")
    jg, feat, y, train_idx, _, _, ncls = r.load_data(args)
    tg = p.load_data(args)[0]
    gt, x, yj = jg.tensor(), jnp.asarray(feat), jnp.asarray(y)
    model = JGCN(input_size=x.shape[1], num_class=ncls, hidden_size=16)
    params = jax.jit(model.init)(jax.random.key(0), gt, x)
    opt = optax.adamw(0.01, weight_decay=5e-4)

    @jax.jit
    def step(params):
        def loss_fn(pp):
            logits = model.apply(pp, gt, x, training=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[train_idx], yj[train_idx]).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates), loss, grads

    want_params, want_loss, grads = step(params)
    tmodel = p.MODELS["GCN"](x.shape[1], ncls, device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(numpy_tree(params), "cpu"))
    topt = p.make_optimizer(tmodel, 0.01, 5e-4)
    loss = p.train_loss(tmodel, tg.tensor("cpu"), torch.as_tensor(feat),
                        torch.as_tensor(y).long(),
                        torch.as_tensor(train_idx), training=False)
    _close_step(tmodel, topt, loss, want_loss, grads, want_params)


def test_ogb_unimp_step():
    """``examples/ogb/train.py:70-98`` (UniMP, all train labels fed) with
    dropout off, on the 20,000-node stand-in: the loss and one adamw
    step."""
    from pgl_tpu.models import UniMP as JUniMP
    r, p = ref("ogb/train.py"), port("ogb/train.py")
    jg, feat, y, train_idx, _, _, ncls = r.load_data(False)
    tg = p.load_data(False)[0]
    gt, x, yj = jg.tensor(), jnp.asarray(feat), jnp.asarray(y)
    train_mask = jnp.zeros(gt.num_nodes, bool).at[train_idx].set(True)
    model = JUniMP(input_size=x.shape[1], num_class=ncls, num_layers=2,
                   hidden_size=128 // 2, num_heads=2, dropout=0.1)
    params = jax.jit(model.init)(jax.random.key(0), gt, x, yj, train_mask)
    opt = optax.adamw(5e-3, weight_decay=1e-4)

    @jax.jit
    def step(params):
        def loss_fn(pp):
            logits = model.apply(pp, gt, x, yj, train_mask, training=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[train_idx], yj[train_idx]).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates), loss, grads

    want_params, want_loss, grads = step(params)
    tmodel = p.build_model("UniMP", x.shape[1], ncls, 128, "cpu")
    tmodel.load_state_dict(flax_to_state_dict(numpy_tree(params), "cpu"))
    topt = torch.optim.AdamW(tmodel.parameters(), lr=5e-3,
                             weight_decay=1e-4)
    tmask = torch.as_tensor(np.asarray(train_mask))
    loss = p.train_loss(tmodel, tg.tensor("cpu"), torch.as_tensor(feat),
                        torch.as_tensor(y).long(),
                        torch.as_tensor(train_idx), tmask, training=False)
    _close_step(tmodel, topt, loss, want_loss, grads, want_params)


def test_lightgcn_bpr_step():
    """``examples/lightgcn/train.py:70-101``: the BPR loss at the
    reference's initial embeddings and the embeddings after one adam step,
    the same negatives fed to both (the step on the reference's gradients,
    as ``_close_step``)."""
    from pgl_tpu import Graph as JGraph
    from pgl_tpu.nn import LightGCNConv as JLightGCNConv
    from pgl_tpu_torch.nn import LightGCNConv
    r, p = ref("lightgcn/train.py"), port("lightgcn/train.py")
    U, I, layers = 120, 150, 3
    pairs, _, _ = r.make_interactions(U, I, 6, 4, seed=0)
    src, dst = pairs[:, 0], pairs[:, 1] + U
    gt = JGraph(np.stack([np.concatenate([src, dst]),
                          np.concatenate([dst, src])], 1),
                num_nodes=U + I).tensor()
    train_pairs, _ = p.split_pairs(pairs)
    conv = JLightGCNConv()
    emb0 = jax.random.normal(jax.random.key(0), (U + I, 16)) * 0.1
    tr_u = jnp.asarray(train_pairs[:, 0])
    tr_i = jnp.asarray(train_pairs[:, 1] + U)
    neg = np.random.default_rng(3).integers(U, U + I, len(train_pairs))
    opt = optax.adam(5e-2)

    def propagate(emb):
        outs, h = [emb], emb
        for _ in range(layers):
            h = conv.apply({}, gt, h)
            outs.append(h)
        return jnp.mean(jnp.stack(outs), 0)

    def loss_fn(e):
        h = propagate(e)
        pos = jnp.sum(h[tr_u] * h[tr_i], -1)
        ngs = jnp.sum(h[tr_u] * h[neg], -1)
        bpr = -jax.nn.log_sigmoid(pos - ngs).mean()
        reg = 1e-4 * (e[tr_u] ** 2 + e[tr_i] ** 2 + e[neg] ** 2).sum(
            -1).mean()
        return bpr + reg

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(emb0)
    updates, _ = opt.update(grads, opt.init(emb0))
    want_emb = optax.apply_updates(emb0, updates)

    emb = torch.tensor(np.asarray(emb0), requires_grad=True)
    topt = torch.optim.Adam([emb], lr=5e-2)
    loss = p.bpr_loss(LightGCNConv(), emb,
                      p.interaction_graph(pairs, U, I).tensor("cpu"),
                      layers, torch.as_tensor(np.asarray(tr_u)).long(),
                      torch.as_tensor(np.asarray(tr_i)).long(),
                      torch.as_tensor(neg))
    close(loss, want_loss)
    loss.backward()
    close(emb.grad, grads)
    with torch.no_grad():
        emb.grad.copy_(torch.as_tensor(np.asarray(grads)))
    topt.step()
    close(emb, want_emb)
