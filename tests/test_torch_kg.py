"""Port parity for the KG embedding models (``pgl_tpu_torch.models.kg``):
the reference's ``tests/test_kg.py`` case by case on the port, the ``kg``
trajectory golden (``tests/test_trajectory_goldens.py:97``), and the port
against the reference on the same inputs: ``KGEModel``'s initial tables
and ``sample_negatives``' draws equal bit for bit; the six scores, the
loss and its gradients in the three negative modes (and with corrupted
heads), ``predict_all_tails``, ``filtered_ranks`` and ``mrr_hits``.

The reference's side of the loss runs as one ``jax.jit`` program over
every case (eager, each case takes a second here). Tolerance: 1e-5
relative, gradients with an absolute floor of 1e-5 of the largest
(float32 sums in another order); ranks exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgl_tpu.models import kg as jkg
from pgl_tpu_torch.models.kg import (ComplExScore, DistMultScore, KGEModel,
                                     OTEScore, QuatEScore, RotatEScore,
                                     TransEScore, filtered_ranks, mrr_hits,
                                     sample_negatives, sharded_kg_params)
from pgl_tpu_torch.utils.convert import load_kge_params

torch.set_num_threads(1)

SCORES = ("transe", "distmult", "complex", "rotate", "quate", "ote")
MODES = ("batch", "full", "chunk")
D = 32
rng = np.random.default_rng(0)
H = rng.normal(size=(5, D)).astype(np.float32)
T = rng.normal(size=(5, D)).astype(np.float32)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, rtol=1e-5, floor=1e-5):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * scale)


def _rel_dim(score, d):
    """OTE's relations hold its 4 blocks of (d/4)² (the others' default)."""
    return 4 * (d // 4) ** 2 if score == "ote" else None


def _score_pairs():
    return [(TransEScore(12.0), jkg.TransEScore(12.0), D),
            (DistMultScore(), jkg.DistMultScore(), D),
            (ComplExScore(), jkg.ComplExScore(), D),
            (RotatEScore(12.0, D), jkg.RotatEScore(12.0, D), D // 2),
            (QuatEScore(), jkg.QuatEScore(), D),
            (OTEScore(12.0, 4), jkg.OTEScore(12.0, 4), 4 * 8 * 8)]


@pytest.mark.parametrize("i", range(6))
def test_score_shapes_and_values(i):
    """Shapes as the reference's test pins them, and the values of the
    score and of ``neg_score`` (corrupted tails and heads) equal to the
    reference's within 1e-5."""
    score, jscore, rel_dim = _score_pairs()[i]
    R = np.random.default_rng(i).normal(size=(5, rel_dim)).astype(
        np.float32)
    cand = np.random.default_rng(10 + i).normal(size=(7, D)).astype(
        np.float32)
    h, r, t, c = map(torch.as_tensor, (H, R, T, cand))
    s = score(h, r, t)
    assert s.shape == (5,) and torch.isfinite(s).all()
    want = jax.jit(lambda *a: (jscore(*a[:3]), jscore.neg_score(*a),
                               jscore.neg_score(*a, neg_head=True)))(
        *map(jnp.asarray, (H, R, T, cand)))
    close(s, want[0])
    for neg_head in (False, True):
        ns = score.neg_score(h, r, t, c, neg_head=neg_head)
        assert ns.shape == (5, 7)
        close(ns, want[1 + neg_head])


def test_transe_identity():
    score = TransEScore(12.0)
    h = torch.ones((1, D))
    r = torch.full((1, D), 0.5)
    assert float(score(h, r, h + r)[0]) == pytest.approx(12.0)


def test_rotate_identity():
    score = RotatEScore(12.0, D)
    h = torch.as_tensor(rng.normal(size=(1, D)).astype(np.float32))
    r = torch.zeros((1, D // 2))  # zero phase = identity rotation
    assert float(score(h, r, h)[0]) == pytest.approx(12.0, abs=1e-3)


def test_ote_orthogonality_preserves_norm():
    """The QR's Q is orthonormal and equals ``jnp.linalg.qr``'s (both
    Householder)."""
    score = OTEScore(12.0, 4)
    h = rng.normal(size=(3, D)).astype(np.float32)
    r = rng.normal(size=(3, 4 * 8 * 8)).astype(np.float32)
    q = score._orthonormal(torch.as_tensor(r), 8)
    hb = h.reshape(3, 4, 8)
    out = torch.einsum("bij,bj->bi", q[:, 0], torch.as_tensor(hb[:, 0]))
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1),
                               np.linalg.norm(hb[:, 0], axis=-1),
                               rtol=1e-4)
    close(q, jkg.OTEScore(12.0, 4)._orthonormal(jnp.asarray(r), 8))


@pytest.mark.parametrize("score", SCORES)
def test_initial_tables_equal_reference(score):
    """``default_rng(seed)``'s entity then relation draw, bit for bit, at
    each score's relation width."""
    mine = KGEModel(40, 6, 16, score=score, seed=5, device="cpu",
                    rel_dim=_rel_dim(score, 16))
    ref = jkg.KGEModel(40, 6, 16, score=score, seed=5,
                       rel_dim=_rel_dim(score, 16))
    for k in ("ent", "rel"):
        np.testing.assert_array_equal(mine.params[k].detach().numpy(),
                                      np.asarray(ref.params[k]))
        assert mine.params[k].requires_grad


def test_sample_negatives_equal_reference():
    """The three modes from generators in the same state: the same ids."""
    h = rng.integers(0, 50, 8)
    t = rng.integers(0, 50, 8)
    for mode, kw in (("batch", {}), ("full", {}), ("chunk",
                                                   {"num_chunks": 2})):
        a = sample_negatives(h, t, 50, mode, 6, np.random.default_rng(3),
                             **kw)
        b = jkg.sample_negatives(h, t, 50, mode, 6,
                                 np.random.default_rng(3), **kw)
        np.testing.assert_array_equal(a, b)
    # ids given as tensors are read back first
    a = sample_negatives(torch.as_tensor(h), torch.as_tensor(t), 50,
                         "batch", 6, np.random.default_rng(3))
    np.testing.assert_array_equal(a, jkg.sample_negatives(
        h, t, 50, "batch", 6, np.random.default_rng(3)))
    with pytest.raises(ValueError, match="not supported"):
        sample_negatives(h, t, 50, "nope", 6, np.random.default_rng(0))


def _loss_cases():
    """(score, mode, neg_head) with their inputs: 6 scores x 3 modes, and
    head corruption on two."""
    cases = []
    for i, score in enumerate(SCORES):
        for mode in MODES:
            cases.append((score, mode, False))
    cases += [("transe", "full", True), ("ote", "chunk", True)]
    out = []
    for i, (score, mode, neg_head) in enumerate(cases):
        g = np.random.default_rng(100 + i)
        B = 8
        h = g.integers(0, 40, B)
        r = g.integers(0, 6, B)
        t = g.integers(0, 40, B)
        neg = sample_negatives(h, t, 40, mode, 6, g, num_chunks=2)
        out.append((score, mode, neg_head, h, r, t, neg))
    return out


@pytest.fixture(scope="module")
def loss_runs():
    """Every case's reference loss and gradients, one jitted program."""
    cases = _loss_cases()
    models = {s: jkg.KGEModel(40, 6, 16, score=s, seed=1,
                              rel_dim=_rel_dim(s, 16)) for s in SCORES}

    @jax.jit
    def run(params):
        out = []
        for (score, mode, neg_head, h, r, t, neg), p in zip(cases, params):
            out.append(jax.value_and_grad(models[score].loss_fn)(
                p, h, r, t, jnp.asarray(neg), neg_head))
        return out

    return cases, models, run([models[c[0]].params for c in cases])


@pytest.mark.parametrize("i", range(len(_loss_cases())))
def test_loss_and_grads_equal_reference(loss_runs, i):
    cases, models, results = loss_runs
    score, mode, neg_head, h, r, t, neg = cases[i]
    model = KGEModel(40, 6, 16, score=score, seed=1, device="cpu",
                     rel_dim=_rel_dim(score, 16))
    load_kge_params(model, {k: np.asarray(v) for k, v in
                            models[score].params.items()})
    loss = model.loss_fn(model.params, *map(torch.as_tensor, (h, r, t,
                                                                neg)),
                         neg_head=neg_head)
    loss.backward()
    want_loss, want_grads = results[i]
    close(loss, want_loss)
    for k in ("ent", "rel"):
        close(model.params[k].grad, want_grads[k])


@pytest.mark.parametrize("score", SCORES)
def test_predict_and_ranks_equal_reference(score):
    """``predict_all_tails``, filtered ranks (with known positives masked)
    and ``mrr_hits`` against the reference's on one model."""
    ref = jkg.KGEModel(60, 5, 16, score=score, seed=2,
                       rel_dim=_rel_dim(score, 16))
    model = KGEModel(60, 5, 16, score=score, seed=2, device="cpu",
                     rel_dim=_rel_dim(score, 16))
    g = np.random.default_rng(7)
    h, r, t = g.integers(0, 60, 20), g.integers(0, 5, 20), g.integers(
        0, 60, 20)
    mask = g.random((20, 60)) < 0.1
    got = model.predict_all_tails(model.params, torch.as_tensor(h),
                                  torch.as_tensor(r))
    want = jax.jit(ref.predict_all_tails)(ref.params, jnp.asarray(h),
                                          jnp.asarray(r))
    close(got, want)
    # ranks of the reference's own scores through both packages
    for m in (None, mask):
        ranks = filtered_ranks(torch.as_tensor(np.asarray(want)), t, m)
        jranks = jkg.filtered_ranks(want, jnp.asarray(t),
                                    None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))
        assert mrr_hits(ranks) == jkg.mrr_hits(jranks)


TINY = np.array([(i, 0, (i + 1) % 10) for i in range(10)])
TINY_STEPS, TINY_HELD, TINY_SEEDS = 200, 50, 8


def _tiny_reference():
    """The reference's tiny KG (relation 0 maps i -> i+1 mod 10) under
    optax's adam at lr 0.1 on ``key(0)``'s chain of negatives, as its own
    test trains it: ``run(params)`` gives each step's (tables before it,
    negatives, loss, gradients) and the tables after the last."""
    import optax
    ref = jkg.KGEModel(10, 1, 16, score="transe", gamma=4.0, seed=0)
    jopt = optax.adam(1e-1)

    @jax.jit
    def step(params, state, key):
        key, sub = jax.random.split(key)
        neg = jax.random.randint(sub, (8,), 0, 10)
        loss, grads = jax.value_and_grad(ref.loss_fn)(
            params, TINY[:, 0], TINY[:, 1], TINY[:, 2], neg)
        updates, state = jopt.update(grads, state)
        return (optax.apply_updates(params, updates), state, key, neg,
                loss, grads)

    def run(params):
        state, key, steps = jopt.init(params), jax.random.key(0), []
        for _ in range(TINY_STEPS):
            before = params
            params, state, key, neg, loss, grads = step(params, state, key)
            steps.append((before, neg, loss, grads))
        return steps, params

    return ref, run


def _tiny_ranks(model, params):
    t = torch.as_tensor(TINY)
    with torch.no_grad():
        scores = model.predict_all_tails(
            {k: v.detach() if torch.is_tensor(v) else torch.tensor(
                np.asarray(v)) for k, v in params.items()},
            t[:, 0], t[:, 1])
    return filtered_ranks(scores, t[:, 2])


def test_kge_trains_along_the_reference():
    """At each of the 200 steps of the reference's tiny-KG run, the port's
    loss and gradients at the reference's tables and negatives agree
    within 1e-5; the port ranks the reference's trained tables as the
    reference does, with the reference's own bar (MRR > 0.7)."""
    ref, run = _tiny_reference()
    steps, final = run(ref.params)
    model = KGEModel(10, 1, 16, score="transe", gamma=4.0, seed=0,
                     device="cpu")
    t = torch.as_tensor(TINY)
    for before, neg, want, grads in steps:
        params = {k: torch.tensor(np.asarray(v), requires_grad=True)
                  for k, v in before.items()}
        loss = model.loss_fn(params, t[:, 0], t[:, 1], t[:, 2],
                             torch.as_tensor(np.array(neg)))
        loss.backward()
        close(loss, want)
        for k, p in params.items():
            close(p.grad, grads[k])
    ranks = _tiny_ranks(model, final)
    want = filtered_ranks(jnp.asarray(ref.predict_all_tails(
        final, TINY[:, 0], TINY[:, 1])), TINY[:, 2])
    np.testing.assert_array_equal(_np(ranks), np.asarray(want))
    assert mrr_hits(ranks)["mrr"] > 0.7


def test_kge_trains():
    """The reference's tiny-KG case on the port: its own 200 steps under
    ``torch.optim.Adam`` follow the reference's loss at 1e-5 for 50 steps
    and end with every true tail in the top 3. Then the runs part: every
    coordinate of h + r - t of a learnt triple is driven to the L1
    distance's kink at 0, where float32 rounding picks the gradient's
    sign, so the step-200 MRR is a function of rounding (the reference's
    own bar, MRR > 0.7, is held on its own trajectory by
    :func:`test_kge_trains_along_the_reference`). The port's MRR is held
    to the reference's own reach: no lower than the lowest MRR of the
    reference's run from its initial tables perturbed by 1e-6 relative
    (``TINY_SEEDS`` seeds)."""
    ref, run = _tiny_reference()
    steps, _ = run(ref.params)
    model = KGEModel(10, 1, 16, score="transe", gamma=4.0, seed=0,
                     device="cpu")
    opt = torch.optim.Adam(list(model.params.values()), lr=1e-1)
    t = torch.as_tensor(TINY)
    for i, (_, neg, want, _) in enumerate(steps):
        opt.zero_grad()
        loss = model.loss_fn(model.params, t[:, 0], t[:, 1], t[:, 2],
                             torch.as_tensor(np.array(neg)))
        loss.backward()
        opt.step()
        if i < TINY_HELD:
            close(loss, want)
    metrics = mrr_hits(_tiny_ranks(model, model.params))
    reach = []
    for seed in range(TINY_SEEDS):
        g = np.random.default_rng(seed)
        perturbed = {k: jnp.asarray((np.asarray(v) * (1 + 1e-6 * g.normal(
            size=v.shape))).astype(np.float32))
            for k, v in ref.params.items()}
        reach.append(mrr_hits(_tiny_ranks(model, run(perturbed)[1]))["mrr"])
    assert metrics["hits@3"] == 1.0, metrics
    assert metrics["mrr"] >= min(reach), (metrics, reach)


def test_filtered_ranks():
    scores = torch.tensor([[0.9, 0.8, 0.1, 0.95]])
    assert int(filtered_ranks(scores, torch.tensor([1]))[0]) == 3
    mask = torch.tensor([[False, False, False, True]])
    assert int(filtered_ranks(scores, torch.tensor([1]), mask)[0]) == 2


def test_chunked_loss_equals_per_triplet_when_C_is_B():
    g = np.random.default_rng(1)
    B, K = 6, 5
    model = KGEModel(30, 3, 8, score="distmult", adversarial_temp=0.0,
                     device="cpu")
    h, r, t = (torch.as_tensor(g.integers(0, n, B)) for n in (30, 3, 30))
    shared = g.integers(0, 30, (B, K))[0]
    l1 = model.loss_fn(model.params, h, r, t, torch.as_tensor(shared))
    l2 = model.loss_fn(model.params, h, r, t,
                       torch.as_tensor(np.tile(shared, (B, 1))))
    np.testing.assert_allclose(float(l1.detach()), float(l2.detach()),
                               rtol=1e-6)


def test_kg_trajectory_golden():
    """The reference's ``kg`` golden (TransE, 20 optax adagrad steps at lr
    0.1) with ``torch.optim.Adagrad`` (accumulator 0.1, eps 1e-7): the
    stored trajectory at the golden test's tolerance, and the reference's
    own run at 1e-5."""
    import os
    golden = np.load(os.path.join(os.path.dirname(__file__),
                                  "test_trajectory_goldens_data.npz"))["kg"]
    g = np.random.default_rng(11)
    n_ent, n_rel, B = 200, 7, 64
    h = torch.as_tensor(g.integers(0, n_ent, B))
    r = torch.as_tensor(g.integers(0, n_rel, B))
    t = torch.as_tensor(g.integers(0, n_ent, B))
    model = KGEModel(n_ent, n_rel, 32, score="transe", seed=3, device="cpu")
    opt = torch.optim.Adagrad(list(model.params.values()), lr=0.1,
                              initial_accumulator_value=0.1, eps=1e-7)
    losses = []
    for i in range(20):
        neg = torch.as_tensor(
            np.random.default_rng(100 + i).integers(0, n_ent, 32))
        opt.zero_grad()
        loss = model.loss_fn(model.params, h, r, t, neg)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, golden, rtol=2e-3)
    from test_trajectory_goldens import _traj_kg
    np.testing.assert_allclose(losses, _traj_kg(), rtol=1e-5)
    assert losses[-1] < losses[0] * 0.9


@pytest.fixture
def world_of_one():
    import torch_parallel_ranks as ranks
    from pgl_tpu_torch.parallel import comm
    comm.init(backend="gloo",
              init_method=f"tcp://127.0.0.1:{ranks.free_port()}",
              world_size=1, rank=0)
    yield
    torch.distributed.destroy_process_group()


def test_sharded_kg_params_world_of_one(world_of_one):
    """``sharded_kg_params`` puts the entity table in a
    ``ShardedEmbedding`` (the port's rank-a-process form; the reference
    takes a mesh): the same loss, gradients and predictions as the dense
    tables. Several ranks: ``tests/test_torch_parallel.py``."""
    model = KGEModel(30, 4, 8, score="rotate", seed=4, device="cpu")
    sharded = sharded_kg_params(model, device="cpu")
    assert sharded["ent"].table.shape == (30, 8)
    g = np.random.default_rng(5)
    h, r, t = (torch.as_tensor(g.integers(0, n, 8)) for n in (30, 4, 30))
    neg = torch.as_tensor(g.integers(0, 30, (8, 5)))
    want = model.loss_fn(model.params, h, r, t, neg)
    want.backward()
    got = model.loss_fn(sharded, h, r, t, neg)
    got.backward()
    close(got, want)
    close(sharded["ent"].table.grad, model.params["ent"].grad)
    close(sharded["rel"].grad, model.params["rel"].grad)
    with torch.no_grad():
        close(model.predict_all_tails(sharded, h, r),
              model.predict_all_tails(model.params, h, r))


def test_kge_default_device_is_the_card():
    if torch.cuda.is_available():
        assert KGEModel(4, 2, 8).params["ent"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            KGEModel(4, 2, 8)


@pytest.mark.parametrize("score", ["rotate", "ote"])
def test_load_kge_params_round_trip(score):
    """``load_kge_params``: the reference's tables into the port's model
    and back, bit for bit, in place; a misshapen table raises."""
    ref = jkg.KGEModel(30, 4, 16, score=score, seed=9,
                       rel_dim=_rel_dim(score, 16))
    model = KGEModel(30, 4, 16, score=score, seed=0, device="cpu",
                     rel_dim=_rel_dim(score, 16))
    ent = model.params["ent"]
    load_kge_params(model, {k: np.asarray(v) for k, v in
                            ref.params.items()})
    assert model.params["ent"] is ent
    for k in ("ent", "rel"):
        np.testing.assert_array_equal(model.params[k].detach().numpy(),
                                      np.asarray(ref.params[k]))
    with pytest.raises(ValueError, match="shape"):
        load_kge_params(model, {"ent": np.zeros((30, 8)),
                                "rel": np.asarray(ref.params["rel"])})
