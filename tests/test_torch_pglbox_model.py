"""Port parity for the PGLBox model stack (``pgl_tpu_torch/apps/
pglbox_model.py``) against ``pgl_tpu/apps/pglbox_model.py``.

Each test of ``tests/test_pglbox_model.py`` runs on both packages: the
reference's flax modules are initialised, their parameters carried to the
port (``utils.convert``), and both run on the same numpy inputs and on the
reference's sampled blocks (``HeteroNeighborSampler`` under a
``jax.random`` key, its arrays handed to the port). Forward and every
gradient agree to 1e-5 (rtol and atol: float32 reductions in another
order). The in-batch loss takes the reference's permutations. The
end-to-end clustering run trains the port alone, with its own sampler and
draws, and holds it to the reference's criteria.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack
pytest.importorskip("flax")

from pgl_tpu import HeterGraph as JHeterGraph
from pgl_tpu.apps import pglbox_model as jpm
from pgl_tpu.sampling import HeteroNeighborSampler as JSampler
from pgl_tpu_torch import HeterGraph
from pgl_tpu_torch.apps import pglbox_model as tpm
from pgl_tpu_torch.sampling import HeteroNeighborSampler
from pgl_tpu_torch.utils.convert import (flax_to_state_dict,
                                         load_pglbox_model_params)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _hetero_edges(seed=0, n_u=50, n_i=80, per_u=6, C=3):
    """The reference test's clustered user-item graph: (edges by type,
    num nodes, pairs, node clusters, C)."""
    rng = np.random.default_rng(seed)
    ucl = rng.integers(0, C, n_u)
    icl = rng.integers(0, C, n_i)
    pairs = []
    for u in range(n_u):
        own = np.nonzero(icl == ucl[u])[0]
        for _ in range(per_u):
            i = int(own[rng.integers(len(own))]) if len(own) \
                else int(rng.integers(n_i))
            pairs.append((u, n_u + i))
    pairs = np.asarray(pairs)
    return ({"u2i": pairs, "i2u": pairs[:, ::-1]}, n_u + n_i, pairs,
            np.concatenate([ucl, icl]), C)


def _j_hetero(seed=0, **kw):
    edges, n, pairs, cls, C = _hetero_edges(seed, **kw)
    types = [(i, "u" if i < kw.get("n_u", 50) else "i") for i in range(n)]
    return JHeterGraph(edges, num_nodes=n, node_types=types), pairs, cls, C


def _to_torch(sampled, fin):
    """The reference sampler's blocks as the port's (int32 and bool)."""
    def t(a):
        return torch.as_tensor(np.array(a))
    return ([(t(f), {e: (t(n), t(m)) for e, (n, m) in per.items()})
             for f, per in sampled], t(fin))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _close_grads(module, jgrads):
    """Every parameter gradient of ``module`` equal to the reference's
    (its flax tree, kernels transposed) at ``TOL``."""
    want = flax_to_state_dict(_numpy(jgrads), "cpu")
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


def _block(seed=0, M=7, k=4, D=8):
    rng = np.random.default_rng(seed)
    h_self = rng.normal(size=(M, D)).astype(np.float32)
    h_neigh = rng.normal(size=(M, k, D)).astype(np.float32)
    mask = rng.random((M, k)) < 0.7
    mask[0] = False                       # a zero-degree row
    w = rng.normal(size=(M, D)).astype(np.float32)
    return h_self, h_neigh, mask, w


@pytest.mark.parametrize("kind", tpm.LAYER_TYPES)
def test_relation_layer_matches_reference(kind):
    """Forward, parameter and input gradients of each relation layer
    against the reference's from carried weights; masked neighbours do not
    move the port's output (the reference test's check)."""
    h_self, h_neigh, mask, w = _block()
    D = h_self.shape[1]
    jl = jpm.RelationLayer(kind, D)
    params = jax.jit(jl.init)(jax.random.key(0), h_self, h_neigh, mask)

    @jax.jit
    def forward_and_grad(p, hs, hn):
        out, vjp = jax.vjp(lambda *a: jl.apply(*a, mask), p, hs, hn)
        return out, vjp(jnp.asarray(w))

    want, (gp, gs, gn) = forward_and_grad(params, h_self, h_neigh)

    layer = tpm.RelationLayer(kind, D)
    layer.load_state_dict(flax_to_state_dict(_numpy(params), "cpu"))
    hs = torch.tensor(h_self, requires_grad=True)
    hn = torch.tensor(h_neigh, requires_grad=True)
    m = torch.as_tensor(mask)
    out = layer(hs, hn, m)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    if kind not in ("sage_bow", "lightgcn"):
        _close_grads(layer, gp)
    np.testing.assert_allclose(hs.grad.numpy(), np.asarray(gs), **TOL)
    np.testing.assert_allclose(hn.grad.numpy(), np.asarray(gn), **TOL)

    with torch.no_grad():
        m2 = m.clone()
        m2[1, 3] = False
        big, small = hn.detach().clone(), hn.detach().clone()
        big[1, 3], small[1, 3] = 1e6, -1e6
        np.testing.assert_allclose(layer(hs, big, m2).numpy(),
                                   layer(hs, small, m2).numpy(), atol=1e-4)
        assert np.isfinite(out.detach().numpy()).all()


@pytest.mark.parametrize("mode", ["sum", "gatne"])
def test_interaction_modes(mode):
    """Sum and GATNE attention over three relations, forward and
    gradients, against the reference; gatne's rows stay inside the
    inputs' envelope and a single input passes through."""
    rng = np.random.default_rng(0)
    fs = [rng.normal(size=(5, 8)).astype(np.float32) for _ in range(3)]
    w = rng.normal(size=(5, 8)).astype(np.float32)
    jf = jpm.FeatureInteraction(mode, 8)
    params = jax.jit(jf.init)(jax.random.key(0), fs)

    @jax.jit
    def forward_and_grad(p, f):
        out, vjp = jax.vjp(jf.apply, p, f)
        return out, vjp(jnp.asarray(w))

    want, (gp, gf) = forward_and_grad(params, fs)

    inter = tpm.FeatureInteraction(mode, 8, num_inputs=3)
    inter.load_state_dict(flax_to_state_dict(_numpy(params), "cpu"))
    ts = [torch.tensor(f, requires_grad=True) for f in fs]
    out = inter(ts)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    if mode == "gatne":
        _close_grads(inter, gp)
        stack = np.stack(fs, 1)
        assert (out.detach().numpy() <= stack.max(1) + 1e-5).all()
        assert (out.detach().numpy() >= stack.min(1) - 1e-5).all()
    else:
        np.testing.assert_allclose(out.detach().numpy(), fs[0] + fs[1] + fs[2],
                                   rtol=1e-6)
    for t, g in zip(ts, gf):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)
    one = tpm.FeatureInteraction(mode, 8, num_inputs=1)
    assert not list(one.parameters()) and one([ts[0]]) is ts[0]


def _model_pair(jmodel, port_kwargs, slot_tables, sampled, fin):
    """The reference model's parameters (initialised on its own sample) and
    the port's model carrying them."""
    params = jax.jit(jmodel.init)(jax.random.key(1), slot_tables, sampled,
                                  fin)
    model = tpm.PGLBoxGNNModel(device="cpu", **port_kwargs)
    load_pglbox_model_params(model, _numpy(params))
    return params, model


@functools.lru_cache(maxsize=1)
def _sampled():
    """The reference graph and its sampler's (3, 3) blocks of 32 seeds,
    drawn once: every model test runs on them."""
    jhg, pairs, cls, C = _j_hetero()
    sampler = JSampler(jhg.tensor(), samples=(3, 3))
    return jhg, cls, C, sampler.sample(jnp.arange(32, dtype=jnp.int32),
                                       jax.random.key(0))


def _check_model(jmodel, kwargs, slot_tables, sampled, fin, seed=3):
    """Forward and every parameter gradient of ``sum(out * w)``, the port
    against the reference on the reference's blocks."""
    params, model = _model_pair(jmodel, kwargs, slot_tables, sampled, fin)
    w = np.random.default_rng(seed).normal(size=(32, kwargs["emb_size"])
                                           ).astype(np.float32)

    # one program (eager flax compiles every operation of each new model)
    @jax.jit
    def forward_and_grad(p, st, sm, fn):
        out, vjp = jax.vjp(lambda q: jmodel.apply(q, st, sm, fn), p)
        return out, vjp(jnp.asarray(w))[0]

    want, gp = forward_and_grad(params, slot_tables, sampled, fin)
    tsampled, tfin = _to_torch(sampled, fin)
    tslots = {k: torch.as_tensor(np.asarray(v))
              for k, v in slot_tables.items()}
    out = model(tslots, tsampled, tfin)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    _close_grads(model, gp)
    return params, model, out.detach(), tslots, tsampled, tfin


@pytest.mark.parametrize("layer_type,interact", [
    ("sage_mean", "sum"), ("sage_bow", "gatne"), ("sage_max", "sum"),
    ("gin", "gatne"), ("gat", "sum"), ("lightgcn", "gatne")])
def test_model_forward_all_types(layer_type, interact):
    """Two hetero layers over the reference's (3, 3) samples of 32 seeds
    at every layer type, each interaction mode at three: the port's output
    and gradients equal the reference's, finite, [32, 16]."""
    jhg, cls, C, sample = _sampled()
    kw = dict(num_nodes=jhg.num_nodes, emb_size=16, etypes=jhg.edge_types,
              num_layers=2, layer_type=layer_type, interact_mode=interact)
    _, _, out, *_ = _check_model(jpm.PGLBoxGNNModel(**kw), kw, {}, *sample)
    assert out.shape == (32, 16) and np.isfinite(out.numpy()).all()


def test_slot_embeddings_change_output():
    """Slot tables and softsign, against the reference; flipping the slot
    values changes the port's output, and the slot table is a parameter
    named as flax names it."""
    jhg, cls, C, sample = _sampled()
    slot_tables = {"cls": jnp.asarray(cls.astype(np.int32))}
    kw = dict(num_nodes=jhg.num_nodes, emb_size=16, etypes=jhg.edge_types,
              num_layers=2, slot_sizes={"cls": C}, softsign=True)
    params, model, out1, _, tsampled, tfin = _check_model(
        jpm.PGLBoxGNNModel(**kw), kw, slot_tables, *sample)
    flipped = {"cls": torch.as_tensor(((cls + 1) % C).astype(np.int32))}
    with torch.no_grad():
        out2 = model(flipped, tsampled, tfin)
    assert not np.allclose(out1.numpy(), out2.numpy())
    assert "slot_cls" in params["params"]
    assert "slot_cls" in dict(model.named_parameters())


def test_residual_alpha_one_freezes_gnn():
    """alpha_residual=1.0 means the output IS the initial embedding — the
    heter residual contract (auto_heter_gnn.py:161-165) — in both."""
    jhg, cls, C, sample = _sampled()
    kw = dict(num_nodes=jhg.num_nodes, emb_size=16, etypes=jhg.edge_types,
              num_layers=2, alpha_residual=1.0)
    params, model, out, *_ = _check_model(jpm.PGLBoxGNNModel(**kw), kw, {},
                                          *sample)
    np.testing.assert_allclose(out.numpy(),
                               model.id_emb.detach()[:32].numpy(), rtol=1e-5)


def _reference_perms(key, B, neg_num):
    """The permutations ``inbatch_negative_loss`` draws from ``key``."""
    perms = []
    for _ in range(neg_num):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, B)))
    return perms


def test_inbatch_negative_loss_matches_reference():
    """Fed the reference's permutations, the loss and its gradients equal
    the reference's; aligned pairs score below shuffled ones with the
    port's own draws."""
    rng = np.random.default_rng(0)
    src = rng.normal(size=(8, 6)).astype(np.float32)
    dst = rng.normal(size=(8, 6)).astype(np.float32)
    key = jax.random.key(7)
    want, (gs, gd) = jax.jit(jax.value_and_grad(
        lambda s, d: jpm.inbatch_negative_loss(s, d, key, 4),
        argnums=(0, 1)))(src, dst)
    s = torch.tensor(src, requires_grad=True)
    d = torch.tensor(dst, requires_grad=True)
    got = tpm.inbatch_negative_loss(s, d, neg_num=4,
                                    perms=_reference_perms(key, 8, 4))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), **TOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd), **TOL)

    e = torch.eye(8) * 3
    gen = torch.Generator().manual_seed(0)
    aligned = float(tpm.inbatch_negative_loss(e, e, gen, 4))
    shuffled = float(tpm.inbatch_negative_loss(
        e, e[torch.as_tensor(rng.permutation(8))],
        torch.Generator().manual_seed(0), 4))
    assert aligned < shuffled


def test_end_to_end_training_separates_clusters():
    """The reference test's run on the port alone (its sampler and
    permutations from torch generators, Adam at 2e-2): the loss of the
    last 10 of 80 steps below 0.7 of the first 10, and the learned user
    embeddings' nearest neighbours share their cluster (> 0.6)."""
    edges, n, pairs, cls, C = _hetero_edges(per_u=8)
    n_u, B = 50, 128
    hg = HeterGraph(edges, num_nodes=n)
    sampler = HeteroNeighborSampler(hg, samples=(4, 4), device="cpu")
    model = tpm.PGLBoxGNNModel(
        num_nodes=n, emb_size=16, etypes=hg.edge_types, num_layers=2,
        layer_type="sage_mean", interact_mode="gatne",
        generator=torch.Generator().manual_seed(1), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=2e-2)
    gen = torch.Generator().manual_seed(2)
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(80):
        b = rng.integers(0, len(pairs), B)
        nodes = torch.as_tensor(np.concatenate([pairs[b, 0], pairs[b, 1]])
                                .astype(np.int32))
        sampled, fin = sampler.sample(nodes, gen)
        emb = model({}, sampled, fin)
        loss = tpm.inbatch_negative_loss(emb[:B], emb[B:], gen, neg_num=4)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.7, losses
    emb = model.id_emb.detach().numpy()[:n_u]
    sim = emb @ emb.T
    np.fill_diagonal(sim, -np.inf)
    ucl = cls[:n_u]
    agree = float((ucl[sim.argmax(1)] == ucl).mean())
    assert agree > 0.6, agree
