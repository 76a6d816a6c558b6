"""Port parity for Graph4Rec (``pgl_tpu_torch.apps.graph4rec``) and the
config system (``pgl_tpu_torch.utils.config``): the Graph4Rec cases of the
reference's ``tests/test_apps.py`` on the port, and each of the ten
presets against the reference from the same weights
(``utils.convert.load_graph4rec_params``), batch and draws.

The port draws from a ``torch.Generator``, the reference from
``jax.random``; each step is a function of its draws (the neighbour
uniforms, then the negatives' permutation), so the tests make the
reference's draws from its key chain (``seed + 17``, split a batch, then
into the encoder's key and the loss's) and feed them to the port
(``Graph4RecTrainer.loss``, or ``_draws`` patched for a whole epoch).
Walks and pairs come from both packages' host kernels and are equal.

Tolerance: the loss at 1e-5 relative; gradients at 1e-5 relative with an
absolute floor of 1e-5 of the largest (float32 sums in another order).
Tables after one optimizer step at 1e-5 relative with an absolute floor of
1e-4 of the learning rate, after an epoch's steps 1e-3 of it: Adam moves
an element by about ``lr · g / (|g| + 1e-8)`` (adagrad by ``lr · g /
√(Σg² + 1e-10)``), which turns the rounding of a gradient near 1e-8 into a
visible share of ``lr``, and the steps carry it on.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pgl_tpu
import pgl_tpu_torch
from pgl_tpu.apps import graph4rec as jg4r
from pgl_tpu.apps.common import inbatch_skipgram_loss as j_loss
from pgl_tpu.distributed.launch import launch_local_cluster as j_cluster
from pgl_tpu.distributed.ps import start_shard_server as j_shard
from pgl_tpu.utils.config import Config as JConfig
from pgl_tpu_torch.apps.graph4rec import PRESETS, Graph4RecTrainer
from pgl_tpu_torch.distributed.launch import launch_local_cluster
from pgl_tpu_torch.distributed.ps import start_shard_server
from pgl_tpu_torch.utils.config import Config, load_config
from pgl_tpu_torch.utils.convert import load_graph4rec_params

torch.set_num_threads(1)

EGO = ("ego_sage", "lightgcn", "gat", "gin")
SMALL = dict(embed_dim=16, batch_pairs=128, walk_len=6, walks_per_node=1,
             samples=[3], edge_dim=4, att_dim=4)


def _bipartite(pkg, n_u=60, n_i=90, feat_dim=0, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_u, 500)
    dst = n_u + rng.integers(0, n_i, 500)
    node_feat = {}
    if feat_dim:
        node_feat["h"] = rng.normal(size=(n_u + n_i, feat_dim)).astype(
            np.float32)
    return pkg.HeterGraph({"u2i": np.stack([src, dst], 1),
                           "i2u": np.stack([dst, src], 1)},
                          num_nodes=n_u + n_i,
                          node_types=[(i, "u" if i < n_u else "i")
                                      for i in range(n_u + n_i)],
                          node_feat=node_feat)


def _homogeneous(pkg):
    rng = np.random.default_rng(0)
    return pkg.Graph(rng.integers(0, 60, (500, 2)), num_nodes=60)


def _graphs(name):
    """(reference graph, port graph) for a preset."""
    if name in ("deepwalk", "node2vec"):
        return _homogeneous(pgl_tpu), _homogeneous(pgl_tpu_torch)
    feat = 12 if name.endswith("_with_features") else 0
    return (_bipartite(pgl_tpu, feat_dim=feat),
            _bipartite(pgl_tpu_torch, feat_dim=feat))


def _numpy(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _pair(name, seed=0, **over):
    """Both packages' trainers of a preset, the port's carrying the
    reference's weights."""
    jg, tg = _graphs(name)
    cfg = dict(SMALL, **over)
    jtr = jg4r.Graph4RecTrainer.from_preset(name, graph=jg, seed=seed, **cfg)
    ttr = Graph4RecTrainer.from_preset(name, graph=tg, seed=seed,
                                       device="cpu", **cfg)
    load_graph4rec_params(ttr, _numpy(jtr.params))
    return jtr, ttr


def nonzero_ctx(shape, seed=1):
    """A seeded context table, normal · 0.1."""
    return (np.random.default_rng(seed).normal(size=shape) * 0.1).astype(
        np.float32)


def reference_draws(jtr, ps=False):
    """The reference's draws, batch after batch, as the port's ``_draws``
    returns them (its ``train`` splits ``key(seed + 17)`` a batch, then
    the batch key into the encoder's and the loss's; the PS step takes
    the batch key whole)."""
    mtype = jtr.cfg.model_type or "walk_based"
    k = int((jtr.cfg.samples or [5])[0])
    neg = int(jtr.cfg.neg_num or 5)
    state = {"key": jax.random.key(jtr._seed + 17)}

    def uniforms(key, n):
        if mtype == "gatne":
            out = []
            for _ in jtr._etype_csc:
                key, sub = jax.random.split(key)
                out.append(jax.random.uniform(sub, (n, k)))
            return out
        return [jax.random.uniform(key, (n, k))] if mtype in EGO else []

    def draws(n):
        state["key"], sub = jax.random.split(state["key"])
        if ps:
            return [], torch.as_tensor(np.array(
                jax.random.permutation(sub, n * neg)))
        k1, k2 = jax.random.split(sub)
        return ([torch.as_tensor(np.array(u)) for u in uniforms(k1, n)],
                torch.as_tensor(np.array(jax.random.permutation(
                    k2, n * neg))))

    return draws, uniforms


def close(got, want, rtol=1e-5, floor=1e-5, atol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * scale + atol)


def trained_close(got, want, lr=5e-3, steps=1):
    """A table after one optimizer step, or (``steps`` > 1) an epoch's:
    see the module's tolerance."""
    close(got, want, floor=0.0, atol=(1e-4 if steps == 1 else 1e-3) * lr)


# -- the presets against the reference -------------------------------------------

@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_step_equals_reference(name):
    """The first batch (walks, pairs, padding) equal; the loss and every
    parameter's gradient at the reference's draws within 1e-5 (the
    optimizer's steps: :func:`test_epoch_equals_reference`). The context
    table starts at zeros, where the loss reaches the encoder only through
    ``h · ctx`` and every gradient but ctx's is 0: both packages take a
    seeded nonzero ctx, and every gradient compared must be nonzero."""
    jtr, ttr = _pair(name)
    jtr.params["ctx"] = jnp.asarray(nonzero_ctx(jtr.params["ctx"].shape))
    load_graph4rec_params(ttr, _numpy(jtr.params))
    batch = next(ttr.batches(0))
    mode = jtr.cfg.walk_mode or "metapath"
    starts = np.tile(jtr._start_nodes(), int(jtr.cfg.walks_per_node))
    from pgl_tpu.native.graph_kernel import skip_gram_gen_pair
    src, dst = skip_gram_gen_pair(jtr._walks(starts, 0),
                                  int(jtr.cfg.win_size), seed=0)
    bp = int(jtr.cfg.batch_pairs)
    np.testing.assert_array_equal(batch[0][:min(bp, len(src))], src[:bp])
    np.testing.assert_array_equal(batch[1][:min(bp, len(dst))], dst[:bp])
    assert mode == (ttr.cfg.walk_mode or "metapath")
    bs, bd, valid = batch
    draws, uniforms = reference_draws(jtr)
    key = jax.random.split(jax.random.key(17))[1]
    k1, k2 = jax.random.split(key)
    neg = int(jtr.cfg.neg_num)

    @jax.jit
    def ref(p, s, d, v):
        return jax.value_and_grad(lambda q: j_loss(
            jtr._encode(q, s, k1), q["ctx"][d], k2, neg, v))(p)

    want_loss, want_grads = ref(jtr.params, jnp.asarray(bs),
                                jnp.asarray(bd), jnp.asarray(valid))
    us, perm = draws(len(bs))
    loss = ttr.loss(torch.as_tensor(bs), torch.as_tensor(bd),
                    torch.as_tensor(valid), us, perm)
    loss.backward()
    close(loss, want_loss)
    for k, p in ttr.params.items():
        assert np.abs(np.asarray(want_grads[k])).max() > 0, k
        close(p.grad, want_grads[k])


@pytest.mark.parametrize("name", ["metapath2vec", "gatne"])
def test_epoch_equals_reference(name):
    """A whole epoch of ``train`` (every batch, the padded tail,
    ``torch.optim.Adam`` against optax's adam) on the reference's draws:
    the mean loss and the trained tables agree."""
    jtr, ttr = _pair(name)
    ttr._draws, _ = reference_draws(jtr)
    close(ttr.train(epochs=1), jtr.train(epochs=1))
    for k, p in ttr.params.items():
        trained_close(p, jtr.params[k], steps=2)


def test_ps_step_equals_reference():
    """The PS step: both packages' 2-shard tables start equal bit for bit;
    the loss and the pulled rows' gradients at the reference's draws agree
    (the reference pads the unique tables to power-of-two buckets, the
    port does not: the real rows are the same); after the step's pushes
    the tables agree. An epoch is not compared: a pull may overtake the
    previous step's asynchronous push, in either package."""
    jg, tg = _graphs("metapath2vec")
    mine = [start_shard_server(s, 2) for s in range(2)]
    theirs = [j_shard(s, 2) for s in range(2)]
    try:
        jtr = jg4r.Graph4RecTrainer.from_preset(
            "metapath2vec", graph=jg, ps_addresses=[
                f"127.0.0.1:{s.port}" for s in theirs], **SMALL)
        ttr = Graph4RecTrainer.from_preset(
            "metapath2vec", graph=tg, device="cpu", ps_addresses=[
                f"127.0.0.1:{s.port}" for s in mine], **SMALL)
        for t in ("emb", "ctx"):
            np.testing.assert_array_equal(ttr.ps[t].dump(),
                                          jtr.ps[t].dump())
        bs, bd, valid = next(ttr.batches(0))
        u_src, inv_src = np.unique(bs, return_inverse=True)
        u_dst, inv_dst = np.unique(bd, return_inverse=True)
        key = jax.random.split(jax.random.key(17))[1]
        nsp = max(1 << int(np.ceil(np.log2(len(u_src)))), 64)
        ndp = max(1 << int(np.ceil(np.log2(len(u_dst)))), 64)
        er = np.zeros((nsp, 16), np.float32)
        er[:len(u_src)] = jtr.ps["emb"].pull(u_src)
        cr = np.zeros((ndp, 16), np.float32)
        cr[:len(u_dst)] = jtr.ps["ctx"].pull(u_dst)
        want, g_er, g_cr = jtr._jit_step(
            jnp.asarray(er), jnp.asarray(cr), jnp.asarray(inv_src),
            jnp.asarray(inv_dst), jnp.asarray(valid), key)
        ter = torch.as_tensor(ttr.ps["emb"].pull(u_src)).requires_grad_()
        tcr = torch.as_tensor(ttr.ps["ctx"].pull(u_dst)).requires_grad_()
        draws, _ = reference_draws(jtr, ps=True)
        _, perm = draws(len(bs))
        loss = ttr.ps_loss(ter, tcr, torch.as_tensor(inv_src),
                           torch.as_tensor(inv_dst), torch.as_tensor(valid),
                           perm)
        loss.backward()
        close(loss, want)
        close(ter.grad, np.asarray(g_er)[:len(u_src)])
        close(tcr.grad, np.asarray(g_cr)[:len(u_dst)])
        # the step's push (the port's from its own gradients), flushed
        ttr.step(bs, bd, valid, ([], perm))
        jtr.ps["emb"].push(u_src, np.asarray(g_er)[:len(u_src)])
        jtr.ps["ctx"].push(u_dst, np.asarray(g_cr)[:len(u_dst)])
        for t in ("emb", "ctx"):
            ttr.ps[t].flush()
            jtr.ps[t].flush()
            trained_close(ttr.ps[t].dump(), jtr.ps[t].dump())
        np.testing.assert_array_equal(ttr.embeddings(),
                                      ttr.ps["emb"].dump())
        for tr in (ttr, jtr):
            for t in tr.ps.values():
                t.close()
    finally:
        for s in mine + theirs:
            s.stop()


def test_cluster_walks_equal_reference(tmp_path):
    """``metapath2vec`` over a 2-server cluster of each package: the same
    walks through RPC, so the same pairs; one step at the reference's
    draws agrees."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 60, 500)
    dst = 60 + rng.integers(0, 90, 500)
    np.savetxt(tmp_path / "u2i.txt", np.stack([src, dst], 1), fmt="%d",
               delimiter="\t")
    (tmp_path / "nodes.txt").write_text(
        "".join(f"u\t{i}\n" for i in range(60))
        + "".join(f"i\t{60 + i}\n" for i in range(90)))
    cfg = {"etype2files": f"u2i:{tmp_path}/u2i.txt", "symmetry": True,
           "ntype2files": f"u:{tmp_path}/nodes.txt,i:{tmp_path}/nodes.txt"}
    servers, client, _ = launch_local_cluster(cfg, 2)
    jservers, jclient, _ = j_cluster(cfg, 2)
    try:
        jtr = jg4r.Graph4RecTrainer.from_preset(
            "metapath2vec", client=jclient, num_nodes=150, **SMALL)
        ttr = Graph4RecTrainer.from_preset(
            "metapath2vec", client=client, num_nodes=150, device="cpu",
            **SMALL)
        load_graph4rec_params(ttr, _numpy(jtr.params))
        # a client's start nodes are a fresh draw of the servers' (no
        # seed, in both packages): fix them
        starts = np.sort(jtr._start_nodes())
        assert set(starts) <= set(range(60))
        jtr._start_nodes = ttr._start_nodes = lambda: starts
        np.testing.assert_array_equal(ttr._walks(starts, 0),
                                      jtr._walks(starts, 0))
        ttr._draws, _ = reference_draws(jtr)
        close(ttr.train(epochs=1), jtr.train(epochs=1))
        trained_close(ttr.params["emb"], jtr.params["emb"], steps=2)
        with pytest.raises(ValueError, match="metapath"):
            Graph4RecTrainer.from_preset("deepwalk", client=client,
                                         num_nodes=150, device="cpu",
                                         **SMALL).train(epochs=1)
    finally:
        for c in (client, jclient):
            c.stop_server()
        for s in servers + jservers:
            s.stop()


# -- the reference's own cases on the port ----------------------------------------

@pytest.mark.parametrize("model_type", ["walk_based", "ego_sage",
                                        "gat", "gin"])
def test_graph4rec_trainer(model_type):
    hg = _bipartite(pgl_tpu_torch, n_u=80, n_i=120)
    cfg = Config({"model_type": model_type, "metapath": "u2i-i2u",
                  "walk_len": 8, "win_size": 2, "embed_dim": 16,
                  "lr": 0.02, "batch_pairs": 256, "neg_num": 3,
                  "sage_etype": "i2u", "samples": [3]})
    trainer = Graph4RecTrainer(cfg, graph=hg, device="cpu")
    l0 = trainer.train(epochs=1)
    l1 = trainer.train(epochs=3)
    assert l1 < l0
    assert trainer.embeddings().shape == (200, 16)


def test_graph4rec_presets_train():
    g = _homogeneous(pgl_tpu_torch)
    for name in ("deepwalk", "node2vec", "lightgcn"):
        tr = Graph4RecTrainer.from_preset(
            name, graph=g, num_nodes=60, epochs=1, walk_len=6,
            batch_pairs=128, walks_per_node=1, device="cpu")
        loss = tr.train(epochs=1)
        assert np.isfinite(loss)
        assert tr.embeddings().shape == (60, 64)
    assert set(PRESETS) == set(jg4r.PRESETS)
    for name, cfg in PRESETS.items():
        assert cfg == jg4r.PRESETS[name], name


def test_graph4rec_gatne_trainer():
    tr = Graph4RecTrainer.from_preset("gatne", graph=_bipartite(
        pgl_tpu_torch), walk_len=6, batch_pairs=256, walks_per_node=1,
        embed_dim=16, edge_dim=4, att_dim=4, device="cpu")
    l0 = tr.train(epochs=1)
    l1 = tr.train(epochs=3)
    assert np.isfinite(l0) and l1 < l0
    assert tr.params["edge_emb"].shape == (150, 2, 4)


def test_graph4rec_with_features_presets():
    hg = _bipartite(pgl_tpu_torch, feat_dim=12)
    for name in ("graphsage_with_features", "metapath2vec_with_features"):
        tr = Graph4RecTrainer.from_preset(name, graph=hg, walk_len=6,
                                          batch_pairs=256,
                                          walks_per_node=1, embed_dim=16,
                                          samples=[3], device="cpu")
        assert np.isfinite(tr.train(epochs=1))
        assert tr.params["w_feat"].shape == (12, 16)
    with pytest.raises(ValueError, match="node_feat"):
        Graph4RecTrainer.from_preset("graphsage_with_features",
                                     graph=_bipartite(pgl_tpu_torch),
                                     device="cpu")


def test_graph4rec_deepwalk_on_typed_graph():
    rng = np.random.default_rng(0)
    hg = pgl_tpu_torch.HeterGraph({"u2u": rng.integers(0, 40, (200, 2))},
                                  num_nodes=40,
                                  node_types=np.array(["u"] * 40,
                                                      dtype=object))
    tr = Graph4RecTrainer.from_preset("deepwalk", graph=hg, device="cpu")
    l1 = tr.train(epochs=1)
    l2 = tr.train(epochs=3)
    assert l1 > 0 and l2 < l1


def test_guards():
    """The reference's guards: the PS path refuses encoders and
    ``use_node_feat``; gatne refuses relations of 2^31 edges or more; an
    unknown preset, a missing source and a client without ``num_nodes``
    raise; the default device is the card."""
    hg = _bipartite(pgl_tpu_torch, feat_dim=4)
    with pytest.raises(ValueError, match="walk_based"):
        Graph4RecTrainer.from_preset("graphsage", graph=hg, device="cpu",
                                     ps_addresses=["127.0.0.1:1"])
    with pytest.raises(ValueError, match="use_node_feat"):
        Graph4RecTrainer.from_preset("metapath2vec_with_features",
                                     graph=hg, device="cpu",
                                     ps_addresses=["127.0.0.1:1"])
    with pytest.raises(ValueError, match="unknown preset"):
        Graph4RecTrainer.from_preset("nope", graph=hg, device="cpu")
    with pytest.raises(ValueError, match="HeterGraph or a DistGraphClient"):
        Graph4RecTrainer(Config({}), device="cpu")
    with pytest.raises(ValueError, match="num_nodes"):
        Graph4RecTrainer(Config({}), client=object(), device="cpu")

    class Huge:
        num_edges = 2 ** 31

    class Typed:
        edge_types = ["a2b"]
        num_nodes = 4

        def __getitem__(self, etype):
            return Huge()

    with pytest.raises(ValueError, match="int32"):
        Graph4RecTrainer.from_preset("gatne", graph=Typed(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Graph4RecTrainer.from_preset("metapath2vec", graph=hg)


def test_draws_come_from_the_generator():
    """Without injected draws a step draws its uniforms and permutation
    from the trainer's generator: two trainers of one seed take the same
    steps."""
    losses = []
    for _ in range(2):
        tr = Graph4RecTrainer.from_preset("gat", graph=_bipartite(
            pgl_tpu_torch), device="cpu", seed=3, **SMALL)
        losses.append([float(tr.step(*b)) for b in tr.batches(0)])
    assert losses[0] == losses[1]


# -- utils/config --------------------------------------------------------------

def test_config_equals_reference(tmp_path):
    src = {"model": {"hidden": 8, "layers": [1, {"a": 2}]}, "lr": 0.1}
    mine, ref = Config(src), JConfig(src)
    assert mine.to_dict() == ref.to_dict()
    assert mine.model.hidden == 8 and mine.missing is None
    assert mine.model.layers[1].a == 2
    merged = mine.merge({"model": {"hidden": 16}, "epochs": 3})
    assert merged.to_dict() == ref.merge(
        {"model": {"hidden": 16}, "epochs": 3}).to_dict()
    assert mine.model.hidden == 8      # merge copies
    assert mine.override("model.depth.k", 4).to_dict() == ref.override(
        "model.depth.k", 4).to_dict()
    flat = {"model": {"hidden": 8}, "lr": 0.1, "tags": [1, 2]}
    path = tmp_path / "c.yaml"
    Config(flat).save(str(path))
    assert load_config(str(path)).to_dict() == flat
    assert load_config(flat).to_dict() == flat


@pytest.mark.parametrize("name", ["gatne", "gin", "graphsage_with_features"])
def test_load_graph4rec_params_round_trip(name):
    """``load_graph4rec_params``: the reference's tables into the port's
    trainer and back, bit for bit (gatne's ``edge_emb [N, R, de]``
    included), in place (the optimizer keeps its tensors); a missing or
    misshapen table raises."""
    jtr, ttr = _pair(name)
    before = {k: id(p) for k, p in ttr.params.items()}
    assert ttr.opt.param_groups[0]["params"][0] is ttr.params["emb"]
    for k, p in ttr.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(jtr.params[k]))
        assert id(p) == before[k]
    ref = _numpy(jtr.params)
    with pytest.raises(ValueError, match="do not match"):
        load_graph4rec_params(ttr, {k: v for k, v in ref.items()
                                    if k != "emb"})
    ref["emb"] = ref["emb"][:-1]
    with pytest.raises(ValueError, match="shape"):
        load_graph4rec_params(ttr, ref)
