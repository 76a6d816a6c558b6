"""Port parity for the PGLBox side of the out-of-core path on the CPU
against ``pgl_tpu``'s: ``SharedEmbedding`` (inline and async pushes leave
the same files bit for bit, and the reference's), ``build_graph_external``
(the same CSR files), ``inbatch_skipgram_loss`` (fed the reference's
``jax.random`` permutation, to 1e-6), ``DistEmbedding`` (``begin_pass``,
``local_ids`` and ``end_pass`` with the capacity drop, both tiers, and the
resident ``end_pass`` with room to spare), and one pass of
``PGLBoxTrainer`` and ``UnsupervisedGraphTrainer`` on identical host walks
and pairs with the reference's draws (losses to 1e-5; PGLBox's tables to
1e-5, which pins Adam's eps, added to the bias-corrected root in both
``optax.adam`` and ``torch.optim.Adam``), and four passes at the
trainer's defaults, whose losses rise in both (a reference behaviour).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("optax")

from pgl_tpu import Graph as JGraph
from pgl_tpu.apps import pglbox as jpglbox
from pgl_tpu.apps.common import inbatch_skipgram_loss as j_loss
from pgl_tpu.apps.ingest import build_graph_external as j_build
from pgl_tpu.apps.unsupervised import UnsupervisedGraphTrainer as JUnsup
from pgl_tpu.utils.shared_embedding import SharedEmbedding as JShared
from pgl_tpu_torch import Graph
from pgl_tpu_torch.apps.common import (_inbatch_skipgram_loss,
                                       inbatch_skipgram_loss)
from pgl_tpu_torch.apps.ingest import build_graph_external
from pgl_tpu_torch.apps.pglbox import DistEmbedding, DistGraph, PGLBoxTrainer
from pgl_tpu_torch.apps.unsupervised import UnsupervisedGraphTrainer
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.utils.shared_embedding import SharedEmbedding

# one intra-op thread: the test files run in parallel worker processes
torch.set_num_threads(1)

TIERS = ["0", "1"]
TIER_IDS = ["mmap", "resident"]


def tree_bytes(root):
    """Every file under ``root`` by relative path, as bytes."""
    out = {}
    for dp, _, fns in os.walk(root):
        for fn in fns:
            p = os.path.join(dp, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def pushes(seed=0, n=100, dim=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, n, 12), rng.normal(size=(12, dim)).astype(
        np.float32)) for _ in range(6)]


def test_shared_embedding_files_match(tmp_path):
    """The same pushes leave the same weight and moment files inline, through
    the spawned updater, and in the reference's (repeated ids included)."""
    made = {}
    for name, cls, use_async in (("inline", SharedEmbedding, False),
                                 ("async", SharedEmbedding, True),
                                 ("reference", JShared, False)):
        emb = cls(100, 8, str(tmp_path / name), lr=0.5, seed=0)
        if use_async:
            emb.start_async_update()
        for idx, grad in pushes():
            emb.push(idx, grad)
        if use_async:
            emb.finish_async_update()
        emb.flush()
        emb.moment.flush()
        made[name] = tree_bytes(tmp_path / name)
    assert set(made["inline"]) == {"weight.npy", "moment.npy"}
    assert made["inline"] == made["async"] == made["reference"]
    reopened = SharedEmbedding(100, 8, str(tmp_path / "inline"))
    assert reopened.pull([3]).shape == (1, 8)
    with pytest.raises(ValueError, match="requested"):
        SharedEmbedding(100, 4, str(tmp_path / "inline"))


def test_build_graph_external_matches_reference(tmp_path):
    rng = np.random.default_rng(1)
    edges = rng.integers(0, 500, (4000, 2))
    p = tmp_path / "e.txt"
    np.savetxt(p, edges, fmt="%d", delimiter="\t")
    for symmetry in (True, False):
        a = build_graph_external(str(p), str(tmp_path / f"port{symmetry}"),
                                 symmetry=symmetry, chunk_bytes=2048)
        b = j_build(str(p), str(tmp_path / f"ref{symmetry}"),
                    symmetry=symmetry, chunk_bytes=2048)
        got, want = tree_bytes(a), tree_bytes(b)
        assert got == want and "adj_dst/sorted_v.npy" in got
        # the port's Graph reads it memory-mapped, with the in-RAM indexes
        g = Graph.load(a, mmap_mode="r")
        ref = Graph(np.array(g.edges), num_nodes=g.num_nodes)
        np.testing.assert_array_equal(g.adj_dst_index.sorted_eid,
                                      ref.adj_dst_index.sorted_eid)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_inbatch_skipgram_loss_matches_reference(masked, reduce):
    rng = np.random.default_rng(4)
    B, D, neg = 64, 16, 5
    h = rng.normal(size=(B, D)).astype(np.float32)
    ctx = rng.normal(size=(B, D)).astype(np.float32)
    valid = (np.arange(B) < 50).astype(np.float32) if masked else None
    key = jax.random.key(3)
    want = float(j_loss(jnp.asarray(h), jnp.asarray(ctx), key, neg,
                        None if valid is None else jnp.asarray(valid),
                        neg_reduce=reduce))
    perm = torch.as_tensor(np.array(jax.random.permutation(key, B * neg)))
    got = _inbatch_skipgram_loss(
        torch.as_tensor(h), torch.as_tensor(ctx), perm, neg,
        None if valid is None else torch.as_tensor(valid), reduce)
    # 1e-6 of the loss (about 11 here: one float32 ulp is 9.5e-7)
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)
    # the public function draws its permutation from the generator
    a, b = (inbatch_skipgram_loss(torch.as_tensor(h), torch.as_tensor(ctx),
                                  torch.Generator().manual_seed(1), neg,
                                  neg_reduce=reduce) for _ in range(2))
    assert torch.isfinite(a) and float(a) == float(b)


@pytest.mark.parametrize("tier", TIERS, ids=TIER_IDS)
def test_dist_embedding_pass_matches_reference(tier, tmp_path, monkeypatch):
    """``begin_pass`` with the capacity drop (the rarest ids go), the
    local ids, and ``end_pass`` writing back only the trained rows, on
    both tiers (the resident one on the CPU through the override)."""
    monkeypatch.setenv("PGL_TPU_PGLBOX_EMB_RESIDENT", tier)
    ids = np.array([3, 3, 3, 5, 5, 7, 9, 11, 11, 11, 11, 40])
    jemb = jpglbox.DistEmbedding(80, 8, str(tmp_path / "ref"), capacity=4)
    emb = DistEmbedding(80, 8, str(tmp_path / "port"), capacity=4,
                        device="cpu")
    assert emb._resident == jemb._resident == (tier == "1")
    t, jt = emb.begin_pass(ids), jemb.begin_pass(ids)
    assert t.shape == (4, 8)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    q = np.array([3, 5, 7, 9, 11, 40, 999])
    np.testing.assert_array_equal(emb.local_ids(q), jemb.local_ids(q))
    assert (emb.local_ids(q) >= 0).sum() == 4
    with pytest.raises(RuntimeError):
        emb.begin_pass([1])
    emb.end_pass(t * 2 + 1)
    jemb.end_pass(jt * 2 + 1)
    np.testing.assert_array_equal(emb.dump_to_mem(), jemb.dump_to_mem())
    emb.flush_to_store()
    jemb.flush_to_store()
    assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "ref")
    with pytest.raises(RuntimeError):
        emb.end_pass(t)


def test_resident_end_pass_with_room_to_spare(tmp_path, monkeypatch):
    """Resident tier, a capacity of 16 over a working set of 3: only the
    three rows are written back; row 0, which the pad slots read, and
    every other row keep their bits (the reference scatters its pads out
    of bounds, which JAX drops and a CUDA ``index_copy_`` would not)."""
    monkeypatch.setenv("PGL_TPU_PGLBOX_EMB_RESIDENT", "1")
    emb = DistEmbedding(50, 4, str(tmp_path / "e"), capacity=16,
                        device="cpu")
    jemb = jpglbox.DistEmbedding(50, 4, str(tmp_path / "j"), capacity=16)
    before = emb.dump_to_mem().copy()
    t = emb.begin_pass([7, 2, 30])
    np.testing.assert_array_equal(t[3:].numpy(),
                                  np.broadcast_to(before[0], (13, 4)))
    emb.end_pass(t + 10)
    jemb.end_pass(jemb.begin_pass([7, 2, 30]) + 10)
    after = emb.dump_to_mem()
    np.testing.assert_array_equal(after, jemb.dump_to_mem())
    keep = np.setdiff1d(np.arange(50), [2, 7, 30])
    np.testing.assert_array_equal(after[keep], before[keep])
    np.testing.assert_array_equal(after[[2, 7, 30]], before[[2, 7, 30]] + 10)


def small_graph(n=80, seed=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (600, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    return np.concatenate([edges, edges[:, ::-1]]), n


def reference_draws(trainer, seed):
    """Feed ``trainer`` (the port's PGLBox trainer) the reference's
    permutations: one key a pass split from ``key(seed + 7)``, one
    ``permutation`` a step split from the pass key, as
    ``pgl_tpu/apps/pglbox.py`` draws them."""
    state = {"outer": jax.random.key(seed + 7)}
    orig = trainer._train_pass

    def train_pass(pass_id, nodes, generator):
        state["outer"], state["pass"] = jax.random.split(state["outer"])
        return orig(pass_id, nodes, generator)

    def draw(generator, n):
        state["pass"], sub = jax.random.split(state["pass"])
        return torch.as_tensor(np.array(jax.random.permutation(sub, n)))

    trainer._train_pass, trainer._draw = train_pass, draw


@pytest.mark.parametrize("tier", TIERS, ids=TIER_IDS)
def test_pglbox_pass_matches_reference(tier, tmp_path, monkeypatch):
    monkeypatch.setenv("PGL_TPU_PGLBOX_EMB_RESIDENT", tier)
    edges, n = small_graph()
    cfg = dict(emb_size=8, walk_len=6, win_size=2, pass_nodes=n, epochs=1,
               batch_pairs=256, lr=0.1)
    jdg = jpglbox.DistGraph.from_graph(JGraph(edges, num_nodes=n),
                                       str(tmp_path / "jg"))
    jtr = jpglbox.PGLBoxTrainer(jdg, str(tmp_path / "jemb"), config=cfg)
    dg = DistGraph.from_graph(Graph(edges, num_nodes=n),
                              str(tmp_path / "g"), device="cpu")
    assert tree_bytes(tmp_path / "g") == tree_bytes(tmp_path / "jg")
    tr = PGLBoxTrainer(dg, str(tmp_path / "emb"), config=cfg, device="cpu")
    np.testing.assert_array_equal(tr.embeddings(), jtr.embeddings())
    reference_draws(tr, 0)
    want = jtr.train()
    got = tr.train()
    assert abs(got - want) < 1e-5
    np.testing.assert_allclose(tr.embeddings(), jtr.embeddings(),
                               rtol=1e-5, atol=1e-5)
    assert tr.timings["steps"] > 0


def test_pglbox_passes_at_the_defaults_follow_the_reference(tmp_path):
    """A reference behaviour at ``PGLBoxTrainer``'s defaults (emb 64, walk
    20, window 5, 5 negatives, 4,096 pairs, 1,024 nodes a pass, lr 0.05
    with a fresh Adam a pass): the pass loss starts at the untrained
    table's ``6 ln 2`` (the initial rows' dot products are near 0) and then
    rises pass by pass. The port fed the reference's draws on the same host
    walks gives the reference's pass losses, 4 passes of a 4,096-node
    community graph, to 1e-3 (float32 rounding carried through Adam from
    pass to pass)."""
    g, _ = community_graph(num_nodes=4096, num_classes=8, feat_dim=4,
                           avg_degree=16, seed=0)
    edges, n = np.asarray(g.edges), 4096
    jdg = jpglbox.DistGraph.from_graph(JGraph(edges, num_nodes=n),
                                       str(tmp_path / "jg"))
    jtr = jpglbox.PGLBoxTrainer(jdg, str(tmp_path / "jemb"))
    key, want = jax.random.key(7), []
    for p, nodes in enumerate(jdg.node_batch_iter(1024, seed=0)):
        key, sub = jax.random.split(key)
        want.append(jtr._train_pass(p, nodes, sub))
    dg = DistGraph.from_graph(Graph(edges, num_nodes=n), str(tmp_path / "g"),
                              device="cpu")
    tr = PGLBoxTrainer(dg, str(tmp_path / "emb"), device="cpu")
    reference_draws(tr, 0)
    got = [tr._train_pass(p, nodes, None) for p, nodes in
           enumerate(dg.node_batch_iter(1024, seed=0))]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    for losses in (want, got):
        assert abs(losses[0] - 6 * np.log(2)) < 0.02
        assert losses[-1] > losses[0]


def test_pglbox_out_of_core(tmp_path):
    """The reference's ``test_pglbox_out_of_core``: edge-file ingestion, the
    mmap'd CSR, pass-based training with write-back, and the infer
    shards equal to the trained table."""
    edges, n = small_graph()
    ef = tmp_path / "edges.txt"
    np.savetxt(ef, edges[:len(edges) // 2], fmt="%d", delimiter="\t")
    dg = DistGraph.from_edge_file(str(ef), str(tmp_path / "g"),
                                  symmetry=True, device="cpu")
    assert dg.num_nodes == n and dg.num_edges == len(edges)
    assert isinstance(dg.graph.adj_src_index.sorted_v, np.memmap)
    assert not dg._use_device_walks()          # the CPU walks on the host
    tr = PGLBoxTrainer(dg, str(tmp_path / "emb"),
                       config=dict(emb_size=8, walk_len=6, win_size=2,
                                   pass_nodes=40, epochs=2,
                                   batch_pairs=256, lr=0.1), device="cpu")
    before = tr.embeddings().copy()
    assert np.isfinite(tr.train())
    after = tr.embeddings()
    assert not np.allclose(before, after)
    shards = tr.infer(str(tmp_path / "infer"), batch_nodes=32)
    assert shards == -(-n // 32)
    got = np.concatenate([
        np.load(tmp_path / "infer" / f"part-{i:05d}.npz")["emb"]
        for i in range(shards)])
    np.testing.assert_array_equal(got, after)


def test_pglbox_resident_tier_persists(tmp_path, monkeypatch):
    """The reference's test: the resident tier (forced on the CPU) persists
    training to the mmap store, which a reopened table sees."""
    monkeypatch.setenv("PGL_TPU_PGLBOX_EMB_RESIDENT", "1")
    edges, n = small_graph(60, seed=1)
    dg = DistGraph.from_graph(Graph(edges, num_nodes=n), str(tmp_path / "g"),
                              device="cpu")
    tr = PGLBoxTrainer(dg, str(tmp_path / "emb"),
                       config=dict(emb_size=8, walk_len=6, win_size=2,
                                   pass_nodes=30, epochs=1,
                                   batch_pairs=256, lr=0.1), device="cpu")
    assert tr.embedding._resident
    before = np.array(np.load(tmp_path / "emb" / "weight.npy",
                              mmap_mode="r"))
    tr.train()
    after = tr.embeddings()
    assert not np.allclose(before, after)
    reopened = SharedEmbedding(n, 8, str(tmp_path / "emb"), lr=0.1)
    np.testing.assert_array_equal(np.asarray(reopened.weight), after)


@pytest.mark.parametrize("neighbor_samples", [None, 4])
def test_unsupervised_pass_matches_reference(neighbor_samples):
    """One pass (every node a walk, ``seed`` 0) on the reference's host
    walks and pairs, with its initial tables and its draws (one key a step
    from ``key(seed + 7)``, split into the sampler's uniforms and the
    negatives' permutation)."""
    g, _ = community_graph(num_nodes=120, num_classes=3, feat_dim=1,
                           avg_degree=6, seed=1)
    edges = np.asarray(g.edges)
    kw = dict(embed_dim=16, neighbor_samples=neighbor_samples,
              pair_batch=512, lr=2e-2)
    jtr = JUnsup(JGraph(edges, num_nodes=120), **kw)
    tr = UnsupervisedGraphTrainer(Graph(edges, num_nodes=120), device="cpu",
                                  **kw)
    assert set(tr.params) == set(jtr.params)
    with torch.no_grad():
        for k, p in tr.params.items():
            p.copy_(torch.as_tensor(np.array(jtr.params[k])))
    state = {"key": jax.random.key(7)}

    def draws(generator, n):
        state["key"], sub = jax.random.split(state["key"])
        k1, k2 = jax.random.split(sub)
        u = None
        if neighbor_samples:
            u = torch.as_tensor(np.array(
                jax.random.uniform(k1, (n, neighbor_samples))))
        return u, torch.as_tensor(np.array(
            jax.random.permutation(k2, n * 5)))

    tr._draws = draws
    want = jtr.train(epochs=1, walk_len=8, batch_nodes=120)
    got = tr.train(epochs=1, walk_len=8, batch_nodes=120)
    assert abs(got - want) < 1e-5
    # Adam divides each element's gradient by its root mean square, so an
    # element whose gradient terms nearly cancel carries their float32
    # rounding into its step at full size (lr 2e-2): the tables are held
    # to 1e-3, a twentieth of one step
    np.testing.assert_allclose(tr.embeddings(), jtr.embeddings(),
                               rtol=0, atol=1e-3)


def test_entry_points_need_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    edges, n = small_graph()
    Graph(edges, num_nodes=n).dump(str(tmp_path / "g"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistGraph(str(tmp_path / "g"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistEmbedding(10, 4, str(tmp_path / "e"), capacity=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UnsupervisedGraphTrainer(Graph(edges, num_nodes=n))
