"""Port parity for the dedup SpMM module (``pgl_tpu_torch/ops/kernels/
dedup_kernels.py``) and the dedup configuration of the GCN path.

On the CPU the port runs the kernels' plain PyTorch versions. They are held
against ``pgl_tpu/ops/pallas/dedup_kernels.py`` on the same numpy inputs:
the layout array for array, the counts (K4, ``materialize_counts`` in
interpret mode) bit for bit, and the apply (K5 with counts, K6 without;
``_blocked_spmm_dedup`` and ``spmm_dedup`` in interpret mode) forward and
gradient at rtol 1e-5, atol 1e-3: float32 sums taken in another order (the
reference's count-matrix products against ``bmm`` plus ``index_add_``),
as in ``tests/test_torch_segment_kernels.py``; one edge dropped or counted
twice would be off by ~1. The CUDA kernels themselves are held against the
plain versions in ``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack: there this file skips, and the gpu tests still collect
pytest.importorskip("flax")

from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.models import GCN as JGCN
from pgl_tpu.ops import softmax_cross_entropy_integer as j_ce
from pgl_tpu.ops.pallas import dedup_kernels as jdk
from pgl_tpu_torch import Graph
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import GCN
from pgl_tpu_torch.ops import dispatch
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.ops.kernels import dedup_kernels as tdk
from pgl_tpu_torch.ops.kernels import segment_kernels as tsk
from pgl_tpu_torch.utils.convert import flax_to_state_dict
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3


def make_edges(kind, seed=0):
    """(src, dst, N) of a small graph of one of four shapes."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        N, E = 500, 4000
        dst = rng.integers(0, N, E)
    elif kind == "hub":
        # half the edges into 8 rows of block 0, from any source: that
        # block has ~500 unique sources, so four windows
        N, E = 600, 5000
        dst = np.concatenate([rng.integers(0, 8, E // 2),
                              rng.integers(0, N, E - E // 2)])
    elif kind == "empty_blocks":
        # no edge lands in rows 128..511: block 1 is empty
        N, E = 600, 3000
        dst = np.where(rng.random(E) < 0.5, rng.integers(0, 128, E),
                       rng.integers(512, N, E))
    else:                                   # "ragged": N % 256 != 0
        N, E = 300, 2500
        dst = rng.integers(0, N, E)
    src = rng.integers(0, N, E)
    return src, dst, N


GRAPHS = ["uniform", "hub", "empty_blocks", "ragged"]


def indexes(kind, seed=0):
    src, dst, N = make_edges(kind, seed)
    return (EdgeIndex.from_edges(dst, src, N),
            EdgeIndex.from_edges(src, dst, N), N)


def both_layouts(idx, N, kind="csc"):
    """The reference's and the port's dedup layout of one index."""
    return (jdk.build_dedup_layout(idx.indptr, idx.sorted_v, N),
            tdk.build_dedup_layout(idx.indptr, idx.sorted_v, N, kind=kind,
                                   device="cpu"))


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("side", ["csc", "csr"])
def test_layout_matches_reference(graph, side):
    csc, csr, N = indexes(graph)
    idx = csc if side == "csc" else csr
    ref, lay = both_layouts(idx, N, side)
    E = lay.num_edges
    blk, wb, start, end = lay.pairs.numpy().T
    np.testing.assert_array_equal(lay.uv.numpy(), np.asarray(ref.uv))
    np.testing.assert_array_equal(blk, np.asarray(ref.pair_blk))
    np.testing.assert_array_equal(wb, np.asarray(ref.pair_wb))
    np.testing.assert_array_equal(start // 128 * 128,
                                  np.asarray(ref.pair_ts))
    np.testing.assert_array_equal(end, np.asarray(ref.pair_te))
    np.testing.assert_array_equal(lay.eid.numpy(), np.asarray(ref.eid))
    np.testing.assert_array_equal(
        lay.dst.numpy(), np.asarray(ref.padded_ids).reshape(-1)[:E])
    np.testing.assert_array_equal(lay.uv.numpy()[lay.urow.numpy()],
                                  np.asarray(ref.padded_v)[:E])
    # the reference's rank intervals are the runs of each unique row
    q = (wb[:, None] + np.arange(tdk.W)[None, :]).ravel()
    iv = np.asarray(ref.rank_iv).reshape(len(wb), 2, tdk.W)
    np.testing.assert_array_equal(
        np.searchsorted(lay.urow.numpy(), q, "left").reshape(-1, tdk.W),
        iv[:, 0])
    np.testing.assert_array_equal(
        np.searchsorted(lay.urow.numpy(), q, "right").reshape(-1, tdk.W),
        iv[:, 1])
    assert (lay.max_count, lay.simple) == (ref.max_count, ref.simple)
    assert (lay.num_segments, lay.num_edges) == (ref.num_segments,
                                                 ref.num_edges)


def test_layout_shapes_of_the_hard_cases():
    """The cases the kernels must survive do occur in the graphs above: a
    block of several windows, a window running past its block's unique
    rows, an empty block owning one empty pair, and N % 256 != 0."""
    lay = both_layouts(indexes("hub")[0], 600)[1]
    blk, wb, start, end = lay.pairs.numpy().T
    assert np.bincount(blk)[0] > 1
    assert (np.diff(wb)[np.diff(blk) > 0] < tdk.W).any()
    lay = both_layouts(indexes("empty_blocks")[0], 600)[1]
    blk, wb, start, end = lay.pairs.numpy().T
    assert (np.bincount(blk) >= 1).all() and (start[blk == 1]
                                              == end[blk == 1]).all()
    assert both_layouts(indexes("ragged")[0], 300)[1].n_pad == 512


@pytest.mark.parametrize("graph", GRAPHS)
def test_layout_spans_and_groups_cover_every_edge_once(graph, monkeypatch):
    monkeypatch.setattr(tdk, "PAIRS_PER_GROUP", 2)
    csc, _, N = indexes(graph)
    lay = both_layouts(csc, N)[1]
    blk, wb, start, end = lay.pairs.numpy().T
    np.testing.assert_array_equal(start[1:], end[:-1])
    assert start[0] == 0 and end[-1] == lay.num_edges
    pair = np.repeat(np.arange(len(blk)), end - start)
    r = lay.dst.numpy() - blk[pair] * tdk.NB
    c = lay.urow.numpy() - wb[pair]
    assert ((0 <= r) & (r < tdk.NB) & (0 <= c) & (c < tdk.W)).all()
    gb, p0, p1, slot = lay.groups.numpy().T
    np.testing.assert_array_equal(p0[1:], p1[:-1])
    assert p0[0] == 0 and p1[-1] == len(blk)
    assert (p1 - p0 <= 2).all() and (blk[p0] == gb).all()
    assert (blk[p1 - 1] == gb).all()
    n_gr = np.bincount(gb)
    split = np.flatnonzero(n_gr > 1)
    np.testing.assert_array_equal(lay.split_blocks.numpy(), split)
    ptr = lay.split_ptr.numpy()
    for i, b in enumerate(split):
        np.testing.assert_array_equal(slot[gb == b],
                                      np.arange(ptr[i], ptr[i + 1]))
    assert (slot[~np.isin(gb, split)] == -1).all()
    assert lay.num_partials == ptr[-1]


@pytest.mark.parametrize("graph", GRAPHS)
def test_counts_match_reference_bit_for_bit(graph):
    csc, _, N = indexes(graph)
    ref, lay = both_layouts(csc, N)
    want = np.asarray(jdk.materialize_counts(ref, interpret=True).counts)
    got = tdk.materialize_counts(lay).counts
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert float(got.float().sum()) == lay.num_edges


@pytest.mark.parametrize("graph,D", [("hub", 1), ("hub", 16), ("hub", 128),
                                     ("uniform", 16), ("empty_blocks", 128),
                                     ("ragged", 16)])
def test_apply_matches_reference(graph, D):
    """K5 (counts cached) and K6 (rebuilt) plain versions against the
    reference's uncached kernel; cached and uncached agree exactly."""
    csc, _, N = indexes(graph)
    ref, lay = both_layouts(csc, N)
    x = np.random.default_rng(D).normal(size=(N, D)).astype(np.float32)
    want = np.asarray(jdk._blocked_spmm_dedup(jnp.asarray(x), ref, N, 256,
                                              1024, 128, True))
    xt = torch.as_tensor(x)
    uncached = tdk.apply_reference(xt, lay)
    cached = tdk.apply_reference(xt, lay, tdk.materialize_counts(lay).counts)
    np.testing.assert_allclose(uncached.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(cached, uncached)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("cached", [False, True])
def test_spmm_dedup_forward_and_grad_match_reference(graph, cached):
    csc, csr, N = indexes(graph, seed=3)
    jcsc, lcsc = both_layouts(csc, N, "csc")
    jcsr, lcsr = both_layouts(csr, N, "csr")
    if cached:
        lcsc, lcsr = (tdk.materialize_counts(lcsc),
                      tdk.materialize_counts(lcsr))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(N, 16)).astype(np.float32)
    w = rng.normal(size=(N, 16)).astype(np.float32)

    def loss(f):
        return (jdk.spmm_dedup(f, jcsc, jcsr, interpret=True) * w).sum()

    want = jdk.spmm_dedup(jnp.asarray(x), jcsc, jcsr, interpret=True)
    want_grad = jax.grad(loss)(jnp.asarray(x))
    f = torch.tensor(x, requires_grad=True)
    out = tdk.spmm_dedup(f, lcsc, lcsr)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_grad),
                               rtol=RTOL, atol=ATOL)


def test_materialize_skips_extreme_multiplicity():
    """bf16 holds counts <= 256 exactly; beyond that, no counts, and the
    apply rebuilds them (K6) and stays exact."""
    N = 64
    rng = np.random.default_rng(0)
    edges = np.concatenate([np.tile([[1, 2]], (300, 1)),
                            rng.integers(0, N, (200, 2))])
    idx = EdgeIndex.from_edges(edges[:, 1], edges[:, 0], N)
    ref, lay = both_layouts(idx, N)
    assert lay.max_count == ref.max_count >= 300 and not lay.simple
    assert tdk.materialize_counts(lay).counts is None
    x = rng.normal(size=(N, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tdk.apply_reference(torch.as_tensor(x), lay).numpy(),
        np.asarray(jdk._blocked_spmm_dedup(jnp.asarray(x), ref, N, 256,
                                           1024, 128, True)),
        rtol=RTOL, atol=ATOL)


def test_plain_version_runs_for_cpu_tensors_only():
    csc, csr, N = indexes("ragged")
    lcsc, lcsr = (both_layouts(csc, N)[1],
                  both_layouts(csr, N, "csr")[1])
    tdk.reset_launches()
    tdk.spmm_dedup(torch.ones(N, 4), tdk.materialize_counts(lcsc), lcsr)
    assert tdk.LAUNCHES == 0
    with pytest.raises(ValueError, match="device"):
        tdk.spmm_dedup(torch.ones(N, 4, device="meta"), lcsc, lcsr)


# -- the rule of Graph.tensor() and the slice --------------------------------

@pytest.fixture
def dedup_small(monkeypatch):
    """DEDUP on, with the band opened so that small graphs qualify."""
    monkeypatch.setattr(dispatch, "DEDUP", True)
    monkeypatch.setattr(dispatch, "DEDUP_MIN_EDGES", 0)
    return monkeypatch


def test_dispatch_builds_dedup_layouts_in_band(dedup_small):
    src, dst, N = make_edges("hub")
    g = Graph(np.stack([src, dst], 1), num_nodes=N).tensor("cpu")
    csc_d, csr_d = g._dedup_layouts
    assert (csc_d.kind, csr_d.kind) == ("csc", "csr")
    assert csc_d.counts is not None and csr_d.counts is not None
    assert g._spmm_layouts is not None           # K1's stay built
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(N, 8)).astype(np.float32))
    want = torch.zeros(N, 8).index_add_(0, torch.as_tensor(dst),
                                        x[torch.as_tensor(src)])
    np.testing.assert_allclose(g.send_u_recv(x, "sum").numpy(),
                               want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("setting", [
    {"DEDUP": False},
    {"DEDUP_MIN_EDGES": 10 ** 6},                # below the band
    {"DEDUP_MAX_EDGES": 100},                    # above the band
    {"DEDUP_MAX_RATIO": 0.01},                   # over the ratio
], ids=["off", "below_band", "above_band", "over_ratio"])
def test_dispatch_builds_no_dedup_layouts_outside_the_rule(dedup_small,
                                                           setting):
    for name, value in setting.items():
        dedup_small.setattr(dispatch, name, value)
    src, dst, N = make_edges("hub")
    g = Graph(np.stack([src, dst], 1), num_nodes=N).tensor("cpu")
    assert g._dedup_layouts is None


def test_dispatch_over_budget_runs_uncached(dedup_small):
    dedup_small.setattr(dispatch, "COUNTS_BUDGET_BYTES", 0)
    src, dst, N = make_edges("uniform")
    g = Graph(np.stack([src, dst], 1), num_nodes=N).tensor("cpu")
    assert all(lay.counts is None for lay in g._dedup_layouts)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(N, 3)).astype(np.float32))
    want = torch.zeros(N, 3).index_add_(0, torch.as_tensor(dst),
                                        x[torch.as_tensor(src)])
    np.testing.assert_allclose(g.send_u_recv(x, "mean").numpy(),
                               (want / g.indegree().clamp(min=1)[:, None]
                                ).numpy(), rtol=RTOL, atol=ATOL)


def _port_gcn(params):
    tg, tlabels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    gt = tg.tensor("cpu")
    model = GCN(16, 3, num_layers=3, hidden_size=24, dropout=0.0,
                device="cpu")
    model.load_state_dict(flax_to_state_dict(params, "cpu"))
    logits = model(gt, gt.node_feat["h"])
    ce(logits, torch.as_tensor(tlabels)).mean().backward()
    return gt, logits.detach().numpy(), {
        k: p.grad.numpy() for k, p in model.named_parameters()}


def test_gcn_through_dedup_matches_reference_and_k1(dedup_small):
    """The GCN of tests/test_torch_gcn.py through the dedup path: against
    the JAX GCN (its XLA path on the CPU computes the same function) at
    that file's tolerances, and against the port's own K1 path."""
    g, labels = j_community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    gj = g.tensor()
    jmodel = JGCN(input_size=16, num_class=3, num_layers=3, hidden_size=24,
                  dropout=0.0)
    params = jmodel.init(jax.random.key(0), gj, gj.node_feat["h"])

    def loss(p):
        logits = jmodel.apply(p, gj, gj.node_feat["h"])
        return j_ce(logits, jnp.asarray(labels)).mean(), logits

    (_, want_logits), want_grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    params = jax.tree.map(np.asarray, params)
    want_grads = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, want_grads), "cpu").items()}

    gt, logits, grads = _port_gcn(params)
    assert gt._dedup_layouts is not None
    dedup_small.setattr(dispatch, "DEDUP", False)
    gk, logits_k1, grads_k1 = _port_gcn(params)
    assert gk._dedup_layouts is None

    for want_l, want_g in ((np.asarray(want_logits), want_grads),
                           (logits_k1, grads_k1)):
        np.testing.assert_allclose(logits, want_l, rtol=1e-5, atol=1e-5)
        assert set(grads) == set(want_g)
        for k in want_g:
            np.testing.assert_allclose(grads[k], want_g[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert tsk.LAUNCHES == 0 and tdk.LAUNCHES == 0
