"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here needs a CUDA card: it skips with a reason without one, and
runs on the card with ``pytest -m gpu tests/test_torch_*.py``. The file
imports neither JAX nor ``pgl_tpu``, whose flax dependency the card's
machine need not have; parity with ``pgl_tpu`` is the CPU tests' job.

Kernel results are held against the plain version evaluated in float64 at
``|kernel - plain| <= 1e-4 * max(1, |plain|, ||terms||_2)`` elementwise by
chip_smoke.py's ``check_spmm`` (K1) and ``check_dedup`` (K5, K6), which say
why: the kernel sums float32 in another order, and its rounding error grows
with the 2-norm of the terms an element sums. K4's counts must equal the
plain counts bit for bit, and K5 and K6 must agree bit for bit and give the
same bits on two runs, on features whose three bf16 planes are all
nonzero. The
attention kernels (K9, K10) go through ``check_attention`` (no terms scale:
their outputs are convex combinations or sums of bounded terms) and must
give the same bits on two runs, the additive K9 and K10 also at every lane
map and on graphs with split rows, 16-edge rows and no edges
(``check_k10_case``, with zeros on the rows without edges), and the
additive K7 at every lane map on a multigraph with split rows and rows
without cells (``check_k7_case``); in dot mode through ``check_dot`` (dq, dk
and dv with the terms scale); the count-matrix attention (K7, K8) through
``check_dedup_attention`` (d a_src and dv on node rows, with the terms
scale), and in dot mode through ``check_dedup_dot`` (dq, dk and dv with the
terms scale; dk and dv on node rows), with the same bits on two runs and on
a layout without counts; in
dot mode the cell form of the staged kernels must also give the per-edge
form's bits at count one, and 12a5247's bits on the pinned cases
(``check_parent_bits``). K1w and the
weighted K6 go through ``check_weighted`` (forward, dx and dw with the
terms scale) and must give the same bits on two runs; K1w also over every
kind of work item (``check_k1w_items``). K11, the dedup SDDMM,
must equal its plain version bit for bit (``check_sddmm``: one IEEE
operation a value, pads +0), and its backward (K1 over ``by_src`` and
``by_dst``) goes through ``check_sddmm_grad`` (float64 with the terms scale,
the same bits twice, its launches). K1 over a BiGraph's rectangular
layouts goes through ``check_rect_spmm``, and the dot K9/K10 on a relation
whose rows are mostly empty through ``check_empty_rows_dot``, each with
exact zeros on the rows without edges. The device samplers and walks
go through ``check_device_samples`` (every sampled neighbour an
in-neighbour, masks where the degree is 0) and ``check_walks`` (every hop
an edge, -1 to the end after a dead end); a minibatch graph whose K1
layouts were built on the host through ``check_batch_graph_k1``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (DDOT_KERNELS, DEDUP_CASE_D, DOT_KERNELS,
                        K10_SHAPES, READOUT_PER_STEP, SAGE_BUCKETS,
                        SDDMM_OPS, attention_graph, attention_inputs, check,
                        check_batch_graph_k1, check_device_samples,
                        check_walks,
                        check_attention, check_counts, check_dedup,
                        check_empty_rows_dot, check_rect_spmm,
                        check_dedup_attention, check_dedup_dot,
                        check_dedup_exact, check_dot, check_k10_case,
                        check_k1w_items, check_k7_case, check_parent_bits,
                        check_sddmm, check_sddmm_grad, check_spmm,
                        check_weighted, dedup_attention_of,
                        dedup_case_edges, dedup_case_facts, dedup_layouts,
                        dispatch_settings, dot_inputs, hard_features,
                        k10_case_graphs, k1_case_edges, k1_features,
                        k7_case_atts, mag_host, motif_host, no_dropout,
                        parity_and_steps, phase_attention_mask,
                        noisy_features, readout_model, readout_trainer,
                        phase_zoo_small,
                        phase_dedup_attention_mask, run_dedup_attention,
                        run_dedup_dot,
                        run_dedup_twice, run_dot, run_weighted, sddmm_inputs,
                        skewed_graph, spread_weights, weighted_terms,
                        without_counts)
from pgl_tpu_torch import BiGraph, Graph
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import FAGCN, GAT, GATv2, GCN, UniMP
from pgl_tpu_torch.nn import GATConv, TransformerConv
from pgl_tpu_torch.ops.kernels import attention_kernels as ak
from pgl_tpu_torch.ops.kernels import dedup_attention as da
from pgl_tpu_torch.ops.kernels import _build
from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
from pgl_tpu_torch.ops.kernels import sddmm_kernels as sdk
from pgl_tpu_torch.ops.kernels import segment_kernels as sk

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 3, 16, 128, 130])
def test_spmm_kernel_matches_plain_version(cuda, D):
    g = Graph(skewed_graph(3000, 40000, seed=4), num_nodes=3000).tensor(cuda)
    csc, csr = g._spmm_layouts
    assert csc.item_partials > 0
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn(3000, D, device=cuda, generator=gen, requires_grad=True)
    w = torch.randn(3000, D, device=cuda, generator=gen)
    sk.reset_launches()
    out = sk.spmm(x, csc, csr)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert sk.LAUNCHES == 2
    assert dict(sk.LAUNCHES_BY_SHAPE) == {("csc", D): 1, ("csr", D): 1}
    assert dict(sk.LAUNCHES_BY_LAYOUT) == {(("csc", D), id(csc)): 1,
                                           (("csr", D), id(csr)): 1}
    with torch.no_grad():
        check_spmm("csc", out, x, csc)
        check_spmm("csr", x.grad, w, csr)
    assert (out[1:1500] == 0).all()          # empty rows are exact zeros


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False], ids=["vec", "unaligned"])
@pytest.mark.parametrize("D", [1, 3, 8, 16, 64, 128, 130, 256, 512])
def test_k1_work_items_match_plain_version(cuda, D, aligned):
    """K1 over every kind of work item (a hub's pieces, rows of their own,
    packs of short rows across item boundaries, empty rows) at one to four
    vectors a lane and past one pass (D = 512 in one walk), on 16-byte
    vectors and on the scalar path (an unaligned table); both layouts, two
    runs giving the same bits."""
    edges, n = k1_case_edges()
    g = Graph(edges, num_nodes=n).tensor(cuda)
    csc, csr = g._spmm_layouts
    kinds = csc.items[:, 3].cpu().numpy()
    assert (kinds >= 0).any() and (kinds == -1).any() and (kinds < -1).any()
    assert csr.item_partials > 0
    gen = torch.Generator(device=cuda).manual_seed(D)
    outs = {}
    for lay in (csc, csr):
        x = k1_features(n, D, cuda, gen, aligned)
        outs[lay.kind] = out = sk._spmm_cuda(x, lay)
        again = sk._spmm_cuda(x, lay)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        with torch.no_grad():
            check_spmm(f"{lay.kind} D={D}", out, x, lay)
    empty = torch.as_tensor(np.bincount(edges[:, 1], minlength=n) == 0,
                            device=cuda)
    assert bool(empty.any()) and (outs["csc"][empty] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("D", [8, 64, 256])
def test_k1_fold_over_red_matches_plain_version(cuda, D):
    """K1 over ``build_uniq_reduce``'s layout, the reference's fold of
    pair-slot rows onto nodes (short rows of a few slots each), on a real
    dedup layout; the same bits twice."""
    g = Graph(attention_graph(3000, 40000, seed=4), num_nodes=3000
              ).tensor(cuda)
    att = dedup_attention_of(g, cuda)
    red = da.build_uniq_reduce(att.layout, att.num_rows)
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn(red.max_index + 1, D, device=cuda, generator=gen)
    sk.reset_launches()
    out = sk._spmm_cuda(x, red)
    assert torch.equal(out, sk._spmm_cuda(x, red))
    assert dict(sk.LAUNCHES_BY_SHAPE) == {("uniq_reduce", D): 2}
    with torch.no_grad():
        check_spmm(f"red D={D}", out, x, red)


@pytest.mark.gpu
def test_sorted_segment_sum_kernel_matches_plain_version(cuda):
    g = Graph(skewed_graph(500, 6000, seed=5), num_nodes=500).tensor(cuda)
    idx = g.adj_dst_index
    msgs = torch.randn(6000, 32, device=cuda, requires_grad=True)
    out = sk.sorted_segment_sum(msgs, idx.segment_ids, idx.indptr, 500)
    w = torch.randn_like(out)
    (out * w).sum().backward()
    ident = sk.build_spmm_layout(idx.indptr.cpu(), np.arange(6000), 500,
                                 device=cuda)
    assert ident.item_partials > 0
    with torch.no_grad():
        check_spmm("segment_sum", out, msgs, ident)
    assert torch.equal(msgs.grad, w[idx.segment_ids])


@pytest.mark.gpu
def test_gcn_on_cuda_matches_cpu(cuda):
    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    logits = {}
    for dev in ("cpu", cuda):
        gt = g.tensor(dev)
        model = GCN(16, 3, num_layers=3, hidden_size=24, dropout=0.0,
                    generator=torch.Generator().manual_seed(0), device=dev)
        logits[str(dev)] = model(gt, gt.node_feat["h"]).detach().cpu()
    np.testing.assert_allclose(logits[str(cuda)], logits["cpu"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = Graph(skewed_graph(100, 800, seed=6), num_nodes=100).tensor(cuda)
    csc, csr = g._spmm_layouts
    with pytest.raises(TypeError, match="float32"):
        sk.spmm(torch.randn(100, 8, device=cuda, dtype=torch.float64),
                csc, csr)
    with pytest.raises(ValueError, match="contiguous"):
        sk.spmm(torch.randn(8, 100, device=cuda).t(), csc, csr)
    with pytest.raises(ValueError, match="gathers row"):
        sk.spmm(torch.randn(50, 8, device=cuda), csc, csr)
    with pytest.raises(ValueError, match="layout"):
        sk.spmm(torch.randn(100, 8, device=cuda), *Graph(
            skewed_graph(100, 800, seed=6), num_nodes=100
        ).tensor("cpu")._spmm_layouts)


@pytest.mark.gpu
@pytest.mark.parametrize("D", DEDUP_CASE_D)
def test_dedup_kernels_match_plain_version(cuda, D):
    """K4 exact; K5 and K6 against float64 forward and backward on a graph
    with a count of 256, windows past their block's unique run, a split
    and an empty dst block, at features with full mantissas and
    subnormals; two runs the same bits; K5 = K6 bit for bit."""
    g = Graph(dedup_case_edges(), num_nodes=3000).tensor(cuda)
    dk.reset_launches()
    csc, csr = dedup_layouts(g, cuda)
    assert dict(dk.LAUNCHES_BY_SHAPE) == {("counts", "csc", None): 1,
                                          ("counts", "csr", None): 1}
    for lay in (csc, csr):
        check_counts(f"counts {lay.kind}", lay.counts, lay)
    assert csc.max_count == 256
    assert all(dedup_case_facts(csc).values())
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = hard_features(3000, D, cuda, gen)
    w = hard_features(3000, D, cuda, gen)
    out5, grad5 = run_dedup_twice(x, w, (csc, csr))
    out6, grad6 = run_dedup_twice(x, w, [dataclasses.replace(lay, counts=None)
                                         for lay in (csc, csr)])
    assert dict(dk.LAUNCHES_BY_SHAPE) == {
        ("counts", "csc", None): 1, ("counts", "csr", None): 1,
        ("dedup_cached", "csc", D): 2, ("dedup_cached", "csr", D): 2,
        ("dedup", "csc", D): 2, ("dedup", "csr", D): 2}
    with torch.no_grad():
        check_dedup("K5 csc", out5, x, csc)
        check_dedup("K5 csr", grad5, w, csr)
    assert torch.equal(out5, out6) and torch.equal(grad5, grad6)
    assert (out5[1:1500] == 0).all()             # empty rows are exact zeros


@pytest.mark.gpu
@pytest.mark.parametrize("D", [3, 128])
def test_dedup_kernels_exact_on_one_term_rows(cuda, D):
    """On a permutation graph K5 and K6 return each source row bit for bit,
    forward and backward: the window's bf16 planes add back exactly."""
    check_dedup_exact("permutation", cuda, d=D)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 130])
def test_dedup_k6_above_the_cached_counts(cuda, D):
    """A count of 300 (no bf16 cache; K6 splits its counts into three
    planes) against float64, two runs the same bits."""
    g = Graph(dedup_case_edges(copies=300), num_nodes=3000).tensor(cuda)
    csc, csr = dedup_layouts(g, cuda)
    assert csc.counts is None and csc.max_count == 300
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = hard_features(3000, D, cuda, gen)
    w = hard_features(3000, D, cuda, gen)
    dk.reset_launches()
    out, grad = run_dedup_twice(x, w, (csc, csr))
    assert dict(dk.LAUNCHES_BY_SHAPE) == {("dedup", "csc", D): 2,
                                          ("dedup", "csr", D): 2}
    with torch.no_grad():
        check_dedup("K6 csc", out, x, csc)
        check_dedup("K6 csr", grad, w, csr)


@pytest.mark.gpu
def test_graph_dedup_path_on_cuda(cuda):
    """``tensor()`` under ``DEDUP`` launches K4 once per layout, and
    ``send_u_recv`` then runs K5 and agrees with the K1 path."""
    edges = skewed_graph(3000, 40000, seed=7)
    x = torch.randn(3000, 32, device=cuda)
    dk.reset_launches()
    with dispatch_settings(DEDUP=True, DEDUP_MIN_EDGES=0):
        gd = Graph(edges, num_nodes=3000).tensor(cuda)
    out = gd.send_u_recv(x, "mean")
    torch.cuda.synchronize()
    assert dict(dk.LAUNCHES_BY_SHAPE) == {
        ("counts", "csc", None): 1, ("counts", "csr", None): 1,
        ("dedup_cached", "csc", 32): 1}
    with dispatch_settings(DEDUP=False):
        g1 = Graph(edges, num_nodes=3000).tensor(cuda)
    assert g1._dedup_layouts is None
    check("dedup against K1", out, g1.send_u_recv(x, "mean"))


@pytest.mark.gpu
def test_gcn_through_dedup_on_cuda_matches_cpu(cuda):
    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    logits = {}
    for dev in ("cpu", cuda):
        with dispatch_settings(DEDUP=True, DEDUP_MIN_EDGES=0):
            gt = g.tensor(dev)
        assert gt._dedup_layouts is not None
        model = GCN(16, 3, num_layers=3, hidden_size=24, dropout=0.0,
                    generator=torch.Generator().manual_seed(0), device=dev)
        logits[str(dev)] = model(gt, gt.node_feat["h"]).detach().cpu()
    np.testing.assert_allclose(logits[str(cuda)], logits["cpu"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.gpu
def test_dedup_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = Graph(skewed_graph(100, 800, seed=6), num_nodes=100).tensor(cuda)
    csc, csr = dedup_layouts(g, cuda)
    with pytest.raises(TypeError, match="float32"):
        dk.spmm_dedup(torch.randn(100, 8, device=cuda, dtype=torch.float64),
                      csc, csr)
    with pytest.raises(ValueError, match="contiguous"):
        dk.spmm_dedup(torch.randn(8, 100, device=cuda).t(), csc, csr)
    with pytest.raises(ValueError, match="gathers row"):
        dk.spmm_dedup(torch.randn(50, 8, device=cuda), csc, csr)
    with pytest.raises(ValueError, match="layout"):
        dk.spmm_dedup(torch.randn(100, 8, device=cuda), *dedup_layouts(
            g, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("H,dvh", [(8, 8), (1, 16), (3, 5)])
def test_attention_kernels_match_plain_version(cuda, H, dvh, rate):
    """K9, K10-dq and K10-dkv on a graph whose hub destination and hub
    source are both split across pieces; two runs give the same bits."""
    g = Graph(attention_graph(3000, 40000, seed=4), num_nodes=3000
              ).tensor(cuda)
    lays = g._attention_layouts()
    assert lays[0].num_partials > 0 and lays[1].num_partials > 0
    gen = torch.Generator(device=cuda).manual_seed(H * dvh)
    ins = attention_inputs(3000, H, dvh, cuda, gen)
    seed = torch.tensor([-987654321], dtype=torch.int32, device=cuda)
    ak.reset_launches()
    _, got = check_attention("small", lays, ins, rate, seed)
    _, again = check_attention("small", lays, ins, rate, seed)
    torch.cuda.synchronize()
    assert all(map(torch.equal, got, again))
    assert dict(ak.LAUNCHES_BY_SHAPE) == {
        (k, H, dvh): 2 for k in ("gat_fwd", "gat_fwd_combine", "gat_dq",
                                 "gat_dq_combine", "gat_dkv",
                                 "gat_dkv_combine")}
    out, lse = got[:2]
    assert (out[1:1500] == 0).all() and (lse[1:1500] == 0).all()


_K10_GRAPHS = {}


@pytest.mark.gpu
@pytest.mark.parametrize("slope", [0.0, 0.2])
@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("H,dvh", K10_SHAPES)
@pytest.mark.parametrize("graph", ["hub", "sixteen", "no_edges"])
def test_k10_additive_matches_plain_version(cuda, graph, H, dvh, rate,
                                            slope):
    """The additive K9 and K10 at every lane map: GAT's shapes, ragged and
    one-column heads, four vectors a lane and a head across the warp; on a
    graph with split hub rows on both sides and empty rows, one of 16-edge
    source rows, and one without edges: within tolerance of float64, the
    same bits twice, empty rows zero (out and lse too)."""
    if not _K10_GRAPHS:
        _K10_GRAPHS.update(k10_case_graphs(cuda))
    g = _K10_GRAPHS[graph]
    gen = torch.Generator(device=cuda).manual_seed(H * dvh)
    ak.reset_launches()
    check_k10_case(graph, g, H, dvh, rate, slope, cuda, gen)
    torch.cuda.synchronize()
    for k in ("gat_fwd", "gat_dq", "gat_dkv"):
        assert ak.LAUNCHES_BY_SHAPE[(k, H, dvh)] == 2


_K7_ATTS = {}


@pytest.mark.gpu
@pytest.mark.parametrize("slope", [0.0, 0.2])
@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("H,dvh", K10_SHAPES)
@pytest.mark.parametrize("graph", ["multi", "no_edges"])
def test_k7_additive_matches_plain_version(cuda, graph, H, dvh, rate,
                                           slope):
    """The additive K7 (with K8 after it) at every lane map of K9's, on a
    multigraph whose cells count 2 to 4 edges, with a hub row split over
    pieces and rows without cells, and on a graph without edges: within
    tolerance of float64, the same bits twice, rows without cells zero."""
    if not _K7_ATTS:
        _K7_ATTS.update(k7_case_atts(cuda))
    gen = torch.Generator(device=cuda).manual_seed(H * dvh)
    da.reset_launches()
    check_k7_case(graph, _K7_ATTS[graph], H, dvh, rate, slope, cuda, gen)
    torch.cuda.synchronize()
    assert da.LAUNCHES_BY_SHAPE[("dedup_fwd", H, dvh)] == 2
    if graph == "multi":
        assert da.LAUNCHES_BY_SHAPE[("dedup_fwd_combine", H, dvh)] == 2


@pytest.mark.gpu
def test_additive_keep_bits_are_the_plain_masks(cuda):
    """K9's keep bits (and K10-dkv's) equal the plain edge mask, K7's (and
    K8's) the plain cell mask, on permutation graphs."""
    phase_attention_mask(cuda)
    phase_dedup_attention_mask(cuda, n=1 << 16)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("H,dvh", [(8, 8), (1, 16), (3, 5), (43, 2)])
def test_dedup_attention_kernels_match_plain_version(cuda, H, dvh, rate):
    """K7 and K8 on a graph whose hub destination and hub source are split
    across pieces (K8's d a_src and dv on node rows); two runs, and the
    layout without counts, give the same bits."""
    g = Graph(attention_graph(3000, 40000, seed=4), num_nodes=3000
              ).tensor(cuda)
    att = dedup_attention_of(g, cuda)
    assert att.num_partials > 0 and att.num_node_partials > 0
    gen = torch.Generator(device=cuda).manual_seed(H * dvh)
    ins = attention_inputs(3000, H, dvh, cuda, gen)
    seed = torch.tensor([-987654321], dtype=torch.int32, device=cuda)
    bare = without_counts(att)
    da.reset_launches()
    got = run_dedup_attention(att, ins, rate, seed)
    for other in (att, bare):
        assert all(map(torch.equal, got,
                       run_dedup_attention(other, ins, rate, seed)))
    torch.cuda.synchronize()
    assert dict(da.LAUNCHES_BY_SHAPE) == {
        (k, H, dvh): 3 for k in ("dedup_fwd", "dedup_fwd_combine",
                                 "dedup_bwd", "dedup_bwd_combine",
                                 "dedup_bwd_node_combine")}
    check_dedup_attention("small", att, ins, rate, seed, got)
    out, lse = got[:2]
    assert (out[1:1500] == 0).all() and (lse[1:1500] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dedup", [False, True])
def test_gat_on_cuda_matches_cpu(cuda, dedup):
    """Through the per-edge attention, and through the count-matrix
    attention (the dedup band opened to this graph)."""
    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    res = {}
    for dev in ("cpu", cuda):
        with dispatch_settings(DEDUP=dedup, DEDUP_MIN_EDGES=0):
            gt = g.tensor(dev)
        assert (gt._dedup_layouts is not None) == dedup
        model = GAT(16, 3, feat_drop=0.0, attn_drop=0.0,
                    generator=torch.Generator().manual_seed(0), device=dev)
        logits = model(gt, gt.node_feat["h"], True)
        logits.square().sum().backward()
        res[str(dev)] = (logits.detach().cpu(),
                         model.gat_0.linear.weight.grad.cpu())
    for got, want in zip(res[str(cuda)], res["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert (gt._dedup_attn is not None) == dedup


@pytest.mark.gpu
def test_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = Graph(skewed_graph(100, 800, seed=6), num_nodes=100)
    lays = g.tensor(cuda)._attention_layouts()
    a = torch.randn(100, 2)
    v = torch.randn(100, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak._fwd_cuda(a, a, v, lays[0], 0.2, 4, 0.0,
                     torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        ak.fused_gat_attention(*(t.to(cuda, torch.float64) for t in (a, a, v)),
                               *lays)
    with pytest.raises(ValueError, match="layout"):
        ak.fused_gat_attention(*(t.to(cuda) for t in (a, a, v)),
                               *g.tensor("cpu")._attention_layouts())


@pytest.mark.gpu
def test_dedup_attention_wrapper_rejects_what_the_kernel_does_not_take(
        cuda):
    g = Graph(skewed_graph(100, 800, seed=6), num_nodes=100)
    att = dedup_attention_of(g.tensor(cuda), cuda, counts=False)
    a = torch.randn(100, 2)
    v = torch.randn(100, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da._fwd_cuda(a, a, v, att, 0.2, 4, 0.0,
                     torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        da.dedup_gat_attention(*(t.to(cuda, torch.float64)
                                 for t in (a, a, v)), att)
    with pytest.raises(ValueError, match="layout"):
        da.dedup_gat_attention(*(t.to(cuda) for t in (a, a, v)),
                               dedup_attention_of(g.tensor("cpu"), "cpu"))
    wide = torch.randn(100, 1, device=cuda)
    with pytest.raises(ValueError, match="slots"):
        da.dedup_gat_attention(wide, wide, torch.randn(100, 513,
                                                       device=cuda), att)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("H,dsh,dvh,leaky", [(2, 128, 128, 0.0),
                                             (8, 16, 16, 0.0),
                                             (43, 2, 8, 0.2)])
def test_dot_attention_kernels_match_plain_version(cuda, H, dsh, dvh, leaky,
                                                   rate):
    """The dot-mode K9, K10-dq and K10-dkv at UniMP's shape, (8, 16, 16)
    and a shape of GATConv's many-head fallback, on a graph whose hub
    destination and hub source are both split across pieces; two runs give
    the same bits."""
    g = Graph(attention_graph(3000, 40000, seed=4), num_nodes=3000
              ).tensor(cuda)
    lays = g._attention_layouts()
    shape = (H, dsh, dvh)
    gen = torch.Generator(device=cuda).manual_seed(H * dsh * dvh)
    ins = dot_inputs(3000, shape, cuda, gen)
    seed = torch.tensor([-987654321], dtype=torch.int32, device=cuda)
    ak.reset_launches()
    got = run_dot(lays, ins, shape, leaky, rate, seed)
    again = run_dot(lays, ins, shape, leaky, rate, seed)
    torch.cuda.synchronize()
    assert all(map(torch.equal, got, again))
    assert dict(ak.LAUNCHES_BY_SHAPE) == {
        (k + c, *shape): 2 for k in DOT_KERNELS for c in ("", "_combine")}
    check_dot("small", lays, ins, shape, leaky, rate, seed, got)
    out, lse = got[:2]
    assert (out[1:1500] == 0).all() and (lse[1:1500] == 0).all()


# (H, dsh, dvh) at each slots-a-lane count NC of the dot kernels
DOT_NC_SHAPES = {1: (2, 16, 16), 2: (1, 64, 64), 4: (8, 16, 16),
                 8: (2, 128, 128), 16: (4, 128, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("nc", sorted(DOT_NC_SHAPES))
def test_dot_dkv_every_slot_count(cuda, nc, rate):
    """The dot-mode K10-dkv (staged through shared memory) at every
    slots-a-lane count against float64 (with K9 and K10-dq, whose lse and
    delta it reads), on a graph whose hub source splits; two runs give the
    same bits."""
    g = Graph(attention_graph(3000, 40000, seed=6), num_nodes=3000
              ).tensor(cuda)
    lays = g._attention_layouts()
    assert lays[1].num_partials > 0
    shape = DOT_NC_SHAPES[nc]
    gen = torch.Generator(device=cuda).manual_seed(nc)
    ins = dot_inputs(3000, shape, cuda, gen)
    seed = torch.tensor([-123456789], dtype=torch.int32, device=cuda)
    got = run_dot(lays, ins, shape, 0.0, rate, seed)
    again = run_dot(lays, ins, shape, 0.0, rate, seed)
    torch.cuda.synchronize()
    assert all(map(torch.equal, got, again))
    check_dot(f"NC={nc}", lays, ins, shape, 0.0, rate, seed, got)


def _permutation_graph(n, cuda, seed=12):
    rng = np.random.default_rng(seed)
    src = rng.permutation(n)
    g = Graph(np.stack([src, np.arange(n)], axis=1), num_nodes=n
              ).tensor(cuda)
    return g, torch.as_tensor(src, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("nc", sorted(DOT_NC_SHAPES))
def test_dot_dkv_keep_mask_is_the_plain_mask(cuda, nc):
    """On a permutation graph (one edge a row) with q = k = 0 and v = g =
    1, K10-dkv's dv is 1 / (1 - rate) where the edge is kept and 0 where it
    is dropped: its keep bits equal ``drop_keep`` of the edge's CSC
    position for every head."""
    n, rate = 4096, 0.3
    H, dsh, dvh = shape = DOT_NC_SHAPES[nc]
    g, src = _permutation_graph(n, cuda)
    lays = g._attention_layouts()
    zeros = torch.zeros(n, H * dsh, device=cuda)
    ones = torch.ones(n, H * dvh, device=cuda)
    seed = torch.tensor([-1640531535], dtype=torch.int32, device=cuda)
    dv = run_dot(lays, (zeros, zeros, ones, ones), shape, 0.0, rate,
                 seed)[4].reshape(n, H, dvh)
    csr = lays[1]
    pos = torch.empty_like(csr.positions())
    pos[csr.seg_ids.long()] = csr.positions()
    want = torch.stack([ak.drop_keep(pos, seed, h, rate) for h in range(H)],
                       dim=1)
    assert torch.equal(dv != 0, want[:, :, None].expand(n, H, dvh))


@pytest.mark.gpu
@pytest.mark.parametrize("nc", sorted(DOT_NC_SHAPES))
def test_dot_dkv_recomputes_the_forward_scores(cuda, nc):
    """On a permutation graph at rate 0 K9's lse of each row is its one
    edge's score, so K10-dkv's p = exp(s - lse) is exactly 1, and dv[src]
    equals g[dst] bit for bit, only where K10-dkv recomputes the score
    with K9's bits."""
    n = 4096
    shape = DOT_NC_SHAPES[nc]
    g, src = _permutation_graph(n, cuda, seed=13)
    lays = g._attention_layouts()
    gen = torch.Generator(device=cuda).manual_seed(nc)
    q, k, v, g_out = dot_inputs(n, shape, cuda, gen)
    seed = torch.tensor([0], dtype=torch.int32, device=cuda)
    out, lse, _, _, dv = run_dot(lays, (q * 4, k, v, g_out), shape, 0.0,
                                 0.0, seed)
    assert bool((lse != 0).any())
    assert torch.equal(dv[src], g_out)


# (H, dsh, dvh, leaky) for each instantiation (NC, FULL, WIDE) of the
# staged K9 and K10-dq: FULL when every slot is a real column (dsh == dvh ==
# wp, H·wp == 32·NC), WIDE when a head is wider than a warp (wp > 32, never
# at NC = 1); the shapes that are not FULL mask columns (dsh != dvh, widths
# below their power of two, padding heads), some with widths that are not a
# multiple of 4 floats (4-byte staging); GATConv's many-head shapes (43
# heads, dsh 2) with leaky 0.2
DOT_STAGED_CASES = {
    (1, True, False): (2, 16, 16, 0.0), (1, False, False): (3, 8, 5, 0.0),
    (2, True, False): (2, 32, 32, 0.0), (2, True, True): (1, 64, 64, 0.0),
    (2, False, False): (3, 16, 12, 0.0), (2, False, True): (1, 64, 50, 0.0),
    (4, True, False): (8, 16, 16, 0.0), (4, True, True): (2, 64, 64, 0.0),
    (4, False, False): (5, 16, 16, 0.0), (4, False, True): (1, 128, 100, 0.0),
    (8, True, False): (8, 32, 32, 0.0), (8, True, True): (2, 128, 128, 0.0),
    (8, False, False): (43, 2, 4, 0.2), (8, False, True): (2, 100, 128, 0.0),
    (16, True, False): (16, 32, 32, 0.0), (16, True, True): (4, 128, 128, 0.0),
    (16, False, False): (43, 2, 8, 0.2), (16, False, True): (3, 128, 128, 0.0),
}


def _staged_instance(H, dsh, dvh):
    """(NC, FULL, WIDE) of the staged K9/K10-dq a shape launches (the
    rule of ``dot_slots`` and ``dot_full`` in attention_kernels.cu)."""
    wp = 1 << (max(dsh, dvh) - 1).bit_length()
    nc = 1 << (-(-H * wp // 32) - 1).bit_length()
    return nc, dsh == dvh == wp and H * wp == 32 * nc, wp > 32


def _misaligned(t):
    """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary, so the
    dot kernels stage its rows by 4-byte copies."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("instance", sorted(DOT_STAGED_CASES))
def test_dot_fwd_and_dq_every_slot_count(cuda, instance, rate, aligned):
    """The dot-mode K9 and K10-dq (staged through shared memory, as
    K10-dkv) in every instantiation (NC, FULL, WIDE), with rows staged by
    16-byte copies and (misaligned inputs) by 4-byte copies, against
    float64 on a graph whose hub destination and hub source split; two
    runs give the same bits."""
    nc, full, wide = instance
    *shape, leaky = DOT_STAGED_CASES[instance]
    shape = tuple(shape)
    assert _staged_instance(*shape) == instance
    g = Graph(attention_graph(3000, 40000, seed=6), num_nodes=3000
              ).tensor(cuda)
    lays = g._attention_layouts()
    assert lays[0].num_partials > 0 and lays[1].num_partials > 0
    gen = torch.Generator(device=cuda).manual_seed(nc + 100 * full
                                                   + 1000 * wide)
    ins = dot_inputs(3000, shape, cuda, gen)
    if not aligned:
        ins = tuple(_misaligned(t) for t in ins)
    seed = torch.tensor([-123456789], dtype=torch.int32, device=cuda)
    got = run_dot(lays, ins, shape, leaky, rate, seed)
    again = run_dot(lays, ins, shape, leaky, rate, seed)
    torch.cuda.synchronize()
    assert all(map(torch.equal, got, again))
    check_dot(f"NC={nc}", lays, ins, shape, leaky, rate, seed, got)


@pytest.mark.gpu
@pytest.mark.parametrize("nc", sorted(DOT_NC_SHAPES))
def test_dot_fwd_and_dq_keep_masks_are_the_plain_mask(cuda, nc):
    """On a permutation graph (one edge a row): with q = k = 0 and v = 1,
    K9's out is 1 / (1 - rate) where the edge is kept and 0 where it is
    dropped; with q = 0, k = g = v = 1 and lse = delta = 0, K10-dq's dq is
    dvh / (1 - rate) where kept and 0 where dropped. Both keep bits equal
    ``drop_keep`` of the edge's CSC position for every head."""
    n, rate = 4096, 0.3
    H, dsh, dvh = shape = DOT_NC_SHAPES[nc]
    g, _ = _permutation_graph(n, cuda)
    csc = g._attention_layouts()[0]
    zeros = torch.zeros(n, H * dsh, device=cuda)
    ones_s = torch.ones(n, H * dsh, device=cuda)
    ones = torch.ones(n, H * dvh, device=cuda)
    zero_h = torch.zeros(n, H, device=cuda)
    seed = torch.tensor([-1640531535], dtype=torch.int32, device=cuda)
    with torch.no_grad():
        out, _ = ak._dot_fwd_cuda(zeros, zeros, ones, csc, 0.0, dsh, dvh,
                                  rate, seed)
        dq = ak._dot_dq_cuda(zeros, ones_s, ones, ones, zero_h, zero_h, csc,
                             0.0, dsh, dvh, rate, seed)
    pos = torch.empty_like(csc.positions())
    pos[csc.seg_ids.long()] = csc.positions()
    want = torch.stack([ak.drop_keep(pos, seed, h, rate) for h in range(H)],
                       dim=1)
    assert torch.equal(out.reshape(n, H, dvh) != 0,
                       want[:, :, None].expand(n, H, dvh))
    assert torch.equal(dq.reshape(n, H, dsh) != 0,
                       want[:, :, None].expand(n, H, dsh))


@pytest.mark.gpu
@pytest.mark.parametrize("nc", sorted(DOT_NC_SHAPES))
def test_dot_dq_recomputes_the_forward_scores(cuda, nc):
    """On a permutation graph at rate 0 K9's lse of each row is its one
    edge's score, so K10-dq's p = exp(s - lse) is exactly 1; with g = v =
    1 and delta = 0, dq = p * dvh * k[src] equals dvh * k[src] bit for bit
    only where K10-dq recomputes the score with K9's bits."""
    n = 4096
    H, dsh, dvh = shape = DOT_NC_SHAPES[nc]
    g, src = _permutation_graph(n, cuda, seed=13)
    csc = g._attention_layouts()[0]
    gen = torch.Generator(device=cuda).manual_seed(nc)
    q, k, _, _ = dot_inputs(n, shape, cuda, gen)
    ones = torch.ones(n, H * dvh, device=cuda)
    seed = torch.tensor([0], dtype=torch.int32, device=cuda)
    with torch.no_grad():
        _, lse = ak._dot_fwd_cuda(q * 4, k, ones, csc, 0.0, dsh, dvh, 0.0,
                                  seed)
        dq = ak._dot_dq_cuda(q * 4, k, ones, ones, lse, torch.zeros_like(lse),
                             csc, 0.0, dsh, dvh, 0.0, seed)
    assert bool((lse != 0).any())
    assert torch.equal(dq, k[src] * dvh)


@pytest.mark.gpu
def test_send_u_recv_of_an_int64_feature_on_cuda(cuda):
    """An int64 feature on a CUDA graph takes the segment path (no kernel
    takes it, ``dispatch.plain_on_cuda``) and gives the CPU graph's sums
    exactly, with no K1 launch; a float32 one still launches K1."""
    host = Graph(skewed_graph(100, 800, seed=6), num_nodes=100)
    x = torch.ones(100, 2, dtype=torch.int64)
    want = host.tensor("cpu").send_u_recv(x, "sum")
    g = host.tensor(cuda)
    sk.reset_launches()
    got = g.send_u_recv(x.to(cuda), "sum")
    assert sk.LAUNCHES == 0
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
    g.send_u_recv(x.to(cuda, torch.float32), "sum")
    assert sk.LAUNCHES == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_on_cuda_raises(cuda, dtype):
    """No kernel has a half-precision instantiation yet, and the reference
    sends bf16 to its kernels: a bf16 or fp16 feature on a CUDA graph
    reaches the wrapper, which raises rather than running the plain
    version, with no launch counted."""
    host = Graph(skewed_graph(100, 800, seed=6), num_nodes=100)
    g = host.tensor(cuda)
    sk.reset_launches()
    with pytest.raises(TypeError):
        g.send_u_recv(torch.ones(100, 2, dtype=dtype, device=cuda), "sum")
    assert sk.LAUNCHES == 0


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float64,
                                    torch.int64])
def test_send_ue_recv_weights_take_the_feature_dtype(cuda, wdtype):
    """A float32 feature with edge weights of another dtype: the weights
    take the feature's dtype, so K1w launches and gives the CPU graph's
    float32 result (rtol/atol 1e-5: float32 sums in another order)."""
    host = Graph(skewed_graph(100, 800, seed=6), num_nodes=100)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(100, 8)), dtype=torch.float32)
    w = torch.as_tensor(rng.integers(-3, 4, size=800)).to(wdtype)
    want = host.tensor("cpu").send_ue_recv(x, w, "mul", "sum")
    g = host.tensor(cuda)
    sk.reset_launches()
    got = g.send_ue_recv(x.to(cuda), w.to(cuda), "mul", "sum")
    assert sk.LAUNCHES == 1 and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["TransformerConv", "UniMP"])
def test_transformer_on_cuda_matches_cpu(cuda, kind):
    """A small TransformerConv (3 heads of 8) and UniMP (2 heads of 16,
    labels fed through a mask), CUDA kernels against the CPU's plain
    versions with the same weights: logits and every parameter gradient at
    ``check``'s rule, and the dot kernels launched."""
    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    mask = np.random.default_rng(2).random(300) < 0.5
    res = {}
    ak.reset_launches()
    for dev in ("cpu", cuda):
        gt = g.tensor(dev)
        y = torch.as_tensor(labels, device=dev).long()
        gen = torch.Generator().manual_seed(0)
        if kind == "UniMP":
            model = UniMP(16, 3, hidden_size=16, num_heads=2, dropout=0.0,
                          generator=gen, device=dev)
            args = (y, torch.as_tensor(mask, device=dev))
        else:
            model = TransformerConv(16, 8, num_heads=3, feat_drop=0.0,
                                    attn_drop=0.0, generator=gen, device=dev)
            args = ()
        logits = model(gt, gt.node_feat["h"], *args, training=True)
        logits.square().sum().backward()
        res[str(dev)] = (logits.detach().cpu(),
                         {k: p.grad.cpu() for k, p in model.named_parameters()})
    torch.cuda.synchronize()
    launched = {k for k, v in ak.LAUNCHES_BY_SHAPE.items() if v}
    assert {k[0] for k in launched} == set(DOT_KERNELS)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res[str(cuda)]
    check("logits", l_gpu, l_cpu)
    for k in g_cpu:
        check(f"grad {k}", g_gpu[k], g_cpu[k])


@pytest.mark.gpu
def test_dot_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = Graph(skewed_graph(100, 800, seed=6), num_nodes=100)
    lays = g.tensor(cuda)._attention_layouts()
    q = torch.randn(100, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak._dot_fwd_cuda(q, q, q, lays[0], 0.0, 4, 4, 0.0,
                         torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        ak.fused_graph_attention(*(t.to(cuda, torch.float64)
                                   for t in (q, q, q)), *lays, 2)
    with pytest.raises(ValueError, match="layout"):
        ak.fused_graph_attention(*(t.to(cuda) for t in (q, q, q)),
                                 *g.tensor("cpu")._attention_layouts(), 2)
    wide = torch.randn(100, 2 * 512, device=cuda)
    with pytest.raises(ValueError, match="slots"):
        ak.fused_graph_attention(wide, wide, torch.randn(100, 2, device=cuda),
                                 *lays, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("H,dsh,dvh", [(2, 128, 128), (8, 16, 16), (4, 64, 8)])
def test_dedup_dot_kernels_match_plain_version(cuda, H, dsh, dvh, rate):
    """The dot-mode K7 and K8 on a graph whose hub destination and hub
    source are split across pieces; two runs, and the layout without
    counts, give the same bits."""
    g = Graph(attention_graph(3000, 40000, seed=4), num_nodes=3000
              ).tensor(cuda)
    att = dedup_attention_of(g, cuda)
    assert att.num_partials > 0 and att.num_node_partials > 0
    shape = (H, dsh, dvh)
    gen = torch.Generator(device=cuda).manual_seed(H * dsh * dvh)
    ins = dot_inputs(3000, shape, cuda, gen)
    seed = torch.tensor([-987654321], dtype=torch.int32, device=cuda)
    bare = without_counts(att)
    da.reset_launches()
    got = run_dedup_dot(att, ins, shape, rate, seed)
    for other in (att, bare):
        assert all(map(torch.equal, got,
                       run_dedup_dot(other, ins, shape, rate, seed)))
    torch.cuda.synchronize()
    want = {(k + c, *shape): 3 for k in DDOT_KERNELS
            for c in ("", "_combine")}
    want["dedup_dot_bwd_node_combine", *shape] = 3
    assert dict(da.LAUNCHES_BY_SHAPE) == want
    check_dedup_dot("small", att, ins, shape, rate, seed, got)
    out, lse = got[:2]
    assert (out[1:1500] == 0).all() and (lse[1:1500] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("instance", sorted(DOT_STAGED_CASES))
def test_dedup_dot_every_slot_count(cuda, instance, rate, aligned):
    """The dot-mode K7 and K8 (the staged kernels' cell form) in every
    instantiation (NC, FULL, WIDE) of ``DOT_STAGED_CASES``, 16- and 4-byte
    staging, against float64 on a multigraph whose hub destination and hub
    source split; two runs and a layout without counts give the same
    bits."""
    nc, full, wide = instance
    *shape, leaky = DOT_STAGED_CASES[instance]
    shape = tuple(shape)
    edges = attention_graph(3000, 40000, seed=6)
    edges[-4000:] = edges[:4000]
    g = Graph(edges, num_nodes=3000).tensor(cuda)
    att = dedup_attention_of(g, cuda)
    assert att.num_partials > 0 and att.num_node_partials > 0
    assert int(att.cell_cnt.max()) > 1
    gen = torch.Generator(device=cuda).manual_seed(nc + 100 * full
                                                   + 1000 * wide)
    ins = dot_inputs(3000, shape, cuda, gen)
    if not aligned:
        ins = tuple(_misaligned(t) for t in ins)
    seed = torch.tensor([-123456789], dtype=torch.int32, device=cuda)
    got = run_dedup_dot(att, ins, shape, rate, seed, leaky)
    for other in (att, without_counts(att)):
        assert all(map(torch.equal, got, run_dedup_dot(
            other, ins, shape, rate, seed, leaky)))
    torch.cuda.synchronize()
    check_dedup_dot(f"NC={nc}", att, ins, shape, rate, seed, got, leaky)


def _cells_as_edge_layouts(att):
    """Per-edge work lists (``ak.AttentionLayout``) over K7/K8's cell lists:
    the row-ordered cells as CSC edges, the node-ordered cells as CSR edges
    whose ``eidx`` is the cells' keys."""
    n, N = att.num_cells, att.num_rows

    def layout(kind, indices, eidx, pieces, split_rows, split_ptr,
               num_partials):
        row, begin, end, _ = pieces.long().T
        rows = torch.repeat_interleave(row, end - begin)
        indptr = torch.cat([rows.new_zeros(1), torch.cumsum(torch.bincount(
            rows, minlength=N), 0)])
        items, n_long, empty = ak.k10_work_list(indptr.cpu().numpy(),
                                                pieces.cpu().numpy())
        return ak.AttentionLayout(
            kind=kind, num_rows=N, num_edges=n,
            max_index=int(indices.max()), num_partials=num_partials,
            k10_long=n_long, indices=indices, seg_ids=rows.int(), eidx=eidx,
            pieces=pieces, split_rows=split_rows, split_ptr=split_ptr,
            k10_items=torch.as_tensor(items.astype(np.int32),
                                      device=pieces.device),
            empty_rows=torch.as_tensor(empty.astype(np.int32),
                                       device=pieces.device))

    return (layout("csc", att.cell_src, None, att.pieces, att.split_rows,
                   att.split_ptr, att.num_partials),
            layout("csr", att.node_dst, att.node_key, att.node_pieces,
                   att.node_split_rows, att.node_split_ptr,
                   att.num_node_partials))


@pytest.mark.gpu
@pytest.mark.parametrize("instance", sorted(DOT_STAGED_CASES))
def test_dedup_dot_cell_form_is_the_edge_form_at_count_one(cuda, instance):
    """On a simple graph (every count 1) the cell form of the three staged
    kernels gives the per-edge form's bits over the same lists: K7's out
    and lse and K8's dq at rate 0 (K9 and K10-dq key the dropout by
    position), K8's dk and dv at rate 0.3 too (K10-dkv reads its keys from
    ``eidx``, here the cells'). So the count and the key enter where the
    per-edge arithmetic has its 1 and its position, and nowhere else."""
    nc, full, wide = instance
    *shape, leaky = DOT_STAGED_CASES[instance]
    H, dsh, dvh = shape = tuple(shape)
    edges = np.unique(attention_graph(3000, 40000, seed=6), axis=0)
    g = Graph(edges, num_nodes=3000).tensor(cuda)
    att = dedup_attention_of(g, cuda)
    assert int(att.cell_cnt.max()) == 1 and att.num_node_partials > 0
    csc, csr = _cells_as_edge_layouts(att)
    gen = torch.Generator(device=cuda).manual_seed(nc)
    q, k, v, g_out = dot_inputs(3000, shape, cuda, gen)
    for rate in (0.0, 0.3):
        seed = torch.tensor([-5555], dtype=torch.int32, device=cuda)
        out, lse, dq, dk, dv = run_dedup_dot(att, (q, k, v, g_out), shape,
                                             rate, seed, leaky)
        with torch.no_grad():
            delta = (g_out.reshape(-1, H, dvh)
                     * out.reshape(-1, H, dvh)).sum(-1)
            bwd = (q, k, v, g_out, lse, delta)
            dk_e, dv_e = ak._dot_dkv_cuda(*bwd, csr, leaky, dsh, dvh, rate,
                                          seed)
            assert torch.equal(dk, dk_e) and torch.equal(dv, dv_e)
            if rate == 0:
                out_e, lse_e = ak._dot_fwd_cuda(q, k, v, csc, leaky, dsh,
                                                dvh, rate, seed)
                dq_e = ak._dot_dq_cuda(*bwd, csc, leaky, dsh, dvh, rate,
                                       seed)
                assert torch.equal(out, out_e) and torch.equal(lse, lse_e)
                assert torch.equal(dq, dq_e)


@pytest.mark.gpu
@pytest.mark.parametrize("nc", sorted(DOT_NC_SHAPES))
def test_dedup_dot_keep_masks_are_the_plain_cell_mask(cuda, nc):
    """On a permutation graph (one cell a row and a node): with q = k = 0
    and v = 1, K7's out is 1 / (1 - rate) where the cell is kept and 0
    where it is dropped; with q = 0, k = g = v = 1 and lse = delta = 0, K8's
    dq is dvh / (1 - rate) and its dv (the node walk, on the cell's node)
    1 / (1 - rate) where kept, 0 where dropped. All three keep bits equal
    ``drop_keep`` of the cell key ``cell_idx`` for every head."""
    n, rate = 4096, 0.3
    H, dsh, dvh = shape = DOT_NC_SHAPES[nc]
    g, _ = _permutation_graph(n, cuda)
    att = dedup_attention_of(g, cuda, counts=False)
    lay = att.layout
    dst, urow, _ = da._edge_slots(lay)
    key = da.cell_idx(dst, urow)
    zeros = torch.zeros(n, H * dsh, device=cuda)
    ones_s = torch.ones(n, H * dsh, device=cuda)
    ones = torch.ones(n, H * dvh, device=cuda)
    zero_h = torch.zeros(n, H, device=cuda)
    seed = torch.tensor([-1640531535], dtype=torch.int32, device=cuda)
    with torch.no_grad():
        out, _ = da._dot_fwd_cuda(zeros, zeros, ones, att, 0.0, dsh, dvh,
                                  rate, seed)
        dq, _, dv = da._dot_bwd_cuda(zeros, ones_s, ones, ones, zero_h,
                                     zero_h, att, 0.0, dsh, dvh, rate, seed)
    want = torch.stack([ak.drop_keep(key, seed, h, rate) for h in range(H)],
                       dim=1)
    for got, rows, w in ((out, dst, dvh), (dq, dst, dsh),
                         (dv, lay.uv.long()[urow], dvh)):
        assert torch.equal(got.reshape(n, H, w)[rows] != 0,
                           want[:, :, None].expand(n, H, w))


@pytest.mark.gpu
def test_dedup_dot_keeps_the_parent_bits(cuda):
    """K7-dot's out and lse and K8-dot's dq equal 12a5247's bits on the
    pinned cases (``chip_smoke.PARENT_BITS``)."""
    assert len(check_parent_bits(cuda)) == 6


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["TransformerConv", "UniMP"])
def test_transformer_on_dedup_graph_on_cuda_matches_cpu(cuda, kind):
    """A small TransformerConv (3 heads of 8) and UniMP (2 heads of 16) on
    a graph with dedup layouts (the band opened to it): the dot-mode K7/K8
    (dk and dv on node rows) against the CPU's plain versions with the
    same weights,
    logits and every parameter gradient at ``check``'s rule."""
    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    mask = np.random.default_rng(2).random(300) < 0.5
    res = {}
    for dev in ("cpu", cuda):
        with dispatch_settings(DEDUP=True, DEDUP_MIN_EDGES=0):
            gt = g.tensor(dev)
        y = torch.as_tensor(labels, device=dev).long()
        gen = torch.Generator().manual_seed(0)
        if kind == "UniMP":
            model = UniMP(16, 3, hidden_size=16, num_heads=2, dropout=0.0,
                          generator=gen, device=dev)
            args = (y, torch.as_tensor(mask, device=dev))
        else:
            model = TransformerConv(16, 8, num_heads=3, feat_drop=0.0,
                                    attn_drop=0.0, generator=gen, device=dev)
            args = ()
        da.reset_launches()
        logits = model(gt, gt.node_feat["h"], *args, training=True)
        logits.square().sum().backward()
        res[str(dev)] = (logits.detach().cpu(),
                         {k: p.grad.cpu() for k, p in model.named_parameters()})
    torch.cuda.synchronize()
    assert {k[0] for k, v in da.LAUNCHES_BY_SHAPE.items() if v} == set(
        DDOT_KERNELS)
    assert gt._attn_layouts is None
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res[str(cuda)]
    check("logits", l_gpu, l_cpu)
    for k in g_cpu:
        check(f"grad {k}", g_gpu[k], g_cpu[k])


@pytest.mark.gpu
def test_dedup_dot_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = Graph(skewed_graph(100, 800, seed=6), num_nodes=100)
    att = dedup_attention_of(g.tensor(cuda), cuda, counts=False)
    q = torch.randn(100, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da._dot_fwd_cuda(q, q, q, att, 0.0, 4, 4, 0.0,
                         torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        da.dedup_dot_attention(*(t.to(cuda, torch.float64)
                                 for t in (q, q, q)), att, 2)
    with pytest.raises(ValueError, match="layout"):
        da.dedup_dot_attention(*(t.to(cuda) for t in (q, q, q)),
                               dedup_attention_of(g.tensor("cpu"), "cpu"), 2)
    wide = torch.randn(100, 2 * 512, device=cuda)
    with pytest.raises(ValueError, match="slots"):
        da.dedup_dot_attention(wide, wide, torch.randn(100, 2, device=cuda),
                               att, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("H,D", [(1, 1), (1, 64), (8, 64), (8, 16), (3, 9),
                                 (16, 16), (2, 200), (1, 600), (3, 600)])
def test_k1w_matches_plain_version(cuda, op, H, D):
    """K1w forward, dx and dw (one launch over CSR) on the skewed graph
    (split rows both ways): scalar and per-head weights, vector and scalar
    loads (dh % 4), heads that span two vectors a lane (D = 200, dh = 100),
    and past 512 columns, where a row takes two column passes and a head
    crosses from the first into the second (D = 600); two runs give the
    same bits."""
    g = Graph(skewed_graph(3000, 40000, seed=7), num_nodes=3000).tensor(cuda)
    csc, csr = g._spmm_layouts
    gen = torch.Generator(device=cuda).manual_seed(H * 1000 + D)
    x = torch.randn(3000, D, device=cuda, generator=gen)
    w = torch.randn(40000, H, device=cuda, generator=gen)
    cot = torch.randn(3000, D, device=cuda, generator=gen)
    sk.reset_launches()
    first = run_weighted(x, w, cot, csc, csr, op)
    assert dict(sk.LAUNCHES_BY_SHAPE) == {(op, "csc", D, H): 1,
                                          (op, "csr", D, H): 1}
    again = run_weighted(x, w, cot, csc, csr, op)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    check_weighted(f"{op} H={H} D={D}", x, w, cot, csc, csr, op, *first)


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False], ids=["vec", "unaligned"])
@pytest.mark.parametrize("D", [1, 3, 8, 16, 64, 128])
def test_k1w_work_items_match_plain_version(cuda, D, aligned):
    """K1w over every kind of work item (a hub's pieces, rows of their own,
    packs of short rows, empty rows) at every head count that divides D,
    mul and add, on 16-byte vectors and on the scalar path: forward, dx
    with dw and dw alone against float64, the same bits twice."""
    edges, n = k1_case_edges()
    g = Graph(edges, num_nodes=n).tensor(cuda)
    kinds = g._spmm_layouts[0].items[:, 3].cpu().numpy()
    assert (kinds >= 0).any() and (kinds == -1).any() and (kinds < -1).any()
    gen = torch.Generator(device=cuda).manual_seed(D)
    check_k1w_items(g, D, aligned, cuda, gen)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mul", "add"])
def test_k1w_one_gradient_alone(cuda, op):
    """dx alone (weights without a gradient: for add, K1's unweighted sum,
    counted as K1) and dw alone (the launch that writes only dw, keyed
    ``mul_dw`` / ``add_dw``)."""
    g = Graph(skewed_graph(3000, 40000, seed=8), num_nodes=3000).tensor(cuda)
    csc, csr = g._spmm_layouts
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(3000, 32, device=cuda, generator=gen)
    w = torch.randn(40000, 4, device=cuda, generator=gen)
    cot = torch.randn(3000, 32, device=cuda, generator=gen)
    sk.reset_launches()
    _, dx, none_w = run_weighted(x, w, cot, csc, csr, op, need_dw=False)
    none_x, _, dw = run_weighted(x, w, cot, csc, csr, op, need_dx=False)
    assert none_w is None and dx is not None and dw is not None
    dx_key = ("mul", "csr", 32, 4) if op == "mul" else ("csr", 32)
    assert dict(sk.LAUNCHES_BY_SHAPE) == {
        (op, "csc", 32, 4): 2, dx_key: 1, (f"{op}_dw", "csr", 32, 4): 1}
    check_weighted("alone", x, w, cot, csc, csr, op, None, dx, dw)


@pytest.mark.gpu
def test_k1w_launch_refuses_an_unweighted_pass(cuda):
    """wop 0 without a dwop is K1, whose entry point is ``pgl_spmm_f32``:
    the weighted entry point refuses it."""
    g = Graph(skewed_graph(300, 4000, seed=8), num_nodes=300).tensor(cuda)
    csr = g._spmm_layouts[1]
    x = torch.randn(300, 16, device=cuda)
    w = torch.randn(4000, 1, device=cuda)
    out = torch.empty(300, 16, device=cuda)
    part = torch.empty(max(csr.item_partials, 1), 16, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk._launch_weighted(x, w, csr, out, part, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("D", [1, 16, 64, 130])
def test_weighted_dedup_kernel_matches_plain_version(cuda, D, spread):
    """The weighted K6 forward, dx (over CSR) and dw (K1w's pass) against
    float64, the same bits twice, and K1w's results within tolerance; with
    normal weights, and with weights over six orders of magnitude
    (``spread``), whose sums need every bf16 plane of C."""
    with dispatch_settings(DEDUP=True, DEDUP_MIN_EDGES=0):
        g = Graph(skewed_graph(3000, 40000, seed=9), num_nodes=3000
                  ).tensor(cuda)
    csc_d, csr_d = g._dedup_layouts
    csc, csr = g._spmm_layouts
    assert not csc_d.simple
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn(3000, D, device=cuda, generator=gen)
    w = (spread_weights(40000, cuda, gen) if spread
         else torch.randn(40000, device=cuda, generator=gen))
    cot = torch.randn(3000, D, device=cuda, generator=gen)
    dk.reset_launches()
    sk.reset_launches()
    runs = []
    for _ in range(2):
        xr = x.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        out = dk.spmm_dedup_weighted(xr, wr, csc_d, csr_d, csr)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        runs.append((out.detach(), xr.grad, wr.grad))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert dict(dk.LAUNCHES_BY_SHAPE) == {("dedup_weighted", "csc", D): 2,
                                          ("dedup_weighted", "csr", D): 2}
    assert dict(sk.LAUNCHES_BY_SHAPE) == {("mul_dw", "csr", D, 1): 2}
    out, dx, dw = runs[0]
    check_weighted("weighted K6", x, w[:, None], cot, csc, csr, "mul", out,
                   dx, dw[:, None])
    k1w = run_weighted(x, w[:, None], cot, csc, csr, "mul")
    with torch.no_grad():
        check("K6w vs K1w", out, k1w[0],
              weighted_terms(x, w[:, None], csc, "mul")[1])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["FAGCN", "FAGCN dedup", "GATv2",
                                  "GATConv unfused"])
def test_weighted_models_on_cuda_match_cpu(cuda, kind):
    """Output and parameter gradients, CUDA against CPU with the same
    weights; the unfused GATConv (48 heads, attention dropout) with its
    dropout replaced by the identity."""
    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    res = {}
    for dev in ("cpu", cuda):
        with dispatch_settings(DEDUP=kind.endswith("dedup"),
                               DEDUP_MIN_EDGES=0):
            gt = g.tensor(dev)
        gen = torch.Generator().manual_seed(0)
        model = (FAGCN(16, 3, hidden_size=16, generator=gen, device=dev)
                 if kind.startswith("FAGCN") else
                 GATv2(16, 3, generator=gen, device=dev) if kind == "GATv2"
                 else GATConv(16, 2, feat_drop=0.0, attn_drop=0.5,
                              num_heads=48, generator=gen, device=dev))
        with no_dropout():
            out = model(gt, gt.node_feat["h"], kind == "GATConv unfused")
        out.square().mean().backward()
        res[str(dev)] = (out.detach().cpu(),
                         {k: p.grad.cpu() for k, p in model.named_parameters()})
    (o_cpu, g_cpu), (o_gpu, g_gpu) = res["cpu"], res[str(cuda)]
    check("output", o_gpu, o_cpu)
    for k in g_cpu:
        check(f"grad {k}", g_gpu[k], g_cpu[k])


@pytest.mark.gpu
def test_weighted_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g = Graph(skewed_graph(100, 800, seed=6), num_nodes=100).tensor(cuda)
    csc, csr = g._spmm_layouts
    x = torch.randn(100, 8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        sk.spmm_weighted(x.double(), torch.randn(800, 1, device=cuda,
                                                 dtype=torch.float64),
                         csc, csr)
    with pytest.raises(ValueError, match="contiguous"):
        sk.spmm_weighted(x, torch.randn(2, 800, device=cuda).t(), csc, csr)
    with pytest.raises(ValueError, match="H \\| D"):
        sk.spmm_weighted(x, torch.randn(800, 3, device=cuda), csc, csr)
    with pytest.raises(ValueError, match="float32 on cpu"):
        sk.spmm_weighted(x, torch.randn(800, 1), csc, csr)


@pytest.fixture
def skewed_sddmm(cuda):
    g = Graph(skewed_graph(3000, 40000, seed=6), num_nodes=3000).tensor(cuda)
    return g, g.sddmm_layout()


@pytest.mark.gpu
@pytest.mark.parametrize("op", SDDMM_OPS)
@pytest.mark.parametrize("D", [1, 3, 16, 128])
def test_sddmm_kernel_equals_plain_version(cuda, skewed_sddmm, op, D):
    g, lay = skewed_sddmm
    gen = torch.Generator(device=cuda).manual_seed(D)
    x, y = sddmm_inputs(g.num_nodes, D, cuda, gen)
    sdk.reset_launches()
    check_sddmm("skewed", lay, x, y, op)
    assert dict(sdk.LAUNCHES_BY_SHAPE) == {("sddmm", op, D): 2}
    x, y = sddmm_inputs(g.num_nodes, D, cuda, gen, zeros=True)
    out = check_sddmm("skewed zeros", lay, x, y, op)
    # through Graph.sddmm_csc: the same kernel, and a non-16-byte-aligned
    # view takes the 4-byte path with the same bits
    assert torch.equal(g.sddmm_csc(x, y, op).view(torch.int32),
                       out.view(torch.int32))
    if D % 4 == 0:
        xs = torch.empty(g.num_nodes * D + 1, device=cuda)[1:].view(-1, D)
        xs.copy_(x)
        assert torch.equal(sdk.sddmm_dedup(xs, y, lay, op).view(torch.int32),
                           out.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("op", SDDMM_OPS)
@pytest.mark.parametrize("D", [1, 16, 128])
def test_sddmm_backward_matches_float64(cuda, skewed_sddmm, op, D):
    g, lay = skewed_sddmm
    gen = torch.Generator(device=cuda).manual_seed(D + 1)
    x, y = sddmm_inputs(g.num_nodes, D, cuda, gen)
    check_sddmm_grad("skewed", x, y, lay, op, gen)


@pytest.mark.gpu
def test_sddmm_raises_without_its_library(cuda, skewed_sddmm, monkeypatch,
                                          tmp_path):
    """A failed nvcc, or a library that cannot be loaded, raises on the
    card; nothing falls back to the plain version."""
    g, lay = skewed_sddmm
    x = torch.randn(g.num_nodes, 8, device=cuda)
    sdk.reset_launches()
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "sddmm_kernels.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "CSRC", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="CUDA build failed"):
        g.sddmm_csc(x, x, "mul")
    monkeypatch.setattr(_build, "build",
                        lambda *names: {n: tmp_path / "missing.so"
                                        for n in names})
    with pytest.raises(OSError):
        sdk.sddmm_dedup(x, x, lay, "mul")
    assert sdk.LAUNCHES == 0


@pytest.mark.gpu
def test_sddmm_wrapper_rejects_what_the_kernel_does_not_take(cuda,
                                                            skewed_sddmm):
    g, lay = skewed_sddmm
    x = torch.randn(g.num_nodes, 8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        sdk.sddmm_dedup(x.double(), x.double(), lay)
    with pytest.raises(ValueError, match="contiguous"):
        sdk.sddmm_dedup(torch.randn(8, g.num_nodes, device=cuda).t(), x, lay)
    with pytest.raises(ValueError, match="layout"):
        sdk.sddmm_dedup(x.cpu(), x.cpu(), lay)


@pytest.mark.gpu
def test_zoo_on_cuda_matches_cpu(cuda):
    """``chip_smoke.phase_zoo_small``: the loss on a label outside the
    classes; every layer and model of the conv-layer zoo, CUDA against CPU
    with the same weights (output and every gradient), K1 launched where a
    sum or mean runs and nowhere else; ``remat`` bit for bit at dropout
    0.6 for GCN, GraphSage and DeepGCNII."""
    phase_zoo_small(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_k1_over_a_rectangular_layout_with_empty_rows(cuda, reduce):
    """A BiGraph of 3,000 sources -> 8,000 destinations whose edges reach
    only the first 2,000 (three quarters of the rows empty) and whose
    source 7 sends 40% of them (a split row on the gradient's layout): K1
    both ways against float64, zeros on the empty rows."""
    rng = np.random.default_rng(9)
    E = 30000
    src = rng.integers(0, 3000, E)
    src[:E * 2 // 5] = 7
    edges = np.stack([src, rng.integers(0, 2000, E)], axis=1)
    bg = BiGraph(edges, src_num_nodes=3000, dst_num_nodes=8000).tensor(cuda)
    csc, csr = bg._spmm_layouts
    assert (csc.num_rows, csr.num_rows) == (8000, 3000)
    assert csr.item_partials > 0
    check_rect_spmm("bigraph", bg, reduce, cuda,
                    torch.Generator(device=cuda).manual_seed(3))


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("etype", ["writes", "writed_by"])
def test_dot_kernels_on_a_relation_with_empty_rows(cuda, etype, rate):
    """The dot-mode K9/K10 at UniMP's shape on a small ogbn-mag-shaped
    relation (``writes``: no author receives an edge; ``writed_by``: no
    paper), against float64, zeros on the rows without edges."""
    hg, _, P = mag_host(num_papers=3000, avg_degree=16)
    g = hg.tensor(cuda)[etype]
    empty = int((g.indegree() == 0).sum())
    assert empty > g.num_nodes // 3
    check_empty_rows_dot(etype, g, rate, cuda,
                         torch.Generator(device=cuda).manual_seed(4))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(READOUT_PER_STEP))
def test_readouts_on_cuda_match_cpu(cuda, name):
    """``chip_smoke.parity_and_steps`` on 64 motif graphs: each readout
    model CUDA against a float64 CPU run, then 3 steps with its K1 launches
    asserted."""
    host, labels = motif_host(num_graphs=64)
    host = noisy_features(host)
    parity_and_steps(name, host, host, lambda d: readout_model(name, d),
                     readout_trainer(name, labels), READOUT_PER_STEP[name],
                     cuda)


def _sampling_graph(n=3000, seed=6):
    """A community graph whose top tenth sends no edge (dead ends for the
    walks, zero in-degrees for the sampler's frontier)."""
    g, y = community_graph(num_nodes=n, num_classes=8, feat_dim=4,
                           avg_degree=12, seed=seed)
    e = np.asarray(g.edges)
    e = e[e[:, 0] < n - n // 10]
    return Graph(e, num_nodes=n), y


@pytest.mark.gpu
def test_device_samplers_on_cuda(cuda):
    """``NeighborSampler`` and ``HeteroNeighborSampler`` on the card, one
    generator there: every sampled neighbour an in-neighbour of its node,
    masks 1 exactly where the node has in-edges."""
    from pgl_tpu_torch import HeterGraph
    from pgl_tpu_torch.sampling import HeteroNeighborSampler, NeighborSampler
    g, _ = _sampling_graph()
    gen = torch.Generator(device=cuda).manual_seed(1)
    sampler = NeighborSampler(g, (25, 10), device=cuda)
    seeds = torch.arange(2800, 3000, device=cuda)
    layers, frontier = sampler.sample(seeds, gen)
    assert frontier.shape == (200 * 250,) and frontier.is_cuda
    check_device_samples(sampler, layers, "NeighborSampler")
    e = np.asarray(g.edges)
    hg = HeterGraph({"a": e, "b": e[::-1].copy()}, num_nodes=g.num_nodes)
    hs = HeteroNeighborSampler(hg, (5, 3), device=cuda)
    hlayers, _ = hs.sample(seeds, gen)
    for frontier, per in hlayers:
        for et, (neigh, mask) in per.items():
            sub = NeighborSampler(hg[et], (1,), device=cuda)
            check_device_samples(sub, [(frontier, neigh, mask)], et)


@pytest.mark.gpu
@pytest.mark.parametrize("walk", ["random_walk", "node2vec_walk"])
def test_device_walks_on_cuda(cuda, walk):
    """``DeviceWalker`` on the card from every node: every hop an edge,
    dead ends -1 to the end."""
    from pgl_tpu_torch.sampling import DeviceWalker, skipgram_pairs
    g, _ = _sampling_graph()
    w = DeviceWalker(g, neighbor_sorted=True, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    starts = torch.arange(g.num_nodes, device=cuda)
    walks = getattr(w, walk)(starts, 12, gen)
    hops, dead = check_walks(w, walks, walk)
    assert hops > 0 and dead >= g.num_nodes // 10
    src, dst, valid = skipgram_pairs(walks, 5, gen)
    assert bool((src[valid] >= 0).all()) and bool((dst[valid] >= 0).all())


@pytest.mark.gpu
def test_batch_graph_with_host_layouts_runs_k1(cuda):
    """A minibatch of the ``layouts=True`` collate at phase 13's buckets:
    K1 over the CSC and CSR layouts built on the host (the sentinel row's
    pad edges split) against float64, within ``check_spmm``'s bound of
    1e-4 times the terms' 2-norm (the sentinel row sums ~56,000 copies of
    one row, so its absolute error is of order 1, not under 1e-3)."""
    from pgl_tpu_torch.sampling import make_padded_batch_fn
    g, y = _sampling_graph(n=20000)
    NB, EB = SAGE_BUCKETS
    batch = make_padded_batch_fn(g, (25, 10), NB, EB, pack=True,
                                 layouts=True)([(i, y[i])
                                                for i in range(512)])
    err, share, graph = check_batch_graph_k1(batch, cuda, "gpu test")
    assert np.isfinite(err) and share <= 1.0 and graph.num_nodes == NB
    assert int(graph.indegree()[NB - 1]) > EB // 4


@pytest.mark.gpu
def test_worker_refuses_a_cuda_tensor(cuda):
    """A Dataloader worker (forked after CUDA is up) handed a CUDA tensor
    raises a clear error instead of touching the parent's context; the
    loader is drained in a thread joined with its own timeout."""
    import threading
    from pgl_tpu_torch.utils.data import Dataloader, Dataset
    held = torch.zeros(4, device=cuda)

    class Held(Dataset):
        def __getitem__(self, i):
            return held

        def __len__(self):
            return 4

    out = {}

    def run():
        try:
            list(Dataloader(Held(), batch_size=2, num_workers=2))
        except RuntimeError as e:
            out["error"] = str(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(120)
    assert not th.is_alive(), "the workers hung"
    assert "tensor on cuda" in out.get("error", ""), out
