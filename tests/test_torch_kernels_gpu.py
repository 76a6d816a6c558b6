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
plain counts bit for bit, and K5 and K6 must agree bit for bit. The
attention kernels (K9, K10) go through ``check_attention`` (no terms scale:
their outputs are convex combinations or sums of bounded terms) and must
give the same bits on two runs; in dot mode through ``check_dot`` (dq, dk
and dv with the terms scale); the count-matrix attention (K7, K8, and K1
over ``red``) through ``check_dedup_attention``, and in dot mode through
``check_dedup_dot`` (dq and the dk and dv slot rows with the terms scale),
with the same bits on two runs and on a layout without counts. K1w and the
weighted K6 go through ``check_weighted`` (forward, dx and dw with the
terms scale) and must give the same bits on two runs. K11, the dedup SDDMM,
must equal its plain version bit for bit (``check_sddmm``: one IEEE
operation a value, pads +0), and its backward (K1 over ``by_src`` and
``by_dst``) goes through ``check_sddmm_grad`` (float64 with the terms scale,
the same bits twice, its launches).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (DDOT_KERNELS, DOT_KERNELS, SDDMM_OPS,
                        attention_graph, attention_inputs, check,
                        check_attention, check_counts, check_dedup,
                        check_dedup_attention, check_dedup_dot, check_dot,
                        check_sddmm, check_sddmm_grad, check_spmm,
                        check_weighted, dedup_attention_of, dedup_layouts,
                        dispatch_settings, dot_inputs, no_dropout,
                        run_dedup_attention, run_dedup_dot, run_dot,
                        run_weighted, sddmm_inputs, skewed_graph,
                        weighted_terms, without_counts)
from pgl_tpu_torch import Graph
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
    assert csc.num_partials > 0
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn(3000, D, device=cuda, generator=gen, requires_grad=True)
    w = torch.randn(3000, D, device=cuda, generator=gen)
    sk.reset_launches()
    out = sk.spmm(x, csc, csr)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert sk.LAUNCHES == 2
    assert dict(sk.LAUNCHES_BY_SHAPE) == {("csc", D): 1, ("csr", D): 1}
    with torch.no_grad():
        check_spmm("csc", out, x, csc)
        check_spmm("csr", x.grad, w, csr)
    assert (out[1:1500] == 0).all()          # empty rows are exact zeros


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
    assert ident.num_partials > 0
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
@pytest.mark.parametrize("D", [1, 3, 16, 128, 130])
def test_dedup_kernels_match_plain_version(cuda, D):
    g = Graph(skewed_graph(3000, 40000, seed=4), num_nodes=3000).tensor(cuda)
    dk.reset_launches()
    csc, csr = dedup_layouts(g, cuda)
    assert dict(dk.LAUNCHES_BY_SHAPE) == {("counts", "csc", None): 1,
                                          ("counts", "csr", None): 1}
    for lay in (csc, csr):
        check_counts(f"counts {lay.kind}", lay.counts, lay)
    assert csc.num_partials > 0                  # the hub block is split
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn(3000, D, device=cuda, generator=gen, requires_grad=True)
    w = torch.randn(3000, D, device=cuda, generator=gen)
    res = []
    for lays in ((csc, csr), [dataclasses.replace(lay, counts=None)
                              for lay in (csc, csr)]):
        out = dk.spmm_dedup(x, *lays)
        (out * w).sum().backward()
        res.append((out.detach(), x.grad))
        x.grad = None
    torch.cuda.synchronize()
    assert dict(dk.LAUNCHES_BY_SHAPE) == {
        ("counts", "csc", None): 1, ("counts", "csr", None): 1,
        ("dedup_cached", "csc", D): 1, ("dedup_cached", "csr", D): 1,
        ("dedup", "csc", D): 1, ("dedup", "csr", D): 1}
    (out5, grad5), (out6, grad6) = res
    with torch.no_grad():
        check_dedup("K5 csc", out5, x, csc)
        check_dedup("K5 csr", grad5, w, csr)
    assert torch.equal(out5, out6) and torch.equal(grad5, grad6)
    assert (out5[1:1500] == 0).all()             # empty rows are exact zeros


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


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("H,dvh", [(8, 8), (1, 16), (3, 5), (43, 2)])
def test_dedup_attention_kernels_match_plain_version(cuda, H, dvh, rate):
    """K7, K8 and the folds on a graph whose hub destination is split
    across pieces; two runs, and the layout without counts, give the same
    bits."""
    g = Graph(attention_graph(3000, 40000, seed=4), num_nodes=3000
              ).tensor(cuda)
    att = dedup_attention_of(g, cuda)
    assert att.num_partials > 0
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
                                 "dedup_bwd", "dedup_bwd_combine")}
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
    """The dot-mode K7, K8 and the folds on a graph whose hub destination
    is split across pieces; two runs, and the layout without counts, give
    the same bits."""
    g = Graph(attention_graph(3000, 40000, seed=4), num_nodes=3000
              ).tensor(cuda)
    att = dedup_attention_of(g, cuda)
    assert att.num_partials > 0
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
    assert dict(da.LAUNCHES_BY_SHAPE) == {
        (k + c, *shape): 3 for k in DDOT_KERNELS for c in ("", "_combine")}
    check_dedup_dot("small", att, ins, shape, rate, seed, got)
    out, lse = got[:2]
    assert (out[1:1500] == 0).all() and (lse[1:1500] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["TransformerConv", "UniMP"])
def test_transformer_on_dedup_graph_on_cuda_matches_cpu(cuda, kind):
    """A small TransformerConv (3 heads of 8) and UniMP (2 heads of 16) on
    a graph with dedup layouts (the band opened to it): the dot-mode K7/K8
    and the folds against the CPU's plain versions with the same weights,
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
                                 (16, 16), (2, 200)])
def test_k1w_matches_plain_version(cuda, op, H, D):
    """K1w forward, dx and dw (one launch over CSR) on the skewed graph
    (split rows both ways): scalar and per-head weights, vector and scalar
    loads (dh % 4), a head wider than one column pass (D = 200, dh = 100);
    two runs give the same bits."""
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
    part = torch.empty(max(csr.num_partials, 1), 16, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk._launch_weighted(x, w, csr, out, part, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 16, 64, 130])
def test_weighted_dedup_kernel_matches_plain_version(cuda, D):
    """The weighted K6 forward, dx (over CSR) and dw (K1w's pass) against
    float64, the same bits twice, and K1w's results within tolerance."""
    with dispatch_settings(DEDUP=True, DEDUP_MIN_EDGES=0):
        g = Graph(skewed_graph(3000, 40000, seed=9), num_nodes=3000
                  ).tensor(cuda)
    csc_d, csr_d = g._dedup_layouts
    csc, csr = g._spmm_layouts
    assert not csc_d.simple
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn(3000, D, device=cuda, generator=gen)
    w = torch.randn(40000, device=cuda, generator=gen)
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
