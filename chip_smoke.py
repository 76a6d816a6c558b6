#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (``pgl_tpu_torch``): the quickest proof
that the port builds, is right and trains on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result, when
there is no card or any phase fails. Phases:

1. the card's name and power limit (``nvidia-smi``); build the kernels from
   ``pgl_tpu_torch/ops/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print the build time and ``ptxas`` report;
2. every kernel against its plain PyTorch version on the card, forward and
   backward: the plain version runs in float64 on the same inputs, and
   ``|kernel - plain| <= 1e-4 * max(1, |plain|, ||terms||_2)`` elementwise,
   where ``||terms||_2`` is the 2-norm of the terms the element sums. The
   kernel sums float32 in another order than the plain version, and its
   rounding error grows with that norm, not with ``|plain|``: a row whose
   terms cancel (the headline hub sums 803,866 of them) ends near 0 with an
   error of the size of its partial sums. One dropped or doubled edge still
   exceeds the tolerance. K1 (sorted-segment SpMM) first; then the dedup
   kernels: K4's counts must equal the plain counts exactly, K5 (cached
   counts) and K6 (rebuilt counts) pass the check above and agree with each
   other bit for bit. Then the whole GCN on a small graph, CUDA against
   CPU, at ``1e-4 * max(1, |cpu|)``, through K1 and through the dedup path;
3. the main path: the bench headline (``bench.py``: ``powerlaw_graph(131072,
   16, feat_dim=128, seed=0)``, ``GCN(128, 16, num_layers=3,
   hidden_size=128, dropout=0)``, Adam at lr 1e-3) trains 3 warm-up and 20
   timed steps three ways: with ``dispatch.DEDUP`` off (K1), on (K4 twice
   at ``tensor()``, then K5), and on with a counts budget of 0 (K6). Each
   asserts its kernels' launches per step, and a finite and falling loss;
4. kernel time (CUDA events over warm launches) at each kernel's shapes on
   the main path, beside the plain version, ``torch.sparse.mm`` on a CSR
   tensor of the same graph (the yardstick for the SpMM; the port never
   calls it) and the bound; then the SpMM device time per step of each
   path;
5. the GAT path (per-edge attention, K9 and K10): K9, K10-dq and K10-dkv
   against their float64 plain versions at dropout rates 0 and 0.6, on a
   skewed small graph with a hub destination and a hub source and on the
   bench GAT graph (``bench.py``: ``powerlaw_graph(65536, 16,
   feat_dim=128, seed=1)``), with the tolerance above (no terms scale:
   every output is a convex combination or a sum of bounded terms); the
   keep bits of K9 and K10-dkv equal the plain mask exactly (a permutation
   graph, where each row has one edge); the small GAT, CUDA against CPU;
   then the bench GAT (``GAT(128, 16, num_heads=8, hidden_size=8,
   feat_drop=0, attn_drop=0)``, Adam at lr 1e-3) and ``GAT`` with its
   default dropouts (0.6, training) each train 3 warm-up and 20 timed
   steps, asserting their launches per step (one K9, K10-dq and K10-dkv
   at each of (H, dvh) = (8, 8) and (1, 16), the combine launches where
   rows split, no SpMM) and a finite, falling loss; a torch.profiler trace
   of the bench GAT step gives its device time by kernel and idle share;
   and the kernels are timed as in 4;
6. the dedup GAT path (count-matrix attention, K7 and K8, then K1 over
   ``build_uniq_reduce``'s layout): the bench GAT graph under
   ``dispatch.DEDUP`` (K4 twice at ``tensor()``; K7/K8's work lists built
   at the first attention call); K7, K8 and the two K1 folds against their
   float64 plain versions at rates 0 and 0.6 on the skewed small graph
   (seven head shapes, 3·H > 128 among them) and on the bench GAT graph,
   two runs and a layout without counts giving the same bits; the keep
   bits of K7 and K8 equal the plain cell mask exactly (a permutation
   graph); the small GAT through the dedup path, CUDA against CPU; then
   three training runs of 20 timed steps, asserting their launches per
   step (K7, K8 and their merges at each of (H, dvh) = (8, 8) and (1, 16),
   the four folds, nothing else): the bench GAT, the same graph over a
   zero counts budget, and GAT's default dropouts with
   ``attn_drop_mode="cell"``; a torch.profiler trace of the step; the
   kernels timed as in 4; and the attention device time per step of this
   route beside the per-edge route's;
7. the UniMP path (per-edge attention in dot mode, K9 and K10 on q·k
   scores): the dot-mode K9, K10-dq and K10-dkv against their float64
   plain versions at rates 0 and 0.3 (dq, dk and dv with the terms scale),
   at UniMP's shape (H, dsh, dvh) = (2, 128, 128), at (8, 16, 16) and at
   two shapes of GATConv's many-head fallback on the skewed small graph,
   and at UniMP's shape on the bench GAT graph (split rows) and on the
   UniMP graph, an ogbn-arxiv-sized stand-in (``community_graph(169343,
   40, feat_dim=128, avg_degree=116, seed=0)``, about 2.4M edges); two runs
   give the same bits; the keep bits equal the plain mask exactly; a small
   UniMP, CUDA against CPU; then ``UniMP(128, 40, num_layers=3,
   hidden_size=128, num_heads=2, dropout=0.3)``, the reference's defaults,
   trains 3 warm-up and 20 timed steps with dropout and 20 without (AdamW,
   a fresh 60% of the train labels fed each step, as
   ``examples/unimp/train.py``), asserting two launches of each dot kernel
   a step and no other; a torch.profiler trace of the step; and the dot
   kernels timed beside two bounds (each input read once; the rows each
   edge gathers);
8. the UniMP dedup path (count-matrix attention in dot mode, K7 and K8 on
   q·k scores, then K1 over ``red``): the bench GAT graph under
   ``dispatch.DEDUP`` (K4 twice at ``tensor()``, the work lists at the
   first attention call); the dot-mode K7, K8 and the two folds against
   their float64 plain versions at rates 0 and 0.3 (dq and the dk and dv
   slot rows with the terms scale) on the skewed small graph at (H, dsh,
   dvh) = (2, 128, 128), (8, 16, 16) and (4, 64, 8) and on the bench GAT
   graph at UniMP's shape, two runs and a layout without counts giving the
   same bits; the keep bits equal the plain cell mask exactly (a
   permutation graph); a small UniMP through the route, CUDA against CPU;
   then UniMP at the reference's defaults on the bench GAT graph trains 3
   warm-up and 20 timed steps without dropout (``training=False``, the
   route the reference takes on a multigraph) and 20 with dropout 0.3 in
   ``attn_drop_mode="cell"``, asserting its launches a step (two of each
   dot kernel and of their merges, four folds at D = 256, nothing else)
   and a finite, falling loss; a torch.profiler trace of the step; the
   kernels timed beside the table and gather bounds; and the attention
   device time per UniMP step of this route beside the per-edge route's
   on the same graph (phase 7's dot kernels there);
9. the edge-weighted path (``send_ue_recv``: K1w, the sorted SpMM on
   weighted messages, and the weighted K6): K1w forward, dx and dw (one
   launch over CSR) against their float64 plain versions with the terms
   scale, for mul and add, one weight an edge or 8 a head, D in (16, 64,
   128), on the skewed small graph and the headline graph, two runs giving
   the same bits, and each gradient alone; the weighted K6 forward, dx and
   dw (K1w's pass) on the headline graph under ``DEDUP`` against float64,
   the same bits twice, forward and dx within tolerance of K1w; small
   FAGCN (through
   K1w and through the weighted K6), GATv2 and GATConv at 48 heads on its
   unfused path, CUDA against CPU; then ``FAGCN(128, 16, hidden_size=64,
   num_layer=3, eps=0.2, dropout=0.6)`` (the reference's widths) trains 3
   warm-up and 20 timed steps on the headline graph with dropout, without,
   and under ``DEDUP`` (the weighted K6), and ``GATv2(128, 16,
   num_heads=8, hidden_size=8, feat_drop=0.6, attn_drop=0.6)`` on the bench
   GAT graph, each asserting its launches a step (FAGCN: three K1w forward
   and three backward at D = 64, or three weighted K6 each way and three dw
   passes; GATv2: K1w at (D, H) = (64, 8) and (16, 1) each way) and a
   finite, falling loss; torch.profiler traces of the FAGCN (both routes)
   and GATv2 steps; the kernels timed beside their plain versions, the byte
   and gather bounds, the library calls (``torch.sparse.mm`` on the
   weights for one weight an edge, ``torch.bmm`` on batched COO matrices
   for one a head, ``torch.sparse.sampled_addmm`` for dw) and K1 at the
   same width; and the weighted SpMM device time a FAGCN step on both
   routes;
10. the dedup SDDMM path (``Graph.sddmm_csc``: K11, and K1 over the
   layout's ``by_src`` and ``by_dst`` for its gradient): the headline graph
   (with its 128-wide ``h`` and both indexes) dumped to a temporary
   directory, loaded back memory-mapped with ``Graph.load``, its indexes
   held against a direct build, and put on the card; ``sddmm_layout()``
   timed on the host; K11 against its plain version **bit for bit** (one
   IEEE operation a value) for add, sub, mul and div at D in (1, 16, 128)
   on the skewed small graph and the headline, div also with exact zeros
   (inf and nan where the plain version has them), pads +0, two runs
   equal, every real slot equal to ``send_uv``'s row for its edge through
   ``eid``; the backward against float64 with the terms scale (the four ops
   at D in (1, 16, 128) on the skewed graph, at D = 16 on the headline, mul
   at 128), the same bits twice, one K11 and two K1 launches each; the rest
   of ``Graph`` on a ``disjoint`` of three small graphs (``send_u_recv``
   and the UDF ``send``/``recv`` with each reduce, CUDA against CPU); then
   the bench row's call (``bench.py:308-335``), ``(g.sddmm_csc(x, x,
   "mul") ** 2).sum().backward()`` on the headline at D = 128, 3 warm-up
   and 20 timed steps asserting one K11 and two K1 launches a step, beside
   the same loss through ``send_uv``, with a torch.profiler trace of each;
   and K11 timed for each op beside its plain version, a byte bound, a
   gather bound and ``send_uv`` (no single library call computes it:
   ``torch.sparse.sampled_addmm`` sums over D), K1 over ``by_src`` and
   ``by_dst`` beside its plain version and ``torch.sparse.mm``.

The second-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores
REPLACES = "pgl_tpu/ops/pallas/segment_kernels.py:161"
SOURCE = "pgl_tpu_torch/ops/kernels/csrc/segment_kernels.cu"
DEDUP_SOURCE = "pgl_tpu_torch/ops/kernels/csrc/dedup_kernels.cu"
DEDUP_REPLACES = {"counts": "pgl_tpu/ops/pallas/dedup_kernels.py:554",
                  "dedup_cached": "pgl_tpu/ops/pallas/dedup_kernels.py:608",
                  "dedup": "pgl_tpu/ops/pallas/dedup_kernels.py:405"}
ATTN_SOURCE = "pgl_tpu_torch/ops/kernels/csrc/attention_kernels.cu"
ATTN_REPLACES = {"gat_fwd": "pgl_tpu/ops/pallas/attention_kernels.py:86",
                 "gat_dq": "pgl_tpu/ops/pallas/attention_kernels.py:288",
                 "gat_dkv": "pgl_tpu/ops/pallas/attention_kernels.py:403"}
DATTN_SOURCE = "pgl_tpu_torch/ops/kernels/csrc/dedup_attention.cu"
DATTN_REPLACES = {"dedup_fwd": "pgl_tpu/ops/pallas/dedup_attention.py:102",
                  "dedup_bwd": "pgl_tpu/ops/pallas/dedup_attention.py:285"}
# (heads, per-head width) of the GAT's two attention calls
GAT_SHAPES = ((8, 8), (1, 16))
STEPS, WARMUP = 20, 3
# SpMM launches per training step, by (layout, width): forward layers 0 and
# 1 at D=128 and layer 2 at D=16 over CSC; backward layers 1 (D=128) and 2
# (D=16) over CSR. Layer 0's input has no gradient, so its backward never
# runs.
PER_STEP = {("csc", 128): 2, ("csc", 16): 1, ("csr", 128): 1, ("csr", 16): 1}


def check(name, got, want, scale=None):
    """Max |got - want|; raises unless |got - want| <= 1e-4 * max(1, |want|,
    scale) everywhere."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    want = want.double()
    err = (got.double() - want).abs()
    bound = want.abs().clamp(min=1.0)
    if scale is not None:
        bound = torch.maximum(bound, scale)
    bad = ~(err <= 1e-4 * bound)
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, "
                             f"max |err| {max_err:.3e}")
    return max_err


def skewed_graph(num_nodes, num_edges, seed):
    """Edges with a hub row (40% of edges, split across pieces) and many
    empty rows."""
    rng = np.random.default_rng(seed)
    hub = num_edges * 2 // 5
    dst = np.concatenate([np.zeros(hub, np.int64),
                          rng.integers(num_nodes // 2, num_nodes,
                                       num_edges - hub)])
    src = rng.integers(0, num_nodes, num_edges)
    return np.stack([src, dst], axis=1)


def check_spmm(name, got, x, layout):
    """``check`` of a kernel result against the plain version in float64;
    the one home of this rule (the GPU tests and the kernel experiments
    import it)."""
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    x = x.detach().double()
    return check(name, got, sk.spmm_reference(x, layout),
                 sk.spmm_reference(x * x, layout).sqrt())


def phase_kernels(g_head, dev):
    """Kernel against plain version, forward and backward."""
    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    small = Graph(skewed_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [("small", small, d) for d in (1, 3, 16, 128, 130, 256)]
    cases += [("headline", g_head, d) for d in (128, 16)]
    for tag, g, d in cases:
        csc, csr = g._spmm_layouts
        x = torch.randn(g.num_nodes, d, device=dev, generator=gen,
                        requires_grad=True)
        w = torch.randn(g.num_nodes, d, device=dev, generator=gen)
        out = sk.spmm(x, csc, csr)
        (out * w).sum().backward()
        with torch.no_grad():
            e_f = check_spmm(f"{tag} csc D={d}", out, x, csc)
            e_b = check_spmm(f"{tag} csr D={d}", x.grad, w, csr)
        print(f"[kernels] {tag} N={g.num_nodes} E={g.num_edges} D={d}: "
              f"max |err| fwd {e_f:.3e} bwd {e_b:.3e}", flush=True)

    # identity gather: sorted_segment_sum over pre-gathered messages
    idx = small.adj_dst_index
    msgs = torch.randn(small.num_edges, 128, device=dev, generator=gen,
                       requires_grad=True)
    out = sk.sorted_segment_sum(msgs, idx.segment_ids, idx.indptr,
                                small.num_nodes)
    w = torch.randn_like(out)
    (out * w).sum().backward()
    with torch.no_grad():
        ident = sk.build_spmm_layout(idx.indptr.cpu(),
                                     np.arange(small.num_edges),
                                     small.num_nodes, device=dev)
        e = check_spmm("segment_sum", out, msgs, ident)
        check("segment_sum grad", msgs.grad, w[idx.segment_ids])
    print(f"[kernels] sorted_segment_sum E={small.num_edges} D=128: "
          f"max |err| {e:.3e}", flush=True)


@contextlib.contextmanager
def dispatch_settings(**settings):
    """Set constants of ``pgl_tpu_torch.ops.dispatch`` (``DEDUP``,
    ``COUNTS_BUDGET_BYTES``, ...) for the graphs built inside; restored
    after."""
    from pgl_tpu_torch.ops import dispatch
    old = {k: getattr(dispatch, k) for k in settings}
    for k, v in settings.items():
        setattr(dispatch, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(dispatch, k, v)


def phase_model_small(dev):
    """The whole GCN on a small graph: CUDA kernels against the CPU's plain
    versions with the same weights (logits and gradients), through K1 and,
    with the dedup band opened to this graph, through K4 and K5."""
    import torch
    from pgl_tpu_torch.datasets import community_graph
    from pgl_tpu_torch.models import GCN
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk

    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    for path, settings in (("K1", {"DEDUP": False}),
                           ("dedup", {"DEDUP": True, "DEDUP_MIN_EDGES": 0})):
        results = {}
        dk.reset_launches()
        for d in ("cpu", dev):
            with dispatch_settings(**settings):
                gt = g.tensor(d)
            model = GCN(16, 3, num_layers=3, hidden_size=24, dropout=0.0,
                        generator=torch.Generator().manual_seed(0), device=d)
            logits = model(gt, gt.node_feat["h"])
            ce(logits, torch.as_tensor(labels, device=d)).mean().backward()
            results[str(d)] = (logits.detach().cpu(),
                               {k: p.grad.cpu()
                                for k, p in model.named_parameters()})
        if path == "dedup" and not dk.LAUNCHES_BY_SHAPE[
                ("dedup_cached", "csc", 24)]:
            raise AssertionError("small GCN did not take the dedup path")
        (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results[str(dev)]
        err = check(f"small GCN {path} logits", l_gpu, l_cpu)
        for k in g_cpu:
            err = max(err, check(f"small GCN {path} grad {k}", g_gpu[k],
                                 g_cpu[k]))
        print(f"[model] small GCN through {path}, CUDA vs CPU: max |err| "
              f"{err:.3e}", flush=True)


def headline_host():
    """The bench headline graph on the host (numpy)."""
    from pgl_tpu_torch.datasets import powerlaw_graph
    return powerlaw_graph(num_nodes=131072, avg_degree=16, feat_dim=128,
                          seed=0)


def headline_graph(dedup=False, host=None, **settings):
    """The bench headline graph on the card, through K1 (``dedup=False``)
    or the dedup path; ``settings`` sets further dispatch constants."""
    with dispatch_settings(DEDUP=dedup, **settings):
        return (host if host is not None else headline_host()).tensor()


def headline_trainer(g):
    """The bench headline GCN on ``g``'s device (weights and labels from
    seed 0) and a function that takes one Adam step and returns its loss."""
    import torch
    from pgl_tpu_torch.models import GCN
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

    x = g.node_feat["h"]
    y = torch.as_tensor(np.random.default_rng(0).integers(
        0, 16, g.num_nodes).astype(np.int64), device=x.device)
    model = GCN(input_size=128, num_class=16, num_layers=3, hidden_size=128,
                dropout=0.0, generator=torch.Generator().manual_seed(0),
                device=x.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = ce(model(g, x), y).mean()
        loss.backward()
        opt.step()
        return loss.detach()

    return model, step


def _kernel_modules():
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    from pgl_tpu_torch.ops.kernels import sddmm_kernels as sdk
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    return sk, dk, ak, da, sdk


def reset_all_launches():
    for module in _kernel_modules():
        module.reset_launches()


def all_launches():
    """Launch counts of every kernel module: K1's keyed ``(kind, D)``, the
    dedup kernels' ``(kernel, kind, D)``, the two attention modules'
    ``(kernel, H, dvh)`` (dot mode ``(kernel, H, dsh, dvh)``), K11's
    ``("sddmm", op, D)``."""
    return {k: v for module in _kernel_modules()
            for k, v in module.LAUNCHES_BY_SHAPE.items()}


def phase_train(g, path="K1", per_step=None, trainer=None, num_class=16):
    """The main path: a model trains on the card (default: the bench
    headline GCN). Asserts the launches of every kernel: ``per_step``
    (default: K1's ``PER_STEP``) times the step count, and no other; and
    finite logits [N, ``num_class``] after the steps."""
    import torch

    per_step = PER_STEP if per_step is None else per_step
    model, step = (trainer or headline_trainer)(g)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses, times = [], []
    reset_all_launches()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    by_shape = {k: v for k, v in all_launches().items() if v}
    launches = sum(by_shape.values())
    losses = [float(v) for v in losses]
    want = {k: v * STEPS for k, v in per_step.items()}
    if by_shape != want:
        raise AssertionError(f"{path}: launches {by_shape}, expected "
                             f"{want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{path}: losses not finite and falling: "
                             f"{losses}")
    with torch.no_grad():
        logits = model(g, g.node_feat["h"])
    if logits.shape != (g.num_nodes, num_class) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{path}: logits not finite [N, {num_class}]")
    step_ms = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[train {path}] {STEPS} steps: loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; median step {step_ms:.4f} ms (min "
          f"{min(times) * 1e3:.4f}, max {max(times) * 1e3:.4f}); peak memory "
          f"{peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before the "
          f"steps); kernel launches {launches} = {launches / STEPS:g}/step",
          flush=True)
    return {"step_ms": step_ms, "peak_mib": peak / 2**20,
            "held_mib": held / 2**20, "loss_first": losses[0],
            "loss_last": losses[-1]}, by_shape


def time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` warm calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def phase_timing(g, dev, by_shape):
    import torch
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    rows = []
    gen = torch.Generator(device=dev).manual_seed(1)
    for kind, lay in zip(("csc", "csr"), g._spmm_layouts):
        A = torch.sparse_csr_tensor(lay.indptr, lay.indices,
                                    torch.ones(lay.num_edges, device=dev),
                                    size=(lay.num_rows, g.num_nodes))
        for d in (128, 16):
            x = torch.randn(g.num_nodes, d, device=dev, generator=gen)
            out = torch.empty(lay.num_rows, d, device=dev)
            part = torch.empty(lay.num_partials, d, device=dev)
            ms = time_ms(lambda: sk._launch(x, lay, out, part), 100)
            plain_ms = time_ms(lambda: sk.spmm_reference(x, lay), 20)
            lib_ms = time_ms(lambda: torch.sparse.mm(A, x), 50)
            with torch.no_grad():
                err = check_spmm(f"timed {kind} D={d}", out, x, lay)
            nbytes = 4 * (g.num_nodes * d + lay.num_edges
                          + lay.num_rows + 1 + lay.num_rows * d)
            ops = lay.num_edges * d
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            rows.append({
                "name": f"spmm_{kind}_d{d}", "route": "cuda",
                "source": SOURCE, "replaces": REPLACES,
                "launches": by_shape.get((kind, d), 0),
                "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms, "share": bound_ms / ms,
                "shape": {"layout": kind, "rows": lay.num_rows,
                          "edges": lay.num_edges, "D": d,
                          "pieces": int(lay.pieces.shape[0]),
                          "split_rows": int(lay.split_rows.shape[0])}})
            print(f"[timing] {kind} D={d}: kernel {ms:.5f} ms, plain "
                  f"{plain_ms:.5f} ms, torch.sparse.mm {lib_ms:.5f} ms, "
                  f"bound {bound_ms:.5f} ms ({bound_ms / ms:.3f} of it)",
                  flush=True)
    return rows


def check_dedup(name, got, x, layout):
    """``check`` of a dedup kernel result against the plain version in
    float64, with the 2-norm scale of ``check_spmm``."""
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    x = x.detach().double()
    return check(name, got, dk.apply_reference(x, layout),
                 dk.apply_reference(x * x, layout).sqrt())


def check_counts(name, got, layout):
    """K4's counts must equal the plain counts bit for bit."""
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    import torch
    want = dk.counts_reference(layout)
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: counts differ from the plain counts "
                             f"in {int((got != want).sum())} cells")


def dedup_layouts(g, dev):
    """Both dedup layouts of ``g`` (no gate), with K4's counts."""
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    return tuple(dk.materialize_counts(dk.build_dedup_layout(
        idx.indptr, idx.sorted_v, g.num_nodes, kind=kind, device=dev))
        for kind, idx in (("csc", g.adj_dst_index.numpy()),
                          ("csr", g.adj_src_index.numpy())))


def phase_dedup_kernels(g_head, dev):
    """K4 exact, K5 and K6 against the float64 plain version forward and
    backward, and K5 against K6 bit for bit."""
    import dataclasses

    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk

    small = Graph(skewed_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
    lay_small = dedup_layouts(small, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [("small", small, lay_small, d) for d in (1, 3, 16, 128, 130,
                                                      256)]
    cases += [("headline", g_head, g_head._dedup_layouts, d)
              for d in (128, 16)]
    for tag, lays in (("small", lay_small),
                      ("headline", g_head._dedup_layouts)):
        for lay in lays:
            check_counts(f"{tag} counts {lay.kind}", lay.counts, lay)
        print(f"[dedup] {tag} counts csc/csr equal the plain counts "
              f"(P = {lays[0].num_pairs} / {lays[1].num_pairs}, partial "
              f"blocks {lays[0].num_partials} / {lays[1].num_partials})",
              flush=True)
    for tag, g, (csc, csr), d in cases:
        uncached = [dataclasses.replace(lay, counts=None)
                    for lay in (csc, csr)]
        x = torch.randn(g.num_nodes, d, device=dev, generator=gen,
                        requires_grad=True)
        w = torch.randn(g.num_nodes, d, device=dev, generator=gen)
        res = []
        for lays in ((csc, csr), uncached):
            out = dk.spmm_dedup(x, *lays)
            (out * w).sum().backward()
            res.append((out.detach(), x.grad))
            x.grad = None
        (out5, grad5), (out6, grad6) = res
        with torch.no_grad():
            e_f = check_dedup(f"{tag} K5 csc D={d}", out5, x, csc)
            e_b = check_dedup(f"{tag} K5 csr D={d}", grad5, w, csr)
        if not (torch.equal(out5, out6) and torch.equal(grad5, grad6)):
            raise AssertionError(f"{tag} D={d}: K5 and K6 differ")
        print(f"[dedup] {tag} N={g.num_nodes} E={g.num_edges} D={d}: K5 = "
              f"K6 bit for bit; max |err| fwd {e_f:.3e} bwd {e_b:.3e}",
              flush=True)


def phase_dedup_timing(g, launches, dev, cells):
    """Rows at the shapes of the main path: K4 and K5 on a graph with
    counts, K6 on one without. ``cells`` maps a layout kind to its nonzero
    count cells (the FLOPs of the bound); K4 fills it."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk

    rows = []
    gen = torch.Generator(device=dev).manual_seed(3)
    N = g.num_nodes
    cached = g._dedup_layouts[0].counts is not None
    for lay in g._dedup_layouts if cached else ():
        buf = torch.empty_like(lay.counts)
        ms = time_ms(lambda: dk._launch_counts(lay, buf), 20)
        check_counts(f"timed counts {lay.kind}", buf, lay)
        plain_ms = time_ms(lambda: dk.counts_reference(lay), 3)
        cells[lay.kind] = int((lay.counts != 0).sum())
        nbytes = (16 * lay.num_pairs + 8 * lay.num_edges
                  + lay.counts_bytes)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dedup_row(
            f"materialize_counts_{lay.kind}", "counts", launches,
            ("counts", lay.kind, None), 0.0, ms, plain_ms, bound_ms,
            "bytes", None, lay, None))
        print(f"[timing] K4 counts {lay.kind}: kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
              f"({bound_ms / ms:.3f} of it); nonzero cells {cells[lay.kind]}",
              flush=True)
    kernel = "dedup_cached" if cached else "dedup"
    for lay, k1 in zip(g._dedup_layouts, g._spmm_layouts):
        A = torch.sparse_csr_tensor(k1.indptr, k1.indices,
                                    torch.ones(k1.num_edges, device=dev),
                                    size=(k1.num_rows, N))
        for d in (128, 16):
            x = torch.randn(N, d, device=dev, generator=gen)
            out = torch.empty(lay.n_pad, d, device=dev)
            part = torch.empty(lay.num_partials * dk.NB, d, device=dev)
            ms = time_ms(lambda: dk._launch_apply(
                x, lay, lay.counts, out, part), 20)
            plain_ms = time_ms(
                lambda: dk.apply_reference(x, lay, lay.counts), 3)
            lib_ms = time_ms(lambda: torch.sparse.mm(A, x), 20)
            with torch.no_grad():
                err = check_dedup(f"timed {kernel} {lay.kind} D={d}",
                                  out[:N], x, lay)
            structure = (lay.counts_bytes if cached
                         else 8 * lay.num_edges)
            nbytes = (structure + 4 * (2 * N * d + lay.uv.numel())
                      + 16 * (lay.num_pairs + lay.groups.shape[0]))
            ops = 2 * cells[lay.kind] * d
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            k1_bound_ms = 4 * (2 * N * d + k1.num_edges + N + 1) \
                / HBM_BYTES_PER_S * 1e3
            rows.append(dedup_row(
                f"spmm_{kernel}_{lay.kind}_d{d}", kernel, launches,
                (kernel, lay.kind, d), err, ms, plain_ms, bound_ms,
                "bytes" if t_bytes >= t_ops else "operations", lib_ms,
                lay, d, k1_bound_ms=k1_bound_ms))
            print(f"[timing] {kernel} {lay.kind} D={d}: kernel {ms:.5f} "
                  f"ms, plain {plain_ms:.5f} ms, torch.sparse.mm "
                  f"{lib_ms:.5f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_ms / ms:.3f} of it; K1's bound "
                  f"{k1_bound_ms:.5f} ms)", flush=True)
    return rows


def dedup_row(name, kernel, launches, key, err, ms, plain_ms, bound_ms,
              bound_by, lib_ms, lay, d, **extra):
    return dict({
        "name": name, "route": "cuda", "source": DEDUP_SOURCE,
        "replaces": DEDUP_REPLACES[kernel], "launches": launches.get(key, 0),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "share": bound_ms / ms,
        "shape": {"layout": lay.kind, "kernel": kernel, "D": d,
                  "edges": lay.num_edges, "pairs": lay.num_pairs,
                  "groups": int(lay.groups.shape[0]),
                  "partial_blocks": lay.num_partials}}, **extra)


def spmm_ms_per_step(rows, kernel):
    """SpMM device ms per headline step of one path, from its rows."""
    return sum(r["ms"] * PER_STEP[r["shape"]["layout"], r["shape"]["D"]]
               for r in rows if r["shape"].get("kernel") == kernel)


def tensor_s(host, dedup, **settings):
    """``(graph, seconds)`` of one ``tensor()`` of the headline host graph,
    ended by a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = headline_graph(dedup, host, **settings)
    torch.cuda.synchronize()
    return g, time.perf_counter() - t0


def attention_graph(num_nodes, num_edges, seed):
    """``skewed_graph`` with a hub source as well (node 7 sends 15% of the
    edges), so both attention layouts have split rows."""
    edges = skewed_graph(num_nodes, num_edges, seed)
    rng = np.random.default_rng(seed + 100)
    edges[rng.choice(num_edges, num_edges * 3 // 20, replace=False), 0] = 7
    return edges


def attention_inputs(n, H, dvh, dev, gen):
    """Random a_dst, a_src [n, H], v and g [n, H * dvh] (float32)."""
    import torch
    return tuple(torch.randn(n, w, device=dev, generator=gen)
                 for w in (H, H, H * dvh, H * dvh))


def check_attention(tag, lays, ins, rate, seed):
    """K9, K10-dq and K10-dkv (float32) against their plain versions in
    float64 on the same inputs; returns the max |err| of each and the
    kernels' outputs."""
    import torch
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    csc, csr = lays
    a_dst, a_src, v, g = ins
    H = a_dst.shape[1]
    dvh = v.shape[1] // H
    with torch.no_grad():
        out, lse = ak._fwd_cuda(a_dst, a_src, v, csc, 0.2, dvh, rate, seed)
        delta = (g.reshape(-1, H, dvh) * out.reshape(-1, H, dvh)).sum(-1)
        bwd = (a_dst, a_src, v, g, lse, delta)
        da_dst = ak._dq_cuda(*bwd, csc, 0.2, dvh, rate, seed)
        da_src, dv = ak._dkv_cuda(*bwd, csr, 0.2, dvh, rate, seed)
        d64 = [t.double() for t in bwd]
        out_p, lse_p = ak.gat_attention_reference(*d64[:3], csc, 0.2, dvh,
                                                  rate, seed)
        dq_p = ak.gat_dq_reference(*d64, csc, 0.2, dvh, rate, seed)
        dsrc_p, dv_p = ak.gat_dkv_reference(*d64, csr, 0.2, dvh, rate, seed)
        name = f"{tag} H={H} dvh={dvh} rate={rate}"
        return {"gat_fwd": max(check(f"{name} K9 out", out, out_p),
                               check(f"{name} K9 lse", lse, lse_p)),
                "gat_dq": check(f"{name} K10-dq", da_dst, dq_p),
                "gat_dkv": max(check(f"{name} K10-dkv d a_src", da_src,
                                     dsrc_p),
                               check(f"{name} K10-dkv dv", dv, dv_p))}, \
            (out, lse, da_dst, da_src, dv)


def phase_attention_kernels(g_gat, dev):
    """Every attention kernel against its float64 plain version at rates 0
    and 0.6 (seed drawn per case), on the small graph at several head
    shapes and on the GAT headline graph at the GAT's; and the runs are
    bit-identical. Returns the max |err| per (kernel, H, dvh) on the
    headline graph."""
    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak

    small = Graph(attention_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {}
    cases = [("small", small, hd) for hd in ((8, 8), (1, 16), (4, 32),
                                             (3, 3), (2, 64), (42, 1))]
    cases += [("headline", g_gat, hd) for hd in GAT_SHAPES]
    for tag, g, (H, dvh) in cases:
        lays = g._attention_layouts()
        if tag == "small" and not (lays[0].num_partials
                                   and lays[1].num_partials):
            raise AssertionError("the small graph must split rows on both "
                                 "layouts")
        ins = attention_inputs(g.num_nodes, H, dvh, dev, gen)
        for rate in (0.0, 0.6):
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                                 generator=gen, device=dev)
            e, got = check_attention(tag, lays, ins, rate, seed)
            _, again = check_attention(tag, lays, ins, rate, seed)
            if not all(map(torch.equal, got, again)):
                raise AssertionError(f"{tag} H={H} dvh={dvh}: two runs "
                                     "differ")
            if tag == "headline":
                for k, v in e.items():
                    errs[k, H, dvh] = max(errs.get((k, H, dvh), 0.0), v)
            print(f"[attention] {tag} N={g.num_nodes} E={g.num_edges} "
                  f"H={H} dvh={dvh} rate={rate}: max |err| K9 "
                  f"{e['gat_fwd']:.3e} K10-dq {e['gat_dq']:.3e} K10-dkv "
                  f"{e['gat_dkv']:.3e}", flush=True)
    ak.reset_launches()
    return errs


def phase_attention_mask(dev):
    """The keep bits of K9 and K10-dkv equal the plain mask exactly: on a
    permutation graph every row has one edge, so with a_dst = a_src = 0,
    v = g = 1 and dvh = 1, K9's out and K10-dkv's dv are 1 / (1 - rate)
    where the edge is kept and 0 where it is dropped. (K10-dq's bits show
    in the float64 checks: a flip there moves a short row's d a_dst by
    about q·gv, far over the tolerance.)"""
    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak

    n, H, rate = 1 << 20, 42, 0.6
    rng = np.random.default_rng(8)
    g = Graph(np.stack([rng.permutation(n), np.arange(n)], axis=1),
              num_nodes=n).tensor(dev)
    csc, csr = g._attention_layouts()
    zeros = torch.zeros(n, H, device=dev)
    ones = torch.ones(n, H, device=dev)
    for seed_v in (-1640531535, 12345):
        seed = torch.tensor([seed_v], dtype=torch.int32, device=dev)
        with torch.no_grad():
            out, lse = ak._fwd_cuda(zeros, zeros, ones, csc, 0.2, 1, rate,
                                    seed)
            _, dv = ak._dkv_cuda(zeros, zeros, ones, ones, lse, out, csr,
                                 0.2, 1, rate, seed)
            for name, got, lay in (("K9", out, csc), ("K10-dkv", dv, csr)):
                pos = torch.empty_like(lay.positions())
                pos[lay.seg_ids.long()] = lay.positions()
                want = torch.stack([ak.drop_keep(pos, seed, h, rate)
                                    for h in range(H)], dim=1)
                if not torch.equal(got != 0, want):
                    raise AssertionError(
                        f"{name} keep bits differ from the plain mask in "
                        f"{int(((got != 0) != want).sum())} of {want.numel()}")
    ak.reset_launches()
    print(f"[attention] keep bits of K9 and K10-dkv equal the plain mask "
          f"over {n} positions x {H} heads, 2 seeds, rate {rate}",
          flush=True)


def phase_gat_small(dev, dedup=False):
    """The whole GAT on a small graph: CUDA kernels against the CPU's plain
    versions with the same weights (logits and gradients); with ``dedup``,
    through the count-matrix attention (the dedup band opened to it)."""
    import torch
    from pgl_tpu_torch.datasets import community_graph
    from pgl_tpu_torch.models import GAT
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    results = {}
    reset_all_launches()
    for d in ("cpu", dev):
        with dispatch_settings(DEDUP=dedup, DEDUP_MIN_EDGES=0):
            gt = g.tensor(d)
        model = GAT(16, 3, num_heads=8, hidden_size=8, feat_drop=0.0,
                    attn_drop=0.0, generator=torch.Generator().manual_seed(0),
                    device=d)
        logits = model(gt, gt.node_feat["h"], True)
        ce(logits, torch.as_tensor(labels, device=d)).mean().backward()
        results[str(d)] = (logits.detach().cpu(),
                           {k: p.grad.cpu()
                            for k, p in model.named_parameters()})
    kernel = "dedup_fwd" if dedup else "gat_fwd"
    if not all_launches().get((kernel, 8, 8)):
        raise AssertionError(f"small GAT did not launch {kernel}")
    reset_all_launches()
    path = "dedup" if dedup else "per-edge"
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results[str(dev)]
    err = check(f"small GAT {path} logits", l_gpu, l_cpu)
    for k in g_cpu:
        err = max(err, check(f"small GAT {path} grad {k}", g_gpu[k],
                             g_cpu[k]))
    print(f"[model] small GAT through the {path} attention, CUDA vs CPU: "
          f"max |err| {err:.3e}", flush=True)


def gat_host():
    """The bench GAT graph on the host (numpy)."""
    from pgl_tpu_torch.datasets import powerlaw_graph
    return powerlaw_graph(num_nodes=65536, avg_degree=16, feat_dim=128,
                          seed=1)


def gat_trainer(g, defaults=False, mode="edge"):
    """The bench GAT (``defaults=False``: no dropout, evaluation mode as in
    the bench) or ``GAT`` with its default dropouts, training, on ``g``'s
    device (weights from seed 0, labels from seed 1), its two GATConvs in
    attention dropout ``mode``, and a function that takes one Adam step and
    returns its loss."""
    import torch
    from pgl_tpu_torch.models import GAT
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

    x = g.node_feat["h"]
    y = torch.as_tensor(np.random.default_rng(1).integers(
        0, 16, g.num_nodes).astype(np.int64), device=x.device)
    drop = {} if defaults else {"feat_drop": 0.0, "attn_drop": 0.0}
    model = GAT(input_size=128, num_class=16, num_heads=8, hidden_size=8,
                generator=torch.Generator().manual_seed(0), device=x.device,
                **drop)
    for layer in (model.gat_0, model.gat_1):
        layer.attn_drop_mode = mode
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = ce(model(g, x, defaults), y).mean()
        loss.backward()
        opt.step()
        return loss.detach()

    return model, step


def gat_per_step(g):
    """Attention launches per GAT step: K9, K10-dq and K10-dkv once at each
    shape, and the second launch of each where its layout splits rows."""
    csc, csr = g._attention_layouts()
    per = {}
    for H, dvh in GAT_SHAPES:
        for kernel, lay in (("gat_fwd", csc), ("gat_dq", csc),
                            ("gat_dkv", csr)):
            per[kernel, H, dvh] = 1
            if lay.num_partials:
                per[f"{kernel}_combine", H, dvh] = 1
    return per


def phase_attention_timing(g, dev, runs, errs):
    """Rows at the GAT's shapes: each kernel's ms (the wrapper's launches,
    combine included), its plain version's, and its bound, at rate 0 (the
    bench GAT) and 0.6 (GAT's defaults). ``runs`` maps a rate to the
    launches of its training run."""
    import torch
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak

    csc, csr = g._attention_layouts()
    N, E = g.num_nodes, g.num_edges
    gen = torch.Generator(device=dev).manual_seed(5)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    rows = []
    for H, dvh in GAT_SHAPES:
        C = H * dvh
        a_dst, a_src, v, g_out = attention_inputs(N, H, dvh, dev, gen)
        for rate, launches in runs.items():
            with torch.no_grad():
                out, lse = ak._fwd_cuda(a_dst, a_src, v, csc, 0.2, dvh, rate,
                                        seed)
                delta = (g_out.reshape(N, H, dvh)
                         * out.reshape(N, H, dvh)).sum(-1)
            bwd = (a_dst, a_src, v, g_out, lse, delta)
            cases = {
                "gat_fwd": (lambda: ak._fwd_cuda(a_dst, a_src, v, csc, 0.2,
                                                 dvh, rate, seed),
                            lambda: ak.gat_attention_reference(
                                a_dst, a_src, v, csc, 0.2, dvh, rate, seed),
                            csc, 2 * H + C, C + H),
                "gat_dq": (lambda: ak._dq_cuda(*bwd, csc, 0.2, dvh, rate,
                                               seed),
                           lambda: ak.gat_dq_reference(*bwd, csc, 0.2, dvh,
                                                       rate, seed),
                           csc, 4 * H + 2 * C, H),
                "gat_dkv": (lambda: ak._dkv_cuda(*bwd, csr, 0.2, dvh, rate,
                                                 seed),
                            lambda: ak.gat_dkv_reference(*bwd, csr, 0.2, dvh,
                                                         rate, seed),
                            csr, 4 * H + 2 * C, H + C),
            }
            for kernel, (fn, plain, lay, cols_in, cols_out) in cases.items():
                with torch.no_grad():
                    ms = time_ms(fn, 50)
                    plain_ms = time_ms(plain, 3)
                # each input read once: the node tables, the edge list
                # (and the CSC positions where the CSR pass drops), the
                # pieces; each output written once
                edge_ints = 1 + (kernel == "gat_dkv" and rate > 0)
                nbytes = 4 * (N * (cols_in + cols_out) + E * edge_ints
                              + 4 * lay.pieces.shape[0])
                # per edge and head: add, leaky, max, 2 exp, 2 scale, the
                # dropout hash (8 integer ops); per column: 2 (fma) in K9,
                # 4 (g.v product and sum, dv) in K10
                per_col = 2 if kernel == "gat_fwd" else 4
                ops = E * (H * (7 + 8 * (rate > 0)) + per_col * C)
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
                bound_ms = max(t_bytes, t_ops) * 1e3
                suffix = f"_drop{rate:g}" if rate else ""
                rows.append({
                    "name": f"{kernel}_h{H}_d{dvh}{suffix}", "route": "cuda",
                    "source": ATTN_SOURCE, "replaces": ATTN_REPLACES[kernel],
                    "launches": launches.get((kernel, H, dvh), 0),
                    "max_abs_err": errs[kernel, H, dvh], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None, "share": bound_ms / ms,
                    "shape": {"kernel": kernel, "H": H, "dvh": dvh,
                              "rate": rate, "rows": N, "edges": E,
                              "pieces": int(lay.pieces.shape[0]),
                              "split_rows": int(lay.split_rows.shape[0])}})
                print(f"[timing] {kernel} H={H} dvh={dvh} rate={rate}: "
                      f"kernel {ms:.5f} ms ({rows[-1]['launches']} launches "
                      f"in its run), plain {plain_ms:.5f} ms, bound "
                      f"{bound_ms:.5f} ms ({rows[-1]['bound_by']}; "
                      f"{bound_ms / ms:.3f} of it)", flush=True)
    ak.reset_launches()
    return rows


def phase_gat_profile(g, tag="GAT", trainer=None):
    """Where a training step's device time goes (default: the bench GAT's):
    20 steps back to back (one synchronize at the end), then 10 under
    torch.profiler; prints the device time per step by kernel (attention
    kernels by name, with K1's folds on the dedup route; the rest by sum),
    the idle share 1 - busy / back-to-back step time, the eight largest
    device kernels, and the host's own time per step (all and the eight
    largest operators)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, step = (trainer or gat_trainer)(g)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    chained_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    n = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    # device spans of annotations (Optimizer.step#...) overlap kernels
    by_name, host, device = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.key] = e.self_cpu_time_total / 1e3 / n
        elif not e.key.startswith("Optimizer."):
            name = e.key.replace("void (anonymous namespace)::",
                                 "").split("(")[0]
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            by_name[name] = by_name.get(name, 0.0) + us / 1e3 / n
            device[e.key[:100]] = us / 1e3 / n
    attn = {k: v for k, v in by_name.items()
            if k.startswith(("gat_", "dot_", "sum_", "dedup_attn",
                             "dedup_dot", "spmm_", "dedup_apply",
                             "sddmm_"))}
    busy = sum(by_name.values())
    profile_line = {
        "chained_ms_per_step": chained_ms, "device_busy_ms_per_step": busy,
        "attention_ms_per_step": sum(attn.values()),
        "other_ms_per_step": busy - sum(attn.values()),
        "idle_share": 1 - busy / chained_ms, "attention_kernels_ms": attn,
        "device_top_ms": dict(sorted(device.items(),
                                     key=lambda kv: -kv[1])[:8]),
        "host_ms_per_step": sum(host.values()),
        "host_top_ms": dict(sorted(host.items(), key=lambda kv: -kv[1])[:8])}
    print(f"[profile] {tag} step: {json.dumps(profile_line)}", flush=True)
    return profile_line


def phase_gat(dev):
    """The GAT path: kernel checks, the small model, the two training runs
    on the bench GAT graph, and the kernels' times. Returns (rows, the
    step line's GAT entries)."""
    import torch

    t0 = time.perf_counter()
    host = gat_host()
    g = host.tensor()
    torch.cuda.synchronize()
    t_tensor = time.perf_counter() - t0
    if g._attn_layouts is not None:
        raise AssertionError("tensor() built attention layouts")
    t0 = time.perf_counter()
    csc, csr = g._attention_layouts()
    torch.cuda.synchronize()
    t_layouts = time.perf_counter() - t0
    deg = g.indegree().cpu().numpy()
    pairs = len(np.unique(host.edges[:, 1] * np.int64(g.num_nodes)
                          + host.edges[:, 0]))
    print(f"[graph] GAT N={g.num_nodes} E={g.num_edges} ({pairs} distinct "
          f"(dst, src) pairs): tensor() "
          f"{t_tensor:.3f} s (generator included), attention layouts "
          f"{t_layouts:.3f} s on the host; largest in-degree "
          f"{int(deg.max())}, empty rows {int((deg == 0).sum())}, largest "
          f"out-degree {int(g.outdegree().max())}; CSC {csc.pieces.shape[0]} "
          f"pieces, {csc.split_rows.shape[0]} split rows; CSR "
          f"{csr.pieces.shape[0]} pieces, {csr.split_rows.shape[0]} split "
          f"rows", flush=True)
    errs = phase_attention_kernels(g, dev)
    phase_attention_mask(dev)
    phase_gat_small(dev)
    per = gat_per_step(g)
    train, by0 = phase_train(g, "GAT", per, gat_trainer)
    train_d, by6 = phase_train(g, "GAT defaults", per,
                               lambda g: gat_trainer(g, defaults=True))
    prof = phase_gat_profile(g)
    rows = phase_attention_timing(g, dev, {0.0: by0, 0.6: by6}, errs)
    attn = {rate: sum(r["ms"] for r in rows if r["shape"]["rate"] == rate)
            for rate in (0.0, 0.6)}
    print(f"[default] attention device ms per GAT step: {attn[0.0]:.5f} "
          f"(no dropout), {attn[0.6]:.5f} (rate 0.6)", flush=True)
    return rows, {
        "GAT": dict(train, attention_ms_per_step=attn[0.0],
                    tensor_s=t_tensor, attention_layouts_s=t_layouts,
                    profile=prof),
        "GAT_defaults": dict(train_d, attention_ms_per_step=attn[0.6])}


def dedup_attention_of(g, dev, counts=True):
    """K7/K8's work lists of ``g``'s CSC dedup layout (built with no gate),
    with K4's counts or without."""
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    idx = g.adj_dst_index.numpy()
    lay = dk.build_dedup_layout(idx.indptr, idx.sorted_v, g.num_nodes,
                                device=dev)
    return da.build_dedup_attention(
        dk.materialize_counts(lay) if counts else lay, g.num_nodes)


def without_counts(att):
    """``att`` rebuilt from its layout with the counts dropped."""
    import dataclasses
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    return da.build_dedup_attention(
        dataclasses.replace(att.layout, counts=None), att.num_rows)


def run_dedup_attention(att, ins, rate, seed):
    """K7, K8 and K1's two folds of K8's slot rows on float32 ``ins``:
    ``(out, lse, d a_dst, d a_src slots, dv slots, d a_src, dv)``."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    a_dst, a_src, v, g = ins
    H = a_dst.shape[1]
    dvh = v.shape[1] // H
    with torch.no_grad():
        out, lse = da._fwd_cuda(a_dst, a_src, v, att, 0.2, dvh, rate, seed)
        delta = (g.reshape(-1, H, dvh) * out.reshape(-1, H, dvh)).sum(-1)
        bwd = da._bwd_cuda(a_dst, a_src, v, g, lse, delta, att, 0.2, dvh,
                           rate, seed)
        return (out, lse) + bwd + (sk._spmm_cuda(bwd[1], att.red),
                                   sk._spmm_cuda(bwd[2], att.red))


def check_dedup_attention(tag, att, ins, rate, seed, got):
    """``got`` of :func:`run_dedup_attention` against the plain versions in
    float64 on the same inputs (the folds by ``check_spmm``); returns the
    max |err| of K7, K8 and the folds."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    out, lse, da_dst, dsrc, dv, fold_src, fold_v = got
    a_dst, a_src, v, g = ins
    H = a_dst.shape[1]
    dvh = v.shape[1] // H
    name = f"{tag} H={H} dvh={dvh} rate={rate}"
    with torch.no_grad():
        d64 = [t.double() for t in ins]
        out_p, lse_p = da.dedup_attention_reference(*d64[:3], att.layout,
                                                    0.2, dvh, rate, seed)
        delta = (d64[3].reshape(-1, H, dvh)
                 * out.double().reshape(-1, H, dvh)).sum(-1)
        dq_p, dsrc_p, dv_p = da.dedup_bwd_reference(
            *d64, lse.double(), delta, att.layout, 0.2, dvh, rate, seed)
        return {"dedup_fwd": max(check(f"{name} K7 out", out, out_p),
                                 check(f"{name} K7 lse", lse, lse_p)),
                "dedup_bwd": max(check(f"{name} K8 d a_dst", da_dst, dq_p),
                                 check(f"{name} K8 d a_src slots", dsrc,
                                       dsrc_p),
                                 check(f"{name} K8 dv slots", dv, dv_p)),
                "uniq_reduce": max(check_spmm(f"{name} fold d a_src",
                                              fold_src, dsrc, att.red),
                                   check_spmm(f"{name} fold dv", fold_v, dv,
                                              att.red))}


def phase_dedup_attention_kernels(g_gat, dev):
    """K7, K8 and the folds against their float64 plain versions at rates 0
    and 0.6 (seed drawn per case), on the small graph at several head
    shapes and on the bench GAT graph at the GAT's; a second run and a
    layout without counts give the same bits. Returns the max |err| per
    (kernel, H, dvh) on the bench graph."""
    import torch
    from pgl_tpu_torch import Graph

    small = Graph(attention_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
    atts = {"small": dedup_attention_of(small, dev),
            "headline": g_gat._dedup_attn_aux()}
    if not (atts["small"].num_partials and atts["headline"].num_partials):
        raise AssertionError("both graphs must split rows into pieces")
    bare = {tag: without_counts(att) for tag, att in atts.items()}
    gen = torch.Generator(device=dev).manual_seed(6)
    errs = {}
    cases = [("small", hd) for hd in ((8, 8), (1, 16), (4, 32), (3, 3),
                                      (2, 64), (42, 1), (43, 2))]
    cases += [("headline", hd) for hd in GAT_SHAPES]
    for tag, (H, dvh) in cases:
        att = atts[tag]
        ins = attention_inputs(att.num_rows, H, dvh, dev, gen)
        for rate in (0.0, 0.6):
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                                 generator=gen, device=dev)
            got = run_dedup_attention(att, ins, rate, seed)
            for what, other in (("a second run", att),
                                ("the layout without counts", bare[tag])):
                if not all(map(torch.equal, got, run_dedup_attention(
                        other, ins, rate, seed))):
                    raise AssertionError(f"{tag} H={H} dvh={dvh} rate="
                                         f"{rate}: {what} differs")
            e = check_dedup_attention(tag, att, ins, rate, seed, got)
            if tag == "headline":
                for k, v in e.items():
                    errs[k, H, dvh] = max(errs.get((k, H, dvh), 0.0), v)
            print(f"[dedup attention] {tag} N={att.num_rows} E="
                  f"{att.layout.num_edges} cells={att.num_cells} H={H} "
                  f"dvh={dvh} rate={rate}: max |err| K7 "
                  f"{e['dedup_fwd']:.3e} K8 {e['dedup_bwd']:.3e} folds "
                  f"{e['uniq_reduce']:.3e}; same bits on a second run and "
                  "without counts", flush=True)
    reset_all_launches()
    return errs


def phase_dedup_attention_mask(dev, n=1 << 20, dot=False):
    """The keep bits of K7 and K8 equal the plain cell mask exactly: on a
    permutation graph every row has one cell and every nonempty slot one,
    so with a_dst = a_src = 0 (``dot``: q = k = 0 with dsh = 2), v = g = 1
    and dvh = 1, K7's out and K8's dv slot rows are 1 / (1 - rate) where
    the cell is kept and 0 where it is dropped, and every other slot row is
    0."""
    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import dedup_attention as da

    H, rate = 42, 0.3 if dot else 0.6
    rng = np.random.default_rng(9)
    g = Graph(np.stack([rng.permutation(n), np.arange(n)], axis=1),
              num_nodes=n).tensor(dev)
    att = dedup_attention_of(g, dev, counts=False)
    lay = att.layout
    if not lay.simple:
        raise AssertionError("a permutation graph is simple")
    dst, urow, slot = da._edge_slots(lay)
    key = da.cell_idx(dst, urow)
    zeros = torch.zeros(n, 2 * H if dot else H, device=dev)
    ones = torch.ones(n, H, device=dev)
    for seed_v in (-1640531535, 12345):
        seed = torch.tensor([seed_v], dtype=torch.int32, device=dev)
        want = torch.stack([ak.drop_keep(key, seed, h, rate)
                            for h in range(H)], dim=1)
        with torch.no_grad():
            if dot:
                out, lse = da._dot_fwd_cuda(zeros, zeros, ones, att, 0.0, 2,
                                            1, rate, seed)
                _, _, dv = da._dot_bwd_cuda(zeros, zeros, ones, ones, lse,
                                            out, att, 0.0, 2, 1, rate, seed)
            else:
                out, lse = da._fwd_cuda(zeros, zeros, ones, att, 0.2, 1,
                                        rate, seed)
                _, _, dv = da._bwd_cuda(zeros, zeros, ones, ones, lse, out,
                                        att, 0.2, 1, rate, seed)
        for name, got in (("K7", out[dst] != 0), ("K8", dv[slot] != 0)):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{name} keep bits differ from the plain mask in "
                    f"{int((got != want).sum())} of {want.numel()}")
        if int((dv != 0).sum()) != int(want.sum()):
            raise AssertionError("K8 wrote to a slot row without cells")
    reset_all_launches()
    mode = "dot " if dot else ""
    print(f"[dedup {mode}attention] keep bits of K7 and K8 equal the plain "
          f"cell mask over {n} cells x {H} heads, 2 seeds, rate {rate}",
          flush=True)


def dedup_gat_per_step(g):
    """Launches per GAT step on the dedup route: K7 and K8 once at each
    shape (with their second launches where rows split), and K1 over
    ``red`` at D = H and D = H·dvh."""
    att = g._dedup_attn_aux()
    per = {}
    for H, dvh in GAT_SHAPES:
        for kernel in ("dedup_fwd", "dedup_bwd"):
            per[kernel, H, dvh] = 1
            if att.num_partials:
                per[f"{kernel}_combine", H, dvh] = 1
        for d in (H, H * dvh):
            per["uniq_reduce", d] = 1
    return per


def timing_row(rows, info, name, kernel, source, replaces, launches, err,
               ms, plain_ms, nbytes, ops, lib_ms, gather_bytes=None,
               lib_name="torch.sparse.mm", **extra):
    """Append one row of the kernels line to ``rows`` and print it. The
    bound is the larger of ``nbytes`` (each input read once, each output
    written once) over the card's memory rate and ``ops`` over its float32
    rate; ``gather_bytes`` (the rows the kernel gathers, read once each
    time) adds a gather bound. ``lib_name`` names the library call timed
    in ``lib_ms``; ``info`` and ``extra`` describe the shape."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    rows.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, "share": bound_ms / ms,
        "shape": dict(info, kernel=kernel, **extra)})
    if lib_ms is not None:
        rows[-1]["library_call"] = lib_name
    gather = ""
    if gather_bytes is not None:
        gather_ms = gather_bytes / HBM_BYTES_PER_S * 1e3
        rows[-1]["gather_bound_ms"] = gather_ms
        gather = (f", gather bound {gather_ms:.5f} ms "
                  f"({gather_ms / ms:.3f} of it)")
    print(f"[timing] {name}: kernel {ms:.5f} ms ({launches} launches in "
          f"its run), plain {plain_ms:.5f} ms, "
          + (f"{lib_name} {lib_ms:.5f} ms, " if lib_ms else "")
          + f"bound {bound_ms:.5f} ms ({rows[-1]['bound_by']}; "
          f"{bound_ms / ms:.3f} of it){gather}", flush=True)


def time_uniq_reduce(rows, info, red, d, launches, dev, gen, iters):
    """Time K1 over ``red`` (the fold of K8's slot rows) at width ``d``
    beside its plain version and ``torch.sparse.mm``, check it, and add its
    row."""
    import torch
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    N, S = red.num_rows, red.num_edges
    A = torch.sparse_csr_tensor(red.indptr, red.indices,
                                torch.ones(S, device=dev), size=(N, S))
    x = torch.randn(S, d, device=dev, generator=gen)
    out = torch.empty(N, d, device=dev)
    part = torch.empty(red.num_partials, d, device=dev)
    ms = time_ms(lambda: sk._launch(x, red, out, part), iters)
    plain_ms = time_ms(lambda: sk.spmm_reference(x, red), 10)
    lib_ms = time_ms(lambda: torch.sparse.mm(A, x), iters)
    with torch.no_grad():
        err = check_spmm(f"timed uniq_reduce D={d}", out, x, red)
    nbytes = 4 * (S * d + S + N + 1 + N * d)
    timing_row(rows, info, f"spmm_uniq_reduce_d{d}", "uniq_reduce", SOURCE,
               REPLACES, launches, err, ms, plain_ms, nbytes, S * d, lib_ms,
               D=d)


def phase_dedup_attention_timing(g, dev, runs, errs):
    """Rows at the GAT's shapes on the dedup route: K7 and K8 (each
    wrapper's launches, merges included) at rate 0 and 0.6, and K1 over
    ``red`` at D = H and H·dvh, beside the plain versions, the bound and,
    for K1, ``torch.sparse.mm``. ``runs`` maps a rate to the launches of its
    training run."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da

    att = g._dedup_attn_aux()
    lay = att.layout
    N, n, S = g.num_nodes, att.num_cells, att.num_slots
    n_pieces = int(att.pieces.shape[0])
    gen = torch.Generator(device=dev).manual_seed(7)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    shape = {"rows": N, "edges": lay.num_edges, "cells": n,
             "pieces": n_pieces, "split_rows": int(att.split_rows.shape[0]),
             "pairs": lay.num_pairs, "slots": S}
    rows = []
    for H, dvh in GAT_SHAPES:
        C = H * dvh
        a_dst, a_src, v, g_out = attention_inputs(N, H, dvh, dev, gen)
        for rate, launches in runs.items():
            drop = rate > 0
            with torch.no_grad():
                out, lse = da._fwd_cuda(a_dst, a_src, v, att, 0.2, dvh,
                                        rate, seed)
                delta = (g_out.reshape(N, H, dvh)
                         * out.reshape(N, H, dvh)).sum(-1)
                bwd = (a_dst, a_src, v, g_out, lse, delta)
                fwd_ms = time_ms(lambda: da._fwd_cuda(
                    a_dst, a_src, v, att, 0.2, dvh, rate, seed), 50)
                fwd_plain = time_ms(lambda: da.dedup_attention_reference(
                    a_dst, a_src, v, lay, 0.2, dvh, rate, seed), 3)
                bwd_ms = time_ms(lambda: da._bwd_cuda(
                    *bwd, att, 0.2, dvh, rate, seed), 50)
                bwd_plain = time_ms(lambda: da.dedup_bwd_reference(
                    *bwd, lay, 0.2, dvh, rate, seed), 3)
            suffix = f"_drop{rate:g}" if rate else ""
            # bytes: each input read once (the node tables; 3 ints a cell
            # and 4 a piece in row order; K8 also 2 ints a cell, the slot
            # pointers, pairs and uv in column order), each output written
            # once (out and lse; d a_dst and the slot rows)
            row_ints = 3 * n + 4 * n_pieces
            fwd_bytes = 4 * (N * (2 * H + C) + row_ints + N * (C + H))
            bwd_bytes = 4 * (N * (4 * H + 2 * C) + row_ints + 2 * n + S + 1
                             + 4 * lay.num_pairs + lay.uv.numel()
                             + N * H + S * (H + C))
            # operations a cell and head: add, leaky, max, 2 exp, 2 scale,
            # count multiply (K8: clamp, leaky slope, 2 multiply-adds, each
            # pass), the hash (8 integer ops); a cell and column: 2 (K7's
            # fma), 2 and 4 in K8's passes (g.v, dv)
            per_head = 8 + 8 * drop
            fwd_ops = n * (H * per_head + 2 * C)
            bwd_ops = n * (2 * H * (per_head + 2) + 6 * C)
            for kernel, ms, plain_ms, nbytes, ops in (
                    ("dedup_fwd", fwd_ms, fwd_plain, fwd_bytes, fwd_ops),
                    ("dedup_bwd", bwd_ms, bwd_plain, bwd_bytes, bwd_ops)):
                timing_row(rows, shape, f"{kernel}_h{H}_d{dvh}{suffix}",
                           kernel, DATTN_SOURCE, DATTN_REPLACES[kernel],
                           launches.get((kernel, H, dvh), 0),
                           errs[kernel, H, dvh], ms, plain_ms, nbytes, ops,
                           None, H=H, dvh=dvh, rate=rate)
        for d in (H, C):
            time_uniq_reduce(rows, shape, att.red, d,
                             runs[0.0].get(("uniq_reduce", d), 0), dev, gen,
                             50)
    reset_all_launches()
    return rows


def phase_dedup_gat(dev, edge_route_ms):
    """The dedup GAT path (count-matrix attention): kernel checks, the
    small model, three training runs on the bench GAT graph, its profile
    and the kernels' times. ``edge_route_ms`` is the per-edge route's
    attention device time per step (rate 0) from ``phase_gat``. Returns
    (rows, the step line's entries)."""
    import torch

    host = gat_host()
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dispatch_settings(DEDUP=True):
        g = host.tensor()
    torch.cuda.synchronize()
    t_tensor = time.perf_counter() - t0
    k4 = {k: v for k, v in all_launches().items() if v}
    if k4 != {("counts", "csc", None): 1, ("counts", "csr", None): 1}:
        raise AssertionError(f"tensor() launched {k4}, expected K4 once "
                             "per layout")
    if g._dedup_attn is not None or g._attn_layouts is not None:
        raise AssertionError("tensor() built attention work lists")
    t0 = time.perf_counter()
    att = g._dedup_attn_aux()
    torch.cuda.synchronize()
    t_att = time.perf_counter() - t0
    csc_d, csr_d = g._dedup_layouts
    print(f"[graph] GAT under DEDUP: tensor() {t_tensor:.3f} s (generator, "
          f"layouts and K4 included); K7/K8 work lists and red {t_att:.3f} "
          f"s on the host. CSC {csc_d.num_pairs} pairs, "
          f"{csc_d.groups.shape[0]} groups, {csc_d.num_partials} partials in "
          f"{csc_d.split_blocks.shape[0]} split blocks, simple "
          f"{csc_d.simple}, max count {csc_d.max_count}, counts "
          f"{csc_d.counts_bytes / 1e6:.1f} MB, uv {csc_d.uv.numel()} rows; "
          f"CSR {csr_d.num_pairs} pairs, counts "
          f"{csr_d.counts_bytes / 1e6:.1f} MB; {att.num_cells} nonzero "
          f"cells, {att.pieces.shape[0]} pieces, {att.split_rows.shape[0]} "
          f"split rows, {att.num_slots} slots", flush=True)
    errs = phase_dedup_attention_kernels(g, dev)
    phase_dedup_attention_mask(dev)
    phase_gat_small(dev, dedup=True)
    per = dedup_gat_per_step(g)
    train, by0 = phase_train(g, "GAT dedup", per, gat_trainer)
    reset_all_launches()
    with dispatch_settings(DEDUP=True, COUNTS_BUDGET_BYTES=0):
        g_bare = host.tensor()
    if any(all_launches().values()) or g_bare._dedup_layouts[0].counts \
            is not None:
        raise AssertionError("tensor() over the counts budget made counts")
    train_bare, _ = phase_train(g_bare, "GAT dedup uncached",
                                dedup_gat_per_step(g_bare), gat_trainer)
    del g_bare
    train_cell, by6 = phase_train(
        g, "GAT defaults cell", per,
        lambda g: gat_trainer(g, defaults=True, mode="cell"))
    prof = phase_gat_profile(g, "GAT dedup")
    rows = phase_dedup_attention_timing(g, dev, {0.0: by0, 0.6: by6}, errs)
    # K7 and K8 once a step at each shape, and the four folds
    folds_ms = sum(r["ms"] for r in rows
                   if r["shape"]["kernel"] == "uniq_reduce")
    attn = {rate: folds_ms + sum(r["ms"] for r in rows
                                 if r["shape"].get("rate") == rate)
            for rate in (0.0, 0.6)}
    lower = "dedup" if attn[0.0] < edge_route_ms else "per-edge"
    print(f"[default] attention device ms per bench GAT step: dedup route "
          f"(K7, K8, folds) {attn[0.0]:.5f}, per-edge route (K9, K10) "
          f"{edge_route_ms:.5f}; lower: {lower}; dedup route at rate 0.6 "
          f"(cell mode) {attn[0.6]:.5f}", flush=True)
    return rows, {
        "GAT_dedup": dict(train, attention_ms_per_step=attn[0.0],
                          tensor_s=t_tensor, work_lists_s=t_att,
                          profile=prof),
        "GAT_dedup_uncached": train_bare,
        "GAT_defaults_cell": dict(train_cell,
                                  attention_ms_per_step=attn[0.6]),
        "attention_route_lower": lower}


# (heads, score width, value width) of UniMP's attention layers 0 and 1
UNIMP_SHAPE = (2, 128, 128)
# ogbn-arxiv's train split of its nodes (examples/unimp/train.py feeds its
# labels); a graph of another size takes the same share
UNIMP_TRAIN, UNIMP_NODES = 90941, 169343
DOT_KERNELS = ("dot_fwd", "dot_dq", "dot_dkv")
DOT_REPLACES = {"dot_" + k[4:]: v for k, v in ATTN_REPLACES.items()}
DDOT_KERNELS = ("dedup_dot_fwd", "dedup_dot_bwd")
DDOT_REPLACES = {"dedup_dot_" + k[6:]: v for k, v in DATTN_REPLACES.items()}


def dot_inputs(n, shape, dev, gen):
    """Random q, k [n, H·dsh] (q scaled by 1/√dsh, so the scores spread as
    unit normals, as TransformerConv's), v and g [n, H·dvh] (float32)."""
    import torch
    H, dsh, dvh = shape
    q, k, v, g = (torch.randn(n, H * w, device=dev, generator=gen)
                  for w in (dsh, dsh, dvh, dvh))
    return q * dsh ** -0.5, k, v, g


def run_dot(lays, ins, shape, leaky, rate, seed):
    """The dot-mode K9, K10-dq and K10-dkv on float32 ``ins``: ``(out, lse,
    dq, dk, dv)``."""
    import torch
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    csc, csr = lays
    q, k, v, g = ins
    H, dsh, dvh = shape
    with torch.no_grad():
        out, lse = ak._dot_fwd_cuda(q, k, v, csc, leaky, dsh, dvh, rate,
                                    seed)
        delta = (g.reshape(-1, H, dvh) * out.reshape(-1, H, dvh)).sum(-1)
        bwd = (q, k, v, g, lse, delta)
        dq = ak._dot_dq_cuda(*bwd, csc, leaky, dsh, dvh, rate, seed)
        dk, dv = ak._dot_dkv_cuda(*bwd, csr, leaky, dsh, dvh, rate, seed)
    return out, lse, dq, dk, dv


def check_dot(tag, lays, ins, shape, leaky, rate, seed, got):
    """``got`` of :func:`run_dot` against the plain versions in float64 on
    the same inputs (the backward on the kernel's lse and delta), with
    ``check``'s rule; dq, dk and dv scaled by the 2-norm of the terms each
    element sums. Returns the max |err| of each kernel."""
    import torch
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    csc, csr = lays
    H, dsh, dvh = shape
    out, lse, dq, dk, dv = got
    name = f"{tag} H={H} dsh={dsh} dvh={dvh} rate={rate}"
    with torch.no_grad():
        q, k, v, g = (t.double() for t in ins)
        out_p, lse_p = ak.dot_attention_reference(q, k, v, csc, dsh, dvh,
                                                  leaky, rate, seed)
        errs = {"dot_fwd": max(check(f"{name} K9 out", out, out_p),
                               check(f"{name} K9 lse", lse, lse_p))}
        del out_p, lse_p
        delta = (g.reshape(-1, H, dvh)
                 * out.double().reshape(-1, H, dvh)).sum(-1)
        bwd = (q, k, v, g, lse.double(), delta)
        args = (dsh, dvh, leaky, rate, seed)
        ends = {lay.kind: ak._ends(lay) for lay in lays}
        n = q.shape[0]

        def grads(lay):
            dst, src = ends[lay.kind]
            return dst, src, ak.edge_grads(*bwd, dst, src, lay.positions(),
                                           leaky, dvh, rate, seed, dsh)

        dst, src, (_, ds, _) = grads(csc)
        scale = ak.head_scatter(ds * ds, k[src] ** 2, dst, n).sqrt()
        del ds
        errs["dot_dq"] = check(f"{name} K10-dq", dq,
                               ak.dot_dq_reference(*bwd, csc, *args), scale)
        dst, src, (qe, ds, g_e) = grads(csr)
        scale_k = ak.head_scatter(ds * ds, q[dst] ** 2, src, n).sqrt()
        scale_v = ak.head_scatter(qe * qe, g_e.reshape(len(dst), -1) ** 2,
                                  src, n).sqrt()
        del qe, ds, g_e
        dk_p, dv_p = ak.dot_dkv_reference(*bwd, csr, *args)
        errs["dot_dkv"] = max(check(f"{name} K10-dkv dk", dk, dk_p, scale_k),
                              check(f"{name} K10-dkv dv", dv, dv_p, scale_v))
    return errs


def phase_dot_kernels(graphs, dev):
    """The dot-mode K9/K10 against their float64 plain versions at rates 0
    and 0.3 (seed drawn per case): on the small graph with a hub
    destination and a hub source at UniMP's shape, (8, 16, 16) and two
    shapes of GATConv's many-head fallback (dsh 2, leaky 0.2), and on each
    of ``graphs`` (tag -> graph: the bench GAT graph, whose hub row splits,
    and UniMP's) at UniMP's shape; a second run gives the same bits.
    Returns the max |err| per (tag, kernel)."""
    import torch
    from pgl_tpu_torch import Graph

    small = Graph(attention_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = [("small", small, shape, leaky) for shape, leaky in (
        (UNIMP_SHAPE, 0.0), ((8, 16, 16), 0.0), ((43, 2, 2), 0.2),
        ((43, 2, 8), 0.2))]
    cases += [(tag, g, UNIMP_SHAPE, 0.0) for tag, g in graphs.items()]
    errs = {}
    for tag, g, shape, leaky in cases:
        lays = g._attention_layouts()
        if tag == "small" and not (lays[0].num_partials
                                   and lays[1].num_partials):
            raise AssertionError("the small graph must split rows on both "
                                 "layouts")
        ins = dot_inputs(g.num_nodes, shape, dev, gen)
        for rate in (0.0, 0.3):
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                                 generator=gen, device=dev)
            got = run_dot(lays, ins, shape, leaky, rate, seed)
            if not all(map(torch.equal, got,
                           run_dot(lays, ins, shape, leaky, rate, seed))):
                raise AssertionError(f"{tag} {shape} rate={rate}: two runs "
                                     "differ")
            e = check_dot(tag, lays, ins, shape, leaky, rate, seed, got)
            del got
            for k, v in e.items():
                errs[tag, k] = max(errs.get((tag, k), 0.0), v)
            print(f"[dot attention] {tag} N={g.num_nodes} E={g.num_edges} "
                  f"(H, dsh, dvh)={shape} leaky={leaky} rate={rate}: max "
                  f"|err| K9 {e['dot_fwd']:.3e} K10-dq {e['dot_dq']:.3e} "
                  f"K10-dkv {e['dot_dkv']:.3e}; same bits on a second run",
                  flush=True)
    reset_all_launches()
    return errs


def phase_dot_mask(dev):
    """The dot-mode keep bits of K9 and K10-dkv equal the plain mask
    exactly: on a permutation graph (one edge a row) with q = k = 0 (dsh =
    2), v = g = 1 and dvh = 1, K9's out and K10-dkv's dv are 1 / (1 - rate)
    where the edge is kept and 0 where it is dropped."""
    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak

    n, H, rate = 1 << 20, 42, 0.3
    rng = np.random.default_rng(10)
    g = Graph(np.stack([rng.permutation(n), np.arange(n)], axis=1),
              num_nodes=n).tensor(dev)
    lays = g._attention_layouts()
    zeros = torch.zeros(n, 2 * H, device=dev)
    ones = torch.ones(n, H, device=dev)
    for seed_v in (-1640531535, 12345):
        seed = torch.tensor([seed_v], dtype=torch.int32, device=dev)
        out, _, _, _, dv = run_dot(lays, (zeros, zeros, ones, ones),
                                   (H, 2, 1), 0.0, rate, seed)
        for name, got, lay in (("K9", out, lays[0]), ("K10-dkv", dv,
                                                       lays[1])):
            pos = torch.empty_like(lay.positions())
            pos[lay.seg_ids.long()] = lay.positions()
            want = torch.stack([ak.drop_keep(pos, seed, h, rate)
                                for h in range(H)], dim=1)
            if not torch.equal(got != 0, want):
                raise AssertionError(
                    f"dot {name} keep bits differ from the plain mask in "
                    f"{int(((got != 0) != want).sum())} of {want.numel()}")
    reset_all_launches()
    print(f"[dot attention] keep bits of K9 and K10-dkv equal the plain mask "
          f"over {n} positions x {H} heads, 2 seeds, rate {rate}", flush=True)


def phase_unimp_small(dev, dedup=False):
    """A small UniMP (2 heads of 16, labels fed through a mask): the CUDA
    kernels against the CPU's plain versions with the same weights, logits
    and every parameter gradient, at ``check``'s rule; with ``dedup``,
    through the count-matrix dot attention (the dedup band opened to the
    graph)."""
    import torch
    from pgl_tpu_torch.datasets import community_graph
    from pgl_tpu_torch.models import UniMP
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    mask = np.random.default_rng(2).random(300) < 0.5
    results = {}
    for d in ("cpu", dev):
        with dispatch_settings(DEDUP=dedup, DEDUP_MIN_EDGES=0):
            gt = g.tensor(d)
        reset_all_launches()            # K4 at tensor() under DEDUP
        y = torch.as_tensor(labels, device=d).long()
        model = UniMP(16, 3, hidden_size=16, num_heads=2, dropout=0.0,
                      generator=torch.Generator().manual_seed(0), device=d)
        logits = model(gt, gt.node_feat["h"], y,
                       torch.as_tensor(mask, device=d), training=True)
        ce(logits, y).mean().backward()
        results[str(d)] = (logits.detach().cpu(),
                           {k: p.grad.cpu()
                            for k, p in model.named_parameters()})
    launched = {k: v for k, v in all_launches().items() if v}
    kernels = DDOT_KERNELS if dedup else DOT_KERNELS
    want = {(k, 2, 16, 16): 2 for k in kernels}
    if dedup:
        want["uniq_reduce", 32] = 4
    if launched != want:
        raise AssertionError(f"small UniMP launched {launched}")
    reset_all_launches()
    path = "dedup" if dedup else "per-edge"
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results[str(dev)]
    err = check(f"small UniMP {path} logits", l_gpu, l_cpu)
    for k in g_cpu:
        err = max(err, check(f"small UniMP {path} grad {k}", g_gpu[k],
                             g_cpu[k]))
    print(f"[model] small UniMP through the {path} route, CUDA vs CPU: max "
          f"|err| {err:.3e} (logits and {len(g_cpu)} parameter gradients)",
          flush=True)


def unimp_host():
    """An ogbn-arxiv-sized stand-in (the arxiv files are not in the repo):
    169,343 nodes of 128 features in 40 classes, about 2.4M edges."""
    from pgl_tpu_torch.datasets import community_graph
    return community_graph(num_nodes=UNIMP_NODES, num_classes=40,
                           feat_dim=128, avg_degree=116, seed=0)


def unimp_trainer(g, labels, training=True, mode="edge"):
    """UniMP at the reference's defaults (``pgl_tpu/models/unimp.py:65-71``:
    3 layers, 2 heads of 128, dropout 0.3; weights from seed 0) on ``g``'s
    device, its two attention layers in attention dropout ``mode``, and a
    function that takes one AdamW step (lr 5e-3, weight decay 5e-4) as
    ``examples/unimp/train.py:65-92``: the train nodes are the first
    ogbn-arxiv share (``UNIMP_TRAIN`` of ``UNIMP_NODES``) of a seeded
    permutation, each step feeds a fresh seeded 60% of their labels, and
    the loss is over the train nodes not fed."""
    import torch
    from pgl_tpu_torch.models import UniMP
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

    x = g.node_feat["h"]
    dev, n = x.device, g.num_nodes
    y = torch.as_tensor(labels, device=dev).long()
    train = torch.zeros(n, dtype=torch.bool, device=dev)
    train[torch.as_tensor(np.random.default_rng(0).permutation(n)[
        :n * UNIMP_TRAIN // UNIMP_NODES], device=dev)] = True
    model = UniMP(input_size=128, num_class=40, num_layers=3,
                  hidden_size=128, num_heads=2, dropout=0.3,
                  generator=torch.Generator().manual_seed(0), device=dev)
    for layer in (model.conv_0, model.conv_1):
        layer.attn_drop_mode = mode
    opt = torch.optim.AdamW(model.parameters(), lr=5e-3, weight_decay=5e-4)
    gen = torch.Generator(device=dev).manual_seed(7)

    def step():
        feed = train & (torch.rand(n, generator=gen, device=dev) < 0.6)
        rest = (train & ~feed).float()
        opt.zero_grad(set_to_none=True)
        losses = ce(model(g, x, y, feed, training=training), y)
        loss = (losses * rest).sum() / rest.sum().clamp(min=1.0)
        loss.backward()
        opt.step()
        return loss.detach()

    return model, step


def phase_dot_timing(graphs, dev, runs, errs):
    """Rows at UniMP's shape for each of ``graphs`` (tag -> graph): each
    dot kernel's ms (the wrapper's launches, merges included), its plain
    version's, and two bounds: the table's (each input read once, each
    output written once) and the gather bound (the rows each edge gathers
    read from device memory once an edge). ``runs`` maps a tag to {rate:
    launches of its training run}."""
    import torch
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak

    H, dsh, dvh = shape = UNIMP_SHAPE
    DS, C = H * dsh, H * dvh
    gen = torch.Generator(device=dev).manual_seed(9)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    rows = []
    for tag, g in graphs.items():
        csc, csr = g._attention_layouts()
        N, E = g.num_nodes, g.num_edges
        q, k, v, g_out = dot_inputs(N, shape, dev, gen)
        for rate, launches in runs[tag].items():
            drop = rate > 0
            args = (dsh, dvh, 0.0, rate, seed)
            with torch.no_grad():
                out, lse = ak._dot_fwd_cuda(q, k, v, csc, 0.0, dsh, dvh,
                                            rate, seed)
                delta = (g_out.reshape(N, H, dvh)
                         * out.reshape(N, H, dvh)).sum(-1)
            bwd = (q, k, v, g_out, lse, delta)
            # (kernel, plain, layout, node columns read, written, gathered
            # an edge, operations an edge)
            per_head = 7 + 8 * drop      # leaky, max, 2 exp, 2 scale; hash
            cases = {
                "dot_fwd": (
                    lambda: ak._dot_fwd_cuda(q, k, v, csc, 0.0, dsh, dvh,
                                             rate, seed),
                    lambda: ak.dot_attention_reference(q, k, v, csc, *args),
                    csc, 2 * DS + C, C + H, DS + C,
                    2 * DS + 2 * C + H * per_head),
                "dot_dq": (
                    lambda: ak._dot_dq_cuda(*bwd, csc, 0.0, dsh, dvh, rate,
                                            seed),
                    lambda: ak.dot_dq_reference(*bwd, csc, *args),
                    csc, 2 * DS + 2 * C + 2 * H, DS, DS + C,
                    4 * DS + 2 * C + H * per_head),
                "dot_dkv": (
                    lambda: ak._dot_dkv_cuda(*bwd, csr, 0.0, dsh, dvh, rate,
                                             seed),
                    lambda: ak.dot_dkv_reference(*bwd, csr, *args),
                    csr, 2 * DS + 2 * C + 2 * H, DS + C, DS + C + 2 * H,
                    4 * DS + 4 * C + H * per_head),
            }
            for kernel, (fn, plain, lay, cols_in, cols_out, gathered,
                         ops_e) in cases.items():
                with torch.no_grad():
                    ms = time_ms(fn, 20)
                    plain_ms = time_ms(plain, 3)
                edge_ints = 1 + (kernel == "dot_dkv" and drop)
                nbytes = 4 * (N * (cols_in + cols_out) + E * edge_ints
                              + 4 * lay.pieces.shape[0])
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = E * ops_e / F32_OPS_PER_S
                bound_ms = max(t_bytes, t_ops) * 1e3
                gather_ms = 4 * E * gathered / HBM_BYTES_PER_S * 1e3
                suffix = (f"_drop{rate:g}" if drop else "") + (
                    "" if tag == "unimp" else f"_{tag}")
                rows.append({
                    "name": f"{kernel}_h{H}_s{dsh}_d{dvh}{suffix}",
                    "route": "cuda", "source": ATTN_SOURCE,
                    "replaces": DOT_REPLACES[kernel],
                    "launches": launches.get((kernel, *shape), 0),
                    "max_abs_err": errs[tag, kernel], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None, "share": bound_ms / ms,
                    "gather_bound_ms": gather_ms,
                    "shape": {"kernel": kernel, "graph": tag, "H": H,
                              "dsh": dsh, "dvh": dvh, "rate": rate,
                              "rows": N, "edges": E,
                              "pieces": int(lay.pieces.shape[0]),
                              "split_rows": int(lay.split_rows.shape[0])}})
                print(f"[timing] {kernel} {tag} (H, dsh, dvh)={shape} "
                      f"rate={rate}: kernel {ms:.5f} ms "
                      f"({rows[-1]['launches']} launches in its run), plain "
                      f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
                      f"({rows[-1]['bound_by']}; {bound_ms / ms:.3f} of it), "
                      f"gather bound {gather_ms:.5f} ms "
                      f"({gather_ms / ms:.3f} of it)", flush=True)
            del out, lse, delta, bwd
    reset_all_launches()
    return rows


def phase_unimp(dev):
    """The UniMP path (dot-mode K9/K10): the arxiv-sized graph, kernel
    checks (with the bench GAT graph, whose hub row splits), keep bits, the
    small model, the slice at full width trained 20 steps with dropout and
    20 without, a profile of the step and the kernels' times. Returns
    (rows, the step line's entries)."""
    import torch

    t0 = time.perf_counter()
    host, labels = unimp_host()
    g = host.tensor()
    torch.cuda.synchronize()
    t_tensor = time.perf_counter() - t0
    t0 = time.perf_counter()
    csc, csr = g._attention_layouts()
    torch.cuda.synchronize()
    t_layouts = time.perf_counter() - t0
    deg = g.indegree().cpu().numpy()
    cells = len(np.unique(host.edges[:, 1] * np.int64(g.num_nodes)
                          + host.edges[:, 0]))
    print(f"[graph] UniMP N={g.num_nodes} E={g.num_edges} ({cells} distinct "
          f"(dst, src) pairs): tensor() {t_tensor:.3f} s (generator "
          f"included), attention layouts {t_layouts:.3f} s on the host; "
          f"largest in-degree {int(deg.max())}, empty rows "
          f"{int((deg == 0).sum())}, largest out-degree "
          f"{int(g.outdegree().max())}; CSC {csc.pieces.shape[0]} pieces, "
          f"{csc.split_rows.shape[0]} split rows; CSR {csr.pieces.shape[0]} "
          f"pieces, {csr.split_rows.shape[0]} split rows", flush=True)
    graphs = {"unimp": g, "gat_graph": gat_host().tensor()}
    errs = phase_dot_kernels(graphs, dev)
    phase_dot_mask(dev)
    phase_unimp_small(dev)
    per = {(k, *UNIMP_SHAPE): 2 for k in DOT_KERNELS}
    train, by3 = phase_train(g, "UniMP", per,
                             lambda g: unimp_trainer(g, labels), 40)
    train_e, by0 = phase_train(
        g, "UniMP no dropout", per,
        lambda g: unimp_trainer(g, labels, training=False), 40)
    prof = phase_gat_profile(g, "UniMP",
                             lambda g: unimp_trainer(g, labels))
    rows = phase_dot_timing(graphs, dev, {"unimp": {0.3: by3, 0.0: by0},
                                          "gat_graph": {0.0: {}}}, errs)
    attn = {rate: 2 * sum(r["ms"] for r in rows
                          if r["shape"]["graph"] == "unimp"
                          and r["shape"]["rate"] == rate)
            for rate in (0.0, 0.3)}
    gather = 2 * sum(r["gather_bound_ms"] for r in rows
                     if r["shape"]["graph"] == "unimp"
                     and r["shape"]["rate"] == 0.0)
    print(f"[default] attention device ms per UniMP step (2 layers of K9, "
          f"K10-dq, K10-dkv): {attn[0.3]:.5f} (rate 0.3, training), "
          f"{attn[0.0]:.5f} (no dropout); gather bound {gather:.5f} ms; "
          f"step median {train['step_ms']:.4f} ms (training), "
          f"{train_e['step_ms']:.4f} ms (no dropout)", flush=True)
    return rows, {
        "UniMP": dict(train, attention_ms_per_step=attn[0.3],
                      gather_bound_ms_per_step=gather, tensor_s=t_tensor,
                      attention_layouts_s=t_layouts, profile=prof),
        "UniMP_no_dropout": dict(train_e, attention_ms_per_step=attn[0.0])}


# -- phase 8: the UniMP dedup path (count-matrix attention in dot mode) ------

def run_dedup_dot(att, ins, shape, rate, seed):
    """The dot-mode K7, K8 and K1's two folds of K8's slot rows on float32
    ``ins``: ``(out, lse, dq, dk slots, dv slots, dk, dv)``."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    q, k, v, g = ins
    H, dsh, dvh = shape
    with torch.no_grad():
        out, lse = da._dot_fwd_cuda(q, k, v, att, 0.0, dsh, dvh, rate, seed)
        delta = (g.reshape(-1, H, dvh) * out.reshape(-1, H, dvh)).sum(-1)
        bwd = da._dot_bwd_cuda(q, k, v, g, lse, delta, att, 0.0, dsh, dvh,
                               rate, seed)
        return (out, lse) + bwd + (sk._spmm_cuda(bwd[1], att.red),
                                   sk._spmm_cuda(bwd[2], att.red))


def check_dedup_dot(tag, att, ins, shape, rate, seed, got):
    """``got`` of :func:`run_dedup_dot` against the plain versions in
    float64 on the same inputs (the backward on the kernel's lse and
    delta), with ``check``'s rule; dq and the dk and dv slot rows scaled by
    the 2-norm of the terms each element sums, the folds by
    ``check_spmm``. Returns the max |err| of K7, K8 and the folds."""
    import torch
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    out, lse, dq, dk, dv, fold_k, fold_v = got
    H, dsh, dvh = shape
    lay = att.layout
    name = f"{tag} H={H} dsh={dsh} dvh={dvh} rate={rate}"
    with torch.no_grad():
        q, k, v, g = (t.double() for t in ins)
        out_p, lse_p = da.dedup_dot_reference(q, k, v, lay, dsh, dvh, 0.0,
                                              rate, seed)
        errs = {"dedup_dot_fwd": max(check(f"{name} K7 out", out, out_p),
                                     check(f"{name} K7 lse", lse, lse_p))}
        del out_p, lse_p
        delta = (g.reshape(-1, H, dvh)
                 * out.double().reshape(-1, H, dvh)).sum(-1)
        bwd = (q, k, v, g, lse.double(), delta)
        dst, urow, slot = da._edge_slots(lay)
        src = lay.uv.long()[urow]
        qe, ds, g_e = ak.edge_grads(*bwd, dst, src, da.cell_idx(dst, urow),
                                    0.0, dvh, rate, seed, dsh)
        n, S = q.shape[0], att.num_slots
        scale_q = ak.head_scatter(ds * ds, k[src] ** 2, dst, n).sqrt()
        scale_k = ak.head_scatter(ds * ds, q[dst] ** 2, slot, S).sqrt()
        scale_v = ak.head_scatter(qe * qe, g_e.reshape(len(dst), -1) ** 2,
                                  slot, S).sqrt()
        del qe, ds, g_e
        dq_p, dk_p, dv_p = da.dedup_dot_bwd_reference(*bwd, lay, dsh, dvh,
                                                      0.0, rate, seed)
        errs["dedup_dot_bwd"] = max(
            check(f"{name} K8 dq", dq, dq_p, scale_q),
            check(f"{name} K8 dk slots", dk, dk_p, scale_k),
            check(f"{name} K8 dv slots", dv, dv_p, scale_v))
        errs["uniq_reduce"] = max(
            check_spmm(f"{name} fold dk", fold_k, dk, att.red),
            check_spmm(f"{name} fold dv", fold_v, dv, att.red))
    return errs


def phase_dedup_dot_kernels(g_gat, dev):
    """The dot-mode K7, K8 and the folds against their float64 plain
    versions at rates 0 and 0.3 (seed drawn per case): on the small graph
    at UniMP's shape, (8, 16, 16) and (4, 64, 8) (dsh != dvh), and on the
    bench GAT graph at UniMP's shape; a second run and a layout without
    counts give the same bits. Returns the max |err| per (tag, kernel)."""
    import torch
    from pgl_tpu_torch import Graph

    small = Graph(attention_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
    atts = {"small": dedup_attention_of(small, dev),
            "headline": g_gat._dedup_attn_aux()}
    if not (atts["small"].num_partials and atts["headline"].num_partials):
        raise AssertionError("both graphs must split rows into pieces")
    bare = {tag: without_counts(att) for tag, att in atts.items()}
    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {}
    cases = [("small", shape) for shape in (UNIMP_SHAPE, (8, 16, 16),
                                            (4, 64, 8))]
    cases += [("headline", UNIMP_SHAPE)]
    for tag, shape in cases:
        att = atts[tag]
        ins = dot_inputs(att.num_rows, shape, dev, gen)
        for rate in (0.0, 0.3):
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                                 generator=gen, device=dev)
            got = run_dedup_dot(att, ins, shape, rate, seed)
            for what, other in (("a second run", att),
                                ("the layout without counts", bare[tag])):
                if not all(map(torch.equal, got, run_dedup_dot(
                        other, ins, shape, rate, seed))):
                    raise AssertionError(f"{tag} {shape} rate={rate}: "
                                         f"{what} differs")
            e = check_dedup_dot(tag, att, ins, shape, rate, seed, got)
            del got
            for k, v in e.items():
                errs[tag, k] = max(errs.get((tag, k), 0.0), v)
            print(f"[dedup dot attention] {tag} N={att.num_rows} E="
                  f"{att.layout.num_edges} cells={att.num_cells} (H, dsh, "
                  f"dvh)={shape} rate={rate}: max |err| K7 "
                  f"{e['dedup_dot_fwd']:.3e} K8 {e['dedup_dot_bwd']:.3e} "
                  f"folds {e['uniq_reduce']:.3e}; same bits on a second run "
                  "and without counts", flush=True)
    reset_all_launches()
    return errs


def unimp_dedup_per_step(g):
    """Launches per UniMP step on the dedup route: K7 and K8 in dot mode
    for layers 0 and 1 (with their second launches where rows split), and
    K1 over ``red`` for each layer's dk and dv."""
    att = g._dedup_attn_aux()
    H, dsh, dvh = UNIMP_SHAPE
    per = {}
    for kernel in DDOT_KERNELS:
        per[(kernel, *UNIMP_SHAPE)] = 2
        if att.num_partials:
            per[(f"{kernel}_combine", *UNIMP_SHAPE)] = 2
    for d in (H * dsh, H * dvh):
        per["uniq_reduce", d] = per.get(("uniq_reduce", d), 0) + 2
    return per


def phase_dedup_dot_timing(g, dev, runs, errs):
    """Rows at UniMP's shape on the bench GAT graph's dedup route: the dot
    K7 and K8 (each wrapper's launches, merges included) at rates 0 and
    0.3, and K1 over ``red`` at D = H·dsh, beside the plain versions, the
    table bound (each input read once, each output written once), the
    gather bound (the rows each cell gathers, read once a cell, and K8's
    slot rows written) and, for K1, ``torch.sparse.mm``. ``runs`` maps a
    rate to the launches of its training run."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da

    att = g._dedup_attn_aux()
    lay = att.layout
    N, n, S = g.num_nodes, att.num_cells, att.num_slots
    H, dsh, dvh = shape = UNIMP_SHAPE
    DS, C = H * dsh, H * dvh
    n_pieces = int(att.pieces.shape[0])
    gen = torch.Generator(device=dev).manual_seed(12)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    info = {"rows": N, "edges": lay.num_edges, "cells": n,
            "pieces": n_pieces, "split_rows": int(att.split_rows.shape[0]),
            "pairs": lay.num_pairs, "slots": S, "H": H, "dsh": dsh,
            "dvh": dvh}
    rows = []

    q, k, v, g_out = dot_inputs(N, shape, dev, gen)
    for rate, launches in runs.items():
        drop = rate > 0
        args = (dsh, dvh, rate, seed)
        with torch.no_grad():
            out, lse = da._dot_fwd_cuda(q, k, v, att, 0.0, *args)
            delta = (g_out.reshape(N, H, dvh)
                     * out.reshape(N, H, dvh)).sum(-1)
            bwd = (q, k, v, g_out, lse, delta)
            fwd_ms = time_ms(lambda: da._dot_fwd_cuda(q, k, v, att, 0.0,
                                                      *args), 20)
            fwd_plain = time_ms(lambda: da.dedup_dot_reference(
                q, k, v, lay, dsh, dvh, 0.0, rate, seed), 3)
            bwd_ms = time_ms(lambda: da._dot_bwd_cuda(*bwd, att, 0.0,
                                                      *args), 20)
            bwd_plain = time_ms(lambda: da.dedup_dot_bwd_reference(
                *bwd, lay, dsh, dvh, 0.0, rate, seed), 3)
        del out, lse, delta, bwd
        # bytes: each input read once (the node tables; 3 ints a cell and 4
        # a piece in row order; K8 also 2 ints a cell, the slot pointers,
        # pairs and uv in column order), each output written once (out and
        # lse; dq and the slot rows)
        row_ints = 3 * n + 4 * n_pieces
        fwd_bytes = 4 * (N * (2 * DS + C) + row_ints + N * (C + H))
        bwd_bytes = 4 * (N * (2 * DS + 2 * C + 2 * H) + row_ints + 2 * n
                         + S + 1 + 4 * lay.num_pairs + lay.uv.numel()
                         + N * DS + S * (DS + C))
        # operations a cell: the score (2 a score column), 2 a value
        # column (K7's fma; K8's g.v in both passes, dv), 2 a score column
        # for dq and dk; a head: max, 2 exp, 2 scale, count multiply, the
        # hash (8 integer ops), K8's clamp and two multiply-adds a pass
        per_head = 6 + 8 * drop
        fwd_ops = n * (2 * DS + 2 * C + H * per_head)
        bwd_ops = n * (8 * DS + 6 * C + 2 * H * (per_head + 3))
        # gathered a cell: k|v rows (K7, K8's row pass), q|g rows, lse and
        # delta (K8's slot pass); K8 also writes its slot rows
        fwd_gather = 4 * n * (DS + C)
        bwd_gather = 4 * (n * (2 * DS + 2 * C + 2 * H) + S * (DS + C))
        suffix = f"_drop{rate:g}" if drop else ""
        for kernel, ms, plain_ms, nbytes, ops, gathered in (
                ("dedup_dot_fwd", fwd_ms, fwd_plain, fwd_bytes, fwd_ops,
                 fwd_gather),
                ("dedup_dot_bwd", bwd_ms, bwd_plain, bwd_bytes, bwd_ops,
                 bwd_gather)):
            timing_row(rows, info, f"{kernel}_h{H}_s{dsh}_d{dvh}{suffix}",
                       kernel, DATTN_SOURCE, DDOT_REPLACES[kernel],
                       launches.get((kernel, *shape), 0),
                       errs["headline", kernel], ms, plain_ms, nbytes, ops,
                       None, gathered, rate=rate)
    for d in sorted({DS, C}):
        time_uniq_reduce(rows, info, att.red, d,
                         runs[0.0].get(("uniq_reduce", d), 0), dev, gen, 20)
    reset_all_launches()
    return rows


def phase_unimp_dedup(dev, edge_route_ms):
    """The UniMP dedup path (count-matrix attention in dot mode) on the
    bench GAT graph under ``DEDUP``: kernel checks, keep bits, the small
    model, UniMP at full width trained 20 steps without dropout and 20
    with dropout in cell mode, a profile of the step and the kernels'
    times. ``edge_route_ms`` is the per-edge route's attention device time
    per UniMP step on the same graph (rate 0) from ``phase_unimp``.
    Returns (rows, the step line's entries)."""
    import torch

    host = gat_host()
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with dispatch_settings(DEDUP=True):
        g = host.tensor()
    torch.cuda.synchronize()
    t_tensor = time.perf_counter() - t0
    if g._dedup_layouts is None or g._dedup_attn is not None:
        raise AssertionError("tensor() under DEDUP: no dedup layouts, or "
                             "work lists built early")
    t0 = time.perf_counter()
    att = g._dedup_attn_aux()
    torch.cuda.synchronize()
    t_att = time.perf_counter() - t0
    print(f"[graph] UniMP dedup: bench GAT graph N={g.num_nodes} "
          f"E={g.num_edges} under DEDUP, tensor() {t_tensor:.3f} s (K4 "
          f"included), K7/K8 work lists and red {t_att:.3f} s; "
          f"{att.num_cells} cells, {att.pieces.shape[0]} pieces, "
          f"{att.split_rows.shape[0]} split rows, {att.num_slots} slots",
          flush=True)
    errs = phase_dedup_dot_kernels(g, dev)
    phase_dedup_attention_mask(dev, dot=True)
    phase_unimp_small(dev, dedup=True)
    labels = np.random.default_rng(2).integers(0, 40, g.num_nodes)
    per = unimp_dedup_per_step(g)
    train, by0 = phase_train(
        g, "UniMP dedup", per,
        lambda g: unimp_trainer(g, labels, training=False), 40)
    train_c, by3 = phase_train(
        g, "UniMP dedup cell", per,
        lambda g: unimp_trainer(g, labels, mode="cell"), 40)
    if g._attn_layouts is not None:
        raise AssertionError("the dedup route built per-edge work lists")
    prof = phase_gat_profile(g, "UniMP dedup",
                             lambda g: unimp_trainer(g, labels, mode="cell"))
    rows = phase_dedup_dot_timing(g, dev, {0.0: by0, 0.3: by3}, errs)
    folds_ms = sum(r["ms"] * per["uniq_reduce", r["shape"]["D"]]
                   for r in rows if r["shape"]["kernel"] == "uniq_reduce")
    attn = {rate: folds_ms + 2 * sum(r["ms"] for r in rows
                                     if r["shape"].get("rate") == rate)
            for rate in (0.0, 0.3)}
    gather = 2 * sum(r["gather_bound_ms"] for r in rows
                     if r["shape"].get("rate") == 0.0)
    lower = "dedup" if attn[0.0] < edge_route_ms else "per-edge"
    print(f"[default] attention device ms per UniMP step on the bench GAT "
          f"graph: dedup route (K7, K8 dot, 4 folds) {attn[0.0]:.5f} (no "
          f"dropout), {attn[0.3]:.5f} (rate 0.3, cell mode); per-edge route "
          f"(K9, K10 dot) {edge_route_ms:.5f}; lower: {lower}; gather bound "
          f"of the dedup route {gather:.5f} ms; step median "
          f"{train['step_ms']:.4f} ms (no dropout), {train_c['step_ms']:.4f} "
          f"ms (cell dropout)", flush=True)
    return rows, {
        "UniMP_dedup": dict(train, attention_ms_per_step=attn[0.0],
                            gather_bound_ms_per_step=gather,
                            tensor_s=t_tensor, work_lists_s=t_att,
                            profile=prof),
        "UniMP_dedup_cell": dict(train_c, attention_ms_per_step=attn[0.3]),
        "unimp_attention_route_lower": lower}


# -- phase 9: edge-weighted message passing (K1w, the weighted K6) --------

# K1w's shapes on the main path: (op, H) at the widths FAGCN (D = 64,
# scalar weights) and GATv2 (D = 64 with 8 heads, D = 16 with one) run
K1W_CASES = [(op, H, D) for op in ("mul", "add") for H in (1, 8)
             for D in (16, 64, 128)]


def weighted_terms(x, w, lay, op):
    """K1w's plain version in float64 over ``lay`` and the 2-norm of each
    output's terms (``check``'s scale)."""
    import torch
    E, H, D = lay.num_edges, w.shape[1], x.shape[1]
    m = x.double().index_select(0, lay.indices).reshape(E, H, D // H)
    we = w.double().index_select(0, lay.edge_id).unsqueeze(-1)
    m = (m * we if op == "mul" else m + we).reshape(E, D)
    z = torch.zeros(lay.num_rows, D, dtype=torch.float64, device=x.device)
    return (z.index_add(0, lay.seg_ids, m),
            z.index_add(0, lay.seg_ids, m * m).sqrt())


def check_weighted(tag, x, w, g, csc, csr, op, out, dx, dw):
    """K1w's forward, dx and dw (float32, any of them None when not run)
    against their float64 plain versions at ``check``'s tolerance with the
    terms scale; returns the max |err| of each."""
    import torch
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    H = w.shape[1]
    errs = {}
    with torch.no_grad():
        if out is not None:
            want, scale = weighted_terms(x, w, csc, op)
            errs["fwd"] = check(f"{tag} K1w fwd", out, want, scale)
        if dx is not None:
            if op == "mul":
                want, scale = weighted_terms(g, w, csr, op)
                errs["dx"] = check(f"{tag} K1w dx", dx, want, scale)
            else:
                errs["dx"] = check_spmm(f"{tag} K1w dx", dx, g, csr)
        if dw is not None:
            g64, x64 = g.double(), x.double()
            want = sk.weight_grad_reference(g64, x64, csr, H, op)
            scale = sk.weight_grad_reference(g64 * g64, x64 * x64, csr, H,
                                             op).sqrt()
            errs["dw"] = check(f"{tag} K1w dw", dw, want, scale)
    return errs


def run_weighted(x, w, g, csc, csr, op, need_dx=True, need_dw=True):
    """One K1w forward and backward on the card: (out, dx, dw)."""
    import torch
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    xr = x.detach().clone().requires_grad_(need_dx)
    wr = w.detach().clone().requires_grad_(need_dw)
    out = sk.spmm_weighted(xr, wr, csc, csr, op)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), xr.grad, wr.grad


def phase_weighted_kernels(g_head, g_dedup, dev):
    """K1w against float64 at every case of ``K1W_CASES`` on the skewed
    small graph and the headline graph, and with one gradient alone (dx,
    then dw); two runs give the same bits. Then the weighted K6 on the
    headline graph under ``DEDUP``: forward, dx and dw against float64,
    the same bits twice, and forward and dx within the tolerance of K1w on
    the same inputs (its dw is K1w's own pass)."""
    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk

    small = Graph(skewed_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    for tag, g in (("small", small), ("headline", g_head)):
        csc, csr = g._spmm_layouts
        for op, H, D in K1W_CASES:
            x = torch.randn(g.num_nodes, D, device=dev, generator=gen)
            w = torch.randn(g.num_edges, H, device=dev, generator=gen)
            cot = torch.randn(g.num_nodes, D, device=dev, generator=gen)
            first = run_weighted(x, w, cot, csc, csr, op)
            again = run_weighted(x, w, cot, csc, csr, op)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"{tag} K1w {op} H={H} D={D}: two "
                                     "runs differ")
            e = check_weighted(f"{tag} {op} H={H} D={D}", x, w, cot, csc,
                               csr, op, *first)
            print(f"[weighted] {tag} E={g.num_edges} {op} H={H} D={D}: max "
                  f"|err| fwd {e['fwd']:.3e} dx {e['dx']:.3e} dw "
                  f"{e['dw']:.3e}; same bits twice", flush=True)
        # one gradient alone: dx (weights without a gradient), dw (features
        # without one: the launch that writes dw only)
        x = torch.randn(g.num_nodes, 64, device=dev, generator=gen)
        w = torch.randn(g.num_edges, 1, device=dev, generator=gen)
        cot = torch.randn(g.num_nodes, 64, device=dev, generator=gen)
        _, dx, _ = run_weighted(x, w, cot, csc, csr, "mul", need_dw=False)
        _, _, dw = run_weighted(x, w, cot, csc, csr, "mul", need_dx=False)
        e = check_weighted(f"{tag} mul alone", x, w, cot, csc, csr, "mul",
                           None, dx, dw)
        print(f"[weighted] {tag} mul H=1 D=64, one gradient alone: max "
              f"|err| dx {e['dx']:.3e} dw {e['dw']:.3e}", flush=True)

    csc_d, csr_d = g_dedup._dedup_layouts
    csc, csr = g_dedup._spmm_layouts
    for D in (16, 64):
        x = torch.randn(g_dedup.num_nodes, D, device=dev, generator=gen)
        w = torch.randn(g_dedup.num_edges, device=dev, generator=gen)
        cot = torch.randn(g_dedup.num_nodes, D, device=dev, generator=gen)
        runs = []
        for _ in range(2):
            xr = x.clone().requires_grad_(True)
            wr = w.clone().requires_grad_(True)
            out = dk.spmm_dedup_weighted(xr, wr, csc_d, csr_d, csr)
            (out * cot).sum().backward()
            torch.cuda.synchronize()
            runs.append((out.detach(), xr.grad, wr.grad))
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"weighted K6 D={D}: two runs differ")
        out, dx, dw = runs[0]
        e = check_weighted(f"headline weighted K6 D={D}", x, w[:, None],
                           cot, csc, csr, "mul", out, dx, dw[:, None])
        k1w = run_weighted(x, w[:, None], cot, csc, csr, "mul")
        with torch.no_grad():
            _, scale = weighted_terms(x, w[:, None], csc, "mul")
            check(f"weighted K6 D={D} against K1w", out, k1w[0], scale)
            _, scale = weighted_terms(cot, w[:, None], csr, "mul")
            check(f"weighted K6 D={D} dx against K1w", dx, k1w[1], scale)
        print(f"[weighted] headline weighted K6 D={D}: max |err| fwd "
              f"{e['fwd']:.3e} dx {e['dx']:.3e} dw {e['dw']:.3e}; same bits "
              "twice; fwd and dx within tolerance of K1w (dw is K1w's own "
              "pass, held against float64 only)", flush=True)
    reset_all_launches()


@contextlib.contextmanager
def no_dropout():
    """The layers' dropout replaced by the identity (their routes keep
    reading the rates), so CUDA and CPU runs compare."""
    from pgl_tpu_torch.nn import conv
    real = conv._dropout
    conv._dropout = lambda x, rate, generator: x
    try:
        yield
    finally:
        conv._dropout = real


def phase_weighted_small(dev):
    """Small FAGCN (through K1w, and through the weighted K6 on a graph
    with dedup layouts), GATv2, and GATConv at 48 heads on its unfused path
    (attention dropout, replaced by the identity), CUDA against the CPU's
    plain versions with the same weights: output and parameter
    gradients."""
    import torch
    from pgl_tpu_torch.datasets import community_graph
    from pgl_tpu_torch.models import FAGCN, GATv2
    from pgl_tpu_torch.nn import GATConv
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

    g, labels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    cases = [
        ("FAGCN", False, False, ("mul", "csc", 16, 1),
         lambda d: FAGCN(16, 3, hidden_size=16, device=d, generator=torch.
                         Generator().manual_seed(0))),
        ("FAGCN dedup", True, False, ("dedup_weighted", "csc", 16),
         lambda d: FAGCN(16, 3, hidden_size=16, device=d, generator=torch.
                         Generator().manual_seed(0))),
        ("GATv2", False, False, ("mul", "csc", 64, 8),
         lambda d: GATv2(16, 3, device=d, generator=torch.
                         Generator().manual_seed(0))),
        ("GATConv 48 heads unfused", False, True, ("mul", "csc", 96, 48),
         lambda d: GATConv(16, 2, feat_drop=0.0, attn_drop=0.5,
                           num_heads=48, device=d, generator=torch.
                           Generator().manual_seed(0)))]
    for name, dedup, training, key, make in cases:
        results = {}
        reset_all_launches()
        for d in ("cpu", dev):
            with dispatch_settings(DEDUP=dedup, DEDUP_MIN_EDGES=0):
                gt = g.tensor(d)
            model = make(d)
            with no_dropout():
                out = model(gt, gt.node_feat["h"], training)
            y = torch.as_tensor(labels, device=d)
            (ce(out, y).mean() if out.shape[1] == 3
             else out.square().mean()).backward()
            results[str(d)] = (out.detach().cpu(),
                               {k: p.grad.cpu()
                                for k, p in model.named_parameters()})
        if not all_launches().get(key):
            raise AssertionError(f"small {name} did not launch {key}")
        reset_all_launches()
        (o_cpu, g_cpu), (o_gpu, g_gpu) = results["cpu"], results[str(dev)]
        err = check(f"small {name} output", o_gpu, o_cpu)
        for k in g_cpu:
            err = max(err, check(f"small {name} grad {k}", g_gpu[k],
                                 g_cpu[k]))
        print(f"[model] small {name}, CUDA vs CPU: max |err| {err:.3e}",
              flush=True)


def fagcn_trainer(g, dropout=0.6):
    """FAGCN at the reference's widths (``FAGCN(128, 16, hidden_size=64,
    num_layer=3, eps=0.2, dropout)``) on ``g``'s device, weights from seed
    0, the headline's labels (seed 0), training; and a function that takes
    one Adam step (lr 1e-3, as the headline) and returns its loss."""
    import torch
    from pgl_tpu_torch.models import FAGCN
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

    x = g.node_feat["h"]
    y = torch.as_tensor(np.random.default_rng(0).integers(
        0, 16, g.num_nodes).astype(np.int64), device=x.device)
    model = FAGCN(128, 16, hidden_size=64, num_layer=3, eps=0.2,
                  dropout=dropout, generator=torch.Generator().manual_seed(0),
                  device=x.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = ce(model(g, x, True), y).mean()
        loss.backward()
        opt.step()
        return loss.detach()

    return model, step


def gatv2_trainer(g):
    """GATv2 at the reference's defaults (``GATv2(128, 16, num_heads=8,
    hidden_size=8, feat_drop=0.6, attn_drop=0.6)``) on ``g``'s device,
    weights from seed 0, labels from seed 1 (as the bench GAT), training,
    and a function that takes one Adam step (lr 1e-3) and returns its
    loss."""
    import torch
    from pgl_tpu_torch.models import GATv2
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

    x = g.node_feat["h"]
    y = torch.as_tensor(np.random.default_rng(1).integers(
        0, 16, g.num_nodes).astype(np.int64), device=x.device)
    model = GATv2(128, 16, num_heads=8, hidden_size=8, feat_drop=0.6,
                  attn_drop=0.6, generator=torch.Generator().manual_seed(0),
                  device=x.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = ce(model(g, x, True), y).mean()
        loss.backward()
        opt.step()
        return loss.detach()

    return model, step


# launches a step, from the code: FAGCN's three FAConv layers each run one
# weighted SpMM forward over CSC and one backward over CSR (every layer's
# input and weights carry a gradient), at D = 64 with one weight an edge;
# under DEDUP the weighted K6 both ways and K1w's dw pass. GATv2's two
# layers: 8 heads of 8 and one of 16.
FAGCN_PER_STEP = {("mul", "csc", 64, 1): 3, ("mul", "csr", 64, 1): 3}
FAGCN_DEDUP_PER_STEP = {("dedup_weighted", "csc", 64): 3,
                        ("dedup_weighted", "csr", 64): 3,
                        ("mul_dw", "csr", 64, 1): 3}
GATV2_PER_STEP = {("mul", "csc", 64, 8): 1, ("mul", "csc", 16, 1): 1,
                  ("mul", "csr", 64, 8): 1, ("mul", "csr", 16, 1): 1}
K1W_REPLACES = "pgl_tpu/ops/pallas/segment_kernels.py:161"
K6W_REPLACES = DEDUP_REPLACES["dedup"]


def batched_csr(lay, values, N):
    """``values.shape[0]`` CSR matrices [N, N] of ``lay``'s pattern, matrix
    h holding ``values[h]`` (in the layout's order)."""
    import torch
    H = values.shape[0]
    return torch.sparse_csr_tensor(
        lay.indptr.expand(H, -1).contiguous(),
        lay.indices.expand(H, -1).contiguous(), values, size=(H, N, N))


def k1w_library(lay, N, w, feat):
    """One PyTorch call that computes K1w's mul over ``lay`` on ``feat``
    [N, D] with ``w`` [E, H]: ``torch.sparse.mm`` on a CSR matrix of the
    weights (H = 1), else ``torch.bmm`` on H COO matrices batched over
    ``feat``'s heads (an [H, N, Dh] view; the output [H, N, Dh]). Batched
    CSR is not implemented for ``bmm`` on CUDA
    (``experiments/torch_spmm/library_calls.py``). Returns (a function of
    no arguments, the call's name)."""
    import torch
    N_, D = feat.shape
    H = w.shape[1]
    wl = w.index_select(0, lay.edge_id)
    if H == 1:
        A = torch.sparse_csr_tensor(lay.indptr, lay.indices, wl[:, 0],
                                    size=(N, N))
        return (lambda: torch.sparse.mm(A, feat)), "torch.sparse.mm"
    A = batched_csr(lay, wl.T.contiguous(), N).to_sparse_coo()
    fv = feat.view(N_, H, D // H).transpose(0, 1)
    return (lambda: torch.bmm(A, fv)), "torch.bmm (batched COO)"


def dw_library(lay, N, H, g, x):
    """One PyTorch call that computes K1w's mul dw over the CSR layout
    ``lay`` (rows the sources): ``torch.sparse.sampled_addmm`` on a CSR
    matrix of ``lay``'s pattern, ``x`` at the rows and ``g.T`` at the
    columns (``beta=0``), batched over the heads for H > 1; dw in the
    layout's order. A function of no arguments."""
    import torch
    E, D = lay.num_edges, x.shape[1]
    if H == 1:
        P = torch.sparse_csr_tensor(lay.indptr, lay.indices,
                                    x.new_zeros(E), size=(N, N))
        return lambda: torch.sparse.sampled_addmm(P, x, g.T, beta=0)
    P = batched_csr(lay, x.new_zeros(H, E), N)
    xv = x.view(-1, H, D // H).transpose(0, 1)
    gv = g.view(-1, H, D // H).permute(1, 2, 0)
    return lambda: torch.sparse.sampled_addmm(P, xv, gv, beta=0)


def weighted_timing(rows, g, dev, gen, op, H, D, launches, name, graph):
    """K1w's forward (CSC) and backward (CSR: dx and dw in one launch) at
    (op, H, D) on ``g``, and K1 at D over the same layouts: CUDA events
    beside the plain versions, the library (mul: ``k1w_library``, and on
    the backward ``dw_library`` after it; K1: ``torch.sparse.mm`` on a CSR
    matrix of ones), the byte bound (each input read once, each output
    written once) and the gather bound (each edge's gathered row read once
    instead of the table)."""
    import torch
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    csc, csr = g._spmm_layouts
    N, E = g.num_nodes, g.num_edges
    x = torch.randn(N, D, device=dev, generator=gen)
    w = torch.randn(E, H, device=dev, generator=gen)
    cot = torch.randn(N, D, device=dev, generator=gen)
    mul = op == "mul"
    wop = 1 if mul else 2
    info = {"graph": graph, "rows": N, "edges": E, "op": op, "H": H, "D": D}
    table = 4 * N * D
    for kind, lay, bwd in (("csc", csc, False), ("csr", csr, True)):
        out = torch.empty(N, D, device=dev)
        part = torch.empty(lay.num_partials, D, device=dev)
        dw = torch.empty(E, H, device=dev) if bwd else None
        if bwd:
            args = (cot, w, lay, out, part, 1 if mul else 0, wop,
                    x if mul else None, dw)
            plain = lambda: ((sk.spmm_weighted_reference(cot, w, lay, "mul")
                              if mul else sk.spmm_reference(cot, lay)),
                             sk.weight_grad_reference(cot, x, lay, H, op))
        else:
            args = (x, w, lay, out, part, wop)
            plain = lambda: sk.spmm_weighted_reference(x, w, lay, op)
        ms = time_ms(lambda: sk._launch_weighted(*args), 50)
        plain_ms = time_ms(plain, 5)
        lib_ms = lib_name = None
        if mul:
            lib, lib_name = k1w_library(lay, N, w, cot if bwd else x)
            if bwd:
                dw_lib = dw_library(lay, N, H, cot, x)
                lib_ms = time_ms(lambda: (lib(), dw_lib()), 50)
                lib_name += " + torch.sparse.sampled_addmm"
            else:
                lib_ms = time_ms(lib, 50)
        with torch.no_grad():
            e = check_weighted(f"timed {name} {kind}", x, w, cot, csc, csr,
                               op, None if bwd else out,
                               out if bwd else None, dw)
        # bytes: the gathered table (and on the backward of mul the row
        # table x), indices, edge ids and pieces, the weights (not read by
        # add's backward), out (and dw) written once
        struct = 8 * E + 16 * lay.pieces.shape[0]
        reads = table * (2 if bwd and mul else 1) + struct + (
            4 * E * H if mul or not bwd else 0)
        nbytes = reads + table + (4 * E * H if bwd else 0)
        kernel = "k1w_bwd" if bwd else "k1w_fwd"
        timing_row(rows, info, f"{name}_{kernel}_{kind}", kernel, SOURCE,
                   K1W_REPLACES, launches.get((op, kind, D, H), 0),
                   max(e.values()), ms, plain_ms, nbytes,
                   2 * E * D * (2 if bwd else 1), lib_ms,
                   nbytes - table + 4 * E * D, lib_name, layout=kind)
        # K1 at the same width over the same layout: what the weights cost
        k1_ms = time_ms(lambda: sk._launch(x, lay, out, part), 50)
        k1_plain = time_ms(lambda: sk.spmm_reference(x, lay), 5)
        A1 = torch.sparse_csr_tensor(lay.indptr, lay.indices,
                                     torch.ones(E, device=dev), size=(N, N))
        k1_lib = time_ms(lambda: torch.sparse.mm(A1, x), 50)
        with torch.no_grad():
            k1_err = check_spmm(f"timed K1 {kind} D={D}", out, x, lay)
        k1_bytes = 2 * table + 4 * E + 16 * lay.pieces.shape[0]
        timing_row(rows, dict(info, op=None, H=None), f"{name}_k1_{kind}",
                   "spmm", SOURCE, REPLACES, launches.get((kind, D), 0),
                   k1_err, k1_ms, k1_plain, k1_bytes, E * D, k1_lib,
                   k1_bytes - table + 4 * E * D, layout=kind)


def phase_weighted_timing(g_head, g_dedup, g_gat, dev, runs):
    """Rows at the main path's shapes: K1w at FAGCN's (mul, H=1, D=64) on
    the headline graph and GATv2's (mul, 8, 64) and (mul, 1, 16) on the
    bench GAT graph, each beside K1 at its width; the weighted K6 forward
    and dx and K1w's dw pass at D = 64 on the headline graph under
    ``DEDUP``. ``runs`` maps a run to its launches."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    weighted_timing(rows, g_head, dev, gen, "mul", 1, 64, runs["fagcn"],
                    "fagcn", "headline")
    for H, D in ((8, 64), (1, 16)):
        weighted_timing(rows, g_gat, dev, gen, "mul", H, D, runs["gatv2"],
                        f"gatv2_h{H}", "gat_graph")

    N, E, D = g_dedup.num_nodes, g_dedup.num_edges, 64
    x = torch.randn(N, D, device=dev, generator=gen)
    w = torch.randn(E, device=dev, generator=gen)
    cot = torch.randn(N, D, device=dev, generator=gen)
    launches = runs["fagcn_dedup"]
    for lay, k1, src in zip(g_dedup._dedup_layouts, g_dedup._spmm_layouts,
                            (x, cot)):
        cell = torch.ones(E, dtype=torch.bool, device=dev)
        cell[1:] = (lay.dst[1:] != lay.dst[:-1]) | (lay.urow[1:]
                                                   != lay.urow[:-1])
        cells = int(cell.sum())
        out = torch.empty(lay.n_pad, D, device=dev)
        part = torch.empty(lay.num_partials * dk.NB, D, device=dev)
        ms = time_ms(lambda: dk._launch_apply(src, lay, None, out, part, w),
                     20)
        plain_ms = time_ms(lambda: dk.apply_weighted_reference(src, w, lay),
                           5)
        A = torch.sparse_csr_tensor(k1.indptr, k1.indices,
                                    w.index_select(0, k1.edge_id),
                                    size=(N, N))
        lib_ms = time_ms(lambda: torch.sparse.mm(A, src), 20)
        with torch.no_grad():
            want, scale = weighted_terms(src, w[:, None], k1, "mul")
            err = check(f"timed weighted K6 {lay.kind}", out[:N], want,
                        scale)
        # bytes: x once, uv, pairs and groups, dst, urow and edge ids, the
        # weights, out written; operations: 2 a nonzero cell and column,
        # one add an edge for the weight sums
        nbytes = (4 * (2 * N * D + lay.uv.numel() + 4 * E)
                  + 16 * (lay.num_pairs + lay.groups.shape[0]))
        info = {"graph": "headline", "rows": N, "edges": E, "D": D,
                "pairs": lay.num_pairs, "groups": int(lay.groups.shape[0]),
                "cells": cells}
        timing_row(rows, info, f"fagcn_dedup_weighted_{lay.kind}",
                   "dedup_weighted", DEDUP_SOURCE, K6W_REPLACES,
                   launches.get(("dedup_weighted", lay.kind, D), 0), err,
                   ms, plain_ms, nbytes, 2 * cells * D + E, lib_ms,
                   nbytes - 4 * N * D + 4 * cells * D, layout=lay.kind)
    # the dedup route's dw: K1w's pass over the K1 CSR layout, dw alone
    csr = g_dedup._spmm_layouts[1]
    dw = torch.empty(E, 1, device=dev)
    w1 = w[:, None]
    ms = time_ms(lambda: sk._launch_weighted(cot, w1, csr, None, None, 0, 1,
                                             x, dw), 50)
    plain_ms = time_ms(lambda: sk.weight_grad_reference(cot, x, csr, 1), 5)
    with torch.no_grad():
        err = check_weighted("timed dw pass", x, w1, cot, None, csr, "mul",
                             None, None, dw)["dw"]
    lib_ms = time_ms(dw_library(csr, N, 1, cot, x), 50)
    # bytes: the two tables, indices, edge ids and dw written (no weights:
    # the launch without dx does not read them), the pieces
    nbytes = 2 * 4 * N * D + 12 * E + 16 * csr.pieces.shape[0]
    timing_row(rows, {"graph": "headline", "rows": N, "edges": E, "D": D,
                      "op": "mul", "H": 1},
               "fagcn_dedup_k1w_dw_csr", "k1w_dw", SOURCE, K1W_REPLACES,
               launches.get(("mul_dw", "csr", D, 1), 0), err, ms, plain_ms,
               nbytes, 2 * E * D, lib_ms, nbytes - 4 * N * D + 4 * E * D,
               "torch.sparse.sampled_addmm", layout="csr")
    reset_all_launches()
    return rows


def phase_weighted(dev, host):
    """The edge-weighted path: kernel checks, the small models, FAGCN on
    the headline graph three ways, GATv2 on the bench GAT graph, their
    profiles and the kernels' times. Returns (rows, the step line's
    entries)."""
    import torch

    g = headline_graph(False, host)
    reset_all_launches()
    g_dedup = headline_graph(True, host)
    if g_dedup._dedup_layouts is None or g_dedup._dedup_layouts[0].edge_id \
            is None:
        raise AssertionError("headline under DEDUP: no dedup layouts with "
                             "edge ids")
    phase_weighted_kernels(g, g_dedup, dev)
    phase_weighted_small(dev)
    train, by6 = phase_train(g, "FAGCN", FAGCN_PER_STEP, fagcn_trainer)
    train0, _ = phase_train(g, "FAGCN no dropout", FAGCN_PER_STEP,
                            lambda g: fagcn_trainer(g, 0.0))
    train_d, by_d = phase_train(g_dedup, "FAGCN dedup", FAGCN_DEDUP_PER_STEP,
                                fagcn_trainer)
    prof = phase_gat_profile(g, "FAGCN", fagcn_trainer)
    prof_d = phase_gat_profile(g_dedup, "FAGCN dedup", fagcn_trainer)
    g_gat = gat_host().tensor()
    train_v2, by_v2 = phase_train(g_gat, "GATv2", GATV2_PER_STEP,
                                  gatv2_trainer)
    prof_v2 = phase_gat_profile(g_gat, "GATv2", gatv2_trainer)
    rows = phase_weighted_timing(
        g, g_dedup, g_gat, dev,
        {"fagcn": by6, "fagcn_dedup": by_d, "gatv2": by_v2})

    def per_step(run, per):
        return sum(r["ms"] * per.get((r["shape"]["op"], r["shape"]["layout"],
                                      r["shape"]["D"], r["shape"]["H"]), 0)
                   for r in rows if r["shape"].get("graph") == run
                   and r["shape"]["kernel"] in ("k1w_fwd", "k1w_bwd"))

    k1w_fagcn = per_step("headline", FAGCN_PER_STEP)
    k1w_gatv2 = per_step("gat_graph", GATV2_PER_STEP)
    dedup_ms = sum(r["ms"] * 3 for r in rows if r["shape"]["kernel"] in (
        "dedup_weighted", "k1w_dw"))
    print(f"[default] weighted SpMM device ms a step: FAGCN K1w "
          f"{k1w_fagcn:.5f}, FAGCN dedup (weighted K6, dw pass) "
          f"{dedup_ms:.5f}; lower: "
          f"{'dedup' if dedup_ms < k1w_fagcn else 'K1w'}; GATv2 K1w "
          f"{k1w_gatv2:.5f}", flush=True)
    return rows, {
        "FAGCN": dict(train, weighted_spmm_ms_per_step=k1w_fagcn,
                      profile=prof),
        "FAGCN_no_dropout": train0,
        "FAGCN_dedup": dict(train_d, weighted_spmm_ms_per_step=dedup_ms,
                            profile=prof_d),
        "GATv2": dict(train_v2, weighted_spmm_ms_per_step=k1w_gatv2,
                      profile=prof_v2)}


# -- phase 10: the dedup SDDMM (K11) through Graph.sddmm_csc -----------------

SDDMM_SOURCE = "pgl_tpu_torch/ops/kernels/csrc/sddmm_kernels.cu"
SDDMM_REPLACES = "pgl_tpu/ops/pallas/sddmm_kernels.py:237"
SDDMM_OPS = ("add", "sub", "mul", "div")


def sddmm_inputs(n, D, dev, gen, zeros=False):
    """``src`` and ``dst`` [n, D] float32 on the card, ``|dst| >= 1``; with
    ``zeros``, every third ``dst`` row and every second ``src`` row exactly
    0, so ``div`` meets x/0 and 0/0."""
    import torch
    x = torch.randn(n, D, device=dev, generator=gen)
    y = torch.randn(n, D, device=dev, generator=gen)
    y = torch.where(y >= 0, y + 1, y - 1)
    if zeros:
        y[::3] = 0.0
        x[::2] = 0.0
    return x, y


def same_bits(a, b):
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_sddmm(tag, lay, x, y, op):
    """K11 against its plain version bit for bit (inf and nan included),
    pads exactly +0, the same bits on a second run. Returns the output."""
    import torch
    from pgl_tpu_torch.ops.kernels import sddmm_kernels as sdk
    out = sdk.sddmm_dedup(x, y, lay, op)
    again = sdk.sddmm_dedup(x, y, lay, op)
    want = sdk.sddmm_reference(x, y, lay, op)
    torch.cuda.synchronize()
    if not same_bits(out, want):
        bad = int((out.view(torch.int32) != want.view(torch.int32)).any(1)
                  .sum())
        raise AssertionError(f"{tag} {op}: K11 differs from its plain "
                             f"version in {bad} slots")
    if not same_bits(out, again):
        raise AssertionError(f"{tag} {op}: two runs differ")
    if bool((out[lay.eid < 0].view(torch.int32) != 0).any()):
        raise AssertionError(f"{tag} {op}: a pad is not +0")
    return out


def sddmm_grads64(op, x, y, g, lay):
    """d/dsrc and d/ddst of ``sum(out * g)`` in float64 (the plain math of
    the reference's ``_sddmm_bwd``), each with the 2-norm of the terms an
    element sums (``check``'s scale)."""
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    x, y, g = x.double(), y.double(), g.double()
    xs = x.index_select(0, lay.slot_src)
    xd = y.index_select(0, lay.slot_dst.clamp(max=lay.num_segments - 1))
    gs, gd = {"add": (g, g), "sub": (g, -g), "mul": (g * xd, g * xs),
              "div": (g / xd, -g * xs / (xd * xd))}[op]
    return [(sk.spmm_reference(t, k1), sk.spmm_reference(t * t, k1).sqrt())
            for t, k1 in ((gs, lay.by_src), (gd, lay.by_dst))]


def run_sddmm_grad(x, y, lay, op, g):
    """(dsrc, ddst) of ``sum(sddmm_dedup(x, y) * g)`` on the card and the
    launches the forward and backward took."""
    import torch
    from pgl_tpu_torch.ops.kernels import sddmm_kernels as sdk
    xr = x.detach().clone().requires_grad_()
    yr = y.detach().clone().requires_grad_()
    reset_all_launches()
    sdk.sddmm_dedup(xr, yr, lay, op).backward(g)
    torch.cuda.synchronize()
    return xr.grad, yr.grad, {k: v for k, v in all_launches().items() if v}


def check_sddmm_grad(tag, x, y, lay, op, gen):
    """The backward of K11 (K1 over ``by_src`` and ``by_dst``) against
    float64 at ``check``'s tolerance with the terms scale, the same bits on
    two runs, and one K11 and two K1 launches. Returns the max |err|."""
    import torch
    D = x.shape[1]
    g = torch.randn(lay.slots, D, device=x.device, generator=gen)
    ds, dd, launches = run_sddmm_grad(x, y, lay, op, g)
    ds2, dd2, _ = run_sddmm_grad(x, y, lay, op, g)
    want = {("sddmm", op, D): 1, ("sddmm_src", D): 1, ("sddmm_dst", D): 1}
    if launches != want:
        raise AssertionError(f"{tag} {op} D={D}: launches {launches}, "
                             f"expected {want}")
    if not (same_bits(ds, ds2) and same_bits(dd, dd2)):
        raise AssertionError(f"{tag} {op} D={D}: two backward runs differ")
    (ws, ss), (wd, sd) = sddmm_grads64(op, x, y, g, lay)
    reset_all_launches()
    return max(check(f"{tag} {op} D={D} dsrc", ds, ws, ss),
               check(f"{tag} {op} D={D} ddst", dd, wd, sd))


def median_ms(fn, iters):
    """Median device time of ``fn`` over ``iters`` warm calls, each between
    two CUDA events."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def loaded_headline(host):
    """The headline graph dumped (with both indexes) to a temporary
    directory, loaded back memory-mapped with ``Graph.load``, its indexes
    held against a direct build, and put on the card (K1 layouts)."""
    import tempfile
    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.utils.edge_index import EdgeIndex

    host.adj_dst_index, host.adj_src_index
    N, edges = host.num_nodes, np.asarray(host.edges)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        host.dump(d)
        t_dump = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = Graph.load(d, mmap_mode="r")
        if not isinstance(loaded.node_feat["h"], np.memmap):
            raise AssertionError("Graph.load did not memory-map")
        for name, (u, v) in (("adj_dst_index", (edges[:, 1], edges[:, 0])),
                             ("adj_src_index", (edges[:, 0], edges[:, 1]))):
            want = EdgeIndex.from_edges(u, v, N)
            got = getattr(loaded, name)
            for f in ("degree", "sorted_u", "sorted_v", "sorted_eid",
                      "indptr"):
                if not np.array_equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"loaded {name}.{f} differs from "
                                         "a direct build")
        with dispatch_settings(DEDUP=False):
            g = loaded.tensor()
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    print(f"[sddmm] headline dumped in {t_dump:.3f} s, loaded memory-mapped, "
          f"indexes equal to a direct build, on the card in {t_load:.3f} s",
          flush=True)
    return g


def phase_sddmm_kernels(g_head, lay_head, dev):
    """K11 against its plain version bit for bit for the four ops at D in
    (1, 16, 128) on the skewed small graph and the headline (div with
    ``|dst| >= 1``, and once with exact zeros), real slots against
    ``send_uv`` through ``eid``, and the backward against float64."""
    import torch
    from pgl_tpu_torch import Graph

    gen = torch.Generator(device=dev).manual_seed(17)
    g_sk = Graph(skewed_graph(3000, 40000, seed=6), num_nodes=3000).tensor()
    lay_sk = g_sk.sddmm_layout()
    graphs = (("skewed", g_sk, lay_sk), ("headline", g_head, lay_head))
    for tag, g, lay in graphs:
        for D in (1, 16, 128):
            x, y = sddmm_inputs(g.num_nodes, D, dev, gen)
            for op in SDDMM_OPS:
                out = check_sddmm(tag, lay, x, y, op)
                if D == 16:
                    # each real slot is send_uv's row for its edge
                    real = lay.eid >= 0
                    edge = g.adj_dst_index.sorted_eid.index_select(
                        0, lay.eid[real])
                    uv = g.send_uv(x, y, op).index_select(0, edge)
                    if not same_bits(out[real], uv):
                        raise AssertionError(f"{tag} {op}: slots differ "
                                             "from send_uv through eid")
                del out
        x, y = sddmm_inputs(g.num_nodes, 16, dev, gen, zeros=True)
        out = check_sddmm(f"{tag} zeros", lay, x, y, "div")
        real = out[lay.eid >= 0]
        if not (bool(torch.isinf(real).any()) and bool(
                torch.isnan(real).any())):
            raise AssertionError(f"{tag}: no inf or nan from x/0 and 0/0")
        print(f"[sddmm] {tag} S={lay.slots} E={lay.num_edges}: K11 equals "
              "its plain version bit for bit (4 ops, D 1/16/128, div with "
              "zeros), pads +0, two runs equal, slots equal send_uv",
              flush=True)
        del out, real
    errs = {}
    for tag, g, lay in graphs:
        for D in ((1, 16, 128) if tag == "skewed" else (16, 128)):
            x, y = sddmm_inputs(g.num_nodes, D, dev, gen)
            for op in SDDMM_OPS if tag == "skewed" or D == 16 else ("mul",):
                errs[(tag, op, D)] = check_sddmm_grad(tag, x, y, lay, op,
                                                      gen)
        torch.cuda.empty_cache()
    print(f"[sddmm] backward (K1 over by_src, by_dst) against float64: max "
          f"|err| {max(errs.values()):.3e}; same bits twice; 1 K11 and 2 K1 "
          "launches each", flush=True)
    del g_sk, lay_sk
    return max(errs.values())


def sddmm_step(g, x, through):
    """One step of the bench row's loss ``(g.sddmm_csc(x, x, "mul") **
    2).sum()`` and its backward, or the same loss through ``send_uv``."""
    def step():
        out = (g.sddmm_csc(x, x, "mul") if through == "sddmm"
               else g.send_uv(x, x, "mul"))
        loss = (out ** 2).sum()
        loss.backward()
        x.grad = None
        return loss.detach()
    return step


def time_steps(step, tag):
    """3 warm-up and 20 timed steps (host clock, each ended by a
    synchronize); the median ms, the losses and the launches of the timed
    steps (the counts set to 0 after the warm-up)."""
    import torch
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    reset_all_launches()
    times, losses = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses not finite: {losses}")
    launches = {k: v for k, v in all_launches().items() if v}
    return float(np.median(times)) * 1e3, losses, launches


def phase_sddmm_timing(g, lay, dev, launches):
    """Rows at the bench row's shape (the headline, D = 128): K11 for each
    op beside its plain version, the byte bound, the gather bound and
    ``send_uv`` (no single library call computes it), and K1 over
    ``by_src`` and ``by_dst`` beside its plain version and
    ``torch.sparse.mm``."""
    import torch
    from pgl_tpu_torch.ops.kernels import sddmm_kernels as sdk
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(19)
    N, E, S, D = g.num_nodes, lay.num_edges, lay.slots, 128
    x, y = sddmm_inputs(N, D, dev, gen)
    out = torch.empty(S, D, device=dev)
    rows = []
    real = lay.eid >= 0
    n_src = int(torch.unique(lay.slot_src[real]).numel())
    n_dst = int(torch.unique(lay.slot_dst[real]).numel())
    info = {"graph": "headline", "rows": N, "edges": E, "slots": S, "D": D,
            "source_rows": n_src, "dst_rows": n_dst}
    # bytes: each distinct source and destination row the real slots
    # gather, once; the two int32 slot tables; the output written once.
    # gather: two rows an edge
    nbytes = (n_src + n_dst + S) * D * 4 + 2 * S * 4
    gather = 2 * E * D * 4 + S * D * 4 + 2 * S * 4
    for op in SDDMM_OPS:
        ms = median_ms(lambda: sdk._launch(x, y, lay, op, out), 20)
        plain_ms = median_ms(lambda: sdk.sddmm_reference(x, y, lay, op), 5)
        uv_ms = median_ms(lambda: g.send_uv(x, y, op), 10)
        torch.cuda.synchronize()
        if not same_bits(out, sdk.sddmm_reference(x, y, lay, op)):
            raise AssertionError(f"timed K11 {op} differs from its plain "
                                 "version")
        timing_row(rows, info, f"sddmm_{op}_d{D}", "sddmm", SDDMM_SOURCE,
                   SDDMM_REPLACES, launches.get(("sddmm", op, D), 0), 0.0,
                   ms, plain_ms, nbytes, S * D, None, gather, op=op)
        rows[-1]["send_uv_ms"] = uv_ms
        print(f"[timing] sddmm_{op}_d{D}: send_uv {uv_ms:.5f} ms "
              f"({uv_ms / ms:.3f} of K11's time)", flush=True)
    del out
    # the backward's two K1 launches over the real slots of a [S, D] table
    t = torch.randn(S, D, device=dev, generator=gen)
    for k1 in (lay.by_src, lay.by_dst):
        A = torch.sparse_csr_tensor(k1.indptr, k1.indices,
                                    torch.ones(E, device=dev), size=(N, S))
        res = torch.empty(N, D, device=dev)
        part = torch.empty(k1.num_partials, D, device=dev)
        ms = median_ms(lambda: sk._launch(t, k1, res, part), 20)
        plain_ms = median_ms(lambda: sk.spmm_reference(t, k1), 5)
        lib_ms = median_ms(lambda: torch.sparse.mm(A, t), 20)
        with torch.no_grad():
            err = check_spmm(f"timed K1 {k1.kind}", res, t, k1)
        k1_bytes = 4 * (E * D + E + N + 1 + N * D) + 16 * k1.pieces.shape[0]
        timing_row(rows, dict(info, op=None), f"{k1.kind}_k1_d{D}",
                   "spmm", SOURCE, SDDMM_REPLACES,
                   launches.get((k1.kind, D), 0), err, ms, plain_ms, k1_bytes,
                   E * D, lib_ms, layout=k1.kind,
                   pieces=int(k1.pieces.shape[0]),
                   split_rows=int(k1.split_rows.shape[0]))
    return rows


def phase_graph_small(dev):
    """The rest of ``Graph`` on the card against the CPU: ``disjoint`` of
    three graphs, ``tensor()``, ``send_u_recv`` and the UDF ``send``/
    ``recv`` with each reduce, and the subgraph ids."""
    import torch
    from pgl_tpu_torch import Graph

    rng = np.random.default_rng(21)
    parts = []
    for n, e in ((200, 1500), (7, 0), (300, 4000)):
        parts.append(Graph(
            np.stack([rng.integers(0, n, e), rng.integers(0, n // 2, e)], 1),
            num_nodes=n,
            node_feat={"h": rng.normal(size=(n, 16)).astype(np.float32)},
            edge_feat={"w": rng.normal(size=(e, 1)).astype(np.float32)}))
    host = Graph.disjoint(parts)
    results = {}
    for d in ("cpu", dev):
        g = host.tensor(d)
        h, w = g.node_feat["h"], g.edge_feat["w"]
        msg = g.send(lambda s, t, e: {"m": s["h"] * t["h"] + e["w"]},
                     src_feat={"h": h}, dst_feat={"h": h},
                     edge_feat={"w": w})
        res = {f"send_u_recv {r}": g.send_u_recv(h, r)
               for r in ("sum", "mean", "max", "min")}
        res.update({f"recv {r}": g.recv(r, msg)
                    for r in ("sum", "mean", "max", "min")})
        res["recv softmax"] = g.recv(
            lambda m: m.reduce_sum(m["m"] * m.reduce_softmax(m["m"])), msg)
        res["graph_node_id"] = g.graph_node_id
        results[str(d)] = {k: v.cpu() for k, v in res.items()}
    err = 0.0
    for k, want in results["cpu"].items():
        got = results[str(dev)][k]
        if k == "graph_node_id":
            if not torch.equal(got, want):
                raise AssertionError("graph_node_id differs on the card")
            continue
        err = max(err, check(f"batched graph {k}", got, want))
    print(f"[graph] disjoint of 3 graphs (N={host.num_nodes}, "
          f"E={host.num_edges}), send_u_recv and UDF send/recv with four "
          f"reduces, CUDA vs CPU: max |err| {err:.3e}", flush=True)


def phase_sddmm(dev, host):
    """The dedup SDDMM path: the headline loaded memory-mapped from a dump,
    K11 and its backward checked, the bench row's step timed through K11
    and through ``send_uv`` with their profiles, the kernels' rows, and the
    rest of ``Graph`` on a small batched graph. Returns (rows, the step
    line's entry)."""
    import torch

    g = loaded_headline(host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lay = g.sddmm_layout()
    torch.cuda.synchronize()
    t_layout = time.perf_counter() - t0
    print(f"[sddmm] sddmm_layout() {t_layout:.3f} s on the host: S="
          f"{lay.slots} slots for E={lay.num_edges} edges "
          f"({lay.slots - lay.num_edges} pads), {lay.uv.size} window rows "
          f"with the tail, by_src {lay.by_src.pieces.shape[0]} pieces, "
          f"by_dst {lay.by_dst.pieces.shape[0]} pieces", flush=True)
    err = phase_sddmm_kernels(g, lay, dev)
    phase_graph_small(dev)

    # the main path: the bench row's SDDMM with its gradient
    x = g.node_feat["h"].detach().clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, launches = time_steps(sddmm_step(g, x, "sddmm"),
                                           "SDDMM")
    peak = torch.cuda.max_memory_allocated()
    # one K11 a forward, K1 over by_src and by_dst a backward
    want = {("sddmm", "mul", 128): STEPS, ("sddmm_src", 128): STEPS,
            ("sddmm_dst", 128): STEPS}
    if launches != want:
        raise AssertionError(f"SDDMM step: launches {launches}, expected "
                             f"{want}")
    uv_ms, uv_losses, uv_launches = time_steps(sddmm_step(g, x, "send_uv"),
                                               "send_uv")
    if uv_launches:
        raise AssertionError(f"send_uv step launched {uv_launches}")
    if abs(losses[0] - uv_losses[0]) > 1e-4 * abs(uv_losses[0]):
        raise AssertionError(f"SDDMM loss {losses[0]} against send_uv's "
                             f"{uv_losses[0]}")
    print(f"[train SDDMM] {STEPS} steps of (sddmm_csc(x, x, mul) ** 2)"
          f".sum().backward(): median {step_ms:.4f} ms (send_uv's "
          f"{uv_ms:.4f} ms); loss {losses[0]:.6f} (send_uv {uv_losses[0]:.6f}"
          f"); peak memory {peak / 2**20:.1f} MiB; launches {launches}",
          flush=True)
    prof = phase_gat_profile(g, "SDDMM", lambda g: (None, sddmm_step(
        g, x, "sddmm")))
    prof_uv = phase_gat_profile(g, "send_uv", lambda g: (None, sddmm_step(
        g, x, "send_uv")))
    reset_all_launches()
    rows = phase_sddmm_timing(g, lay, dev, launches)
    reset_all_launches()
    return rows, {"SDDMM": {
        "step_ms": step_ms, "send_uv_step_ms": uv_ms,
        "loss_first": losses[0], "loss_last": losses[-1],
        "peak_mib": peak / 2**20, "layout_s": t_layout, "slots": lay.slots,
        "backward_max_abs_err": err, "profile": prof,
        "send_uv_profile": prof_uv}}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pgl_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t0 = time.perf_counter()
    libs = _build.build("segment_kernels", "dedup_kernels",
                        "attention_kernels", "dedup_attention",
                        "sddmm_kernels")
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    for path in libs.values():
        print(path.with_suffix(".log").read_text().strip(), flush=True)

    t0 = time.perf_counter()
    host = headline_host()
    g = headline_graph(False, host)
    deg = g.indegree().cpu().numpy()
    print(f"[graph] headline N={g.num_nodes} E={g.num_edges} built in "
          f"{time.perf_counter() - t0:.2f} s; largest in-degree "
          f"{int(deg.max())}, empty rows {int((deg == 0).sum())}, largest "
          f"out-degree {int(g.outdegree().max())}", flush=True)

    phase_kernels(g, dev)
    phase_model_small(dev)
    train, by_shape = phase_train(g, "K1")
    rows = phase_timing(g, dev, by_shape)
    for r in rows:
        r["shape"]["kernel"] = "spmm"
    del g
    g, t_k1 = tensor_s(host, False)         # host indexes warm, as below
    del g
    torch.cuda.empty_cache()

    # the dedup path: K4 twice at tensor() time, then K5 five times a step
    reset_all_launches()
    g_d, t_dedup = tensor_s(host, True)
    k4 = {k: v for k, v in all_launches().items() if v}
    if k4 != {("counts", "csc", None): 1, ("counts", "csr", None): 1}:
        raise AssertionError(f"tensor() launched {k4}, expected K4 once "
                             "per layout")
    csc_d, csr_d = g_d._dedup_layouts
    print(f"[graph] tensor() {t_k1:.3f} s with K1 layouts only, "
          f"{t_dedup:.3f} s with the dedup layouts and counts; CSC "
          f"{csc_d.num_pairs} pairs, {csc_d.groups.shape[0]} groups, "
          f"simple {csc_d.simple}, max count {csc_d.max_count}; CSR "
          f"{csr_d.num_pairs} pairs, {csr_d.groups.shape[0]} groups",
          flush=True)
    train_d, by_d = phase_train(g_d, "dedup", {
        ("dedup_cached", k, d): v for (k, d), v in PER_STEP.items()})
    phase_dedup_kernels(g_d, dev)
    cells = {}
    rows += phase_dedup_timing(g_d, {**k4, **by_d}, dev, cells)
    del g_d, csc_d, csr_d
    torch.cuda.empty_cache()

    # the dedup path over budget: no counts, K6 five times a step
    reset_all_launches()
    g_6, t_6 = tensor_s(host, True, COUNTS_BUDGET_BYTES=0)
    if any(all_launches().values()) or g_6._dedup_layouts[0].counts \
            is not None:
        raise AssertionError("tensor() over the counts budget made counts")
    train_6, by_6 = phase_train(g_6, "dedup uncached", {
        ("dedup", k, d): v for (k, d), v in PER_STEP.items()})
    rows += phase_dedup_timing(g_6, by_6, dev, cells)

    spmm = {path: spmm_ms_per_step(rows, kernel) for path, kernel in (
        ("K1", "spmm"), ("dedup", "dedup_cached"),
        ("dedup_uncached", "dedup"))}
    print(f"[default] SpMM device ms per headline step: K1 {spmm['K1']:.5f}, "
          f"dedup (K5) {spmm['dedup']:.5f}, dedup over budget (K6) "
          f"{spmm['dedup_uncached']:.5f}; lower: "
          f"{'dedup' if spmm['dedup'] < spmm['K1'] else 'K1'}", flush=True)
    del g_6
    torch.cuda.empty_cache()
    gat_rows, gat_steps = phase_gat(dev)
    rows += gat_rows
    torch.cuda.empty_cache()
    dedup_rows, dedup_steps = phase_dedup_gat(
        dev, gat_steps["GAT"]["attention_ms_per_step"])
    rows += dedup_rows
    torch.cuda.empty_cache()
    unimp_rows, unimp_steps = phase_unimp(dev)
    rows += unimp_rows
    torch.cuda.empty_cache()
    # the per-edge dot kernels' attention ms a UniMP step on the bench GAT
    # graph (2 layers of K9, K10-dq, K10-dkv at rate 0)
    edge_ms = 2 * sum(r["ms"] for r in unimp_rows
                      if r["shape"]["graph"] == "gat_graph")
    ddot_rows, ddot_steps = phase_unimp_dedup(dev, edge_ms)
    rows += ddot_rows
    torch.cuda.empty_cache()
    weighted_rows, weighted_steps = phase_weighted(dev, host)
    rows += weighted_rows
    torch.cuda.empty_cache()
    sddmm_rows, sddmm_steps = phase_sddmm(dev, host)
    rows += sddmm_rows
    print(json.dumps({"step": {
        "K1": dict(train, spmm_ms_per_step=spmm["K1"], tensor_s=t_k1),
        "dedup": dict(train_d, spmm_ms_per_step=spmm["dedup"],
                      tensor_s=t_dedup),
        "dedup_uncached": dict(train_6,
                               spmm_ms_per_step=spmm["dedup_uncached"],
                               tensor_s=t_6),
        **gat_steps, **dedup_steps, **unimp_steps, **ddot_steps,
        **weighted_steps, **sddmm_steps, "device": smi}}),
        flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
