#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (``pgl_tpu_torch``): the quickest proof
that the port builds, is right and trains on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result, when
there is no card or any phase fails. Phases:

1. the card's name and power limit (``nvidia-smi``); build the kernels from
   ``pgl_tpu_torch/ops/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print the build time and ``ptxas`` report, and for each
   instantiation of the dedup apply (K5, K6, the weighted K6) its
   registers, spills and dynamic shared memory, and of K1 and K1w
   (``spmm_rows``, ``spmm_packs``; K1w's by its weight and weight-gradient
   ops), the additive K8's node walk (``dedup_attn_bwd_nodes``), the
   additive lane-group kernels (``gat_fwd_groups``: K9 per edge, K7 per
   cell; their merge ``gat_fwd_combine``; K10's ``gat_dq_groups``,
   ``gat_dkv_groups``) and the staged dot kernels (``dot_fwd_staged``,
   ``dot_dq_staged``,
   ``dot_dkv_staged``: K9 and K10 per edge, K7 and K8 per cell) its
   registers and spills, failing if a staged dot kernel spills;
2. every kernel against its plain PyTorch version on the card, forward and
   backward: the plain version runs in float64 on the same inputs, and
   ``|kernel - plain| <= 1e-4 * max(1, |plain|, ||terms||_2)`` elementwise,
   where ``||terms||_2`` is the 2-norm of the terms the element sums. The
   kernel sums float32 in another order than the plain version, and its
   rounding error grows with that norm, not with ``|plain|``: a row whose
   terms cancel (the headline hub sums 803,866 of them) ends near 0 with an
   error of the size of its partial sums. One dropped or doubled edge still
   exceeds the tolerance. K1 (sorted-segment SpMM) first, also over every
   kind of work item (a hub's pieces, rows of their own, packs of short
   rows across item boundaries, empty rows) at D in (1, 3, 8, 16, 64, 128,
   130, 256, 512) on 16-byte and on unaligned tables, the same bits twice;
   then the dedup kernels: K4's counts must equal the plain counts
   exactly, K5 (cached counts) and K6 (rebuilt counts) pass the check
   above, give the same
   bits on two runs and agree with each other bit for bit, on a graph with
   a count of 256, windows past their block's unique run, split and empty
   dst blocks, at features with full 24-bit mantissas and subnormals and D
   in (1, 3, 8, 16, 64, 128, 130, 256); K6 alone on a count of 300; and on
   the headline at D = 128 and 16. Then the whole GCN on a small graph,
   CUDA against CPU, at ``1e-4 * max(1, |cpu|)``, through K1 and through
   the dedup path;
3. the main path: the bench headline (``bench.py``: ``powerlaw_graph(131072,
   16, feat_dim=128, seed=0)``, ``GCN(128, 16, num_layers=3,
   hidden_size=128, dropout=0)``, Adam at lr 1e-3) trains 3 warm-up and 20
   timed steps three ways: with ``dispatch.DEDUP`` off (K1), on (K4 twice
   at ``tensor()``, then K5), and on with a counts budget of 0 (K6). Each
   asserts its kernels' launches per step, and a finite and falling loss;
4. kernel time (CUDA events over warm launches) at each kernel's shapes on
   the main path, beside the plain version, ``torch.sparse.mm`` on a CSR
   tensor of the same graph (the yardstick for the SpMM; the port never
   calls it) and the bound; K5, K6 and K1 side by side at each of the
   step's (layout, D); then the SpMM device time per step of each path;
5. the GAT path (per-edge attention, K9 and K10): K9, K10-dq and K10-dkv
   against their float64 plain versions at dropout rates 0 and 0.6, on a
   skewed small graph with a hub destination and a hub source and on the
   bench GAT graph (``bench.py``: ``powerlaw_graph(65536, 16,
   feat_dim=128, seed=1)``), with the tolerance above (no terms scale:
   every output is a convex combination or a sum of bounded terms), and
   at every lane map of ``K10_SHAPES`` (rates 0 and 0.6, leaky 0 and 0.2)
   on a split hub, 16-edge rows and no edges, the same bits twice and
   zeros on empty rows; the keep bits of K9 and K10-dkv equal the plain
   mask exactly (a permutation graph, where each row has one edge); the
   small GAT, CUDA against CPU;
   then the bench GAT (``GAT(128, 16, num_heads=8, hidden_size=8,
   feat_drop=0, attn_drop=0)``, Adam at lr 1e-3) and ``GAT`` with its
   default dropouts (0.6, training) each train 3 warm-up and 20 timed
   steps, asserting their launches per step (one K9, K10-dq and K10-dkv
   at each of (H, dvh) = (8, 8) and (1, 16), the combine launches where
   rows split, no SpMM) and a finite, falling loss; a torch.profiler trace
   of the bench GAT step gives its device time by kernel and idle share;
   and the kernels are timed as in 4;
6. the dedup GAT path (count-matrix attention, K7 and K8; K8's node walk
   writes d a_src and dv on node rows, with no fold): the bench GAT graph
   under ``dispatch.DEDUP`` (K4 twice at ``tensor()``; K7/K8's work lists
   built at the first attention call); K7 and K8 against their float64
   plain versions at rates 0 and 0.6 on the skewed small graph (seven head
   shapes, 3·H > 128 among them) and on the bench GAT graph, two runs and
   a layout without counts giving the same bits; K7 (with K8) at every
   lane map of ``K10_SHAPES``, rates 0 and 0.6, leaky 0 and 0.2, on a
   multigraph whose cells count 2 to 4 edges (a split hub, rows without
   cells) and on no edges, the same bits twice and zeros on the rows
   without cells; the keep bits of K7 and K8 equal the plain cell mask
   exactly (a permutation graph); the small
   GAT through the dedup path, CUDA against CPU; then three training runs
   of 20 timed steps, asserting their launches per step (K7, K8 and their
   merges at each of (H, dvh) = (8, 8) and (1, 16), nothing else): the
   bench GAT, the same graph over a zero counts budget, and GAT's default
   dropouts with ``attn_drop_mode="cell"``; a torch.profiler trace of the
   step; the kernels timed as in 4, K8 beside its byte bound and the
   bound of the rows its passes gather; and the attention device time per
   step of this route beside the per-edge route's;
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
8. the UniMP dedup path (count-matrix attention in dot mode: K7 and K8
   on q·k scores, the staged dot kernels in their cell form; K8's node
   walk writes dk and dv on node rows, with no fold): the bench GAT graph
   under ``dispatch.DEDUP`` (K4 twice at ``tensor()``, the work lists at
   the first attention call, the node order's sort timed alone); the
   dot-mode K7 and K8 against their float64 plain versions at rates 0 and
   0.3 (dq, dk and dv with the terms scale) on the skewed small graph at
   (H, dsh, dvh) = (2, 128, 128), (8, 16, 16), (4, 64, 8) and (43, 2, 4)
   with a leaky relu, and on the bench GAT graph at UniMP's shape, two runs
   and a layout without counts giving the same bits; out, lse and dq equal
   to 12a5247's bits (``PARENT_BITS``) on six pinned cases; the keep bits
   equal the plain cell mask exactly (a permutation graph); a small UniMP
   through the route, CUDA against CPU; then UniMP at the reference's
   defaults on the bench GAT graph trains 3 warm-up and 20 timed steps
   without dropout (``training=False``, the route the reference takes on a
   multigraph) and 20 with dropout 0.3 in ``attn_drop_mode="cell"``,
   asserting its launches a step (two of each dot kernel and of their
   merges, nothing else) and a finite, falling loss; a torch.profiler trace
   of the step; the kernels timed beside the table and gather bounds, K8
   split by kernel (row pass, node walk); and the attention device time per
   UniMP step of this route beside the per-edge route's on the same graph
   (phase 7's dot kernels there);
9. the edge-weighted path (``send_ue_recv``: K1w, the sorted SpMM on
   weighted messages over K1's work list, and the weighted K6): K1w
   forward, dx with dw and dw alone over every kind of work item (the K1
   case graph) at D in (1, 3, 8, 16, 64, 128) with every head count of
   ``K1W_ITEM_CASES``, mul and add, on 16-byte and unaligned tables; then
   forward, dx and dw (one launch over CSR) against their float64 plain
   versions with the terms scale, for mul and add, one weight an edge or 8
   a head, D in (16, 64, 128), on the skewed small graph and the headline
   graph, two runs giving the same bits, and each gradient alone; the
   weighted K6 forward, dx and
   dw (K1w's pass) on the headline graph under ``DEDUP`` against float64,
   the same bits twice, forward and dx within tolerance of K1w, at D = 16
   and 64 and with weights over six orders of magnitude; small
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
   ``by_dst`` beside its plain version and ``torch.sparse.mm``;
11. the layer zoo (``nn``'s conv layers and the models on them, whose
   sums and means are K1): every layer (``GraphSageConv`` with each
   ``aggr_func``, ``APPNP``, ``LightGCNConv``, ``SGCConv``, ``SSGCConv``,
   ``GPRConv``, ``GCNII``, ``GINConv``, ``NGCFConv``, ``BernProp``,
   ``ChebProp``, ``GraphPool`` with each pool, ``GraphNorm``) and model
   (``GraphSage`` with each ``aggr_func``, ``GIN``, ``DeepGCNII``,
   ``APPNPModel``, ``SGC``, ``SSGC``, ``GPRGNN``, ``BernNet``,
   ``ChebNetII``) on a small graph, CUDA against CPU with the same weights,
   output and every gradient at ``1e-4 * max(1, |cpu|)``, K1 launched where
   a sum or mean runs and nowhere else; ``remat=True`` against
   ``remat=False`` for ``GCN``, ``GraphSage`` and ``DeepGCNII`` training at
   dropout 0.6, the same bits over two steps; then on the headline
   ``GraphSage(128, 16, num_layers=2, hidden_size=128, aggr_func="mean")``
   (``bench.py:370``'s widths, full batch) and ``DeepGCNII(128, 16,
   hidden_size=64, k_hop=16)`` (the citation benchmark's, dropout 0.6),
   also with ``remat``, train 3 warm-up and 20 timed steps (Adam at lr
   1e-3) asserting their K1 launches a step (``ZOO_PER_STEP``), a finite,
   falling loss and printing the peak memory, with torch.profiler traces
   (K1's device time a step, the idle share); and ``APPNPModel``,
   ``GPRGNN``, ``ChebNetII``, ``BernNet``, ``SGC``, ``SSGC`` on the
   headline and ``GIN`` on a ``disjoint`` of 64 powerlaw graphs of 2,048
   nodes with graph labels take 3 steps each at the reference's defaults,
   asserting their K1 launches a step;
12. the heterogeneous path, readouts and LSTM aggregation: an
   ogbn-mag-shaped ``HeterGraph`` (``mag_host``: the UniMP graph's 169,343
   papers with their ``cites``, 260,000 authors, 1,642,627 ``writes`` and
   their reverse ``writed_by``; one 128-wide feature table, authors the
   mean of their papers', put on the card once for the three relations);
   the dot-mode K9/K10 at UniMP's shape on each relation against float64
   (``writes`` at rates 0 and 0.3, the others at 0.3), with exact zeros
   on the rows without edges; ``RUniMP(128, 40, num_layers=2,
   hidden_size=128, num_heads=2, dropout=0.3)``, the reference's defaults,
   trains 3 warm-up and 20 timed steps (AdamW, a fresh 60% of the train
   papers' labels fed each step) asserting one K9, K10-dq and K10-dkv a
   relation a step (``RUNIMP_PER_STEP``; the last layer, ``concat=False``,
   runs none) and a falling loss, with a torch.profiler trace (the dot
   kernels' and ``q[dst]``'s gather backward's device ms) and the dot
   kernels timed on each relation; ``examples/rgcn/train.py``'s RGCN
   (hidden 32, two bases) trains 20 steps asserting K1's launches
   (``RGCN_PER_STEP``), with its trace and K1 timed at D = 32 and 40 on
   each relation; ``label_propagation_smooth`` on ``cites`` (40 classes,
   3 hops, three K1 launches) CUDA against CPU; the ``writes`` edges as a
   ``BiGraph`` of authors -> papers, K1 over its rectangular layouts at D
   = 128 for sum and mean against float64 (output and gradient, zeros on
   the rows without edges) and timed; then, on a ``disjoint`` of 4,096
   motif graphs (``examples/global_pool/train.py``'s generator and
   widths), GIN with each readout (sum, mean, max, ``GlobalAttention``,
   ``Set2Set``, the Graph Multiset Transformer) and GCN, ``SAGPool``, GCN
   in both modes (CUDA against a float64 CPU run with the same weights on
   that batch, gradients with the terms scale; the max and top-k readouts
   on its features plus seeded noise, which breaks their ties), and
   ``LSTMSage`` at its defaults on the headline (CUDA against float64 CPU
   on a powerlaw graph of 4,096 nodes), each 3 steps asserting its K1
   launches (``READOUT_PER_STEP``; LSTMSage none). The launches of the
   per-relation rows are read on each relation's layouts
   (``LAUNCHES_BY_LAYOUT``), the BiGraph rows' in its checks' runs.
13. sampling, the data pipeline, walks and partitioning, on the UniMP
   graph (``unimp_host``, 2,404,895 edges, in-degree up to 33; the
   sampler's copy holds the edges alone, its CSC built before the workers
   fork): (a) host-sampled minibatch GraphSAGE (``bench.py:354-485``'s
   pipeline at the arxiv stand-in's size): ``make_padded_batch_fn(...,
   (25, 10), 2^17, 2^17, pack=True, layouts=True)`` in the port's
   ``Dataloader`` with 4 forked workers, each batch of 512 seeds (drawn
   from the first 90,941 nodes) sampled, padded (the sentinel row takes
   the pad edges) and given both K1 layouts on the host, sent through a
   pinned buffer by one non-blocking copy, its graph rebuilt on the card
   by ``padded_batch_graph`` and the features gathered there by ``sidx``;
   K1 on the host-built layouts against float64; ``GraphSage(128, 40, 2
   layers, 128 hidden, dropout 0)`` with Adam at lr 1e-3 takes 3 warm-up
   and 20 timed batches asserting 2 CSC and 1 CSR K1 launches at D = 128
   a step and a finite, falling loss; the breakdown of ``bench.py:443-482``
   (the pipeline ms a batch; sample and collate with 4 workers and in 1
   process; the copy plus the step) and a torch.profiler trace (device
   time, K1's, the idle share); K1's rows at these shapes; (b)
   ``NeighborSampler`` + ``BipartiteSAGE`` at the same seeds and samples,
   one generator on the card, 3 warm-up and 20 timed steps (every sampled
   neighbour an in-neighbour, masks where the degree is 0, a finite,
   falling loss), the device time by kind (GEMMs, gathers, the rest; the
   sampler alone), the idle share and the peak memory; (c) ``DeviceWalker``
   from every node: ``random_walk`` (length 20, DeepWalk's) and
   ``node2vec_walk`` (p = 0.25, q = 4, node2vec's), every hop checked on
   the card as an edge by a binary search over the neighbour-sorted CSR
   and every dead end -1 to the end, walks per second; ``skipgram_pairs``
   (window 5) on the node2vec block; (d) on the host, ``metis_partition``
   into 16 parts and ``reorder_graph``: seconds and the edge cut.

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
# the staged dot kernels, per edge (K9, K10) and per cell (K7, K8)
DOT_SOURCE = "pgl_tpu_torch/ops/kernels/csrc/dot_staged.cuh"
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
# widths the dedup apply is checked at: one, odd, each column tile, past it
DEDUP_CASE_D = (1, 3, 8, 16, 64, 128, 130, 256)


def apply_report(log):
    """Lines on the dedup apply kernels (K5, K6, the weighted K6) from
    ``nvcc -Xptxas -v``'s report ``log``: each instantiation's registers
    and spills beside the dynamic shared memory its launch asks for."""
    import re
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    lib = dk._lib()
    names = {(0, 0): ("K5", 0, 1), (1, 0): ("K6", 1, 1),
             (1, 1): ("K6, counts > 256", 1, 257),
             (2, 1): ("weighted K6", 2, 1)}
    lines, kernel, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*dedup_applyILi(\d)ELb(\d)"
                      r"ELi(\d+)E", line)
        if m:
            kernel = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"spills {m.group(1)} / {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            mode, fa, dt = kernel
            name, mode_arg, max_count = names[mode, fa]
            smem = lib.pgl_dedup_apply_smem(mode_arg, max_count, dt)
            lines.append(f"[build] dedup_apply {name}, column tile {dt}: "
                         f"{m.group(1)} registers, {spills}, dynamic shared "
                         f"memory {smem} B")
            kernel = None
    return sorted(lines)


# ptxas entries reported one line each: (label, the mangled name with the
# template arguments as groups, their names); the staged dot kernels' last
# argument is CELLS, 0 per edge (K9, K10) and 1 per count-matrix cell (K7,
# K8 in dot mode)
_STAGED = r"ILi(\d+)ELb(\d)ELb(\d)ELb{}E"
# K1's items kernels are K1w's with no weight op (WOP = DWOP = 0)
_ITEMS = r"ILi(\d+)ELi(\d+)ELi(\d+)ELi{}ELi{}E"
REGISTER_REPORT = (
    ("K1 spmm_rows", "spmm_rows" + _ITEMS.format(0, 0), ("VEC", "L", "NV")),
    ("K1 spmm_packs", "spmm_packs" + _ITEMS.format(0, 0),
     ("VEC", "L", "NV")),
    ("K1w spmm_rows", "spmm_rows" + _ITEMS.format(r"([12])", r"(\d)"),
     ("VEC", "L", "NV", "WOP", "DWOP")),
    ("K1w spmm_rows", "spmm_rows" + _ITEMS.format("(0)", r"([12])"),
     ("VEC", "L", "NV", "WOP", "DWOP")),
    ("K1w spmm_packs", "spmm_packs" + _ITEMS.format(r"([12])", r"(\d)"),
     ("VEC", "L", "NV", "WOP", "DWOP")),
    ("K1w spmm_packs", "spmm_packs" + _ITEMS.format("(0)", r"([12])"),
     ("VEC", "L", "NV", "WOP", "DWOP")),
    ("K8 node walk dedup_attn_bwd_nodes",
     r"dedup_attn_bwd_nodesILi(\d+)ELi(\d+)ELi(\d+)E", ("NC", "U", "G")),
    ("K9 additive gat_fwd_groups",
     r"gat_fwd_groupsILi(\d+)ELi(\d+)ELb(\d)ELb0E", ("VEC", "NV", "V4")),
    ("K7 additive gat_fwd_groups cells",
     r"gat_fwd_groupsILi(\d+)ELi(\d+)ELb(\d)ELb1E", ("VEC", "NV", "V4")),
    ("K9 / K7 merge gat_fwd_combine", r"gat_fwd_combineILi(\d+)E", ("NC",)),
    ("K10-dq additive gat_dq_groups", r"gat_dq_groupsILi(\d+)ELi(\d+)ELb(\d)E",
     ("VEC", "NV", "V4")),
    ("K10-dkv additive gat_dkv_groups",
     r"gat_dkv_groupsILi(\d+)ELi(\d+)ELb(\d)E", ("VEC", "NV", "V4")),
    ("K9-dot dot_fwd_staged", "dot_fwd_staged" + _STAGED.format(0),
     ("NC", "FULL", "WIDE")),
    ("K10-dq-dot dot_dq_staged", "dot_dq_staged" + _STAGED.format(0),
     ("NC", "FULL", "WIDE")),
    ("K10-dkv-dot dot_dkv_staged", "dot_dkv_staged" + _STAGED.format(0),
     ("NC", "FULL", "WIDE")),
    ("K7-dot dot_fwd_staged cells", "dot_fwd_staged" + _STAGED.format(1),
     ("NC", "FULL", "WIDE")),
    ("K8-dot row pass dot_dq_staged cells",
     "dot_dq_staged" + _STAGED.format(1), ("NC", "FULL", "WIDE")),
    ("K8-dot node walk dot_dkv_staged cells",
     "dot_dkv_staged" + _STAGED.format(1), ("NC", "FULL", "WIDE")))


def register_report(log):
    """Lines on K1's, K1w's, the additive K8 node walk's and K10's, and the
    staged dot kernels' instantiations (K9, K10 per edge; K7, K8 per cell) from ``nvcc
    -Xptxas -v``'s report ``log``: registers and spilled bytes of each.
    Raises if a staged dot kernel spills."""
    import re
    lines, entry, spills, spilled, spill_bytes = [], None, "", [], 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = None
            for label, pattern, names in REGISTER_REPORT:
                k = re.search(pattern, m.group(1))
                if k:
                    entry = label + " " + ", ".join(
                        f"{n}={v}" for n, v in zip(names, k.groups()))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"spills {m.group(1)} / {m.group(2)} B"
            spill_bytes = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            lines.append(f"[build] {entry}: {m.group(1)} registers, "
                         f"{spills}")
            if "staged" in entry and spill_bytes:
                spilled.append(entry)
            entry = None
    if spilled:
        raise AssertionError(f"staged dot kernels spill: {spilled}")
    return sorted(lines)


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


def bound_share(got, want, scale=None):
    """The largest |got - want| as a share of ``check``'s bound."""
    import torch
    want = want.double()
    bound = want.abs().clamp(min=1.0)
    if scale is not None:
        bound = torch.maximum(bound, scale)
    share = (got.double() - want).abs() / (1e-4 * bound)
    return float(share.max()) if share.numel() else 0.0


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


def k1_case_edges(seed=11, n=2000):
    """(edges [E, 2] as (src, dst), n) whose CSC rows hold every kind of
    K1 work item: a hub of 1,300 edges (pieces), rows of 33 to 599 edges
    (items of their own, or pieces past 64), runs of short rows (0 to 12
    edges) packed across item boundaries, and a run of 200 empty rows;
    1,200 edges leave one source, so the CSR side splits a row too."""
    rng = np.random.default_rng(seed)
    deg = rng.choice([0, 0, 1, 2, 3, 5, 8, 12], size=n)
    deg[rng.choice(n, 40, replace=False)] = rng.integers(33, 600, 40)
    deg[7] = 1300
    deg[11] = 40
    deg[100:300] = 0
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, len(dst))
    src[rng.choice(len(dst), 1200, replace=False)] = 5
    return np.stack([src, dst], axis=1), n


def k1_features(n, d, dev, gen, aligned=True):
    """A contiguous float32 [n, d] table; ``aligned=False`` starts it one
    float past a 16-byte boundary (K1's scalar path at any width)."""
    import torch
    flat = torch.randn(n * d + 1, device=dev, generator=gen)
    return flat[:n * d].view(n, d) if aligned else flat[1:].view(n, d)


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

    # every kind of K1 work item, one to four vectors a lane and a walk of
    # 512 columns, on 16-byte vectors and on the scalar path; same bits twice
    edges, n = k1_case_edges()
    case = Graph(edges, num_nodes=n).tensor(dev)
    err = 0.0
    for d in (1, 3, 8, 16, 64, 128, 130, 256, 512):
        for aligned in (True, False):
            for lay in case._spmm_layouts:
                x = k1_features(n, d, dev, gen, aligned)
                out = sk._spmm_cuda(x, lay)
                if not torch.equal(out, sk._spmm_cuda(x, lay)):
                    raise AssertionError(f"K1 case {lay.kind} D={d}: two "
                                         "runs differ")
                with torch.no_grad():
                    err = max(err, check_spmm(
                        f"case {lay.kind} D={d} aligned={aligned}", out, x,
                        lay))
    kinds = case._spmm_layouts[0].items[:, 3].cpu()
    print(f"[kernels] K1 work items (CSC: {int((kinds >= 0).sum())} pieces "
          f"of split rows, {int((kinds == -1).sum())} whole rows, "
          f"{int((kinds < -1).sum())} packs) at D in (1, 3, 8, 16, 64, 128, "
          f"130, 256, 512), vector and scalar loads, both layouts: max "
          f"|err| {err:.3e}; same bits on a second run", flush=True)

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


def phase_dtype_route(dev):
    """The dtype rule of ``Graph`` (``dispatch.plain_on_cuda``): an int64
    feature on a CUDA graph takes the segment path, launches no kernel and
    gives the CPU graph's sums exactly; the same feature in float32 still
    launches K1 (sum, then mean); in bf16 it reaches the wrapper, which
    raises (no kernel has a bf16 instantiation yet)."""
    import torch
    from pgl_tpu_torch import Graph

    host = Graph(skewed_graph(1000, 20000, seed=6), num_nodes=1000)
    ones = torch.ones(1000, 2, dtype=torch.int64)
    want = host.tensor("cpu").send_u_recv(ones, "sum")
    g = host.tensor(dev)
    reset_all_launches()
    got = g.send_u_recv(ones.to(dev), "sum")
    torch.cuda.synchronize()
    launched = {k: v for k, v in all_launches().items() if v}
    if launched:
        raise AssertionError(f"an int64 send_u_recv launched {launched}")
    if got.dtype != torch.int64 or not torch.equal(got.cpu(), want):
        raise AssertionError("an int64 send_u_recv on the card differs "
                             "from the CPU's sums")
    for reduce in ("sum", "mean"):
        g.send_u_recv(ones.to(dev, torch.float32), reduce)
    k1 = sum(v for k, v in all_launches().items() if k[0] == "csc")
    if k1 != 2:
        raise AssertionError(f"a float32 send_u_recv launched K1 {k1} "
                             "times, expected 2")
    reset_all_launches()
    try:
        g.send_u_recv(ones.to(dev, torch.bfloat16), "sum")
    except TypeError:
        pass
    else:
        raise AssertionError("a bf16 send_u_recv on the card did not raise")
    if any(all_launches().values()):
        raise AssertionError("a bf16 send_u_recv launched a kernel")
    print(f"[graph] int64 send_u_recv on the card: the CPU's sums exactly "
          f"(N={g.num_nodes}, E={g.num_edges}, largest sum "
          f"{int(want.max())}), no kernel launched; float32 launched K1 "
          f"twice (sum, mean); bf16 raised", flush=True)


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


def launches_on(layouts):
    """The K1 and attention launches counted on ``layouts`` (by the
    wrappers' ``LAUNCHES_BY_LAYOUT``), keyed as ``all_launches``."""
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    ids = {id(lay) for lay in layouts}
    got = {}
    for module in (sk, ak):
        for (key, lid), v in module.LAUNCHES_BY_LAYOUT.items():
            if lid in ids and v:
                got[key] = got.get(key, 0) + v
    return got


def phase_train(g, path="K1", per_step=None, trainer=None, num_class=16,
                parts=None):
    """The main path: a model trains on the card (default: the bench
    headline GCN). Asserts the launches of every kernel: ``per_step``
    (default: K1's ``PER_STEP``) times the step count, and no other; and
    finite logits [N, ``num_class``] after the steps. With ``parts`` (tag
    -> layouts, e.g. the relations of a heterogeneous graph) it also
    returns the launches of the timed steps on each tag's layouts, which
    must add up to all of them."""
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
    by_part = {t: launches_on(lays) for t, lays in (parts or {}).items()}
    if parts is not None:
        summed = {}
        for got in by_part.values():
            for k, v in got.items():
                summed[k] = summed.get(k, 0) + v
        if summed != by_shape:
            raise AssertionError(f"{path}: launches on the parts {by_part} "
                                 f"do not add up to {by_shape}")
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
    train = {"step_ms": step_ms, "peak_mib": peak / 2**20,
             "held_mib": held / 2**20, "loss_first": losses[0],
             "loss_last": losses[-1]}
    return (train, by_shape) if parts is None else (train, by_shape,
                                                   by_part)


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
    return k1_rows("", g._spmm_layouts, (g.num_nodes, g.num_nodes),
                   (128, 16), dev, by_shape)


def k1_rows(tag, lays, tables, dims, dev, by_shape):
    """K1's rows (CUDA-event ms over warm launches, the plain version's,
    ``torch.sparse.mm`` on a CSR tensor of the layout, the bound, the max
    |err| against float64) over each layout of ``lays`` gathering a table
    of ``tables[i]`` rows, at each width of ``dims``; ``by_shape[(kind,
    D)]`` is the launches in the run the row stands for. The bound reads
    the table's distinct gathered rows once (a batch graph gathers a few
    of its bucket's rows), the indices and row pointer once, and writes
    every output row. Rows are named ``spmm_<kind>_d<D>`` and
    ``_<tag>``."""
    import torch
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    rows = []
    gen = torch.Generator(device=dev).manual_seed(1)
    for lay, n in zip(lays, tables):
        kind = lay.kind
        A = torch.sparse_csr_tensor(lay.indptr, lay.indices,
                                    torch.ones(lay.num_edges, device=dev),
                                    size=(lay.num_rows, n))
        gathered = int(torch.unique(lay.indices).numel())
        for d in dims:
            x = torch.randn(n, d, device=dev, generator=gen)
            out = torch.empty(lay.num_rows, d, device=dev)
            part = torch.empty(lay.item_partials, d, device=dev)
            ms = time_ms(lambda: sk._launch(x, lay, out, part), 100)
            plain_ms = time_ms(lambda: sk.spmm_reference(x, lay), 20)
            lib_ms = time_ms(lambda: torch.sparse.mm(A, x), 50)
            with torch.no_grad():
                err = check_spmm(f"timed {kind} D={d} {tag}", out, x, lay)
            nbytes = 4 * (gathered * d + lay.num_edges
                          + lay.num_rows + 1 + lay.num_rows * d)
            ops = lay.num_edges * d
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            rows.append({
                "name": f"spmm_{kind}_d{d}" + (f"_{tag}" if tag else ""),
                "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                "launches": by_shape.get((kind, d), 0),
                "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms, "share": bound_ms / ms,
                "shape": {"layout": kind, "rows": lay.num_rows,
                          "table_rows": n, "gathered_rows": gathered,
                          "edges": lay.num_edges, "D": d,
                          "items": int(lay.items.shape[0]),
                          "split_rows": int(lay.item_split_rows.shape[0])}})
            print(f"[timing] {kind} D={d} {tag}: kernel {ms:.5f} ms, plain "
                  f"{plain_ms:.5f} ms, torch.sparse.mm {lib_ms:.5f} ms, "
                  f"bound {bound_ms:.5f} ms ({bound_ms / ms:.3f} of it; "
                  f"{gathered} of {n} table rows gathered)", flush=True)
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


def dedup_case_edges(num_nodes=3000, num_edges=40000, seed=4, copies=256):
    """``skewed_graph`` plus one (dst, src) cell repeated ``copies`` times:
    at 256 the largest count bf16 caches (K5 runs); above it K6 keeps its
    counts in float32 and splits them, as it does weights."""
    edges = skewed_graph(num_nodes, num_edges, seed)
    cell = np.tile(np.array([[5, num_nodes - 7]]), (copies, 1))
    return np.concatenate([edges, cell])


def dedup_case_facts(lay):
    """What the dedup apply can get wrong that ``lay`` exercises: windows
    that run past their block's unique run, dst blocks split over groups
    (partials), empty blocks (one pair, no edges)."""
    pairs = lay.pairs.cpu().numpy().astype(np.int64)
    blk, wb, start, end = pairs.T
    first = np.searchsorted(blk, np.arange(blk.max() + 2))
    run_end = np.append(wb[first[1:-1]], lay.uv.numel() - 128)
    n_pairs = np.diff(first)
    return {"overrun": int((wb + 128 > run_end[blk]).sum()),
            "partials": lay.num_partials,
            "empty_blocks": int(((start == end)
                                 & (n_pairs[blk] == 1)).sum())}


def hard_features(n, d, dev, gen, subnormal=True):
    """float32 features whose three bf16 planes are all nonzero (full
    24-bit mantissas, 1 + k * 2^-23 times a power of two, either sign), and
    with ``subnormal`` one entry in 64 subnormal."""
    import torch
    k = torch.randint(0, 1 << 23, (n, d), device=dev, generator=gen)
    e = torch.randint(-4, 5, (n, d), device=dev, generator=gen)
    sign = torch.randint(0, 2, (n, d), device=dev, generator=gen) * 2 - 1
    x = sign * (1 + k.float() * 2.0 ** -23) * torch.pow(2.0, e.float())
    sub = torch.randint(0, 64, (n, d), device=dev, generator=gen) == 0
    tiny = k.float() * 2.0 ** -149
    return torch.where(sub & subnormal, sign * tiny, x).float().contiguous()


def check_dedup_exact(tag, dev, n=3000, d=128, seed=6):
    """On a permutation graph every output of the dedup apply is one term
    of count 1, so K5 and K6 must return the source row bit for bit, in
    both directions: the three bf16 planes of a normal float32 add back to
    it exactly, and a lost plane (the lowest is 2^-16 of the value, under
    ``check``'s tolerance) shows here."""
    import dataclasses

    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    perm = np.random.default_rng(seed).permutation(n)
    g = Graph(np.stack([perm, np.arange(n)], axis=1), num_nodes=n
              ).tensor(dev)
    csc, csr = dedup_layouts(g, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = hard_features(n, d, dev, gen, subnormal=False)
    w = hard_features(n, d, dev, gen, subnormal=False)
    p = torch.as_tensor(perm, device=dev)
    uncached = [dataclasses.replace(lay, counts=None) for lay in (csc, csr)]
    for name, lays in (("K5", (csc, csr)), ("K6", uncached)):
        out, grad = run_dedup_twice(x, w, lays)
        if not (torch.equal(out, x[p]) and torch.equal(grad[p], w)):
            raise AssertionError(f"{tag} {name}: a one-term row differs "
                                 "from its source row")


def run_dedup_twice(x, w, lays):
    """``spmm_dedup`` forward and backward (cotangent ``w``) twice; raises
    unless the two runs give the same bits. Returns (out, grad)."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    res = []
    for _ in range(2):
        xr = x.detach().clone().requires_grad_(True)
        out = dk.spmm_dedup(xr, *lays)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        res.append((out.detach(), xr.grad))
    if not all(torch.equal(a, b) for a, b in zip(*res)):
        raise AssertionError("dedup apply: two runs differ")
    return res[0]


def phase_dedup_kernels(g_head, dev):
    """K4 exact, K5 and K6 against the float64 plain version forward and
    backward, two runs the same bits, and K5 against K6 bit for bit: on a
    graph with a count of 256, windows past their block's run, split and
    empty blocks, at features with full mantissas and subnormals and
    D in ``DEDUP_CASE_D``; K6 alone on a count of 300 (counts split into
    planes); then the headline at the main path's widths."""
    import dataclasses

    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk

    small = Graph(dedup_case_edges(), num_nodes=3000).tensor(dev)
    lay_small = dedup_layouts(small, dev)
    facts = [dedup_case_facts(lay) for lay in lay_small]
    if not (lay_small[0].max_count == 256 and lay_small[0].counts is not None
            and all(facts[0].values())):
        raise AssertionError(f"the dedup case graph misses a case: max "
                             f"count {lay_small[0].max_count}, {facts[0]}")
    over = Graph(dedup_case_edges(copies=300), num_nodes=3000).tensor(dev)
    lay_over = dedup_layouts(over, dev)
    if lay_over[0].counts is not None:
        raise AssertionError("counts cached for a count of 300")
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [("small", small, lay_small, d, True) for d in DEDUP_CASE_D]
    cases += [("count 300", over, lay_over, d, True) for d in (16, 128)]
    cases += [("headline", g_head, g_head._dedup_layouts, d, False)
              for d in (128, 16)]
    for tag, lays in (("small", lay_small),
                      ("headline", g_head._dedup_layouts)):
        for lay in lays:
            check_counts(f"{tag} counts {lay.kind}", lay.counts, lay)
        print(f"[dedup] {tag} counts csc/csr equal the plain counts "
              f"(P = {lays[0].num_pairs} / {lays[1].num_pairs}, partial "
              f"blocks {lays[0].num_partials} / {lays[1].num_partials})",
              flush=True)
    print(f"[dedup] case graph: max count 256, csc {facts[0]}, csr "
          f"{facts[1]}", flush=True)
    for d in (128, 3):
        check_dedup_exact("permutation", dev, d=d)
    print("[dedup] permutation graph, D=128 and 3: K5 and K6 return each "
          "source row bit for bit, forward and backward", flush=True)
    for tag, g, (csc, csr), d, hard in cases:
        uncached = [dataclasses.replace(lay, counts=None)
                    for lay in (csc, csr)]
        if hard:
            x = hard_features(g.num_nodes, d, dev, gen)
            w = hard_features(g.num_nodes, d, dev, gen)
        else:
            x = torch.randn(g.num_nodes, d, device=dev, generator=gen)
            w = torch.randn(g.num_nodes, d, device=dev, generator=gen)
        out6, grad6 = run_dedup_twice(x, w, uncached)
        with torch.no_grad():
            e_f = check_dedup(f"{tag} K6 csc D={d}", out6, x, csc)
            e_b = check_dedup(f"{tag} K6 csr D={d}", grad6, w, csr)
        if csc.counts is not None:
            out5, grad5 = run_dedup_twice(x, w, (csc, csr))
            if not (torch.equal(out5, out6) and torch.equal(grad5, grad6)):
                raise AssertionError(f"{tag} D={d}: K5 and K6 differ")
        print(f"[dedup] {tag} N={g.num_nodes} E={g.num_edges} D={d}"
              f"{' (full mantissas, subnormals)' if hard else ''}: "
              f"{'K5 = K6 bit for bit; ' if csc.counts is not None else ''}"
              f"two runs the same bits; max |err| fwd {e_f:.3e} bwd "
              f"{e_b:.3e}", flush=True)


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


def check_attention(tag, lays, ins, rate, seed, slope=0.2):
    """K9, K10-dq and K10-dkv (float32) against their plain versions in
    float64 on the same inputs, with leaky slope ``slope``; returns the max
    |err| of each and the kernels' outputs."""
    import torch
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    csc, csr = lays
    a_dst, a_src, v, g = ins
    H = a_dst.shape[1]
    dvh = v.shape[1] // H
    with torch.no_grad():
        out, lse = ak._fwd_cuda(a_dst, a_src, v, csc, slope, dvh, rate, seed)
        delta = (g.reshape(-1, H, dvh) * out.reshape(-1, H, dvh)).sum(-1)
        bwd = (a_dst, a_src, v, g, lse, delta)
        da_dst = ak._dq_cuda(*bwd, csc, slope, dvh, rate, seed)
        da_src, dv = ak._dkv_cuda(*bwd, csr, slope, dvh, rate, seed)
        d64 = [t.double() for t in bwd]
        out_p, lse_p = ak.gat_attention_reference(*d64[:3], csc, slope, dvh,
                                                  rate, seed)
        dq_p = ak.gat_dq_reference(*d64, csc, slope, dvh, rate, seed)
        dsrc_p, dv_p = ak.gat_dkv_reference(*d64, csr, slope, dvh, rate,
                                            seed)
        name = f"{tag} H={H} dvh={dvh} rate={rate} leaky={slope}"
        return {"gat_fwd": max(check(f"{name} K9 out", out, out_p),
                               check(f"{name} K9 lse", lse, lse_p)),
                "gat_dq": check(f"{name} K10-dq", da_dst, dq_p),
                "gat_dkv": max(check(f"{name} K10-dkv d a_src", da_src,
                                     dsrc_p),
                               check(f"{name} K10-dkv dv", dv, dv_p))}, \
            (out, lse, da_dst, da_src, dv)


# the additive K9's, K10's and K7's shapes held on every run (one lane
# map each): GAT's two, a head of 32
# columns, ragged widths (no multiple of 4), one column, 16 heads of 32
# (four vectors a lane) and a head of 512 columns (across the warp)
K10_SHAPES = ((8, 8), (1, 16), (4, 32), (3, 5), (2, 3), (1, 1), (16, 32),
              (1, 512))


def k10_case_graphs(dev):
    """The graphs K9 and the additive K10 are held on: ``hub`` (a hub
    destination and a hub source split over pieces on both sides, empty
    rows), ``sixteen`` (every source sends 16 edges, the bench GAT graph's
    CSR rows) and ``no_edges`` (every row empty)."""
    from pgl_tpu_torch import Graph
    rng = np.random.default_rng(21)
    n = 4096
    sixteen = np.stack([np.repeat(np.arange(n), 16),
                        rng.integers(0, n, 16 * n)], axis=1)
    graphs = {"hub": Graph(attention_graph(3000, 40000, seed=1),
                           num_nodes=3000),
              "sixteen": Graph(sixteen, num_nodes=n),
              "no_edges": Graph(np.zeros((0, 2), dtype=np.int64),
                                num_nodes=500)}
    graphs = {k: g.tensor(dev) for k, g in graphs.items()}
    csc, csr = graphs["hub"]._attention_layouts()
    if not (csc.num_partials and csr.num_partials
            and csc.empty_rows.shape[0]):
        raise AssertionError("the hub graph must split rows on both sides "
                             "and have empty rows")
    return graphs


def check_k10_case(tag, g, H, dvh, rate, slope, dev, gen):
    """K9 and the additive K10 on ``g`` at (H, dvh) against float64, the
    same bits on a second run, and zeros on the rows without edges (out,
    lse and d a_dst on CSC's, d a_src and dv on CSR's). Returns the max
    |err| of each kernel."""
    import torch
    lays = g._attention_layouts()
    ins = attention_inputs(g.num_nodes, H, dvh, dev, gen)
    seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                         generator=gen, device=dev)
    e, got = check_attention(tag, lays, ins, rate, seed, slope)
    _, again = check_attention(tag, lays, ins, rate, seed, slope)
    if not all(map(torch.equal, got, again)):
        raise AssertionError(f"{tag} H={H} dvh={dvh} rate={rate} leaky="
                             f"{slope}: two runs differ")
    out, lse, da_dst, da_src, dv = got
    for t, lay in ((out, lays[0]), (lse, lays[0]), (da_dst, lays[0]),
                   (da_src, lays[1]), (dv, lays[1])):
        if t[lay.empty_rows.long()].any():
            raise AssertionError(f"{tag} H={H} dvh={dvh}: an empty row is "
                                 "not zero")
    return e


def phase_attention_kernels(g_gat, dev):
    """Every attention kernel against its float64 plain version at rates 0
    and 0.6 (seed drawn per case), on the small graph at several head
    shapes and on the GAT headline graph at the GAT's; and the runs are
    bit-identical. Then K9 and the additive K10 at ``K10_SHAPES``, rates 0
    and 0.6, leaky 0 and 0.2, on ``k10_case_graphs`` (``check_k10_case``).
    Returns the max |err| per (kernel, H, dvh) on the headline graph."""
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
    # K9 and the additive K10 at every lane map, rate and slope, on a split
    # hub, 16-edge rows and no edges
    k10 = {}
    for tag, g in k10_case_graphs(dev).items():
        for H, dvh in K10_SHAPES:
            for rate in (0.0, 0.6):
                for slope in (0.0, 0.2):
                    e = check_k10_case(tag, g, H, dvh, rate, slope, dev, gen)
                    for k in e:
                        k10[k] = max(k10.get(k, 0.0), e[k])
        print(f"[attention] K9 and K10 {tag} N={g.num_nodes} E="
              f"{g.num_edges} at (H, dvh) in {K10_SHAPES}, rates 0 and 0.6, "
              f"leaky 0 and 0.2: max |err| K9 {k10['gat_fwd']:.3e} K10-dq "
              f"{k10['gat_dq']:.3e} K10-dkv {k10['gat_dkv']:.3e}; same bits "
              "twice; empty rows zero", flush=True)
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
    combine included; and the device's ms by kernel, torch.profiler), its
    plain version's, its bound and the bound of the rows it gathers, at
    rate 0 (the bench GAT) and 0.6 (GAT's defaults). ``runs`` maps a rate to the
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
                    # the device's own time (a call at (1, 16) is shorter
                    # than the host's time to launch it, which `ms` holds)
                    split = kernel_split_ms(fn)
                # each input read once: the node tables, the edge list
                # (and the CSC positions where the CSR pass drops), the
                # work list (items and empty rows; the split rows' list
                # is a few ints); each output written once
                edge_ints = 1 + (kernel == "gat_dkv" and rate > 0)
                work = 4 * lay.k10_items.shape[0] + lay.empty_rows.shape[0]
                nbytes = 4 * (N * (cols_in + cols_out) + E * edge_ints
                              + work)
                # per edge and head: add, leaky, max, 2 exp, 2 scale, the
                # dropout hash (8 integer ops); per column: 2 (fma) in K9,
                # 4 (g.v product and sum, dv) in K10
                per_col = 2 if kernel == "gat_fwd" else 4
                ops = E * (H * (7 + 8 * (rate > 0)) + per_col * C)
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
                bound_ms = max(t_bytes, t_ops) * 1e3
                # the rows each edge gathers, read once: a_src | v (K9,
                # K10-dq), a_dst, lse, delta | g and the CSC position
                # under dropout (K10-dkv)
                gathered = 4 * E * (H + C if kernel != "gat_dkv"
                                    else 3 * H + C + (rate > 0))
                gather_ms = gathered / HBM_BYTES_PER_S * 1e3
                suffix = f"_drop{rate:g}" if rate else ""
                merge_ms = sum(v for k, v in split.items()
                               if k.startswith(("gat_fwd_combine",
                                                "sum_combine")))
                rows.append({
                    "name": f"{kernel}_h{H}_d{dvh}{suffix}", "route": "cuda",
                    "source": ATTN_SOURCE, "replaces": ATTN_REPLACES[kernel],
                    "launches": launches.get((kernel, H, dvh), 0),
                    "max_abs_err": errs[kernel, H, dvh], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None, "share": bound_ms / ms,
                    "gather_bound_ms": gather_ms,
                    "gather_share": gather_ms / ms,
                    "device_ms": sum(split.values()), "split_ms": split,
                    "merge_ms": merge_ms,
                    "shape": {"kernel": kernel, "H": H, "dvh": dvh,
                              "rate": rate, "rows": N, "edges": E,
                              "split_rows": int(lay.split_rows.shape[0]),
                              "items": int(lay.k10_items.shape[0]),
                              "long_items": lay.k10_long,
                              "empty_rows": int(lay.empty_rows.shape[0])}})
                print(f"[timing] {kernel} H={H} dvh={dvh} rate={rate}: "
                      f"kernel {ms:.5f} ms ({rows[-1]['launches']} launches "
                      f"in its run), plain {plain_ms:.5f} ms, bound "
                      f"{bound_ms:.5f} ms ({rows[-1]['bound_by']}; "
                      f"{bound_ms / ms:.3f} of it), gather bound "
                      f"{gather_ms:.5f} ms ({gather_ms / ms:.3f} of it); "
                      f"device {rows[-1]['device_ms']:.5f} ms, the merge of "
                      f"split rows {merge_ms:.5f} of it, by kernel {split}; "
                      f"work list {lay.k10_items.shape[0]} items ("
                      f"{lay.k10_long} long), {lay.empty_rows.shape[0]} "
                      "empty rows", flush=True)
    ak.reset_launches()
    return rows


def kernel_name(key):
    """A profiler kernel key without its return type, namespace and
    parameters: ``dot_dq_staged<8, true, true, true>``, ``sum_combine``
    (a kernel that is no template has no ``void`` in its key)."""
    for prefix in ("void ", "(anonymous namespace)::"):
        if key.startswith(prefix):
            key = key[len(prefix):]
    return key.split("(")[0]


def phase_gat_profile(g, tag="GAT", trainer=None):
    """Where a training step's device time goes (default: the bench GAT's):
    20 steps back to back (one synchronize at the end), then 10 under
    torch.profiler; prints the device time per step by kernel (attention
    kernels by name, with K1's folds on the dedup route; the rest by sum),
    the idle share 1 - busy / back-to-back step time, the eight largest
    device kernels, the device time by kind (``device_kinds``), and the
    host's own time per step (all and the eight largest operators)."""
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
            name = kernel_name(e.key)
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
        "indexing_backward_ms": sum(v for k, v in device.items()
                                    if "indexing_backward" in k),
        "device_top_ms": dict(sorted(device.items(),
                                     key=lambda kv: -kv[1])[:8]),
        "device_ms_by_kind": device_kinds(device),
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
          f"pieces, {csc.split_rows.shape[0]} split rows, additive work "
          f"list {csc.k10_items.shape[0]} items ({csc.k10_long} long), "
          f"{csc.empty_rows.shape[0]} empty rows; CSR "
          f"{csr.pieces.shape[0]} pieces, {csr.split_rows.shape[0]} split "
          f"rows, {csr.k10_items.shape[0]} items ({csr.k10_long} long)",
          flush=True)
    errs = phase_attention_kernels(g, dev)
    phase_attention_mask(dev)
    phase_gat_small(dev)
    per = gat_per_step(g)
    train, by0 = phase_train(g, "GAT", per, gat_trainer)
    train_d, by6 = phase_train(g, "GAT defaults", per,
                               lambda g: gat_trainer(g, defaults=True))
    prof = phase_gat_profile(g)
    rows = phase_attention_timing(g, dev, {0.0: by0, 0.6: by6}, errs)
    # the device's time (torch.profiler): K10 at (1, 16) takes less than
    # the host's time to launch it, which the rows' events hold
    attn = {rate: sum(r["device_ms"] for r in rows
                      if r["shape"]["rate"] == rate) for rate in (0.0, 0.6)}
    events = sum(r["ms"] for r in rows if r["shape"]["rate"] == 0.0)
    print(f"[default] attention device ms per GAT step: {attn[0.0]:.5f} "
          f"(no dropout), {attn[0.6]:.5f} (rate 0.6); by CUDA events "
          f"around each call {events:.5f} (no dropout)", flush=True)
    return rows, {
        "GAT": dict(train, attention_ms_per_step=attn[0.0],
                    attention_event_ms_per_step=events,
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


def run_dedup_attention(att, ins, rate, seed, slope=0.2):
    """K7 and K8 on float32 ``ins`` with leaky slope ``slope``: ``(out,
    lse, d a_dst, d a_src, dv)``, all on node rows."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    a_dst, a_src, v, g = ins
    H = a_dst.shape[1]
    dvh = v.shape[1] // H
    with torch.no_grad():
        out, lse = da._fwd_cuda(a_dst, a_src, v, att, slope, dvh, rate,
                                seed)
        delta = (g.reshape(-1, H, dvh) * out.reshape(-1, H, dvh)).sum(-1)
        return (out, lse) + da._bwd_cuda(a_dst, a_src, v, g, lse, delta,
                                         att, slope, dvh, rate, seed)


def check_dedup_attention(tag, att, ins, rate, seed, got, slope=0.2):
    """``got`` of :func:`run_dedup_attention` against the plain versions in
    float64 on the same inputs (d a_src and dv with the terms scale: a hub
    source sums thousands of them); returns the max |err| of K7 and K8."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    out, lse, da_dst, dsrc, dv = got
    a_dst, a_src, v, g = ins
    H = a_dst.shape[1]
    dvh = v.shape[1] // H
    name = f"{tag} H={H} dvh={dvh} rate={rate} leaky={slope}"
    with torch.no_grad():
        d64 = [t.double() for t in ins]
        out_p, lse_p = da.dedup_attention_reference(*d64[:3], att.layout,
                                                    slope, dvh, rate, seed)
        delta = (d64[3].reshape(-1, H, dvh)
                 * out.double().reshape(-1, H, dvh)).sum(-1)
        bwd = (*d64, lse.double(), delta, att.layout, slope, dvh, rate,
               seed)
        dq_p, dsrc_p, dv_p = da.dedup_bwd_reference(*bwd)
        terms = dedup_bwd_terms(*bwd)
        return {"dedup_fwd": max(check(f"{name} K7 out", out, out_p),
                                 check(f"{name} K7 lse", lse, lse_p)),
                "dedup_bwd": max(check(f"{name} K8 d a_dst", da_dst, dq_p),
                                 check(f"{name} K8 d a_src", dsrc, dsrc_p,
                                       terms[0]),
                                 check(f"{name} K8 dv", dv, dv_p,
                                       terms[1]))}


def dedup_bwd_terms(a_dst, a_src, v, g, lse, delta, layout, slope, dvh,
                    rate, seed):
    """The 2-norm of the terms each node's d a_src and dv sum (``check``'s
    scale for the node walk's sums), in float64."""
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    N, H = a_dst.shape
    dst, urow, _ = da._edge_slots(layout)
    src = layout.uv.long()[urow]
    q, ds, g_e = ak.edge_grads(a_dst, a_src, v, g, lse, delta, dst, src,
                               da.cell_idx(dst, urow), slope, dvh, rate,
                               seed)
    dv = (q[..., None] * g_e).reshape(-1, H * dvh)
    return (ds.new_zeros(N, H).index_add_(0, src, ds * ds).sqrt(),
            dv.new_zeros(N, H * dvh).index_add_(0, src, dv * dv).sqrt())


def k7_case_atts(dev):
    """The count matrices K7 is held on at every lane map (K8 beside it):
    ``multi``, every edge of ``attention_graph(3000, 20000)`` sent two to
    four times (each cell counts at least 2 edges; the hub destination's
    cells split over pieces; rows without cells), and ``no_edges`` (every
    row without cells)."""
    from pgl_tpu_torch import Graph
    rng = np.random.default_rng(22)
    base = attention_graph(3000, 20000, seed=2)
    multi = np.repeat(base, rng.integers(2, 5, len(base)), axis=0)
    atts = {"multi": dedup_attention_of(Graph(
                multi[rng.permutation(len(multi))], num_nodes=3000
            ).tensor(dev), dev),
            "no_edges": dedup_attention_of(Graph(
                np.zeros((0, 2), dtype=np.int64), num_nodes=500
            ).tensor(dev), dev, counts=False)}
    att = atts["multi"]
    if not (att.num_partials and att.k10_long and att.empty_rows.shape[0]
            and int(att.cell_cnt.min()) >= 2):
        raise AssertionError("the multigraph must split a row into pieces, "
                             "have rows without cells and count >= 2 a "
                             "cell")
    return atts


def check_k7_case(tag, att, H, dvh, rate, slope, dev, gen):
    """K7 (and K8) on ``att`` at (H, dvh) against float64, the same bits on
    a second run, and zeros on the rows without cells (out, lse and d
    a_dst). Returns the max |err| of each kernel."""
    import torch
    ins = attention_inputs(att.num_rows, H, dvh, dev, gen)
    seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                         generator=gen, device=dev)
    got = run_dedup_attention(att, ins, rate, seed, slope)
    again = run_dedup_attention(att, ins, rate, seed, slope)
    if not all(map(torch.equal, got, again)):
        raise AssertionError(f"{tag} H={H} dvh={dvh} rate={rate} leaky="
                             f"{slope}: two runs differ")
    empty = att.empty_rows.long()
    if any(t[empty].any() for t in got[:3]):
        raise AssertionError(f"{tag} H={H} dvh={dvh}: a row without cells "
                             "is not zero")
    return check_dedup_attention(tag, att, ins, rate, seed, got, slope)


def phase_dedup_attention_kernels(g_gat, dev):
    """K7 and K8 against their float64 plain versions at rates 0 and 0.6
    (seed drawn per case), on the small graph at several head shapes and
    on the bench GAT graph at the GAT's; a second run and a layout without
    counts give the same bits. Returns the max |err| per (kernel, H, dvh)
    on the bench graph."""
    import torch
    from pgl_tpu_torch import Graph

    small = Graph(attention_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
    atts = {"small": dedup_attention_of(small, dev),
            "headline": g_gat._dedup_attn_aux()}
    if not (atts["small"].num_partials and atts["headline"].num_partials
            and atts["small"].num_node_partials):
        raise AssertionError("both graphs must split rows into pieces, and "
                             "the small graph's hub source its cells")
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
                  f"{e['dedup_fwd']:.3e} K8 {e['dedup_bwd']:.3e}; same bits "
                  "on a second run and without counts", flush=True)
    # K7 at every lane map, rate and slope, on a multigraph with a split
    # hub and rows without cells, and on no cells at all
    for tag, att in k7_case_atts(dev).items():
        k7 = {}
        for H, dvh in K10_SHAPES:
            for rate in (0.0, 0.6):
                for slope in (0.0, 0.2):
                    e = check_k7_case(tag, att, H, dvh, rate, slope, dev,
                                      gen)
                    for k in e:
                        k7[k] = max(k7.get(k, 0.0), e[k])
        print(f"[dedup attention] K7 {tag} N={att.num_rows} E="
              f"{att.layout.num_edges} cells={att.num_cells} items="
              f"{att.k10_items.shape[0]} (long {att.k10_long}) rows without "
              f"cells={att.empty_rows.shape[0]} at (H, dvh) in "
              f"{K10_SHAPES}, rates 0 and 0.6, leaky 0 and 0.2: max |err| "
              f"K7 {k7['dedup_fwd']:.3e} K8 {k7['dedup_bwd']:.3e}; same "
              "bits twice; rows without cells zero", flush=True)
    reset_all_launches()
    return errs


def phase_dedup_attention_mask(dev, n=1 << 20, dot=False):
    """The keep bits of K7 and K8 equal the plain cell mask exactly: on a
    permutation graph every row has one cell and every node one, so with
    a_dst = a_src = 0 (``dot``: q = k = 0 with dsh = 2), v = g = 1 and dvh
    = 1, K7's out and K8's dv node rows (from the node walk) are 1 / (1 -
    rate) where the cell is kept and 0 where it is dropped."""
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
    dst, urow, _ = da._edge_slots(lay)
    key = da.cell_idx(dst, urow)
    dv_row = lay.uv.long()[urow]   # where K8 writes a cell's dv: its node
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
        for name, got in (("K7", out[dst] != 0), ("K8", dv[dv_row] != 0)):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{name} keep bits differ from the plain mask in "
                    f"{int((got != want).sum())} of {want.numel()}")
        if int((dv != 0).sum()) != int(want.sum()):
            raise AssertionError("K8 wrote to a node row without cells")
    reset_all_launches()
    mode = "dot " if dot else ""
    print(f"[dedup {mode}attention] keep bits of K7 and K8 equal the plain "
          f"cell mask over {n} cells x {H} heads, 2 seeds, rate {rate}",
          flush=True)


def dedup_gat_per_step(g):
    """Launches per GAT step on the dedup route: K7 and K8 once at each
    shape, with their second launches where rows (and for K8's node walk,
    nodes) split; no fold (the node walk writes node rows)."""
    att = g._dedup_attn_aux()
    per = {}
    for H, dvh in GAT_SHAPES:
        for kernel in ("dedup_fwd", "dedup_bwd"):
            per[kernel, H, dvh] = 1
            if att.num_partials:
                per[f"{kernel}_combine", H, dvh] = 1
        if att.num_node_partials:
            per["dedup_bwd_node_combine", H, dvh] = 1
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


def phase_dedup_attention_timing(g, dev, runs, errs):
    """Rows at the GAT's shapes on the dedup route: K7 and K8 (each
    wrapper's launches, merges included) at rate 0 and 0.6, beside the
    plain versions, the byte bound and the bound of the rows each gathers,
    each split by kernel (K7: the forward and its merge; K8: row pass,
    node walk) with its device ms (torch.profiler). ``runs`` maps a rate
    to the launches of its training run."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da

    att = g._dedup_attn_aux()
    lay = att.layout
    N, n = g.num_nodes, att.num_cells
    n_pieces = int(att.pieces.shape[0])
    n_node_pieces = int(att.node_pieces.shape[0])
    gen = torch.Generator(device=dev).manual_seed(7)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    n_items = int(att.k10_items.shape[0])
    n_empty = int(att.empty_rows.shape[0])
    shape = {"rows": N, "edges": lay.num_edges, "cells": n,
             "pieces": n_pieces, "split_rows": int(att.split_rows.shape[0]),
             "items": n_items, "long_items": att.k10_long,
             "empty_rows": n_empty,
             "node_pieces": n_node_pieces,
             "split_nodes": int(att.node_split_rows.shape[0]),
             "pairs": lay.num_pairs}
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
                split = kernel_split_ms(lambda: da._bwd_cuda(
                    *bwd, att, 0.2, dvh, rate, seed))
                fwd_split = kernel_split_ms(lambda: da._fwd_cuda(
                    a_dst, a_src, v, att, 0.2, dvh, rate, seed))
            suffix = f"_drop{rate:g}" if rate else ""
            # bytes: each input read once (the node tables; 3 ints a cell
            # in row order, K7's 4 an item and 1 an empty row, K8's row
            # pass 4 a piece; K8 also 3 ints a cell and 4 a piece in node
            # order), each output written once (out and lse; d a_dst, d
            # a_src and dv)
            row_ints = 3 * n + 4 * n_pieces
            node_ints = 3 * n + 4 * n_node_pieces
            fwd_bytes = 4 * (N * (2 * H + C) + 3 * n + 4 * n_items + n_empty
                             + N * (C + H))
            bwd_bytes = 4 * (N * (4 * H + 2 * C) + row_ints + node_ints
                             + N * (2 * H + C))
            # operations a cell and head: add, leaky, max, 2 exp, 2 scale,
            # count multiply (K8: clamp, leaky slope, 2 multiply-adds, each
            # pass), the hash (8 integer ops); a cell and column: 2 (K7's
            # fma), 2 and 4 in K8's passes (g.v, dv)
            per_head = 8 + 8 * drop
            fwd_ops = n * (H * per_head + 2 * C)
            bwd_ops = n * (2 * H * (per_head + 2) + 6 * C)
            # gathered a cell: a_src | v (K7, K8's row pass), a_dst, lse,
            # delta | g (K8's node walk)
            rows_gather = 4 * n * (H + C)
            walk_gather = 4 * n * (3 * H + C)
            for kernel, ms, plain_ms, nbytes, ops, gathered in (
                    ("dedup_fwd", fwd_ms, fwd_plain, fwd_bytes, fwd_ops,
                     rows_gather),
                    ("dedup_bwd", bwd_ms, bwd_plain, bwd_bytes, bwd_ops,
                     rows_gather + walk_gather)):
                timing_row(rows, shape, f"{kernel}_h{H}_d{dvh}{suffix}",
                           kernel, DATTN_SOURCE, DATTN_REPLACES[kernel],
                           launches.get((kernel, H, dvh), 0),
                           errs[kernel, H, dvh], ms, plain_ms, nbytes, ops,
                           None, gathered, H=H, dvh=dvh, rate=rate)
                by_kernel = fwd_split if kernel == "dedup_fwd" else split
                rows[-1]["split_ms"] = by_kernel
                rows[-1]["device_ms"] = sum(by_kernel.values())
            merge_ms = sum(v for k, v in fwd_split.items()
                           if k.startswith("gat_fwd_combine"))
            rows[-2]["merge_ms"] = merge_ms
            print(f"[timing] dedup_fwd H={H} dvh={dvh} rate={rate} by "
                  f"kernel: device {rows[-2]['device_ms']:.5f} ms, the "
                  f"merge of split rows {merge_ms:.5f} of it: {fwd_split}; "
                  f"work list {n_items} items ({att.k10_long} long), "
                  f"{n_empty} rows without cells", flush=True)
            passes = {"row pass": rows_gather, "node walk": walk_gather}
            parts = []
            for name, part_ms in sorted(split.items()):
                what = ("row pass" if name.startswith("dedup_attn_bwd_rows")
                        else "node walk"
                        if name.startswith("dedup_attn_bwd_nodes") else name)
                bound = passes.get(what)
                parts.append(f"{what} ({name}) {part_ms:.5f} ms" + (
                    "" if bound is None else
                    f", gather bound {bound / HBM_BYTES_PER_S * 1e3:.5f} "
                    f"ms ({bound / HBM_BYTES_PER_S * 1e3 / part_ms:.3f} of "
                    "it)"))
            print(f"[timing] dedup_bwd H={H} dvh={dvh} rate={rate} by "
                  "kernel: " + "; ".join(parts), flush=True)
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
          f"layouts and K4 included); K7/K8 work lists {t_att:.3f} "
          f"s on the host. CSC {csc_d.num_pairs} pairs, "
          f"{csc_d.groups.shape[0]} groups, {csc_d.num_partials} partials in "
          f"{csc_d.split_blocks.shape[0]} split blocks, simple "
          f"{csc_d.simple}, max count {csc_d.max_count}, counts "
          f"{csc_d.counts_bytes / 1e6:.1f} MB, uv {csc_d.uv.numel()} rows; "
          f"CSR {csr_d.num_pairs} pairs, counts "
          f"{csr_d.counts_bytes / 1e6:.1f} MB; {att.num_cells} nonzero "
          f"cells, {att.pieces.shape[0]} pieces, {att.split_rows.shape[0]} "
          f"split rows; node order {att.node_pieces.shape[0]} pieces, "
          f"{att.node_split_rows.shape[0]} split nodes", flush=True)
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
    # K7 and K8 once a step at each shape: the device's time
    # (torch.profiler), as the per-edge route's, and CUDA events
    attn, events = ({rate: sum(r[key] for r in rows
                               if r["shape"].get("rate") == rate)
                     for rate in (0.0, 0.6)} for key in ("device_ms", "ms"))
    lower = "dedup" if attn[0.0] < edge_route_ms else "per-edge"
    print(f"[default] attention device ms per bench GAT step: dedup route "
          f"(K7, K8) {attn[0.0]:.5f}, per-edge route (K9, K10) "
          f"{edge_route_ms:.5f}; lower: {lower}; dedup route at rate 0.6 "
          f"(cell mode) {attn[0.6]:.5f}; by CUDA events around each call "
          f"{events[0.0]:.5f} (no dropout)", flush=True)
    return rows, {
        "GAT_dedup": dict(train, attention_ms_per_step=attn[0.0],
                          attention_event_ms_per_step=events[0.0],
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
    destination and a hub source at UniMP's shape, (8, 16, 16) and three
    shapes of GATConv's many-head fallback (dsh 2, leaky 0.2; 4, 8 and 16
    slots a lane), and on each
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
        ((43, 2, 4), 0.2), ((43, 2, 8), 0.2))]
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
                    "route": "cuda", "source": DOT_SOURCE,
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
                                          "gat_graph": {0.0: {}, 0.3: {}}},
                            errs)
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

def run_dedup_dot(att, ins, shape, rate, seed, leaky=0.0):
    """The dot-mode K7 and K8 on float32 ``ins``: ``(out, lse, dq, dk,
    dv)``, dk and dv on node rows (K8's node walk)."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    q, k, v, g = ins
    H, dsh, dvh = shape
    with torch.no_grad():
        out, lse = da._dot_fwd_cuda(q, k, v, att, leaky, dsh, dvh, rate,
                                    seed)
        delta = (g.reshape(-1, H, dvh) * out.reshape(-1, H, dvh)).sum(-1)
        return (out, lse) + da._dot_bwd_cuda(q, k, v, g, lse, delta, att,
                                             leaky, dsh, dvh, rate, seed)


def check_dedup_dot(tag, att, ins, shape, rate, seed, got, leaky=0.0):
    """``got`` of :func:`run_dedup_dot` against the plain versions in
    float64 on the same inputs (the backward on the kernel's lse and
    delta), with ``check``'s rule; dq, dk and dv (node rows) scaled by the
    2-norm of the terms each element sums. Returns the max |err| of K7 and
    K8."""
    import torch
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    out, lse, dq, dk, dv = got
    H, dsh, dvh = shape
    lay = att.layout
    name = f"{tag} H={H} dsh={dsh} dvh={dvh} leaky={leaky} rate={rate}"
    with torch.no_grad():
        q, k, v, g = (t.double() for t in ins)
        out_p, lse_p = da.dedup_dot_reference(q, k, v, lay, dsh, dvh, leaky,
                                              rate, seed)
        errs = {"dedup_dot_fwd": max(check(f"{name} K7 out", out, out_p),
                                     check(f"{name} K7 lse", lse, lse_p))}
        del out_p, lse_p
        delta = (g.reshape(-1, H, dvh)
                 * out.double().reshape(-1, H, dvh)).sum(-1)
        bwd = (q, k, v, g, lse.double(), delta)
        dst, urow, _ = da._edge_slots(lay)
        src = lay.uv.long()[urow]
        qe, ds, g_e = ak.edge_grads(*bwd, dst, src, da.cell_idx(dst, urow),
                                    leaky, dvh, rate, seed, dsh)
        n = q.shape[0]
        scale_q = ak.head_scatter(ds * ds, k[src] ** 2, dst, n).sqrt()
        scale_k = ak.head_scatter(ds * ds, q[dst] ** 2, src, n).sqrt()
        scale_v = ak.head_scatter(qe * qe, g_e.flatten(1) ** 2, src,
                                  n).sqrt()
        del qe, ds, g_e
        dq_p, dk_p, dv_p = da.dedup_dot_bwd_reference(*bwd, lay, dsh, dvh,
                                                      leaky, rate, seed)
        errs["dedup_dot_bwd"] = max(
            check(f"{name} K8 dq", dq, dq_p, scale_q),
            check(f"{name} K8 dk", dk, dk_p, scale_k),
            check(f"{name} K8 dv", dv, dv_p, scale_v))
    return errs


# The bits of the dot-mode K7 (out, lse) and K8's row pass (dq) before the
# cell form, pinned: the sha256 of out | lse | dq (float32 bytes) on each
# case of ``parent_bits_case`` from the kernels of 12a5247
# (``dedup_dot_fwd``, ``dedup_dot_bwd_rows``), as
# experiments/torch_spmm/k1_k10_before_after.py --only k7 printed them on
# an H100 80GB HBM3. The cell form keeps the cells' order, the score's tree
# and the place of the multiplicity, so it must give the same bits.
PARENT_BITS_CASES = (((2, 128, 128), 0.0, 0.0), ((2, 128, 128), 0.0, 0.3),
                     ((8, 16, 16), 0.0, 0.3), ((43, 2, 4), 0.2, 0.3),
                     ((4, 128, 128), 0.0, 0.0), ((3, 8, 5), 0.0, 0.3))
PARENT_BITS = {
    ((2, 128, 128), 0.0, 0.0):
        "c5191302e8bf229b60433d297e172334355137e65de371bc0fe2a4a1b5c4dae2",
    ((2, 128, 128), 0.0, 0.3):
        "33e1d4a30e2cab293da76dc39da98e6a40eb4ab4d4b0eb1bd0a792d4887e73fa",
    ((8, 16, 16), 0.0, 0.3):
        "370bf329f6716eed9662f5f57f5a7729575fa35300f15b8f5967d9668e1f2b6b",
    ((43, 2, 4), 0.2, 0.3):
        "c94d4d7a24136a94dff2e65ec5a6f9cd54be9a7d6034e79d3227d22b39a75330",
    ((4, 128, 128), 0.0, 0.0):
        "97cbfe3509a4732dc0b76649e9a6ab6224044403bb6bd7ccc3ccd4ac7a23dfb7",
    ((3, 8, 5), 0.0, 0.3):
        "18a9052d0816e8663ebe7b528f5410e2ac5043ffdd1737d1e9b6240f7438960b"}


def parent_bits_graph(dev):
    """The small skewed multigraph of the pinned bits (hub destination and
    hub source split), as K7/K8's work lists on ``dev``."""
    from pgl_tpu_torch import Graph
    edges = attention_graph(3000, 40000, seed=4)
    edges[-4000:] = edges[:4000]        # duplicate edges: counts of 2 and up
    return dedup_attention_of(Graph(edges, num_nodes=3000).tensor(dev), dev,
                              counts=False)


def parent_bits_case(att, shape, rate, dev):
    """q, k, v, g (numpy draws, so every torch build gets the same bits)
    and the seed of one pinned case."""
    import torch
    H, dsh, dvh = shape
    rng = np.random.default_rng(H * 10000 + dsh * 100 + dvh)
    n = att.num_rows
    ins = [rng.standard_normal((n, H * w), dtype=np.float32)
           for w in (dsh, dsh, dvh, dvh)]
    ins[0] *= np.float32(dsh ** -0.5)
    seed = torch.tensor([-12345 if rate else 0], dtype=torch.int32,
                        device=dev)
    return tuple(torch.from_numpy(x).to(dev) for x in ins), seed


def bits_digest(*tensors):
    """sha256 of the tensors' float32 bytes, one after the other."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def check_parent_bits(dev):
    """K7-dot's out and lse and K8-dot's dq on each pinned case, digested
    and held against ``PARENT_BITS``; returns the digests."""
    att = parent_bits_graph(dev)
    got = {}
    for shape, leaky, rate in PARENT_BITS_CASES:
        ins, seed = parent_bits_case(att, shape, rate, dev)
        out, lse, dq, _, _ = run_dedup_dot(att, ins, shape, rate, seed,
                                           leaky)
        got[shape, leaky, rate] = bits_digest(out, lse, dq)
    bad = [c for c, d in got.items() if PARENT_BITS.get(c) != d]
    if bad:
        raise AssertionError(f"dot-mode K7/K8 bits differ from 12a5247's "
                             f"on {bad}: {got}")
    reset_all_launches()
    return got


def phase_dedup_dot_kernels(g_gat, dev):
    """The dot-mode K7 and K8 against their float64 plain versions at rates
    0 and 0.3 (seed drawn per case): on the small graph at UniMP's shape,
    (8, 16, 16), (4, 64, 8) (dsh != dvh) and GATConv's (43, 2, 4) with a
    leaky relu, and on the bench GAT graph at UniMP's shape; a second run
    and a layout without counts give the same bits; out, lse and dq have
    12a5247's bits on the pinned cases. Returns the max |err| per (tag,
    kernel)."""
    import torch
    from pgl_tpu_torch import Graph

    small = Graph(attention_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
    atts = {"small": dedup_attention_of(small, dev),
            "headline": g_gat._dedup_attn_aux()}
    if not (atts["small"].num_partials and atts["headline"].num_partials
            and atts["small"].num_node_partials):
        raise AssertionError("both graphs must split rows, and the small "
                             "one a node, into pieces")
    bare = {tag: without_counts(att) for tag, att in atts.items()}
    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {}
    cases = [("small", shape, 0.0) for shape in (UNIMP_SHAPE, (8, 16, 16),
                                                 (4, 64, 8))]
    cases += [("small", (43, 2, 4), 0.2), ("headline", UNIMP_SHAPE, 0.0)]
    for tag, shape, leaky in cases:
        att = atts[tag]
        ins = dot_inputs(att.num_rows, shape, dev, gen)
        for rate in (0.0, 0.3):
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                                 generator=gen, device=dev)
            got = run_dedup_dot(att, ins, shape, rate, seed, leaky)
            for what, other in (("a second run", att),
                                ("the layout without counts", bare[tag])):
                if not all(map(torch.equal, got, run_dedup_dot(
                        other, ins, shape, rate, seed, leaky))):
                    raise AssertionError(f"{tag} {shape} rate={rate}: "
                                         f"{what} differs")
            e = check_dedup_dot(tag, att, ins, shape, rate, seed, got, leaky)
            del got
            for k, v in e.items():
                errs[tag, k] = max(errs.get((tag, k), 0.0), v)
            print(f"[dedup dot attention] {tag} N={att.num_rows} E="
                  f"{att.layout.num_edges} cells={att.num_cells} (H, dsh, "
                  f"dvh)={shape} leaky={leaky} rate={rate}: max |err| K7 "
                  f"{e['dedup_dot_fwd']:.3e} K8 {e['dedup_dot_bwd']:.3e}; "
                  "same bits on a second run and without counts",
                  flush=True)
    digests = check_parent_bits(dev)
    print(f"[dedup dot attention] out, lse and dq have 12a5247's bits on "
          f"{len(digests)} pinned cases", flush=True)
    reset_all_launches()
    return errs


def unimp_dedup_per_step(g):
    """Launches per UniMP step on the dedup route: K7 and K8 in dot mode
    for layers 0 and 1 (with their second launches where rows or nodes
    split); no fold (K8's node walk writes dk and dv on node rows)."""
    att = g._dedup_attn_aux()
    per = {}
    for kernel in DDOT_KERNELS:
        per[(kernel, *UNIMP_SHAPE)] = 2
        if att.num_partials:
            per[(f"{kernel}_combine", *UNIMP_SHAPE)] = 2
    if att.num_node_partials:
        per[("dedup_dot_bwd_node_combine", *UNIMP_SHAPE)] = 2
    return per


def kernel_split_ms(fn, iters=10):
    """Device ms per call of ``fn`` by kernel (torch.profiler over
    ``iters`` warm calls), keyed by the kernel's name and template
    arguments."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = kernel_name(e.key)
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            split[name] = split.get(name, 0.0) + us / 1e3 / iters
    return split


def phase_dedup_dot_timing(g, dev, runs, errs):
    """Rows at UniMP's shape on the bench GAT graph's dedup route: the dot
    K7 and K8 (each wrapper's launches, merges included) at rates 0 and
    0.3, beside the plain versions, the table bound (each input read once,
    each output written once) and the gather bound (the rows each cell
    gathers, read once a cell: k | v in K7 and K8's row pass, q | g | lse |
    delta in K8's node walk); K8's time split by kernel (torch.profiler),
    each pass beside its own gather bound. ``runs`` maps a rate to the
    launches of its training run."""
    import torch
    from pgl_tpu_torch.ops.kernels import dedup_attention as da

    att = g._dedup_attn_aux()
    lay = att.layout
    N, n = g.num_nodes, att.num_cells
    H, dsh, dvh = shape = UNIMP_SHAPE
    DS, C = H * dsh, H * dvh
    n_pieces = int(att.pieces.shape[0])
    n_node_pieces = int(att.node_pieces.shape[0])
    gen = torch.Generator(device=dev).manual_seed(12)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    info = {"rows": N, "edges": lay.num_edges, "cells": n,
            "pieces": n_pieces, "split_rows": int(att.split_rows.shape[0]),
            "node_pieces": n_node_pieces,
            "split_nodes": int(att.node_split_rows.shape[0]), "H": H,
            "dsh": dsh, "dvh": dvh}
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
            split = kernel_split_ms(lambda: da._dot_bwd_cuda(
                *bwd, att, 0.0, *args))
        del out, lse, delta, bwd
        # bytes: each input read once (the node tables; 3 ints a cell and 4
        # a piece in row order; K8 also 3 ints a cell and 4 a piece in node
        # order), each output written once (out and lse; dq, dk and dv)
        row_ints = 3 * n + 4 * n_pieces
        node_ints = 3 * n + 4 * n_node_pieces
        fwd_bytes = 4 * (N * (2 * DS + C) + row_ints + N * (C + H))
        bwd_bytes = 4 * (N * (2 * DS + 2 * C + 2 * H) + row_ints + node_ints
                         + N * (2 * DS + C))
        # operations a cell: the score (2 a score column), 2 a value
        # column (K7's fma; K8's g.v in both passes, dv), 2 a score column
        # for dq and dk; a head: max, 2 exp, 2 scale, count multiply, the
        # hash (8 integer ops), K8's clamp and two multiply-adds a pass
        per_head = 6 + 8 * drop
        fwd_ops = n * (2 * DS + 2 * C + H * per_head)
        bwd_ops = n * (8 * DS + 6 * C + 2 * H * (per_head + 3))
        # gathered a cell: k|v rows (K7, K8's row pass), q|g rows, lse and
        # delta (K8's node walk)
        fwd_gather = 4 * n * (DS + C)
        walk_gather = 4 * n * (DS + C + 2 * H)
        bwd_gather = fwd_gather + walk_gather
        suffix = f"_drop{rate:g}" if drop else ""
        for kernel, ms, plain_ms, nbytes, ops, gathered in (
                ("dedup_dot_fwd", fwd_ms, fwd_plain, fwd_bytes, fwd_ops,
                 fwd_gather),
                ("dedup_dot_bwd", bwd_ms, bwd_plain, bwd_bytes, bwd_ops,
                 bwd_gather)):
            timing_row(rows, info, f"{kernel}_h{H}_s{dsh}_d{dvh}{suffix}",
                       kernel, DOT_SOURCE, DDOT_REPLACES[kernel],
                       launches.get((kernel, *shape), 0),
                       errs["headline", kernel], ms, plain_ms, nbytes, ops,
                       None, gathered, rate=rate)
        passes = {"row pass": fwd_gather, "node walk": walk_gather}
        parts = []
        for name, part_ms in sorted(split.items()):
            what = ("row pass" if name.startswith("dot_dq_staged") else
                    "node walk" if name.startswith("dot_dkv_staged") else
                    name)
            bound = passes.get(what)
            parts.append(f"{what} ({name}) {part_ms:.5f} ms" + (
                "" if bound is None else
                f", gather bound {bound / HBM_BYTES_PER_S * 1e3:.5f} ms "
                f"({bound / HBM_BYTES_PER_S * 1e3 / part_ms:.3f} of it)"))
        rows[-1]["split_ms"] = split
        print(f"[timing] dedup_dot_bwd rate={rate} by kernel: "
              + "; ".join(parts), flush=True)
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
    # the node order's one sort, timed alone on keys of the same size and
    # spread (the row-ordered cells' nodes)
    nodes = att.cell_src.cpu().numpy()
    t0 = time.perf_counter()
    np.argsort(nodes, kind="stable")
    t_sort = time.perf_counter() - t0
    print(f"[graph] UniMP dedup: bench GAT graph N={g.num_nodes} "
          f"E={g.num_edges} under DEDUP, tensor() {t_tensor:.3f} s (K4 "
          f"included), K7/K8 work lists {t_att:.3f} s (the node "
          f"order's sort {t_sort:.4f} s); {att.num_cells} cells, "
          f"{att.pieces.shape[0]} pieces, {att.split_rows.shape[0]} split "
          f"rows, {att.node_pieces.shape[0]} node pieces, "
          f"{att.node_split_rows.shape[0]} split nodes", flush=True)
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
    attn = {rate: 2 * sum(r["ms"] for r in rows
                          if r["shape"].get("rate") == rate)
            for rate in (0.0, 0.3)}
    gather = 2 * sum(r["gather_bound_ms"] for r in rows
                     if r["shape"].get("rate") == 0.0)
    lower = "dedup" if attn[0.0] < edge_route_ms else "per-edge"
    print(f"[default] attention device ms per UniMP step on the bench GAT "
          f"graph: dedup route (K7, K8 dot) {attn[0.0]:.5f} (no "
          f"dropout), {attn[0.3]:.5f} (rate 0.3, cell mode); per-edge route "
          f"(K9, K10 dot) {edge_route_ms:.5f}; lower: {lower}; gather bound "
          f"of the dedup route {gather:.5f} ms; step median "
          f"{train['step_ms']:.4f} ms (no dropout), {train_c['step_ms']:.4f} "
          f"ms (cell dropout)", flush=True)
    return rows, {
        "UniMP_dedup": dict(train, attention_ms_per_step=attn[0.0],
                            gather_bound_ms_per_step=gather,
                            tensor_s=t_tensor, work_lists_s=t_att,
                            node_sort_s=t_sort, profile=prof),
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


def spread_weights(n, dev, gen):
    """``n`` float32 weights of either sign over six orders of magnitude
    (|w| from 1e-3 to 1e3, log-uniform): a cell's sum needs all three bf16
    planes of the weighted K6's C."""
    import torch
    mag = torch.pow(10.0, torch.rand(n, device=dev, generator=gen) * 6 - 3)
    sign = torch.randint(0, 2, (n,), device=dev, generator=gen) * 2 - 1
    return (sign * mag).float().contiguous()


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


# K1w on every kind of work item: widths and the heads that divide them
K1W_ITEM_CASES = {1: (1,), 3: (1, 3), 8: (1, 2, 8), 16: (1, 4),
                  64: (1, 8), 128: (1, 2)}


def check_k1w_items(case, D, aligned, dev, gen):
    """K1w over every kind of work item of ``case`` (the graph of
    ``k1_case_edges`` on the card: a hub's pieces, rows of their own,
    packs of short rows, empty rows) at width D for each head count of
    ``K1W_ITEM_CASES``, mul and add, on 16-byte or unaligned tables (the
    scalar path): the forward, dx with dw and dw alone against float64,
    each the same bits twice. Returns the max |err|."""
    import torch
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    csc, csr = case._spmm_layouts
    n, E = case.num_nodes, case.num_edges
    err = 0.0
    for H in K1W_ITEM_CASES[D]:
        for op in ("mul", "add"):
            x, cot = (k1_features(n, D, dev, gen, aligned) for _ in range(2))
            w = torch.randn(E, H, device=dev, generator=gen)

            def run():
                out = sk._weighted_forward(x, w, csc, op)
                dx, dw = sk._weighted_backward(cot, x, w, csr, op, True,
                                               True)
                return out, dx, dw, sk._weighted_backward(
                    cot, x, w, csr, op, False, True)[1]

            first, again = run(), run()
            torch.cuda.synchronize()
            if not all(map(torch.equal, first, again)):
                raise AssertionError(f"K1w items {op} H={H} D={D} aligned="
                                     f"{aligned}: two runs differ")
            tag = f"K1w items {op} H={H} D={D} aligned={aligned}"
            e = check_weighted(tag, x, w, cot, csc, csr, op, *first[:3])
            e["dw alone"] = check_weighted(f"{tag} dw alone", x, w, cot,
                                           csc, csr, op, None, None,
                                           first[3])["dw"]
            err = max(err, *e.values())
    return err


def phase_weighted_kernels(g_head, g_dedup, dev):
    """K1w against float64 over every kind of work item (``check_k1w_items``
    at each width of ``K1W_ITEM_CASES``), at every case of ``K1W_CASES`` on
    the skewed small graph and the headline graph, and with one gradient
    alone (dx, then dw); two runs give the same bits. Then the weighted K6
    on the
    headline graph under ``DEDUP``: forward, dx and dw against float64,
    the same bits twice, and forward and dx within the tolerance of K1w on
    the same inputs (its dw is K1w's own pass)."""
    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(9)
    edges, n = k1_case_edges()
    case = Graph(edges, num_nodes=n).tensor(dev)
    err = max(check_k1w_items(case, D, aligned, dev, gen)
              for D in K1W_ITEM_CASES for aligned in (True, False))
    kinds = case._spmm_layouts[0].items[:, 3].cpu()
    print(f"[weighted] K1w work items (CSC: {int((kinds >= 0).sum())} "
          f"pieces of split rows, {int((kinds == -1).sum())} whole rows, "
          f"{int((kinds < -1).sum())} packs) at D in "
          f"{tuple(K1W_ITEM_CASES)} with every H of each, mul and add, "
          f"vector and scalar loads: max |err| {err:.3e} (forward, dx with "
          "dw, dw alone); same bits on a second run", flush=True)
    small = Graph(skewed_graph(3000, 40000, seed=1), num_nodes=3000
                  ).tensor(dev)
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
    for D, spread in ((16, False), (64, False), (64, True)):
        x = torch.randn(g_dedup.num_nodes, D, device=dev, generator=gen)
        w = (spread_weights(g_dedup.num_edges, dev, gen) if spread else
             torch.randn(g_dedup.num_edges, device=dev, generator=gen))
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
        print(f"[weighted] headline weighted K6 D={D}"
              f"{' (weights over six orders of magnitude)' if spread else ''}"
              f": max |err| fwd "
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
        part = torch.empty(lay.item_partials, D, device=dev)
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
        # table x), indices, edge ids and work items, the weights (not read
        # by add's backward), out (and dw) written once
        struct = 8 * E + 16 * lay.items.shape[0]
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
        k1_bytes = 2 * table + 4 * E + 16 * lay.items.shape[0]
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
    # the launch without dx does not read them), the work items
    nbytes = 2 * 4 * N * D + 12 * E + 16 * csr.items.shape[0]
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
        part = torch.empty(k1.item_partials, D, device=dev)
        ms = median_ms(lambda: sk._launch(t, k1, res, part), 20)
        plain_ms = median_ms(lambda: sk.spmm_reference(t, k1), 5)
        lib_ms = median_ms(lambda: torch.sparse.mm(A, t), 20)
        with torch.no_grad():
            err = check_spmm(f"timed K1 {k1.kind}", res, t, k1)
        k1_bytes = 4 * (E * D + E + N + 1 + N * D) + 16 * k1.items.shape[0]
        timing_row(rows, dict(info, op=None), f"{k1.kind}_k1_d{D}",
                   "spmm", SOURCE, SDDMM_REPLACES,
                   launches.get((k1.kind, D), 0), err, ms, plain_ms, k1_bytes,
                   E * D, lib_ms, layout=k1.kind,
                   items=int(k1.items.shape[0]),
                   split_rows=int(k1.item_split_rows.shape[0]))
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
          f"with the tail, by_src {lay.by_src.items.shape[0]} work items, "
          f"by_dst {lay.by_dst.items.shape[0]} work items", flush=True)
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


# -- phase 11: the layer zoo (nn's conv layers and their models) on K1 ------

# the models of phase 11, 128 features in and 16 classes out as the
# headline: (b) GraphSage at bench.py:370's widths and the citation
# benchmark's GCNII (examples/citation_benchmark/train.py:46); (c) the rest
# at the reference's defaults. The keyword arguments of the
# pgl_tpu_torch.models class that the name's first word names.
ZOO_MODELS = {
    "GraphSage": dict(num_layers=2, hidden_size=128, aggr_func="mean"),
    "DeepGCNII": dict(hidden_size=64, k_hop=16),
    "DeepGCNII remat": dict(hidden_size=64, k_hop=16, remat=True),
    "APPNPModel": {}, "GPRGNN": {}, "ChebNetII": {}, "BernNet": {},
    "SGC": {}, "SSGC": {}, "GIN": {},
}
# K1 launches a training step, from the code (counted on the CPU by
# tests/test_torch_models_zoo.py): every hop one K1 over CSC forward and,
# where its input carries a gradient, one over CSR backward; a layer whose
# input is the data (GraphSage's and GIN's first, SGC's and SSGC's hops)
# has none; remat recomputes GCNII's 16 forwards in the backward. BernNet:
# 10 hops of (I + Â), then 1 + 2 + ... + 10 of (I - Â).
ZOO_PER_STEP = {
    "GraphSage": {("csc", 128): 2, ("csr", 128): 1},
    "DeepGCNII": {("csc", 64): 16, ("csr", 64): 16},
    "DeepGCNII remat": {("csc", 64): 32, ("csr", 64): 16},
    "APPNPModel": {("csc", 16): 10, ("csr", 16): 10},
    "GPRGNN": {("csc", 16): 10, ("csr", 16): 10},
    "ChebNetII": {("csc", 16): 10, ("csr", 16): 10},
    "BernNet": {("csc", 16): 65, ("csr", 16): 65},
    "SGC": {("csc", 128): 2},
    "SSGC": {("csc", 128): 16},
    "GIN": {("csc", 128): 1, ("csc", 64): 4, ("csr", 64): 4},
}


def zoo_model(name, device):
    """Phase 11's model ``name`` (``ZOO_MODELS``) on ``device``, weights
    and dropout generators from seed 0."""
    import torch
    from pgl_tpu_torch import models
    return getattr(models, name.split()[0])(
        128, 16, generator=torch.Generator().manual_seed(0), device=device,
        **ZOO_MODELS[name])


def gin_host(num_graphs=64, num_nodes=2048):
    """A ``disjoint`` batch of ``num_graphs`` powerlaw graphs of
    ``num_nodes`` nodes, degree 16 and 128 features (seeds 0, 1, ...) and
    its graph labels (16 classes, seed 0)."""
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.datasets import powerlaw_graph
    g = Graph.disjoint([powerlaw_graph(num_nodes, 16, feat_dim=128, seed=s)
                        for s in range(num_graphs)])
    return g, np.random.default_rng(0).integers(0, 16, num_graphs)


def zoo_trainer(name, labels=None):
    """A trainer for ``phase_train``: model ``name`` on the graph's device
    and a function that takes one Adam step (lr 1e-3, training, the
    reference's dropouts) and returns its loss. Labels: ``labels`` (GIN's
    graph labels) or the headline's (seed 0)."""
    def trainer(g):
        import torch
        from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
        x = g.node_feat["h"]
        y = labels if labels is not None else np.random.default_rng(
            0).integers(0, 16, g.num_nodes)
        y = torch.as_tensor(np.asarray(y, np.int64), device=x.device)
        model = zoo_model(name, x.device)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = ce(model(g, x, True), y).mean()
            loss.backward()
            opt.step()
            return loss.detach()

        return model, step
    return trainer


def zoo_layer_cases():
    """(name, make(device), call(module, graph, x)) for every layer of the
    zoo on a 16-wide feature."""
    import torch
    from pgl_tpu_torch import nn as gnn

    def gen():
        return torch.Generator().manual_seed(0)

    cases = [(f"GraphSageConv {a}",
              lambda d, a=a: gnn.GraphSageConv(16, 8, aggr_func=a,
                                               generator=gen(), device=d),
              lambda m, g, x: m(g, x, "relu"))
             for a in ("sum", "mean", "max", "min")]
    cases += [
        ("APPNP", lambda d: gnn.APPNP(k_hop=4), None),
        ("LightGCNConv", lambda d: gnn.LightGCNConv(), None),
        ("SGCConv", lambda d: gnn.SGCConv(16, 8, k_hop=3, generator=gen(),
                                          device=d), None),
        ("SSGCConv", lambda d: gnn.SSGCConv(16, 8, k_hop=4, bias=True,
                                            generator=gen(), device=d),
         None),
        ("GPRConv", lambda d: gnn.GPRConv(16, 12, 8, k_hop=4,
                                          generator=gen(), device=d), None),
        ("GCNII", lambda d: gnn.GCNII(16, activation="relu", k_hop=4,
                                      generator=gen(), device=d), None),
        ("GINConv", lambda d: gnn.GINConv(16, 8, activation="relu",
                                          init_eps=0.3, train_eps=True,
                                          generator=gen(), device=d), None),
        ("NGCFConv", lambda d: gnn.NGCFConv(16, 8, generator=gen(),
                                            device=d), None),
        ("BernProp", lambda d: gnn.BernProp(k_hop=4, device=d), None),
        ("ChebProp", lambda d: gnn.ChebProp(k_hop=4, device=d), None)]
    cases += [(f"GraphPool {p}", lambda d, p=p: gnn.GraphPool(p), None)
              for p in ("sum", "mean", "max", "min")]
    cases.append(("GraphNorm", lambda d: gnn.GraphNorm(), None))
    return cases


def zoo_small_models():
    """(name, make(device)) for every model of the zoo at small widths
    (16 features, 3 classes), GraphSage with each ``aggr_func``."""
    import torch
    from pgl_tpu_torch import models

    def gen():
        return torch.Generator().manual_seed(0)

    cases = [(f"GraphSage {a}",
              lambda d, a=a: models.GraphSage(16, 3, hidden_size=16,
                                              aggr_func=a, generator=gen(),
                                              device=d))
             for a in ("sum", "mean", "max", "min")]
    for cls, kw in (("GIN", dict(num_layers=3, hidden_size=16)),
                    ("DeepGCNII", dict(hidden_size=16, k_hop=6)),
                    ("APPNPModel", dict(hidden_size=16)),
                    ("SGC", {}), ("SSGC", {}),
                    ("GPRGNN", dict(hidden_size=16)),
                    ("BernNet", dict(hidden_size=16, k_hop=5)),
                    ("ChebNetII", dict(hidden_size=16, k_hop=5))):
        cases.append((cls, lambda d, cls=cls, kw=kw: getattr(models, cls)(
            16, 3, generator=gen(), device=d, **kw)))
    return cases


def _zoo_run(make, call, host, dev, x_grad=True):
    """Output and gradients (parameters, and the input with ``x_grad``)
    of ``make(dev)`` on ``host`` under a fixed cotangent (seed 2), moved
    to the CPU."""
    import torch
    g = host.tensor(dev)
    module = make(dev)
    x = g.node_feat["h"].clone().requires_grad_(x_grad)
    out = call(module, g, x) if call is not None else module(g, x)
    w = torch.as_tensor(np.random.default_rng(2).normal(
        size=tuple(out.shape)).astype(np.float32), device=dev)
    (out * w).sum().backward()
    grads = {k: p.grad.cpu() for k, p in module.named_parameters()}
    if x_grad:
        grads["input"] = x.grad.cpu()
    return out.detach().cpu(), grads


def phase_zoo_small(dev):
    """(a) The loss on a label outside the classes; every layer and model
    of the zoo, CUDA against the CPU with the same weights (evaluation: no
    dropout), output and gradients at ``1e-4 * max(1, |cpu|)``, on the 300-node community graph (pools and GIN on a
    ``disjoint`` of three); then ``remat`` against none for ``GCN``,
    ``GraphSage`` and ``DeepGCNII`` on the card, training at dropout 0.6:
    two steps' outputs and gradients the same bits."""
    import torch
    from pgl_tpu_torch import Graph, models
    from pgl_tpu_torch.datasets import community_graph
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

    # a label outside the classes selects no logit: the row's log-sum-exp,
    # and no device-side assert
    got = ce(torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 1.0]], device=dev),
             torch.tensor([2, -1], device=dev)).cpu()
    check("cross-entropy, label -1", got,
          torch.tensor([0.4076059, 1.5514448]))

    single, _ = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                avg_degree=8, seed=5)
    batched = Graph.disjoint([community_graph(n, 3, 16, 6, seed=s)[0]
                              for n, s in ((90, 1), (120, 2), (60, 3))])
    cases = [(name, make, call, batched if name.startswith("Graph")
              and not name.startswith("GraphSage") else single)
             for name, make, call in zoo_layer_cases()]
    cases += [(name, make, lambda m, g, x: m(g, x),
               batched if name == "GIN" else single)
              for name, make in zoo_small_models()]
    for name, make, call, host in cases:
        reset_all_launches()
        cpu = _zoo_run(make, call, host, "cpu")
        gpu = _zoo_run(make, call, host, dev)
        # sum and mean reach K1; max, min and the pools the segment path
        k1 = sum(v for k, v in all_launches().items()
                 if k[0] in ("csc", "csr"))
        plain = name.endswith(("max", "min")) or name.startswith(
            ("GraphPool", "GraphNorm"))
        if bool(k1) == plain:
            raise AssertionError(f"small {name}: K1 launched {k1} times")
        e = check(f"small {name} output", gpu[0], cpu[0])
        for k in cpu[1]:
            e = max(e, check(f"small {name} grad {k}", gpu[1][k], cpu[1][k]))
        print(f"[zoo] small {name}, CUDA vs CPU: max |err| {e:.3e}",
              flush=True)
    reset_all_launches()

    host = single
    for cls, kw in (("GCN", dict(num_layers=3, hidden_size=16)),
                    ("GraphSage", dict(hidden_size=16)),
                    ("DeepGCNII", dict(hidden_size=16, k_hop=6))):
        runs = []
        for remat in (False, True):
            g = host.tensor(dev)
            model = getattr(models, cls)(
                16, 3, dropout=0.6, remat=remat, generator=torch.Generator(
                    ).manual_seed(0), device=dev, **kw)
            steps = []
            for _ in range(2):
                model.zero_grad(set_to_none=True)
                out = model(g, g.node_feat["h"], True)
                out.square().sum().backward()
                steps.append((out.detach().clone(),
                              {k: p.grad.clone()
                               for k, p in model.named_parameters()}))
            runs.append(steps)
        for (o0, g0), (o1, g1) in zip(*runs):
            if not torch.equal(o0, o1) or any(not torch.equal(g0[k], g1[k])
                                              for k in g0):
                raise AssertionError(f"{cls} remat=True differs from "
                                     "remat=False at dropout 0.6")
        print(f"[zoo] {cls} remat=True against remat=False, training at "
              f"dropout 0.6, two steps: the same bits (output and "
              f"{len(runs[0][0][1])} gradients)", flush=True)


def zoo_steps(g, name, trainer, steps=3):
    """(c) ``steps`` Adam steps of ``name`` on ``g``: asserts its K1
    launches a step (``ZOO_PER_STEP``) and finite losses; returns the
    losses and the median step ms."""
    import torch
    _, step = trainer(g)
    reset_all_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = {k: v for k, v in all_launches().items() if v}
    want = {k: v * steps for k, v in ZOO_PER_STEP[name].items()}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses not finite: {losses}")
    step_ms = float(np.median(times)) * 1e3
    print(f"[zoo {name}] {steps} steps: loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; median step {step_ms:.4f} ms (the first "
          f"{times[0] * 1e3:.4f}); K1 launches a step "
          f"{dict(sorted(ZOO_PER_STEP[name].items()))}", flush=True)
    return {"step_ms": step_ms, "losses": losses}


def phase_zoo(dev, host, smi):
    """The layer zoo: (a) small parity and remat; (b) GraphSage and
    DeepGCNII (also with remat) trained at full width on the headline with
    profiles; (c) the other models 3 steps each. Returns the step line's
    entries."""
    import torch

    phase_zoo_small(dev)
    g = headline_graph(False, host)
    steps = {}
    for name in ("GraphSage", "DeepGCNII", "DeepGCNII remat"):
        train, _ = phase_train(g, name, ZOO_PER_STEP[name],
                               zoo_trainer(name))
        steps[name] = train
    for name in ("GraphSage", "DeepGCNII"):
        prof = phase_gat_profile(g, name, zoo_trainer(name))
        k1 = sum(v for k, v in prof["attention_kernels_ms"].items()
                 if k.startswith("spmm_"))
        steps[name].update(profile=prof, k1_ms_per_step=k1)
        print(f"[zoo {name}] {smi}: step {steps[name]['step_ms']:.4f} ms, "
              f"K1 device {k1:.5f} ms a step, device busy "
              f"{prof['device_busy_ms_per_step']:.5f} ms, idle share "
              f"{prof['idle_share']:.4f}, peak memory "
              f"{steps[name]['peak_mib']:.1f} MiB", flush=True)
    print(f"[zoo DeepGCNII remat] {smi}: step "
          f"{steps['DeepGCNII remat']['step_ms']:.4f} ms, peak memory "
          f"{steps['DeepGCNII remat']['peak_mib']:.1f} MiB against "
          f"{steps['DeepGCNII']['peak_mib']:.1f} MiB without", flush=True)
    for name in ("APPNPModel", "GPRGNN", "ChebNetII", "BernNet", "SGC",
                 "SSGC"):
        steps[name] = zoo_steps(g, name, zoo_trainer(name))
    del g
    torch.cuda.empty_cache()
    gin, labels = gin_host()
    g = gin.tensor()
    steps["GIN"] = zoo_steps(g, "GIN", zoo_trainer("GIN", labels))
    print(f"[zoo GIN] a disjoint of {g.num_graph} graphs, N={g.num_nodes} "
          f"E={g.num_edges}, GraphPool over each", flush=True)
    reset_all_launches()
    return {f"zoo {k}": v for k, v in steps.items()}


# -- phase 12: the heterogeneous path, readouts, pooling, LSTM aggregation ---

MAG_ETYPES = ("cites", "writes", "writed_by")
# 260,000 authors at the UniMP graph's 169,343 papers (ogbn-mag has
# 1,134,649 for 736,389: 1.54 a paper) and ogbn-mag's author-writes-paper
# edges (7,145,660: 9.7 a paper)
MAG_AUTHORS_PER_PAPER = 260_000 / UNIMP_NODES
MAG_WRITES_PER_PAPER = 9.7
# dot-kernel launches an R-UniMP step: layer 0 (concat) runs K9, K10-dq and
# K10-dkv once per edge type; the last layer (concat=False) takes the
# edge-space composition, no kernel
RUNIMP_PER_STEP = {(k, *UNIMP_SHAPE): len(MAG_ETYPES) for k in DOT_KERNELS}
# K1 an RGCN step (hidden 32, 40 classes): each layer's mean is K1 over CSC
# once per edge type, and its gradient over CSR (layer 0's too: its input
# x @ W carries W's gradient)
RGCN_PER_STEP = {("csc", 32): 3, ("csr", 32): 3, ("csc", 40): 3,
                 ("csr", 40): 3}
# K1 a step of the readout models on motif graphs (8 features, hidden 32):
# GIN's first sum runs on the data (no gradient), its other two each way;
# GMT's GMPool_G adds layer_k's and layer_v's GCNConv at 32 each way;
# SAGPool's score GCNConv(32, 1) runs at width 1, and the second GCN at 32
READOUT_GIN = {("csc", 8): 1, ("csc", 32): 2, ("csr", 32): 2}
READOUT_PER_STEP = {
    **{p: READOUT_GIN for p in ("sum", "mean", "max", "GlobalAttention",
                                "Set2Set")},
    "GMT": {("csc", 8): 1, ("csc", 32): 4, ("csr", 32): 4},
    **{f"SAGPool {m}": {("csc", 8): 1, ("csc", 1): 1, ("csr", 1): 1,
                        ("csc", 32): 1, ("csr", 32): 1}
       for m in ("dynamic", "static")}}
MOTIF_GRAPHS = 4096


def mag_host(num_papers=UNIMP_NODES, avg_degree=116, seed=0):
    """An ogbn-mag-shaped HeterGraph (``examples/r_unimp/train.py:35-63``'s
    relations) and its labels: the UniMP graph's papers (``community_graph
    (num_papers, 40, feat_dim=128, avg_degree)``, their labels and
    ``cites``), then ``MAG_AUTHORS_PER_PAPER`` authors a paper after them
    in the same node space, each of the community of a random paper;
    ``writes`` draws
    ``MAG_WRITES_PER_PAPER`` edges a paper, author (uniform) -> a paper of
    the author's community, ``writed_by`` reverses them. An author's
    features are the mean of its papers' (zeros for one without papers,
    as R-UniMP's MAG240M pipeline fills authors); its label is -1.
    Returns ``(hg, labels, num_papers)``."""
    import torch
    from pgl_tpu_torch import HeterGraph
    from pgl_tpu_torch.datasets import community_graph

    papers, labels = community_graph(num_nodes=num_papers, num_classes=40,
                                     feat_dim=128, avg_degree=avg_degree,
                                     seed=seed)
    rng = np.random.default_rng(seed + 1)
    num_authors = round(MAG_AUTHORS_PER_PAPER * num_papers)
    E = round(MAG_WRITES_PER_PAPER * num_papers)
    comm = labels[rng.integers(0, num_papers, num_authors)]
    author = rng.integers(0, num_authors, E)
    order = np.argsort(labels, kind="stable")
    count = np.bincount(labels, minlength=40)
    start = np.cumsum(count) - count
    c = comm[author]
    paper = order[start[c] + (rng.random(E) * count[c]).astype(np.int64)]
    pfeat = torch.as_tensor(papers.node_feat["h"])
    a = torch.as_tensor(author)
    afeat = torch.zeros(num_authors, 128).index_add_(
        0, a, pfeat.index_select(0, torch.as_tensor(paper)))
    afeat /= torch.bincount(a, minlength=num_authors).clamp(min=1)[:, None]
    writes = np.stack([num_papers + author, paper], axis=1)
    hg = HeterGraph({"cites": papers.edges, "writes": writes,
                     "writed_by": writes[:, ::-1].copy()},
                    num_nodes=num_papers + num_authors,
                    node_feat={"h": np.concatenate(
                        [papers.node_feat["h"], afeat.numpy()])})
    return hg, np.concatenate([labels.astype(np.int64),
                               np.full(num_authors, -1)]), num_papers


def mag_train_mask(n, num_papers, dev):
    """The train papers: ogbn-arxiv's share (``UNIMP_TRAIN`` of
    ``UNIMP_NODES``) of a seeded permutation of the papers."""
    import torch
    train = torch.zeros(n, dtype=torch.bool, device=dev)
    train[torch.as_tensor(np.random.default_rng(0).permutation(num_papers)[
        :num_papers * UNIMP_TRAIN // UNIMP_NODES], device=dev)] = True
    return train


def runimp_trainer(labels, num_papers, hidden=128):
    """A trainer for ``phase_train``: ``RUniMP(128, 40, MAG_ETYPES,
    num_layers=2, hidden_size, num_heads=2, dropout=0.3)`` (the reference's
    defaults at ``hidden=128``; weights from seed 0) on the graph's device
    and one AdamW step (lr 5e-3, weight decay 5e-4) as ``unimp_trainer``'s:
    a fresh seeded 60% of the train papers' labels fed, the loss over the
    train papers not fed."""
    def trainer(hg):
        import torch
        from pgl_tpu_torch.models import RUniMP
        from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

        x = hg.node_feat["h"]
        dev, n = x.device, hg.num_nodes
        y = torch.as_tensor(labels, device=dev)
        train = mag_train_mask(n, num_papers, dev)
        model = RUniMP(128, 40, MAG_ETYPES, num_layers=2,
                       hidden_size=hidden, num_heads=2, dropout=0.3,
                       generator=torch.Generator().manual_seed(0),
                       device=dev)
        opt = torch.optim.AdamW(model.parameters(), lr=5e-3,
                                weight_decay=5e-4)
        gen = torch.Generator(device=dev).manual_seed(7)

        def step():
            feed = train & (torch.rand(n, generator=gen, device=dev) < 0.6)
            rest = (train & ~feed).float()
            opt.zero_grad(set_to_none=True)
            losses = ce(model(hg, x, y, feed, training=True), y)
            loss = (losses * rest).sum() / rest.sum().clamp(min=1.0)
            loss.backward()
            opt.step()
            return loss.detach()

        return model, step
    return trainer


def rgcn_trainer(labels, num_papers):
    """A trainer for ``phase_train``: ``examples/rgcn/train.py``'s RGCN
    (``RGCNConv(128, 32, num_bases=2)``, relu, ``RGCNConv(32, 40,
    num_bases=2)`` over ``MAG_ETYPES``; weights from seed 0) and one Adam
    step (lr 0.01) on the train papers."""
    def trainer(hg):
        import torch
        from pgl_tpu_torch.nn import RGCNConv
        from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce

        x = hg.node_feat["h"]
        dev = x.device
        gen = torch.Generator().manual_seed(0)

        class RGCN(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.l1 = RGCNConv(128, 32, MAG_ETYPES, 2, generator=gen,
                                   device=dev)
                self.l2 = RGCNConv(32, 40, MAG_ETYPES, 2, generator=gen,
                                   device=dev)

            def forward(self, graph, feat):
                return self.l2(graph, torch.relu(self.l1(graph, feat)))

        model = RGCN()
        y = torch.as_tensor(labels, device=dev)
        train = mag_train_mask(hg.num_nodes, num_papers, dev)
        opt = torch.optim.Adam(model.parameters(), lr=0.01)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = ce(model(hg, x)[train], y[train]).mean()
            loss.backward()
            opt.step()
            return loss.detach()

        return model, step
    return trainer


def check_rect_spmm(tag, bg, reduce, dev, gen):
    """``bg.send_recv`` (K1 over the rectangular layouts) with ``reduce``
    (sum or mean) against float64 on a random table and cotangent: the
    output and the table's gradient at ``check``'s rule with the terms
    scale, exact zeros on destinations without edges and on sources
    without edges' gradient rows, one launch each way. Returns the max
    |err| by layout and the launches read."""
    import torch
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    csc, csr = bg._spmm_layouts
    D = 128
    x = torch.randn(bg.src_num_nodes, D, device=dev,
                    generator=gen).requires_grad_()
    g = torch.randn(bg.dst_num_nodes, D, device=dev, generator=gen)
    reset_all_launches()
    out = bg.send_recv(x, reduce)
    out.backward(g)
    launched = {k: v for k, v in all_launches().items() if v}
    if launched != {("csc", D): 1, ("csr", D): 1} or launches_on(
            (csc, csr)) != launched:
        raise AssertionError(f"{tag} {reduce}: launched {launched}, on its "
                             f"layouts {launches_on((csc, csr))}")
    reset_all_launches()
    indeg = bg.indegree().double()[:, None]
    div = indeg.clamp(min=1) if reduce == "mean" else torch.ones_like(indeg)
    with torch.no_grad():
        x64 = x.detach().double()
        errs = {"csc": check(
            f"{tag} {reduce} out", out, sk.spmm_reference(x64, csc) / div,
            sk.spmm_reference(x64 * x64, csc).sqrt() / div)}
        g64 = g.double() / div
        errs["csr"] = check(f"{tag} {reduce} grad", x.grad,
                            sk.spmm_reference(g64, csr),
                            sk.spmm_reference(g64 * g64, csr).sqrt())
        for name, t, deg in (("out", out, bg.indegree()),
                             ("grad", x.grad, bg.outdegree())):
            if bool(t[deg == 0].any()):
                raise AssertionError(f"{tag} {reduce}: {name} not zero on "
                                     "rows without edges")
    return errs, launched


def check_empty_rows_dot(tag, g, rate, dev, gen):
    """The dot-mode K9/K10 at UniMP's shape on relation graph ``g`` against
    float64 (``check_dot``), and exact zeros where a row has no edge: out
    and dq on destinations without incoming edges, dk and dv on sources
    without outgoing ones. Returns the max |err| by kernel."""
    import torch
    lays = g._attention_layouts()
    ins = dot_inputs(g.num_nodes, UNIMP_SHAPE, dev, gen)
    seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                         generator=gen, device=dev)
    got = run_dot(lays, ins, UNIMP_SHAPE, 0.0, rate, seed)
    errs = check_dot(tag, lays, ins, UNIMP_SHAPE, 0.0, rate, seed, got)
    out, _, dq, dk, dv = got
    indeg, outdeg = g.indegree(), g.outdegree()
    for name, t, deg in (("out", out, indeg), ("dq", dq, indeg),
                         ("dk", dk, outdeg), ("dv", dv, outdeg)):
        if bool(t[deg == 0].any()):
            raise AssertionError(f"{tag} rate={rate}: {name} not zero on "
                                 "rows without edges")
    reset_all_launches()
    return errs


def phase_hetero(dev, smi):
    """R-UniMP at full width on the ogbn-mag-shaped graph (the slice's main
    path), RGCN, label propagation and the rectangular K1 of a BiGraph:
    returns (rows, the step line's entries)."""
    import torch
    from pgl_tpu_torch import BiGraph, Graph
    from pgl_tpu_torch.models import label_propagation_smooth

    t0 = time.perf_counter()
    host, labels, P = mag_host()
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    hg = host.tensor()
    torch.cuda.synchronize()
    t_tensor = time.perf_counter() - t0
    table = hg.node_feat["h"]
    if {hg[t].node_feat["h"].data_ptr() for t in MAG_ETYPES} != {
            table.data_ptr()}:
        raise AssertionError("the relations do not share one feature table")
    held = torch.cuda.memory_allocated() - before
    facts = {t: (hg[t].num_edges, int((hg[t].indegree() == 0).sum()))
             for t in MAG_ETYPES}
    print(f"[hetero] ogbn-mag-shaped HeterGraph: {P} papers, "
          f"{hg.num_nodes - P} authors, N={hg.num_nodes}, "
          f"E={hg.num_edges} (edges, rows without in-edges by type: "
          f"{facts}); host build {t_host:.2f} s, tensor() {t_tensor:.2f} s; "
          f"one feature table of {table.numel() * 4 / 2**20:.1f} MiB shared "
          f"by the {len(MAG_ETYPES)} relations; {held / 2**20:.1f} MiB on "
          f"the card after tensor()", flush=True)

    # the dot kernels on each relation at this size, zeros on empty rows
    gen = torch.Generator(device=dev).manual_seed(12)
    errs = {}
    for t in MAG_ETYPES:
        for rate in ((0.0, 0.3) if t == "writes" else (0.3,)):
            e = check_empty_rows_dot(f"mag {t}", hg[t], rate, dev, gen)
            for k, v in e.items():
                errs[f"mag_{t}", k] = max(errs.get((f"mag_{t}", k), 0.0), v)
            print(f"[hetero dot] {t} rate={rate}: max |err| K9 "
                  f"{e['dot_fwd']:.3e} K10-dq {e['dot_dq']:.3e} K10-dkv "
                  f"{e['dot_dkv']:.3e}; zeros on the rows without edges",
                  flush=True)

    steps = {}
    train, _, by_r = phase_train(
        hg, "R-UniMP", RUNIMP_PER_STEP, runimp_trainer(labels, P), 40,
        {t: hg[t]._attention_layouts() for t in MAG_ETYPES})
    prof = phase_gat_profile(hg, "R-UniMP", runimp_trainer(labels, P))
    dot_ms = sum(v for k, v in prof["attention_kernels_ms"].items()
                 if k.startswith("dot_"))
    busy = prof["device_busy_ms_per_step"]
    steps["R-UniMP"] = dict(train, tensor_s=t_tensor, host_build_s=t_host,
                            feature_table_mib=table.numel() * 4 / 2**20,
                            dot_ms_per_step=dot_ms, profile=prof)
    print(f"[hetero R-UniMP] {smi}: step {train['step_ms']:.4f} ms, dot "
          f"kernels {dot_ms:.5f} device ms a step, device busy "
          f"{prof['device_busy_ms_per_step']:.5f} ms, idle share "
          f"{prof['idle_share']:.4f}, q[dst] gather backward "
          f"(indexing_backward_kernel) {prof['indexing_backward_ms']:.5f} ms "
          f"({prof['indexing_backward_ms'] / busy:.4f} of the device "
          f"time), peak memory {train['peak_mib']:.1f} MiB",
          flush=True)
    rows = phase_dot_timing({f"mag_{t}": hg[t] for t in MAG_ETYPES}, dev,
                            {f"mag_{t}": {0.3: by_r[t]} for t in MAG_ETYPES},
                            errs)

    train, _, by_g = phase_train(
        hg, "RGCN", RGCN_PER_STEP, rgcn_trainer(labels, P), 40,
        {t: hg[t]._spmm_layouts for t in MAG_ETYPES})
    prof = phase_gat_profile(hg, "RGCN", rgcn_trainer(labels, P))
    k1 = sum(v for k, v in prof["attention_kernels_ms"].items()
             if k.startswith("spmm_"))
    steps["RGCN"] = dict(train, k1_ms_per_step=k1, profile=prof)
    print(f"[hetero RGCN] {smi}: step {train['step_ms']:.4f} ms, K1 "
          f"{k1:.5f} device ms a step ({sum(RGCN_PER_STEP.values())} "
          f"launches), device busy {prof['device_busy_ms_per_step']:.5f} ms, "
          f"idle share {prof['idle_share']:.4f}", flush=True)
    for t in MAG_ETYPES:
        g = hg[t]
        rows += k1_rows(f"mag_{t}", g._spmm_layouts,
                        (g.num_nodes, g.num_nodes), (32, 40), dev, by_g[t])

    # label propagation on cites, C = 40, 3 hops: K1 once a hop
    rng = np.random.default_rng(3)
    n = hg.num_nodes
    probs = rng.random((n, 40)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    train_np = mag_train_mask(n, P, "cpu").numpy()
    gold = np.zeros((n, 40), np.float32)
    gold[np.flatnonzero(train_np), labels[train_np]] = 1.0
    ins = [torch.as_tensor(a) for a in (probs, gold, train_np)]
    reset_all_launches()
    with torch.no_grad():
        got = label_propagation_smooth(hg["cites"],
                                       *(a.to(dev) for a in ins))
    launched = {k: v for k, v in all_launches().items() if v}
    if launched != {("csc", 40): 3}:
        raise AssertionError(f"label propagation launched {launched}")
    cites_cpu = Graph(host["cites"].edges, num_nodes=n).tensor("cpu")
    with torch.no_grad():
        want = label_propagation_smooth(cites_cpu, *ins)
    err = check("label propagation, CUDA vs CPU", got.cpu(), want)
    print(f"[hetero] label_propagation_smooth on cites (C=40, 3 hops, 3 K1 "
          f"launches): CUDA vs CPU max |err| {err:.3e}", flush=True)
    reset_all_launches()
    del hg, got, table
    torch.cuda.empty_cache()

    # writes as a BiGraph: authors -> papers
    w = host["writes"].edges
    bg = BiGraph(np.stack([w[:, 0] - P, w[:, 1]], axis=1),
                 src_num_nodes=host.num_nodes - P, dst_num_nodes=P).tensor()
    csc, csr = bg._spmm_layouts
    errs, launches = {}, {}
    for reduce in ("sum", "mean"):
        e, launched = check_rect_spmm("BiGraph writes", bg, reduce, dev, gen)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[hetero BiGraph] writes, {bg.src_num_nodes} authors -> "
              f"{bg.dst_num_nodes} papers, D=128, {reduce}: max |err| out "
              f"{e['csc']:.3e}, grad {e['csr']:.3e}; zeros on the "
              f"{int((bg.indegree() == 0).sum())} papers and "
              f"{int((bg.outdegree() == 0).sum())} authors without edges",
              flush=True)
    rect = k1_rows("bigraph_writes", (csc, csr),
                   (bg.src_num_nodes, bg.dst_num_nodes), (128,), dev,
                   launches)
    for r in rect:
        r["max_abs_err"] = max(r["max_abs_err"], errs[r["shape"]["layout"]])
    rows += rect
    reset_all_launches()
    return rows, {f"hetero {k}": v for k, v in steps.items()}


def motif_host(num_graphs=MOTIF_GRAPHS, seed=0):
    """``examples/global_pool/train.py``'s motifs (a cycle, star or ladder
    of 6 to 13 nodes, both edge directions, constant 8 features), a
    ``disjoint`` of ``num_graphs`` of them, and their kinds as labels."""
    from pgl_tpu_torch import Graph
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for _ in range(num_graphs):
        kind, n = int(rng.integers(0, 3)), int(rng.integers(6, 14))
        if kind == 0:
            src = np.arange(n)
            dst = (src + 1) % n
        elif kind == 1:
            src = np.concatenate([np.zeros(n - 1, int), np.arange(1, n)])
            dst = np.concatenate([np.arange(1, n), np.zeros(n - 1, int)])
        else:
            half = max(n // 2, 2)
            n = 2 * half
            rail = np.arange(half - 1)
            src = np.concatenate([rail, rail + half, np.arange(half)])
            dst = np.concatenate([rail + 1, rail + half + 1,
                                  np.arange(half) + half])
        edges = np.stack([np.concatenate([src, dst]),
                          np.concatenate([dst, src])], 1)
        graphs.append(Graph(edges, num_nodes=n,
                            node_feat={"h": np.ones((n, 8), np.float32)}))
        labels.append(kind)
    return Graph.disjoint(graphs), np.asarray(labels)


def noisy_features(host, seed=1):
    """``host`` with a seeded normal of 0.1 added to its features. On the
    motifs' constant features symmetric nodes tie, and which of them wins
    a max or a top-k follows the sums' rounding, which differs between
    devices: the parity runs break the ties."""
    from pgl_tpu_torch import Graph
    x = host.node_feat["h"]
    return Graph(host.edges, num_nodes=host.num_nodes, node_feat={
        "h": x + 0.1 * np.random.default_rng(seed).normal(
            size=x.shape).astype(np.float32)},
        _graph_node_index=host._graph_node_index,
        _graph_edge_index=host._graph_edge_index, _num_graph=host.num_graph)


def readout_model(name, device):
    """Phase 12's graph classifiers at ``examples/global_pool/train.py``'s
    widths (8 features, hidden 32, 3 classes; weights from seed 0): GIN (3
    ``GINConv``, relu) then the readout ``name`` (``GraphPool`` sum, mean
    or max, ``GlobalAttention`` with a Dense gate, ``Set2Set`` of 2
    iterations, or ``GraphMultisetTransformer`` of 4 heads and 32 nodes),
    a relu Dense and the classifier; or, for ``SAGPool <mode>``, GCN,
    ``SAGPool(ratio=0.5)``, GCN and the mean and max readouts
    concatenated."""
    import torch
    from pgl_tpu_torch import nn as gnn
    from pgl_tpu_torch.nn.conv import _dense
    from pgl_tpu_torch.nn.functional import graph_pool

    gen = torch.Generator().manual_seed(0)
    H = 32

    class Classifier(torch.nn.Module):
        def __init__(self):
            super().__init__()
            if name.startswith("SAGPool"):
                self.conv1 = gnn.GCNConv(8, H, "relu", generator=gen,
                                         device=device)
                self.pool = gnn.SAGPool(H, ratio=0.5,
                                        static=name.endswith("static"),
                                        generator=gen, device=device)
                self.conv2 = gnn.GCNConv(H, H, "relu", generator=gen,
                                         device=device)
                width = 2 * H
            else:
                for i in range(3):
                    self.add_module(f"gin_{i}", gnn.GINConv(
                        8 if i == 0 else H, H, activation="relu",
                        generator=gen, device=device))
                width = 2 * H if name == "Set2Set" else H
                if name in ("sum", "mean", "max"):
                    self.readout = gnn.GraphPool(name)
                elif name == "GlobalAttention":
                    self.readout = gnn.GlobalAttention(_dense(H, 1, gen))
                elif name == "Set2Set":
                    self.readout = gnn.Set2Set(H, n_iters=2, generator=gen,
                                               device=device)
                else:
                    self.readout = gnn.GraphMultisetTransformer(
                        H, H, H, num_heads=4, num_nodes=32, generator=gen,
                        device=device)
            self.head = _dense(width, H, gen)
            self.classifier = _dense(H, 3, gen)
            self.to(device)

        def forward(self, graph, x, training=False):
            if name.startswith("SAGPool"):
                x, kept, g = self.pool(graph, self.conv1(graph, x))
                x = self.conv2(g, x)
                if g is graph:      # static: readouts over the kept rows
                    keep = kept[:, None]
                    mean = graph_pool(g, x * keep, "sum") / graph_pool(
                        g, keep.to(x.dtype), "sum").clamp(min=1)
                    x = torch.where(keep, x, float("-inf"))
                else:
                    mean = graph_pool(g, x, "mean")
                h = torch.cat([mean, graph_pool(g, x, "max")], dim=-1)
            else:
                for i in range(3):
                    x = getattr(self, f"gin_{i}")(graph, x)
                h = self.readout(graph, x)
            return self.classifier(torch.relu(self.head(h)))

    return Classifier()


def readout_trainer(name, labels):
    """A trainer: ``readout_model(name)`` on the graph's device and one
    Adam step (lr 5e-3) of the mean cross-entropy over the graphs."""
    def trainer(g):
        import torch
        from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
        x = g.node_feat["h"]
        model = readout_model(name, x.device)
        y = torch.as_tensor(labels, device=x.device).long()
        opt = torch.optim.Adam(model.parameters(), lr=5e-3)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = ce(model(g, x, True), y).mean()
            loss.backward()
            opt.step()
            return loss.detach()

        return model, step
    return trainer


def lstmsage_model(device):
    """``LSTMSage(128, 16)`` at its defaults (2 layers, hidden 16, at most
    32 messages a node, dropout 0.5; weights from seed 0)."""
    import torch
    from pgl_tpu_torch.models import LSTMSage
    return LSTMSage(128, 16, generator=torch.Generator().manual_seed(0),
                    device=device)


def lstmsage_trainer(labels):
    """A trainer: ``lstmsage_model`` and one Adam step (lr 1e-3), training
    (dropout on)."""
    def trainer(g):
        import torch
        from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
        x = g.node_feat["h"]
        model = lstmsage_model(x.device)
        y = torch.as_tensor(labels, device=x.device).long()
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = ce(model(g, x, True), y).mean()
            loss.backward()
            opt.step()
            return loss.detach()

        return model, step
    return trainer


def parity(tag, ref, make, dev, blocks=64):
    """``make(device)`` from one seed on the card and, in float64, on the
    CPU, evaluated on the graph ``ref``: the output and every parameter
    gradient under a fixed random cotangent, the card's against float64 at
    ``check``'s rule. A gradient sums a term an output row, so its scale is
    the 2-norm of those terms, taken over ``blocks`` blocks of the output's
    rows: the float64 gradient of each block's share of the cotangent (the
    rows' cotangents are independent and of mean 0, so the blocks' squares
    sum to the rows' in expectation). Returns (max |err|, the largest
    share of its bound an error takes, the gradients held)."""
    import torch
    got, want = {}, {}
    for d, dtype, res in ((dev, torch.float32, got),
                          ("cpu", torch.float64, want)):
        g = ref.tensor(d)
        model = make(d).to(dtype)
        out = model(g, g.node_feat["h"].to(dtype))
        w = torch.as_tensor(np.random.default_rng(2).normal(
            size=tuple(out.shape)).astype(np.float32), dtype=dtype,
            device=d)
        params = {k: p for k, p in model.named_parameters()
                  if p.requires_grad}
        grads = torch.autograd.grad((out * w).sum(), list(params.values()),
                                    retain_graph=d == "cpu",
                                    allow_unused=True)
        res["out"] = out.detach().cpu()
        res.update((k, v.cpu()) for k, v in zip(params, grads)
                   if v is not None)
    # out, w and params are the CPU's now, in float64
    if set(got) != set(want):
        raise AssertionError(f"{tag}: gradients of {sorted(got)} on the "
                             f"card, {sorted(want)} on the CPU")
    names = [k for k in want if k != "out"]
    sq = {k: torch.zeros_like(want[k]) for k in names}
    for rows in np.array_split(np.arange(out.shape[0]), blocks):
        part = torch.zeros_like(w)
        part[rows] = w[rows]
        grads = torch.autograd.grad((out * part).sum(),
                                    [params[k] for k in names],
                                    retain_graph=True)
        for k, v in zip(names, grads):
            sq[k] += v * v
    err = check(f"{tag} output", got["out"], want["out"])
    share = bound_share(got["out"], want["out"])
    for k in names:
        scale = sq[k].sqrt()
        err = max(err, check(f"{tag} grad {k}", got[k], want[k], scale))
        share = max(share, bound_share(got[k], want[k], scale))
    return err, share, len(names)


def parity_and_steps(tag, ref, host, make, trainer, per_step, dev,
                     steps=3):
    """(a) ``parity`` of ``make`` on the graph ``ref``; (b) ``steps``
    training steps on the card on ``host`` asserting ``per_step`` launches
    a step (and no other) and finite losses. Returns the step line's
    entry."""
    import torch
    err, share, held = parity(tag, ref, make, dev)
    g = host.tensor(dev)
    _, step = trainer(g)
    reset_all_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = {k: v for k, v in all_launches().items() if v}
    want = {k: v * steps for k, v in per_step.items()}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses not finite: {losses}")
    reset_all_launches()
    step_ms = float(np.median(times)) * 1e3
    print(f"[readout {tag}] CUDA vs float64 CPU max |err| {err:.3e}, "
          f"{share:.4f} of its bound at most (output and {held} gradients "
          f"on N={ref.num_nodes}); {steps} "
          f"steps on N={host.num_nodes}: loss {losses[0]:.6f} "
          f"-> {losses[-1]:.6f}, median step {step_ms:.4f} ms; launches a "
          f"step {dict(sorted(per_step.items()))}", flush=True)
    return {"step_ms": step_ms, "losses": losses, "max_abs_err": err,
            "bound_share": share}


def phase_readouts(dev, head_host):
    """GIN with each readout and GCN-SAGPool-GCN in both modes on a
    ``disjoint`` of ``MOTIF_GRAPHS`` motif graphs: ``parity`` on that batch,
    then 3 steps on it. The readouts that pick nodes, max and SAGPool's
    top-k, take their ``parity`` on 64 motif graphs with
    ``noisy_features``: the constant features tie, and on 4,096 graphs
    even the noisy ones leave pairs within float32 rounding of each other,
    whose winner differs between float32 and float64. ``LSTMSage`` at its
    defaults, ``parity``
    on a powerlaw graph of 4,096 nodes (its hub takes 25,407 messages; the
    headline is too large for a float64 CPU run), then 3 steps on the
    headline (in-degree up to 803,866): the 32-message cap bites in both.
    Each asserts its launches a step. Returns the step line's entries."""
    import torch
    from pgl_tpu_torch.datasets import powerlaw_graph

    host, labels = motif_host()
    noisy = noisy_features(motif_host(num_graphs=64, seed=2)[0])
    print(f"[readout] {MOTIF_GRAPHS} motif graphs: N={host.num_nodes} "
          f"E={host.num_edges}", flush=True)
    steps = {}
    for name, per_step in READOUT_PER_STEP.items():
        ref = noisy if name == "max" or name.startswith("SAGPool") else host
        steps[name] = parity_and_steps(
            name, ref, host, lambda d, name=name: readout_model(name, d),
            readout_trainer(name, labels), per_step, dev)
    y = np.random.default_rng(0).integers(0, 16, head_host.num_nodes)
    steps["LSTMSage"] = parity_and_steps(
        "LSTMSage", powerlaw_graph(4096, 16, feat_dim=128, seed=3),
        head_host, lstmsage_model, lstmsage_trainer(y), {}, dev)
    torch.cuda.empty_cache()
    return {f"readout {k}": v for k, v in steps.items()}


# -- phase 13: sampling, the data pipeline, walks and partitioning ----------

SAGE_B, SAGE_SAMPLES = 512, (25, 10)
SAGE_BUCKETS = (1 << 17, 1 << 17)
SAGE_PER_STEP = {("csc", 128): 2, ("csr", 128): 1}
SAGE_WORKERS = 4
WALK_LEN, WALK_P, WALK_Q, WALK_WIN = 20, 0.25, 4.0, 5
PARTS = 16


def sage_items(labels, n, seed=0):
    """``n`` (node, label) items, nodes drawn from the first
    ``UNIMP_TRAIN`` (the train split's size), as a ``Dataset``."""
    from pgl_tpu_torch.utils.data import Dataset
    nodes = np.random.default_rng(seed).choice(UNIMP_TRAIN, n)

    class Items(Dataset):
        def __getitem__(self, i):
            return int(nodes[i]), int(labels[nodes[i]])

        def __len__(self):
            return n

    return Items()


class PinnedCopy:
    """Host batches to the card through one pinned buffer of ``words``
    int32 words: each batch is copied into it, once the last batch's copy
    has finished, and sent by one non-blocking copy."""

    def __init__(self, dev, words):
        import torch
        self.dev = dev
        self.buf = torch.empty(words, dtype=torch.int32, pin_memory=True)
        self.done = None

    def __call__(self, batch):
        import torch
        n = batch.shape[0]
        if n > self.buf.shape[0]:
            raise ValueError(f"a batch of {n} words; the pinned buffer "
                             f"holds {self.buf.shape[0]}")
        if self.done is not None:
            self.done.synchronize()
        self.buf[:n].copy_(torch.from_numpy(batch))
        out = self.buf[:n].to(self.dev, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()
        return out


def sage_minibatch_trainer(feat, dev):
    """``GraphSage(128, 40, 2 layers, 128 hidden, dropout 0)`` and Adam at
    lr 1e-3 on the card (weights from seed 0), and a step that takes a
    host batch of the ``layouts=True`` collate: one pinned copy, the batch
    graph with its K1 layouts, features gathered by ``sidx`` on the card,
    the masked mean cross entropy. Returns (model, step(batch) -> loss)."""
    import torch
    from pgl_tpu_torch.models import GraphSage
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
    from pgl_tpu_torch.sampling import max_batch_words, padded_batch_graph

    NB, EB = SAGE_BUCKETS
    model = GraphSage(128, 40, num_layers=2, hidden_size=128, dropout=0.0,
                      generator=torch.Generator().manual_seed(0), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    copy = PinnedCopy(dev, max_batch_words(NB, EB))

    def step(batch):
        buf = copy(batch)
        graph, sidx, smask, y, mask = padded_batch_graph(buf, NB, EB,
                                                         host=batch)
        x = feat.index_select(0, sidx.long()) * smask
        opt.zero_grad(set_to_none=True)
        loss = (ce(model(graph, x), y.long()) * mask).sum() / \
            mask.sum().clamp(min=1.0)
        loss.backward()
        opt.step()
        return loss.detach()

    return model, step


def check_batch_graph_k1(batch, dev, tag="minibatch"):
    """A ``layouts=True`` batch on the card: the K1 layouts that came from
    the host (CSC and CSR) against K1's plain version in float64 at D =
    128, the sentinel row's pad edges split into pieces (``check_spmm``:
    within 1e-4 of the terms' 2-norm; the sentinel sums some 56,000
    copies of one row, so its absolute error is of order 1); returns (max
    |err|, the largest error as a share of that bound, the batch
    graph)."""
    import torch
    from pgl_tpu_torch.sampling import padded_batch_graph
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    NB, EB = SAGE_BUCKETS
    buf = torch.as_tensor(batch).to(dev)
    graph, *_ = padded_batch_graph(buf, NB, EB, host=batch)
    gen = torch.Generator(device=dev).manual_seed(13)
    err = share = 0.0
    for lay in graph._spmm_layouts:
        if lay.item_split_rows.shape[0] < 1:
            raise AssertionError(f"{tag}: the {lay.kind} layout has no "
                                 "split row (the sentinel's pad edges)")
        x = torch.randn(NB, 128, device=dev, generator=gen)
        got = sk._spmm_one(x, lay)
        err = max(err, check_spmm(f"{tag} {lay.kind}", got, x, lay))
        x64 = x.double()
        share = max(share, bound_share(
            got, sk.spmm_reference(x64, lay),
            sk.spmm_reference(x64 * x64, lay).sqrt()))
    return err, share, graph


def check_device_samples(sampler, layers, tag):
    """Every sampled neighbour of a node with in-edges is one of its
    in-neighbours (a binary search of ``(node, neighbour)`` over the CSC's
    ``dst * N + src`` keys); masks are 1 exactly where the frontier holds a
    node with in-edges (a zero-degree node's slots hold fill ids, which
    the next layer masks); on the card."""
    import torch
    ip = sampler.indptr.long()
    N = ip.shape[0] - 1
    deg = ip[1:] - ip[:-1]
    owner = torch.repeat_interleave(torch.arange(N, device=ip.device), deg)
    keys = owner * N + sampler.sorted_v.long()
    keys = torch.sort(keys).values
    for frontier, neigh, mask in layers:
        f = frontier.long()
        inside = (f >= 0) & (f < N)
        has = inside & (deg[f.clamp(0, N - 1)] > 0)
        if not bool((mask == has[:, None]).all()):
            raise AssertionError(f"{tag}: masks disagree with the degrees")
        q = (f[:, None] * N + neigh.long())[mask]
        pos = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
        if not bool((keys[pos] == q).all()):
            raise AssertionError(f"{tag}: a sampled neighbour is not an "
                                 "in-neighbour")
    return True


def check_walks(walker, walks, tag):
    """Every hop of ``walks`` (until its -1) is an edge of the graph (a
    binary search over the neighbour-sorted CSR, on the card), and a walk
    that reached -1 stays -1 to its end; returns the number of hops
    checked and of walks that hit a dead end."""
    import torch
    from pgl_tpu_torch.sampling import device_walk as dw
    w = walks.long()
    a, b = w[:, :-1], w[:, 1:]
    live = b >= 0
    if bool((live & (a < 0)).any()):
        raise AssertionError(f"{tag}: a walk resumes after its -1")
    ok = dw._is_neighbor(walker._nbr_key, walker.num_nodes, a[live],
                         b[live])
    if not bool(ok.all()):
        raise AssertionError(f"{tag}: {int((~ok).sum())} hops are not "
                             "edges")
    return int(live.sum()), int((w[:, -1] < 0).sum())


def phase_sampling(dev, smi, rows):
    """Phase 13: (a) host-sampled minibatch GraphSAGE, (b) device-sampled
    ``NeighborSampler`` + ``BipartiteSAGE``, (c) device walks and skip-gram
    pairs, (d) METIS-style partitioning and reordering on the host, all on
    the UniMP graph. Appends K1's rows at the minibatch shapes to
    ``rows``; returns the step line's entries."""
    import torch
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.models import BipartiteSAGE
    from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
    from pgl_tpu_torch.partition import metis_partition, reorder_graph
    from pgl_tpu_torch.sampling import (DeviceWalker, NeighborSampler,
                                        make_padded_batch_fn,
                                        skipgram_pairs)
    from pgl_tpu_torch.utils.data import Dataloader

    NB, EB = SAGE_BUCKETS
    t0 = time.perf_counter()
    host, labels = unimp_host()
    feat = torch.as_tensor(host.node_feat["h"]).to(dev)
    y_dev = torch.as_tensor(labels.astype(np.int64), device=dev)
    # the sampler's graph: the edges alone (features stay on the card), its
    # CSC built before the workers fork
    sg = Graph(host.edges, num_nodes=host.num_nodes)
    sg.adj_dst_index
    print(f"[sampling] graph N={host.num_nodes} E={host.num_edges}, "
          f"largest in-degree {int(sg.indegree().max())}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {}

    # (a) host-sampled: workers sample, pad and build K1's layouts
    fn = make_padded_batch_fn(sg, SAGE_SAMPLES, NB, EB, pack=True,
                              layouts=True)
    n_batches = WARMUP + STEPS
    items = sage_items(labels, SAGE_B * STEPS)
    t0 = time.perf_counter()
    first = fn([items[i] for i in range(SAGE_B)])
    t_first = time.perf_counter() - t0
    err, share, g0 = check_batch_graph_k1(first, dev)
    c0, r0 = g0._spmm_layouts
    ns = int(first[0])
    pads = int(g0.indegree()[NB - 1])
    print(f"[sampling a] a batch of {SAGE_B} seeds, samples "
          f"{SAGE_SAMPLES}: {ns} nodes, {EB - pads} edges in buckets of "
          f"{NB} / {EB} ({pads} pad edges in the sentinel row); "
          f"{first.nbytes / 2**20:.2f} MiB a batch with both layouts "
          f"({c0.items.shape[0]} / {r0.items.shape[0]} items, {c0.item_split_rows.shape[0]} / "
          f"{r0.item_split_rows.shape[0]} split rows); collate "
          f"{t_first * 1e3:.2f} ms in this process; K1 on the host "
          f"layouts against float64: max |err| {err:.3e}, {share:.4f} of "
          f"the bound", flush=True)
    del g0
    model, step = sage_minibatch_trainer(feat, dev)
    losses = [step(first) for _ in range(WARMUP)]
    torch.cuda.synchronize()
    reset_all_launches()
    # the pipeline as bench.py times it: from the loader's start (the
    # workers fork) to the last step's end
    t0 = time.perf_counter()
    for batch in Dataloader(items, batch_size=SAGE_B,
                            num_workers=SAGE_WORKERS, collate_fn=fn):
        losses.append(step(batch))
    torch.cuda.synchronize()
    pipeline_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    launches = {k: v for k, v in all_launches().items() if v}
    want = {k: v * STEPS for k, v in SAGE_PER_STEP.items()}
    losses = [float(v) for v in losses]
    if len(losses) != n_batches or launches != want:
        raise AssertionError(f"host-sampled SAGE: {len(losses)} batches, "
                             f"launches {launches}, expected {want}")
    if not all(np.isfinite(losses)) or not (np.mean(losses[-5:])
                                            < np.mean(losses[:5])):
        raise AssertionError(f"host-sampled SAGE: losses not finite and "
                             f"falling: {losses}")
    # sample and collate alone: 4 workers, then 1 process
    t0 = time.perf_counter()
    nb = sum(1 for _ in Dataloader(sage_items(labels, SAGE_B * STEPS, 1),
                                   batch_size=SAGE_B,
                                   num_workers=SAGE_WORKERS, collate_fn=fn))
    collate_4_ms = (time.perf_counter() - t0) * 1e3 / nb
    t0 = time.perf_counter()
    for i in range(4):
        fn([items[i * SAGE_B + j] for j in range(SAGE_B)])
    collate_1_ms = (time.perf_counter() - t0) * 1e3 / 4
    # the copy and the step alone, on one host batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(first)
    torch.cuda.synchronize()
    copy_step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    prof = phase_gat_profile(None, "minibatch GraphSage",
                             lambda _: (model, lambda: step(first)))
    k1_ms = sum(v for k, v in prof["attention_kernels_ms"].items()
                if k.startswith("spmm_"))
    out["sage host-sampled"] = {
        "pipeline_ms": pipeline_ms, "sample_collate_4worker_ms":
        collate_4_ms, "sample_collate_1proc_ms": collate_1_ms,
        "copy_plus_step_ms": copy_step_ms,
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "idle_share": prof["idle_share"], "k1_ms_per_step": k1_ms,
        "batch_mib": first.nbytes / 2**20, "nodes": ns,
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches_per_step": {f"{k[0]} D={k[1]}": v
                              for k, v in SAGE_PER_STEP.items()}}
    print(f"[sampling a] {smi}: pipeline {pipeline_ms:.4f} ms a batch "
          f"({SAGE_WORKERS} workers, {STEPS} batches, from the loader's "
          f"start); sample + collate "
          f"{collate_4_ms:.4f} ms a batch with {SAGE_WORKERS} workers, "
          f"{collate_1_ms:.4f} ms in 1 process; copy + step "
          f"{copy_step_ms:.4f} ms; device busy "
          f"{prof['device_busy_ms_per_step']:.5f} ms a step, K1 "
          f"{k1_ms:.5f}, idle share {prof['idle_share']:.4f}; loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; K1 launches a step "
          f"{SAGE_PER_STEP}", flush=True)
    _, _, g1 = check_batch_graph_k1(first, dev)
    rows += k1_rows("minibatch", g1._spmm_layouts, (NB, NB), (128,), dev,
                    launches)
    del g1, model, step
    torch.cuda.empty_cache()

    # (b) device-sampled: NeighborSampler + BipartiteSAGE, one generator
    sampler = NeighborSampler(sg, SAGE_SAMPLES, device=dev)
    dmodel = BipartiteSAGE(128, 40, num_layers=2, hidden_size=128,
                           generator=torch.Generator().manual_seed(0),
                           device=dev)
    dopt = torch.optim.Adam(dmodel.parameters(), lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(3)

    def dstep():
        seeds = torch.randint(0, UNIMP_TRAIN, (SAGE_B,), generator=gen,
                              device=dev)
        sampled, _ = sampler.sample(seeds, gen)
        dopt.zero_grad(set_to_none=True)
        loss = ce(dmodel(feat, seeds, sampled), y_dev[seeds]).mean()
        loss.backward()
        dopt.step()
        return loss.detach()

    seeds = torch.randint(0, UNIMP_TRAIN, (SAGE_B,), generator=gen,
                          device=dev)
    layers, _ = sampler.sample(seeds, gen)
    check_device_samples(sampler, layers, "NeighborSampler")
    rows_gathered = SAGE_B + sum(n.numel() for _, n, _ in layers)
    for _ in range(WARMUP):
        dstep()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dlosses, times = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        dlosses.append(float(dstep()))
        times.append(time.perf_counter() - t0)
    dstep_ms = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    if not all(np.isfinite(dlosses)) or not (np.mean(dlosses[-5:])
                                             < np.mean(dlosses[:5])):
        raise AssertionError(f"device-sampled SAGE: losses not finite and "
                             f"falling: {dlosses}")
    dprof = phase_gat_profile(None, "device-sampled SAGE",
                              lambda _: (dmodel, dstep))
    sprof = phase_gat_profile(None, "NeighborSampler.sample", lambda _: (
        None, lambda: sampler.sample(torch.randint(
            0, UNIMP_TRAIN, (SAGE_B,), generator=gen, device=dev), gen)))
    kinds = dprof["device_ms_by_kind"]
    out["sage device-sampled"] = {
        "step_ms": dstep_ms, "device_busy_ms_per_step":
        dprof["device_busy_ms_per_step"], "idle_share": dprof["idle_share"],
        "sampling_device_ms": sprof["device_busy_ms_per_step"],
        "device_ms_by_kind": kinds, "peak_mib": peak,
        "rows_gathered": rows_gathered, "loss_first": dlosses[0],
        "loss_last": dlosses[-1]}
    print(f"[sampling b] {smi}: step {dstep_ms:.4f} ms (median of "
          f"{STEPS}); device busy {dprof['device_busy_ms_per_step']:.5f} ms "
          f"a step, idle share {dprof['idle_share']:.4f}; by kind "
          f"{json.dumps(kinds)}; the sampler alone "
          f"{sprof['device_busy_ms_per_step']:.5f} device ms; "
          f"{rows_gathered} rows of 128 gathered a step; peak "
          f"{peak:.1f} MiB; loss {dlosses[0]:.6f} -> {dlosses[-1]:.6f}",
          flush=True)
    del sampler, dmodel, dopt
    torch.cuda.empty_cache()

    # (c) walks on the card from every node
    walker = DeviceWalker(sg, neighbor_sorted=True, device=dev)
    wgen = torch.Generator(device=dev).manual_seed(5)
    starts = torch.arange(host.num_nodes, device=dev)
    walks_out = {}
    for name, call in (
            ("random_walk", lambda: walker.random_walk(starts, WALK_LEN,
                                                       wgen)),
            ("node2vec_walk", lambda: walker.node2vec_walk(
                starts, WALK_LEN, wgen, p=WALK_P, q=WALK_Q))):
        walks = call()
        hops, dead = check_walks(walker, walks, name)
        ms = median_ms(call, 5)
        walks_out[name] = {"ms": ms, "walks_per_s": host.num_nodes / ms
                           * 1e3, "hops_checked": hops,
                           "dead_ends": dead}
        print(f"[sampling c] {smi}: {name} from {host.num_nodes} nodes, "
              f"length {WALK_LEN}: {ms:.4f} ms, "
              f"{host.num_nodes / ms * 1e3:.1f} walks/s; {hops} hops "
              f"checked against the graph, {dead} dead ends", flush=True)
    src, dst, valid = skipgram_pairs(walks, WALK_WIN, wgen)
    pairs = int(valid.sum())
    pair_ms = median_ms(lambda: skipgram_pairs(walks, WALK_WIN, wgen), 5)
    walks_out["skipgram_pairs"] = {"ms": pair_ms, "pairs_per_block": pairs,
                                   "slots": int(valid.numel())}
    print(f"[sampling c] skipgram_pairs win={WALK_WIN} on the node2vec "
          f"block [{host.num_nodes}, {WALK_LEN}]: {pairs} pairs of "
          f"{valid.numel()} slots, {pair_ms:.4f} ms", flush=True)
    out["walks"] = walks_out
    del walker, walks, src, dst, valid
    torch.cuda.empty_cache()

    # (d) on the host: METIS-style partition and reorder
    t0 = time.perf_counter()
    parts = metis_partition(sg, PARTS, seed=0)
    t_part = time.perf_counter() - t0
    e = np.asarray(host.edges)
    cut = int((parts[e[:, 0]] != parts[e[:, 1]]).sum())
    sizes = np.bincount(parts, minlength=PARTS)
    t0 = time.perf_counter()
    g2, order = reorder_graph(host, parts=parts)
    t_reorder = time.perf_counter() - t0
    if sorted(order.tolist()) != list(range(host.num_nodes)) or \
            g2.num_edges != host.num_edges:
        raise AssertionError("reorder_graph lost nodes or edges")
    out["partition"] = {"metis_s": t_part, "reorder_s": t_reorder,
                        "edge_cut": cut, "cut_share": cut / len(e),
                        "largest_part": int(sizes.max()),
                        "smallest_part": int(sizes.min())}
    print(f"[sampling d] host: metis_partition into {PARTS} parts "
          f"{t_part:.3f} s, edge cut {cut} of {len(e)} "
          f"({cut / len(e):.4f}), parts of {sizes.min()} to {sizes.max()} "
          f"nodes; reorder_graph {t_reorder:.3f} s", flush=True)
    return out


def device_kinds(device_ms):
    """Device ms a step by kind, from kernel names: the GEMMs, the row
    gathers (``index_select`` and its kin), K1, and the rest."""
    kinds = {"gemm": 0.0, "gather": 0.0, "k1": 0.0, "other": 0.0}
    for name, ms in device_ms.items():
        low = name.lower()
        if any(s in low for s in ("gemm", "cutlass", "xmma", "gemv")):
            kinds["gemm"] += ms
        elif "indexselect" in low or "index_select" in low or \
                "index_elementwise" in low or "gather" in low:
            kinds["gather"] += ms
        elif low.startswith("void spmm_") or "spmm_" in low:
            kinds["k1"] += ms
        else:
            kinds["other"] += ms
    return kinds


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
    for line in apply_report(
            libs["dedup_kernels"].with_suffix(".log").read_text()):
        print(line, flush=True)
    for name in ("segment_kernels", "attention_kernels", "dedup_attention"):
        for line in register_report(
                libs[name].with_suffix(".log").read_text()):
            print(line, flush=True)

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
    phase_dtype_route(dev)
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

    by_kernel = {(r["shape"]["kernel"], r["shape"]["layout"],
                  r["shape"]["D"]): r for r in rows if "kernel" in r["shape"]}
    for (kind, d) in PER_STEP:
        k5, k6, k1 = (by_kernel[k, kind, d]
                      for k in ("dedup_cached", "dedup", "spmm"))
        print(f"[dedup vs K1] {kind} D={d}: K5 {k5['ms']:.5f} ms, K6 "
              f"{k6['ms']:.5f} ms, K1 {k1['ms']:.5f} ms, torch.sparse.mm "
              f"{k1['library_ms']:.5f} ms (K5 {k5['ms'] / k1['ms']:.2f}x K1, "
              f"{k5['ms'] / k1['library_ms']:.2f}x torch.sparse.mm)",
              flush=True)
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
                      if r["shape"]["graph"] == "gat_graph"
                      and r["shape"]["rate"] == 0)
    ddot_rows, ddot_steps = phase_unimp_dedup(dev, edge_ms)
    rows += ddot_rows
    torch.cuda.empty_cache()
    weighted_rows, weighted_steps = phase_weighted(dev, host)
    rows += weighted_rows
    torch.cuda.empty_cache()
    sddmm_rows, sddmm_steps = phase_sddmm(dev, host)
    rows += sddmm_rows
    torch.cuda.empty_cache()
    zoo_steps = phase_zoo(dev, host, smi)
    torch.cuda.empty_cache()
    hetero_rows, hetero_steps = phase_hetero(dev, smi)
    rows += hetero_rows
    torch.cuda.empty_cache()
    readout_steps = phase_readouts(dev, host)
    torch.cuda.empty_cache()
    sampling_steps = phase_sampling(dev, smi, rows)
    print(json.dumps({"step": {
        "K1": dict(train, spmm_ms_per_step=spmm["K1"], tensor_s=t_k1),
        "dedup": dict(train_d, spmm_ms_per_step=spmm["dedup"],
                      tensor_s=t_dedup),
        "dedup_uncached": dict(train_6,
                               spmm_ms_per_step=spmm["dedup_uncached"],
                               tensor_s=t_6),
        **gat_steps, **dedup_steps, **unimp_steps, **ddot_steps,
        **weighted_steps, **sddmm_steps, **zoo_steps, **hetero_steps,
        **readout_steps, **sampling_steps, "device": smi}}),
        flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
