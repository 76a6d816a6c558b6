"""One rank of the parallel port's CPU parity runs, launched by
``tests/test_torch_parallel.py`` and ``tests/test_torch_halo_heter.py``:

    python tests/torch_parallel_ranks.py SUITE RANK SIZE PORT DIR

joins a gloo group of SIZE ranks on ``tcp://127.0.0.1:PORT`` (one torch
thread, every collective bounded by a 120 s timeout), reads its inputs
from ``DIR/inputs.npz`` (made from a seed with numpy by the test, flax
parameters carried as state dicts under ``sd/<layer>/<name>``), runs every
case of SUITE ("halo", "heter" or "two") on ``device="cpu"`` ("gpu": a halo GCN and GAT on ``cuda:0``, every rank
on the one card; "export" exports a halo and a ``ShardedGraph`` GCN, each
rank its own artifact in DIR, which the fresh ranks of "serve" load and
run) and writes ``DIR/rank<RANK>.npz``: the unsharded results
(the same on every rank) and this rank's own shards. Imports torch and the
port only. :func:`start` and :func:`finish` launch and collect the ranks
for the tests.
"""

import datetime
import os
import socket
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from pgl_tpu_torch import Graph, HeterGraph  # noqa: E402
from pgl_tpu_torch.parallel import (HaloGraph, HaloHeterGraph,  # noqa: E402
                                    ShardedEmbedding, ShardedGraph, comm,
                                    multihost)

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def state(inputs, name):
    """The state dict carried for layer ``name``."""
    pre = f"sd/{name}/"
    return {k[len(pre):]: torch.as_tensor(inputs[k]) for k in inputs.files
            if k.startswith(pre)}


def grads_summed(module, group=None):
    """Each parameter's gradient summed over the ranks (the trainer's
    convention), by name."""
    out = {}
    for k, p in module.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[k] = comm.all_reduce_(g.detach().clone(),
                                  group=group).cpu().numpy()
    return out


def masked_sq(out, mask):
    """Σ over this rank's real rows of out², the rank's share of the
    global loss."""
    return ((out ** 2) * mask.reshape((-1,) + (1,) * (out.ndim - 1))).sum()


def halo_suite(inp, rank, size, res):
    N = int(inp["N"])
    feat, edges = inp["FEAT"], inp["EDGES"]
    g = Graph(edges, num_nodes=N, node_feat={"h": feat})
    gt = g.tensor(CPU)
    hg = HaloGraph.from_graph(g, device=CPU)
    U = hg.unshard_node_values
    x = hg.node_feat["h"]
    res[f"shard_x_{rank}"] = x.numpy()
    res[f"shard_w_{rank}"] = hg.shard_edge_values(inp["W_E"]).numpy()
    res["round_x"] = U(hg.shard_node_values(feat))
    res["round_lab"] = U(hg.shard_node_values(inp["LAB"]))
    res["round_w"] = hg.unshard_edge_values(hg.shard_edge_values(inp["W_E"]))
    res["comm_bytes"] = np.array(hg.comm_bytes_per_exchange)
    rep = hg.scaling_report(feat_dim=128)
    for k, v in rep.items():
        res[f"report_{k}"] = np.asarray(v)
    for op in ("sum", "mean", "max", "min"):
        res[f"recv_{op}"] = U(hg.send_u_recv(x, op))
    res["recv_mean_1d"] = U(hg.send_u_recv(x[:, 0].contiguous(), "mean"))
    res["indegree"] = U(hg.indegree())
    res["outdegree"] = U(hg.outdegree())

    # the feature gradient, twice: the exchange's backward is one order
    for i in range(2):
        xg = x.clone().requires_grad_(True)
        masked_sq(hg.send_u_recv(xg, "sum"), hg.node_mask).backward()
        res[f"grad_x_{i}"] = U(xg.grad)

    w = hg.shard_edge_values(inp["W_E"])
    for mo in ("add", "sub", "mul", "div"):
        for ro in ("sum", "mean", "max", "min"):
            res[f"ue_{mo}_{ro}"] = U(hg.send_ue_recv(x, w, mo, ro))
    wv = hg.shard_edge_values(inp["W_VEC"])
    for ro in ("mean", "max"):
        res[f"ue_vec_{ro}"] = U(hg.send_ue_recv(x, wv, "mul", ro))
    # the weighted sum (K1w's route) and its two gradients
    xg = x.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    masked_sq(hg.send_ue_recv(xg, wg, "mul", "sum"), hg.node_mask).backward()
    res["ue_grad_x"] = U(xg.grad)
    res["ue_grad_w"] = hg.unshard_edge_values(wg.grad)

    a = hg.shard_node_values(inp["A"])
    b = hg.shard_node_values(inp["B"])
    for mo in ("add", "sub", "mul", "div"):
        res[f"uv_{mo}"] = hg.unshard_edge_values(hg.send_uv(a, b, mo))
    s = hg.shard_node_values(inp["A"][:, 0])
    scores = hg.send_uv(s, s, "add")
    res["uv_scalar"] = hg.unshard_edge_values(scores)
    from pgl_tpu_torch.nn.functional import edge_softmax
    res["softmax"] = hg.unshard_edge_values(edge_softmax(hg, scores))

    wh = hg.shard_node_values(inp["A"])

    def message(src, dst, edge):
        return {"m": src["h"] * 0.5 + dst["w"].sum(-1, keepdim=True)}

    msg = hg.send(message, src_feat={"h": x}, dst_feat={"w": wh})
    for op in ("sum", "mean", "max"):
        res[f"udf_{op}"] = U(hg.recv(op, msg))

    # the bf16 wire
    hgbf = HaloGraph.from_graph(g, halo_dtype=torch.bfloat16, device=CPU)
    xb = hgbf.node_feat["h"]
    res["bf16_comm_bytes"] = np.array(hgbf.comm_bytes_per_exchange)
    res["bf16_sum"] = U(hgbf.send_u_recv(xb, "sum"))
    xg = xb.clone().requires_grad_(True)
    masked_sq(hgbf.send_u_recv(xg, "sum"), hgbf.node_mask).backward()
    res["bf16_grad"] = U(xg.grad)
    res["bf16_t_comm"] = np.asarray(
        hgbf.scaling_report(feat_dim=128)["t_comm_s"])

    layers(inp, hg, gt, hgbf, rank, res)
    attention(inp, hg, res)
    zoo(inp, hg, res)
    degenerate(inp, rank, res)
    persistence(inp, hg, res)
    sharded(inp, g, gt, rank, size, res)
    hosts(inp, rank, size, res)
    embedding(inp, rank, res)


def run_layer(inp, hg, res, name, layer, *args):
    """``layer`` with the carried weights ``name`` on this rank's shard:
    the output, the feature gradient and the summed parameter gradients
    of the masked Σ out²."""
    U = hg.unshard_node_values
    layer.load_state_dict(state(inp, name), strict=True)
    xg = hg.node_feat["h"].clone().requires_grad_(True)
    out = layer(hg, xg, *args)
    masked_sq(out, hg.node_mask).backward()
    res[f"{name}_out"] = U(out)
    res[f"{name}_grad_x"] = U(xg.grad)
    for k, v in grads_summed(layer).items():
        res[f"{name}_grad/{k}"] = v


def layers(inp, hg, gt, hgbf, rank, res):
    from pgl_tpu_torch.nn import GATConv, GCNConv, TransformerConv
    import pgl_tpu_torch.nn.conv as conv
    D = int(inp["D"])
    U = hg.unshard_node_values
    x = hg.node_feat["h"]

    def run(name, layer, *args):
        run_layer(inp, hg, res, name, layer, *args)

    run("gcn", GCNConv(D, 4, device=CPU))
    gcn = GCNConv(D, 4, device=CPU)
    gcn.load_state_dict(state(inp, "gcn"))
    res["gcn_bf16_out"] = hgbf.unshard_node_values(
        gcn(hgbf, hgbf.node_feat["h"]))
    run("gat", GATConv(D, 6, num_heads=4, feat_drop=0.0, attn_drop=0.0,
                       device=CPU))
    run("tc", TransformerConv(D, 8, num_heads=4, feat_drop=0.0,
                              attn_drop=0.0, device=CPU))
    run("tc_mean", TransformerConv(D, 8, num_heads=4, feat_drop=0.0,
                                   attn_drop=0.0, concat=False, device=CPU))
    run("tc_ef", TransformerConv(D, 4, num_heads=2, feat_drop=0.0,
                                 attn_drop=0.0, device=CPU),
        hg.shard_edge_values(inp["EF"]))
    # attention dropout through the layer: the reference's seed, fixed
    seed = int(inp["LAYER_SEED"])
    real_seed = conv._attn_seed
    conv._attn_seed = lambda generator, rate: (
        None if rate <= 1e-15 else torch.tensor([seed], dtype=torch.int32))
    try:
        gat = GATConv(D, 6, num_heads=4, feat_drop=0.0, attn_drop=0.5,
                      device=CPU)
        gat.load_state_dict(state(inp, "gat"))
        res["gat_drop_out"] = U(gat(hg, x, training=True))
    finally:
        conv._attn_seed = real_seed


def attention(inp, hg, res):
    U = hg.unshard_node_values
    a_dst, a_src = (hg.shard_node_values(inp[k]) for k in ("AD", "AS"))
    v = hg.shard_node_values(inp["AV"])
    seed = int(inp["LAYER_SEED"])
    for tag, rate, seed in (("r0", 0.0, None), ("s", 0.5, seed),
                            ("s_again", 0.5, seed), ("other", 0.5, seed + 1)):
        res[f"gat_att_{tag}"] = U(hg.gat_attention(a_dst, a_src, v, 0.2,
                                                   rate, seed))
    # the attention layouts are square over n_loc = N_pad + S·H_pad: the
    # CSC rows past N_pad are empty
    csc, csr = hg._attention_layouts()
    empty = csc.empty_rows.long()
    res[f"att_layout_{hg.rank}"] = np.array([
        csc.num_rows, csr.num_rows, hg.n_pad, hg.num_shards * hg.h_pad,
        int((empty >= hg.n_pad).sum()), csc.num_edges, hg.kl + hg.kr])
    q, k, vv = (hg.shard_node_values(inp[n]) for n in ("Q", "K", "DV"))
    H = int(inp["DOT_H"])
    res["dot_att"] = U(hg.dot_attention(q, k, vv, H))
    res["dot_att_s5"] = U(hg.dot_attention(q, k, vv, H, 0.3, 5))
    # gradients of the dot attention
    ins = [t.clone().requires_grad_(True) for t in (q, k, vv)]
    masked_sq(hg.dot_attention(*ins, H), hg.node_mask).backward()
    for name, t in zip(("q", "k", "v"), ins):
        res[f"dot_grad_{name}"] = U(t.grad)


def zoo(inp, hg, res):
    """Every zoo layer on the halo layout with the reference's weights."""
    import pgl_tpu_torch.nn as gnn
    D = int(inp["D"])
    makes = {
        "graphsage": lambda: gnn.GraphSageConv(D, 6, device=CPU),
        "gcn": lambda: gnn.GCNConv(D, 6, device=CPU),
        "gatv2": lambda: gnn.GATv2Conv(D, 6, num_heads=2, feat_drop=0.0,
                                       attn_drop=0.0, device=CPU),
        "gin": lambda: gnn.GINConv(D, 6, device=CPU),
        "sgc": lambda: gnn.SGCConv(D, 6, k_hop=2, cached=False, device=CPU),
        "ngcf": lambda: gnn.NGCFConv(D, 6, device=CPU),
        "lightgcn": lambda: gnn.LightGCNConv(),
        "faconv": lambda: gnn.FAConv(D, drop=0.0, device=CPU),
    }
    for name, make in makes.items():
        run_layer(inp, hg, res, f"zoo_{name}", make())
    run_layer(inp, hg, res, "zoo_pinsage", gnn.PinSageConv(D, 6, device=CPU),
              hg.shard_edge_values(inp["EW"]))


def degenerate(inp, rank, res):
    """Tiny and zero-cut partitions, with the carried GAT weights."""
    from pgl_tpu_torch.nn import GATConv
    D = int(inp["D"])
    for tag in ("tiny", "zerocut"):
        edges, feat = inp[f"{tag.upper()}_EDGES"], inp[f"{tag.upper()}_FEAT"]
        n = feat.shape[0]
        parts = inp["ZEROCUT_PARTS"] if tag == "zerocut" else None
        g = Graph(edges, num_nodes=n, node_feat={"h": feat})
        hg = HaloGraph.from_graph(g, parts=parts, device=CPU)
        gt = g.tensor(CPU)
        res[f"{tag}_halo_size"] = np.array(hg.halo_size)
        res[f"{tag}_h_pad"] = np.array(hg.h_pad)
        res[f"{tag}_owned_{rank}"] = np.array(int(hg.node_mask.sum()))
        res[f"{tag}_sum_halo"] = hg.unshard_node_values(
            hg.send_u_recv(hg.node_feat["h"], "sum"))
        res[f"{tag}_sum_one"] = gt.send_recv(gt.node_feat["h"], "sum") \
            .numpy()
        layer = GATConv(D, 3, num_heads=2, feat_drop=0.0, attn_drop=0.0,
                        device=CPU)
        layer.load_state_dict(state(inp, "deg_gat"), strict=True)
        res[f"{tag}_gat_halo"] = hg.unshard_node_values(
            layer(hg, hg.node_feat["h"]))
        res[f"{tag}_gat_one"] = layer(gt, gt.node_feat["h"]).detach().numpy()


def persistence(inp, hg, res):
    """The port's save and load, and a partition the reference saved."""
    out_dir = os.environ["PGL_TEST_DIR"]
    mine = os.path.join(out_dir, "port_halo.npz")
    hg.save(mine)
    a = hg.shard_node_values(inp["AD"][:, :2])
    v = hg.shard_node_values(inp["AV"][:, :8])
    res["load_fresh_gat"] = hg.unshard_node_values(hg.gat_attention(a, a, v))
    for tag, path in (("port", mine),
                      ("ref", os.path.join(out_dir, "ref_halo.npz"))):
        h2 = HaloGraph.load(path, device=CPU)
        res[f"load_{tag}_meta"] = np.array([h2.num_nodes, h2.num_edges,
                                            h2.halo_size])
        res[f"load_{tag}_sum"] = h2.unshard_node_values(
            h2.send_u_recv(h2.node_feat["h"], "sum"))
        res[f"load_{tag}_gat"] = h2.unshard_node_values(
            h2.gat_attention(a, a, v))


def sharded(inp, g, gt, rank, size, res):
    feat = torch.as_tensor(inp["FEAT"])
    sg = ShardedGraph.from_graph(g, device=CPU)
    res[f"sg_edges_{rank}"] = sg.edges.numpy()
    for op in ("sum", "mean", "max", "min"):
        res[f"sg_{op}"] = sg.send_u_recv(feat, op).numpy()
    res["sg_mean_1d"] = sg.send_u_recv(feat[:, 0].contiguous(),
                                       "mean").numpy()
    res["sg_indegree"] = sg.indegree().numpy()
    res["sg_outdegree"] = sg.outdegree().numpy()
    w = sg.shard_edge_values(inp["W_E"])
    for mo in ("add", "sub", "mul", "div"):
        for ro in ("sum", "mean", "max", "min"):
            res[f"sg_ue_{mo}_{ro}"] = sg.send_ue_recv(feat, w, mo, ro).numpy()
    a = torch.as_tensor(inp["A"][:, 0])
    perm, k = sg._host_perm, sg.k

    def to_edges(per_rank):
        """Every rank's real edge values, in the original edge order."""
        got = comm.all_gather(per_rank).numpy()
        perms = comm.all_gather(torch.as_tensor(perm)).numpy()
        counts = comm.all_gather(torch.tensor([k])).numpy()[:, 0]
        out = np.zeros(inp["EDGES"].shape[0], got.dtype)
        for r in range(size):
            out[perms[r, :counts[r]]] = got[r, :counts[r]]
        return out

    scores = sg.send_uv(a, a, "add")
    res["sg_uv"] = to_edges(scores)
    res["sg_softmax"] = to_edges(sg.edge_softmax(
        sg.shard_edge_values(res["sg_uv"])))
    # gradients: the loss every rank computes whole, divided by the size
    for i in range(2):
        xg = feat.clone().requires_grad_(True)
        ((sg.send_u_recv(xg, "sum") ** 2).sum() / size).backward()
        res[f"sg_grad_{i}"] = comm.all_reduce_(xg.grad.clone()).numpy()
    from pgl_tpu_torch.nn import GCNConv
    layer = GCNConv(int(inp["D"]), 4, device=CPU)
    layer.load_state_dict(state(inp, "gcn"))
    xg = feat.clone().requires_grad_(True)
    out = layer(sg, xg)
    ((out ** 2).sum() / size).backward()
    res["sg_gcn_out"] = out.detach().numpy()
    res["sg_gcn_grad_x"] = comm.all_reduce_(xg.grad.clone()).numpy()
    for kk, v in grads_summed(layer).items():
        res[f"sg_gcn_grad/{kk}"] = v
    for strategy in ("dst_mod", "round_robin"):
        s2 = ShardedGraph.from_graph(g, strategy=strategy, device=CPU)
        res[f"sg_{strategy}_sum"] = s2.send_u_recv(feat, "sum").numpy()


def hosts(inp, rank, size, res):
    """multihost over every rank and over the group of ranks 0 and 1."""
    N = int(inp["N"])
    feat = torch.as_tensor(inp["FEAT"])
    pair = torch.distributed.new_group([0, 1])
    for tag, group, n in (("all", None, size), ("pair", pair, 2)):
        if rank >= n:
            continue
        shards = [inp[f"HOST_SHARD_{i}"] for i in range(n)]
        vals = [inp[f"HOST_W_{i}"] for i in range(n)]
        sg = multihost.sharded_graph_from_host_shards(
            lambda sid: shards[sid], N, group=group, device=CPU)
        res[f"mh_{tag}_sum"] = sg.send_u_recv(feat, "sum").numpy()
        w = multihost.shard_edge_values_from_host_shards(
            sg, lambda sid: vals[sid])
        res[f"mh_{tag}_mul"] = sg.send_ue_recv(feat, w, "mul", "sum").numpy()
        res[f"mh_{tag}_e_pad"] = np.array(sg.e_pad)
    torch.distributed.barrier()


def embedding(inp, rank, res):
    emb = ShardedEmbedding(int(inp["EMB_ROWS"]), int(inp["EMB_DIM"]),
                           seed=int(inp["EMB_SEED"]), device=CPU)
    res[f"emb_block_{rank}"] = emb.table.detach().numpy().copy()
    ids = torch.as_tensor(inp[f"EMB_IDS_{rank}"])
    rows = emb.lookup(ids)
    res[f"emb_rows_{rank}"] = rows.detach().numpy()
    (rows * torch.as_tensor(inp[f"EMB_G_{rank}"])).sum().backward()
    res[f"emb_grad_{rank}"] = emb.table.grad.numpy()
    emb.apply_sparse_grad(ids, torch.as_tensor(inp[f"EMB_G_{rank}"]), 0.1)
    res[f"emb_after_{rank}"] = emb.table.detach().numpy()


def heter_suite(inp, rank, size, res):
    from pgl_tpu_torch.models import RUniMP, label_propagation_smooth
    from pgl_tpu_torch.nn import RGCNConv
    N, D = int(inp["N"]), int(inp["D"])
    etypes = ["cites", "writes"]
    edges = {t: inp[f"EDGES_{t}"] for t in etypes}
    hgr = HeterGraph(edges, num_nodes=N, node_feat={"h": inp["FEAT"]})
    hhg = HaloHeterGraph.from_heter_graph(hgr, device=CPU)
    U = hhg.unshard_node_values
    for t in etypes:
        for key, val in hhg[t]._host.items():
            res[f"built_{t}_{key}"] = val
    res["round_x"] = U(hhg.shard_node_values(inp["FEAT"]))
    x = hhg.node_feat["h"]
    rgcn = RGCNConv(D, 6, etypes, num_bases=2, device=CPU)
    rgcn.load_state_dict(state(inp, "rgcn"))
    res["rgcn_out"] = U(rgcn(hhg, x))
    model = RUniMP(D, 3, etypes, num_layers=2, hidden_size=4, num_heads=2,
                   dropout=0.0, device=CPU)
    model.load_state_dict(state(inp, "runimp"))
    lab = hhg.shard_node_values(inp["LAB"]).to(torch.int64)
    msk = hhg.shard_node_values(inp["MSK"].astype(np.float32)) > 0.5
    out = model(hhg, x, lab, msk)
    node_mask = hhg["cites"].node_mask
    masked_sq(out, node_mask).backward()
    res["runimp_out"] = U(out)
    for k, v in grads_summed(model).items():
        res[f"runimp_grad/{k}"] = v
    # label propagation on one relation's HaloGraph
    cites = hhg["cites"]
    probs = cites.shard_node_values(inp["PROBS"])
    gold = cites.shard_node_values(inp["GOLD"])
    train = cites.shard_node_values(inp["TRAIN"])
    res["smooth"] = U(label_propagation_smooth(cites, probs, gold, train))
    # save and load
    path = os.path.join(os.environ["PGL_TEST_DIR"], "hetero")
    hhg.save(path)
    h2 = HaloHeterGraph.load(path, device=CPU)
    res["load_halo_size"] = np.array([h2.halo_size, hhg.halo_size])
    rgcn2 = RGCNConv(D, 5, etypes, device=CPU)
    res["load_rgcn"] = h2.unshard_node_values(rgcn2(h2, h2.node_feat["h"]))
    res["fresh_rgcn"] = U(rgcn2(hhg, x))


def gpu_suite(inp, rank, size, res):
    """The halo GCN and GAT on ``cuda:0`` (every rank on the one card):
    the unsharded output, the feature gradient twice and the parameter
    gradients summed over the ranks; rank 0 also runs the whole graph."""
    from pgl_tpu_torch.models import GAT, GCN
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk
    dev = torch.device("cuda:0")
    N, F = int(inp["N"]), inp["FEAT"].shape[1]
    g = Graph(inp["EDGES"], num_nodes=N, node_feat={"h": inp["FEAT"]})
    hg = HaloGraph.from_graph(g, partition="metis", device=dev)
    gt = g.tensor(dev)
    makes = {"gcn": lambda: GCN(F, 4, num_layers=2, hidden_size=16,
                                dropout=0.0, device=dev),
             "gat": lambda: GAT(F, 4, num_heads=4, hidden_size=8,
                                feat_drop=0.0, attn_drop=0.0, device=dev)}
    for name, make in makes.items():
        model = make()
        sk.reset_launches()
        ak.reset_launches()
        for i in range(2):
            model.zero_grad()
            x = hg.node_feat["h"].clone().requires_grad_(True)
            out = model(hg, x)
            masked_sq(out, hg.node_mask).backward()
            res[f"{name}_grad_x_{i}"] = hg.unshard_node_values(x.grad)
        res[f"{name}_out"] = hg.unshard_node_values(out)
        res[f"{name}_k1_{rank}"] = np.array(sum(
            v for (kind, _), v in sk.LAUNCHES_BY_SHAPE.items()
            if kind.startswith("halo_")))
        res[f"{name}_attn_{rank}"] = np.array(sum(
            ak.LAUNCHES_BY_SHAPE.values()))
        for k, v in grads_summed(model).items():
            res[f"{name}_grad/{k}"] = v
        if rank == 0:
            model.zero_grad()
            x = gt.node_feat["h"].clone().requires_grad_(True)
            out = model(gt, x)
            (out ** 2).sum().backward()
            res[f"{name}_one_out"] = out.detach().cpu().numpy()
            res[f"{name}_one_grad_x"] = x.grad.cpu().numpy()
            for k, p in model.named_parameters():
                res[f"{name}_one_grad/{k}"] = p.grad.cpu().numpy()


def two_suite(inp, rank, size, res):
    """On 2 ranks: ``ShardedGraph`` max and min under ``round_robin``,
    whose edges into one destination tie across the ranks (each case's
    feature gradient of Σ out / size, summed over the ranks), and a KGE
    loss over ``sharded_kg_params`` (each rank its own batch)."""
    for case in ("pair", "uneven"):
        g = Graph(inp[f"TIE_{case}_EDGES"], num_nodes=int(
            inp[f"TIE_{case}_N"]))
        sg = ShardedGraph.from_graph(g, strategy="round_robin", device=CPU)
        res[f"tie_{case}_edges_{rank}"] = np.array(sg.k)
        for op in ("max", "min"):
            xg = torch.as_tensor(inp[f"TIE_{case}_X"]).requires_grad_(True)
            out = sg.send_u_recv(xg, op)
            (out.sum() / size).backward()
            res[f"tie_{case}_{op}"] = out.detach().numpy()
            res[f"tie_{case}_{op}_grad"] = comm.all_reduce_(
                xg.grad.clone()).numpy()
    from pgl_tpu_torch.models.kg import KGEModel, sharded_kg_params
    model = KGEModel(*inp["KG_SHAPE"], score="transe", seed=3, device=CPU)
    params = sharded_kg_params(model, device=CPU)
    h, r, t, neg = (torch.as_tensor(inp[f"KG_{k}"][rank])
                    for k in ("H", "R", "T", "NEG"))
    loss = model.loss_fn(params, h, r, t, neg)
    loss.backward()
    res[f"kg_loss_{rank}"] = loss.detach().numpy()
    res[f"kg_ent_grad_{rank}"] = params["ent"].table.grad.numpy()
    res["kg_rel_grad"] = comm.all_reduce_(params["rel"].grad.clone()).numpy()
    with torch.no_grad():
        res[f"kg_pred_{rank}"] = model.predict_all_tails(params, h, r)


EXPORTED = ("halo_gcn", "sharded_gcn")


def _export_graphs(inp, rank):
    """The halo and edge shards of the inputs' graph and each one's input
    feature."""
    g = Graph(inp["EDGES"], num_nodes=int(inp["N"]),
              node_feat={"h": inp["FEAT"]})
    hg = HaloGraph.from_graph(g, device=CPU)
    sg = ShardedGraph.from_graph(g, device=CPU)
    return {"halo_gcn": (hg, hg.node_feat["h"]),
            "sharded_gcn": (sg, torch.as_tensor(inp["FEAT"]))}


def export_suite(inp, rank, size, res):
    """The reference GCN's carried weights on each shard: the eager
    output (this rank's, and unsharded), and the program each rank exports
    (``DIR/<model>_r<RANK>.pt2``, with its input) and its op calls."""
    from pgl_tpu_torch.models import GCN
    from pgl_tpu_torch.utils.export import export_model, op_calls
    tmp = os.environ["PGL_TEST_DIR"]
    for name, (graph, x) in _export_graphs(inp, rank).items():
        model = GCN(inp["FEAT"].shape[1], 3, hidden_size=16, device=CPU)
        model.load_state_dict(state(inp, "gcn"), strict=True)
        program = export_model(lambda x: model(graph, x), (x,),
                               os.path.join(tmp, f"{name}_r{rank}.pt2"))
        torch.save(x, os.path.join(tmp, f"{name}_x{rank}.pt"))
        calls = op_calls(program)
        res[f"{name}_op_names_{rank}"] = np.array(sorted(calls))
        res[f"{name}_op_calls_{rank}"] = np.array(
            [calls[k] for k in sorted(calls)])
        with torch.no_grad():
            out = model(graph, x)
        res[f"{name}_eager_{rank}"] = out.numpy()
        res[f"{name}_out"] = (graph.unshard_node_values(out)
                              if name == "halo_gcn" else out.numpy())


def serve_suite(inp, rank, size, res):
    """Fresh ranks: each serves its own artifacts (``Predictor`` in the
    world of the export) and refuses the next rank's."""
    from pgl_tpu_torch.utils.export import Predictor
    tmp = os.environ["PGL_TEST_DIR"]
    for name in EXPORTED:
        x = torch.load(os.path.join(tmp, f"{name}_x{rank}.pt"))
        res[f"{name}_served_{rank}"] = Predictor(os.path.join(
            tmp, f"{name}_r{rank}.pt2")).run(x).numpy()
        try:
            Predictor(os.path.join(tmp, f"{name}_r{(rank + 1) % size}.pt2"))
        except RuntimeError as err:
            res[f"{name}_refused_{rank}"] = np.array(
                f"exported by rank {(rank + 1) % size}" in str(err))
        else:
            res[f"{name}_refused_{rank}"] = np.array(False)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(suite: str, size: int, out_dir) -> list:
    """Launch ``size`` ranks of ``suite`` on ``out_dir``'s inputs (one
    thread each); :func:`finish` waits for them."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r),
         str(size), str(port), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for r in range(size)]


def finish(procs, out_dir, timeout: float = 240.0) -> dict:
    """Wait at most ``timeout`` seconds for the ranks (killing them after)
    and return rank 0's results plus every rank's own (``rank<r>/...``);
    raises with a failed rank's output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"RANK{r} PASS" not in out:
            raise AssertionError(f"rank {r} failed:\n{out[-6000:]}")
    res = dict(np.load(os.path.join(out_dir, "rank0.npz")))
    for r in range(1, len(procs)):
        z = np.load(os.path.join(out_dir, f"rank{r}.npz"))
        res.update({k: z[k] for k in z.files if k not in res})
    return res


def main():
    suite, rank, size, port, out_dir = sys.argv[1:6]
    rank, size = int(rank), int(size)
    os.environ["PGL_TEST_DIR"] = out_dir
    comm.init(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
              world_size=size, rank=rank,
              timeout=datetime.timedelta(seconds=120))
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    res = {}
    {"halo": halo_suite, "heter": heter_suite, "two": two_suite,
     "gpu": gpu_suite, "export": export_suite,
     "serve": serve_suite}[suite](inp, rank, size, res)
    out = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                         else v) for k, v in res.items()}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"RANK{rank} PASS", flush=True)


if __name__ == "__main__":
    main()
