"""Port parity for the parallel layer: ``pgl_tpu_torch.parallel``'s
``HaloGraph``, ``ShardedGraph``, ``ShardedEmbedding`` and ``multihost`` on
4 gloo ranks on the CPU against ``pgl_tpu.parallel`` on a mesh of 4 host
devices; mirrors ``tests/test_halo_graph.py``, ``test_dist_graph.py`` and
``test_halo_multiprocess.py`` case by case.

The port's ranks run once for the whole file (``torch_parallel_ranks.py``,
one process a rank, one torch thread each, every wait bounded) on inputs
made here from a seed with numpy and flax parameters carried as state
dicts; their results come back through an npz. Meanwhile the reference
runs here, each group of its calls one program under ``jax.jit`` (eager,
every ``shard_map`` would compile apart, about 3 s each on this host).
The layer zoo (``tests/test_halo_graph.py``'s, PinSage included) runs on
the reference's HaloGraph in one ``jax.jit`` group, its flax parameters
carried to the ranks as state dicts.

Tolerance: host index arrays, shards and dropout masks exactly; float32
sums at rtol 1e-5 and atol 1e-5; gradients at rtol 1e-4, atol 1e-5 (sums
in another order), as the port's other parity tests.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

pytest.importorskip("flax")

import pgl_tpu
import pgl_tpu.nn as jnn
import pgl_tpu_torch as pgl_torch
import pgl_tpu.nn.functional as JGF
from pgl_tpu.parallel import HaloGraph as JHaloGraph
from pgl_tpu.parallel import ShardedEmbedding as JShardedEmbedding
from pgl_tpu.parallel import ShardedGraph as JShardedGraph
from pgl_tpu.parallel import build_halo_partition as j_build
from pgl_tpu.parallel import multihost as jmultihost
from pgl_tpu.parallel import shard_edges as j_shard_edges
from pgl_tpu_torch.parallel import (HaloGraph, ShardedGraph, comm,
                                    build_halo_partition, multihost,
                                    shard_edges)
from pgl_tpu_torch.utils.convert import flax_to_state_dict

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

S = 4
RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-4

N, E, D = 37, 141, 5
rng = np.random.default_rng(7)
EDGES = rng.integers(0, N, (E, 2))
FEAT = rng.normal(size=(N, D)).astype(np.float32)
W_E = (rng.uniform(0.5, 1.5, E) * np.sign(rng.normal(size=E))).astype(
    np.float32)
W_VEC = rng.uniform(0.5, 1.5, (E, D)).astype(np.float32)
A = rng.normal(size=(N, 3)).astype(np.float32)
B = (rng.uniform(0.5, 1.5, (N, 3))
     * np.sign(rng.normal(size=(N, 3)))).astype(np.float32)
LAB = rng.integers(0, 3, N)
EF = rng.normal(size=(E, 8)).astype(np.float32)
EW = rng.uniform(0.5, 1.5, (E, 1)).astype(np.float32)
DOT_H, DSH = 4, 32
Q = rng.normal(size=(N, DOT_H * DSH)).astype(np.float32) * 0.2
K = rng.normal(size=(N, DOT_H * DSH)).astype(np.float32) * 0.2
DV = rng.normal(size=(N, DOT_H * DSH)).astype(np.float32)
# the attention dropout seed of ``gat_attention`` and of the GAT layer
LAYER_SEED = 77
# a graph of 5 nodes over 4 ranks (contiguous ranges 2, 2, 1, 0: a rank
# of one node and an empty one) and a zero-cut one (no remote edge)
TINY_EDGES = rng.integers(0, 5, (9, 2))
TINY_FEAT = rng.normal(size=(5, D)).astype(np.float32)
ZEROCUT_PARTS = np.arange(32) // 8
ZEROCUT_EDGES = np.concatenate(
    [rng.integers(0, 8, (20, 2)) + 8 * c for c in range(S)])
ZEROCUT_FEAT = rng.normal(size=(32, D)).astype(np.float32)
HOST_SHARDS = [rng.integers(0, N, (30 + 7 * i, 2)) for i in range(S)]
HOST_W = [rng.normal(size=len(s)).astype(np.float32) for s in HOST_SHARDS]
EMB_ROWS, EMB_DIM, EMB_SEED = 101, 8, 3
EMB_IDS = [rng.integers(0, EMB_ROWS, 12) for _ in range(S)]
EMB_G = [rng.normal(size=(12, EMB_DIM)).astype(np.float32)
         for _ in range(S)]


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=ATOL)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(n=S, axis="node"):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _layers():
    return {
        "gcn": (jnn.GCNConv(input_size=D, output_size=4), ()),
        "gat": (jnn.GATConv(input_size=D, hidden_size=6, num_heads=4,
                            feat_drop=0.0, attn_drop=0.0), ()),
        "tc": (jnn.TransformerConv(input_size=D, hidden_size=8, num_heads=4,
                                   feat_drop=0.0, attn_drop=0.0), ()),
        "tc_mean": (jnn.TransformerConv(input_size=D, hidden_size=8,
                                        num_heads=4, feat_drop=0.0,
                                        attn_drop=0.0, concat=False), ()),
        "tc_ef": (jnn.TransformerConv(input_size=D, hidden_size=4,
                                      num_heads=2, feat_drop=0.0,
                                      attn_drop=0.0), ("EF",)),
    }


def _zoo():
    """The zoo of ``tests/test_halo_graph.py`` (each layer's graph-op
    composition on the halo layout) and the edge values each takes."""
    return {
        "graphsage": (jnn.GraphSageConv(input_size=D, hidden_size=6), ()),
        "gcn": (jnn.GCNConv(input_size=D, output_size=6), ()),
        "gatv2": (jnn.GATv2Conv(input_size=D, hidden_size=6, num_heads=2,
                                feat_drop=0.0, attn_drop=0.0), ()),
        "gin": (jnn.GINConv(input_size=D, output_size=6), ()),
        "sgc": (jnn.SGCConv(input_size=D, output_size=6, k_hop=2,
                            cached=False), ()),
        "ngcf": (jnn.NGCFConv(input_size=D, output_size=6), ()),
        "lightgcn": (jnn.LightGCNConv(), ()),
        "faconv": (jnn.FAConv(hidden_size=D, drop=0.0), ()),
        "pinsage": (jnn.PinSageConv(input_size=D, hidden_size=6), ("EW",)),
    }


def _gat_inputs(params):
    """(a_dst, a_src, v) of the GAT layer ``params`` on FEAT, float32."""
    p = _numpy_tree(params)["params"]
    v = FEAT @ p["linear"]["kernel"] + p["linear"]["bias"]
    heads = v.reshape(N, 4, 6)
    return ((heads * p["weight_dst"]).sum(-1).astype(np.float32),
            (heads * p["weight_src"]).sum(-1).astype(np.float32),
            v.astype(np.float32))


def _single():
    return pgl_tpu.Graph(EDGES, num_nodes=N, node_feat={"h": FEAT}).tensor()


@pytest.fixture(scope="module")
def runs():
    """(port, ref): the ranks' results and the reference's, computed while
    the ranks run."""
    with tempfile.TemporaryDirectory() as tmp:
        gj = _single()
        mesh = _mesh()
        ref = {"mesh": mesh}
        hg = JHaloGraph.from_graph(
            pgl_tpu.Graph(EDGES, num_nodes=N, node_feat={"h": FEAT}), mesh)
        ref["hg"] = hg
        hg.save(os.path.join(tmp, "ref_halo.npz"))
        inputs = dict(N=N, D=D, EDGES=EDGES, FEAT=FEAT, W_E=W_E,
                      W_VEC=W_VEC, A=A, B=B, LAB=LAB, EF=EF, EW=EW, Q=Q, K=K,
                      DV=DV, DOT_H=DOT_H,
                      LAYER_SEED=LAYER_SEED, TINY_EDGES=TINY_EDGES,
                      TINY_FEAT=TINY_FEAT, ZEROCUT_EDGES=ZEROCUT_EDGES,
                      ZEROCUT_FEAT=ZEROCUT_FEAT, ZEROCUT_PARTS=ZEROCUT_PARTS,
                      EMB_ROWS=EMB_ROWS, EMB_DIM=EMB_DIM, EMB_SEED=EMB_SEED)
        for i in range(S):
            inputs[f"HOST_SHARD_{i}"] = HOST_SHARDS[i]
            inputs[f"HOST_W_{i}"] = HOST_W[i]
            inputs[f"EMB_IDS_{i}"] = EMB_IDS[i]
            inputs[f"EMB_G_{i}"] = EMB_G[i]
        params = {}
        for name, (layer, extra) in _layers().items():
            args = [jnp.asarray(inputs[k]) for k in extra]
            # under jax.jit: eager flax takes seconds a call here
            params[name] = jax.jit(layer.init)(jax.random.key(0), gj,
                                               gj.node_feat["h"], *args)
            sd = flax_to_state_dict(_numpy_tree(params[name]), "cpu")
            inputs.update({f"sd/{name}/{k}": v.numpy()
                           for k, v in sd.items()})
        # the zoo's parameters, initialised in one program
        zoo = _zoo()
        params["zoo"] = jax.jit(lambda g, x, ew: {
            name: layer.init(jax.random.key(0), g, x,
                             *(ew for _ in extra))
            for name, (layer, extra) in zoo.items()})(
                gj, gj.node_feat["h"], jnp.asarray(EW))
        for name, p in params["zoo"].items():
            sd = flax_to_state_dict(_numpy_tree(p), "cpu")
            inputs.update({f"sd/zoo_{name}/{k}": v.numpy()
                           for k, v in sd.items()})
        # a GAT layer for the degenerate partitions
        params["deg_gat"] = jax.jit(jnn.GATConv(
            input_size=D, hidden_size=3, num_heads=2, feat_drop=0.0,
            attn_drop=0.0).init)(jax.random.key(2), gj, gj.node_feat["h"])
        sd = flax_to_state_dict(_numpy_tree(params["deg_gat"]), "cpu")
        inputs.update({f"sd/deg_gat/{k}": v.numpy() for k, v in sd.items()})
        ref["params"] = params
        # gat_attention's inputs are the GAT layer's own, so one reference
        # call at dropout holds both the op and the layer
        ref["att_in"] = _gat_inputs(params["gat"])
        inputs.update(zip(("AD", "AS", "AV"), ref["att_in"]))
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        procs = ranks.start("halo", S, tmp)
        try:
            _reference(ref, gj)
        finally:
            port = ranks.finish(procs, tmp)
        port["_dir"] = tmp
        yield port, ref


def _message(src, dst, edge):
    return {"m": src["h"] * 0.5 + dst["w"].sum(-1, keepdims=True)}


def _masked_sq(out, mask):
    """Σ over the real rows of out² (``mask`` [S, N_pad])."""
    return ((out ** 2) * mask.reshape(mask.shape + (1,) * (out.ndim - 2))
            ).sum()


def _reference(ref, gj):
    """The reference's results on the mesh (``pgl_tpu.parallel``), each
    group of calls one program under ``jax.jit`` (the graphs are pytree
    arguments): eager, every ``shard_map`` would compile on its own."""
    hg, mesh = ref["hg"], ref["mesh"]
    U, UE = hg.unshard_node_values, hg.unshard_edge_values
    x = hg.shard_node_values(FEAT)
    w, wv = hg.shard_edge_values(W_E), hg.shard_edge_values(W_VEC)
    a, b = hg.shard_node_values(A), hg.shard_node_values(B)
    s0 = hg.shard_node_values(A[:, 0])
    mask = jnp.asarray(hg._host_node_mask)

    @jax.jit
    def ops(hg, x, w, wv, a, b, s0):
        node, edge = {}, {}
        for op in ("sum", "mean", "max", "min"):
            node[f"recv_{op}"] = hg.send_u_recv(x, op)
        for mo in ("add", "sub", "mul", "div"):
            for ro in ("sum", "mean", "max", "min"):
                node[f"ue_{mo}_{ro}"] = hg.send_ue_recv(x, w, mo, ro)
            edge[f"uv_{mo}"] = hg.send_uv(a, b, mo)
        for ro in ("mean", "max"):
            node[f"ue_vec_{ro}"] = hg.send_ue_recv(x, wv, "mul", ro)
        edge["uv_scalar"] = hg.send_uv(s0, s0, "add")
        edge["softmax"] = JGF.edge_softmax(hg, edge["uv_scalar"])
        node["indegree"] = hg.indegree()
        node["outdegree"] = hg.outdegree()
        msg = hg.send(_message, src_feat={"h": x}, dst_feat={"w": a})
        for op in ("sum", "mean", "max"):
            node[f"udf_{op}"] = hg.recv(op, msg)
        node["grad_x"] = jax.grad(lambda x: _masked_sq(
            hg.send_u_recv(x, "sum"), mask))(x)
        node["ue_grad_x"], edge["ue_grad_w"] = jax.grad(
            lambda x, w: _masked_sq(hg.send_ue_recv(x, w, "mul", "sum"),
                                    mask), argnums=(0, 1))(x, w)
        return node, edge

    node, edge = ops(hg, x, w, wv, a, b, s0)
    ref.update({k: U(v) for k, v in node.items()})
    ref.update({k: UE(v) for k, v in edge.items()})

    # the layers: outputs, feature and parameter gradients
    efh = hg.shard_edge_values(EF)
    for name, (layer, extra) in _layers().items():
        args = (efh,) if extra else ()

        def loss(p, hg, x, *args, layer=layer):
            out = layer.apply(p, hg, x, *args)
            return _masked_sq(out, mask), out

        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 2), has_aux=True))(ref["params"][name], hg, x,
                                                 *args)
        ref[f"{name}_out"], ref[f"{name}_grad_x"] = U(out), U(gx)
        ref[f"{name}_grad"] = flax_to_state_dict(_numpy_tree(gp), "cpu")

    # the zoo, in one program: outputs, feature and parameter gradients
    @jax.jit
    def zoo(hg, params, x, ew):
        got = {}
        for name, (layer, extra) in _zoo().items():
            args = (ew,) if extra else ()

            def loss(p, x, layer=layer, args=args):
                out = layer.apply(p, hg, x, *args)
                return _masked_sq(out, mask), out

            (_, out), grads = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(params[name], x)
            got[name] = (out, grads)
        return got

    for name, (out, (gp, gx)) in zoo(hg, ref["params"]["zoo"], x,
                                     hg.shard_edge_values(EW)).items():
        ref[f"zoo_{name}_out"], ref[f"zoo_{name}_grad_x"] = U(out), U(gx)
        ref[f"zoo_{name}_grad"] = flax_to_state_dict(_numpy_tree(gp), "cpu")

    # attention: the GAT layer's own inputs at dropout 0.5, the layer at
    # dropout with its seed pinned, the dot attention and its gradients
    ad, as_, av = (hg.shard_node_values(t) for t in ref["att_in"])
    q, k, dv = (hg.shard_node_values(t) for t in (Q, K, DV))
    gat = jnn.GATConv(input_size=D, hidden_size=6, num_heads=4,
                      feat_drop=0.0, attn_drop=0.5)
    import pgl_tpu.nn.conv as jconv
    real = jconv._attn_drop_seed
    jconv._attn_drop_seed = lambda module, rate: (
        None if rate <= 1e-15 else jnp.int32(LAYER_SEED))
    try:
        @jax.jit
        def attention(hg, ad, as_, av, seed, q, k, dv, x):
            dot = jax.value_and_grad(lambda q, k, v: _masked_sq(
                hg.dot_attention(q, k, v, DOT_H), mask),
                argnums=(0, 1, 2))
            _, dot_grads = dot(q, k, dv)
            return (hg.gat_attention(ad, as_, av, 0.2, 0.5, seed),
                    hg.gat_attention(ad, as_, av, 0.2),
                    hg.dot_attention(q, k, dv, DOT_H), dot_grads,
                    gat.apply(ref["params"]["gat"], hg, x, True,
                              rngs={"dropout": jax.random.key(1)}))

        att, att0, dot, dot_grads, gat_drop = attention(
            hg, ad, as_, av, jnp.int32(LAYER_SEED), q, k, dv, x)
    finally:
        jconv._attn_drop_seed = real
    ref.update(gat_att=U(att), gat_att_r0=U(att0), dot_att=U(dot),
               gat_drop_out=U(gat_drop))
    for nm, g in zip("qkv", dot_grads):
        ref[f"dot_grad_{nm}"] = U(g)

    # the bf16 wire
    hgbf = JHaloGraph.from_graph(
        pgl_tpu.Graph(EDGES, num_nodes=N, node_feat={"h": FEAT}), mesh,
        halo_dtype="bfloat16")
    ref["hgbf"] = hgbf
    xb = hgbf.shard_node_values(FEAT)
    out, grad = jax.jit(lambda hg, x: (
        hg.send_u_recv(x, "sum"), jax.grad(lambda x: _masked_sq(
            hg.send_u_recv(x, "sum"), mask))(x)))(hgbf, xb)
    ref["bf16_sum"], ref["bf16_grad"] = (hgbf.unshard_node_values(out),
                                         hgbf.unshard_node_values(grad))

    # degenerate partitions: sums and a GAT layer
    deg_gat = jnn.GATConv(input_size=D, hidden_size=3, num_heads=2,
                          feat_drop=0.0, attn_drop=0.0)
    for tag, edges, feat, parts in (
            ("tiny", TINY_EDGES, TINY_FEAT, None),
            ("zerocut", ZEROCUT_EDGES, ZEROCUT_FEAT, ZEROCUT_PARTS)):
        g = JHaloGraph.from_graph(
            pgl_tpu.Graph(edges, num_nodes=len(feat)), mesh, parts=parts)
        xs = g.shard_node_values(feat)
        out, gout = jax.jit(lambda g, x: (
            g.send_u_recv(x, "sum"),
            deg_gat.apply(ref["params"]["deg_gat"], g, x)))(g, xs)
        ref[f"{tag}_sum"] = g.unshard_node_values(out)
        ref[f"{tag}_gat"] = g.unshard_node_values(gout)
        ref[f"{tag}_halo_size"] = g.halo_size

    # ShardedGraph: its ops, gradients and the GCN layer
    sg = JShardedGraph.from_graph(
        pgl_tpu.Graph(EDGES, num_nodes=N, node_feat={"h": FEAT}),
        _mesh(axis="edge"))
    ref["sg"] = sg
    fx = jnp.asarray(FEAT)
    gcn, _ = _layers()["gcn"]

    @jax.jit
    def sharded(sg, fx, w, s0):
        out = {f"sg_{op}": sg.send_u_recv(fx, op)
               for op in ("sum", "mean", "max", "min")}
        for mo in ("add", "sub", "mul", "div"):
            for ro in ("sum", "mean", "max", "min"):
                out[f"sg_ue_{mo}_{ro}"] = sg.send_ue_recv(fx, w, mo, ro)
        out["sg_indegree"] = sg.indegree()
        out["sg_outdegree"] = sg.outdegree()
        scores = sg.send_uv(s0, s0, "add")
        out["sg_uv"], out["sg_softmax"] = scores, sg.edge_softmax(scores)
        out["sg_grad"] = jax.grad(lambda x: (sg.send_u_recv(x, "sum")
                                             ** 2).sum())(fx)

        def loss(p, x):
            o = gcn.apply(p, sg, x)
            return (o ** 2).sum(), o

        (_, out["sg_gcn_out"]), (gp, out["sg_gcn_grad_x"]) = \
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
                ref["params"]["gcn"], fx)
        return out, gp

    out, gp = sharded(sg, fx, sg.shard_edge_values(W_E), jnp.asarray(A[:, 0]))
    perm, smask = np.asarray(sg.perm).reshape(-1), \
        np.asarray(sg.mask).reshape(-1) > 0
    for k_, v in out.items():
        v = np.asarray(v)
        if k_ in ("sg_uv", "sg_softmax"):    # [S, E_pad] to edge order
            got = np.zeros(E, v.dtype)
            got[perm[smask]] = v.reshape(-1)[smask]
            v = got
        ref[k_] = v
    ref["sg_gcn_grad"] = flax_to_state_dict(_numpy_tree(gp), "cpu")

    # multihost over a mesh of two; the embedding table
    pair = jmultihost.sharded_graph_from_host_shards(
        lambda sid: HOST_SHARDS[sid], num_nodes=N,
        mesh=_mesh(2, "edge"))
    ref["mh_pair_sum"] = np.asarray(jax.jit(
        lambda g, x: g.send_u_recv(x, "sum"))(pair, fx))
    emb = JShardedEmbedding(EMB_ROWS, EMB_DIM, _mesh(axis="data"),
                            seed=EMB_SEED)
    ref["emb_table"] = np.asarray(emb.table)
    ids = np.concatenate(EMB_IDS)
    ref["emb_rows"] = np.asarray(emb.lookup(jnp.asarray(ids)))
    emb.apply_sparse_grad(jnp.asarray(ids), jnp.asarray(np.concatenate(
        EMB_G)), 0.1)
    ref["emb_after"] = np.asarray(emb.table)


# -- the host layout ------------------------------------------------------------

@pytest.mark.parametrize("case", ["range4", "range8", "parts", "tiny",
                                  "zerocut", "no_edges"])
def test_build_halo_partition_equal(case):
    """Every array of the host build equals the reference's, exactly."""
    edges, n, s, parts = {
        "range4": (EDGES, N, 4, None),
        "range8": (EDGES, N, 8, None),
        "parts": (EDGES, N, 4, rng.integers(0, 4, N)),
        "tiny": (TINY_EDGES, 5, 4, None),
        "zerocut": (ZEROCUT_EDGES, 32, 4, ZEROCUT_PARTS),
        "no_edges": (np.zeros((0, 2), np.int64), 9, 4, None),
    }[case]
    got = build_halo_partition(edges, n, s, parts)
    want = j_build(edges, n, s, parts)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_metis_parts_equal():
    """``partition="metis"`` (balanced by in-edges) picks the reference's
    parts: the port's METIS is its copy."""
    from pgl_tpu.partition import metis_partition as j_metis
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.partition import metis_partition
    np.testing.assert_array_equal(
        metis_partition(Graph(EDGES, num_nodes=N), S, balance="in_edges"),
        j_metis(pgl_tpu.Graph(EDGES, num_nodes=N), S, balance="in_edges"))


def test_shards_equal_reference(runs):
    """Each rank's node and edge rows are the reference's shard, exactly."""
    port, ref = runs
    hg = ref["hg"]
    x = np.asarray(hg.shard_node_values(FEAT))
    w = np.asarray(hg.shard_edge_values(W_E))
    for r in range(S):
        np.testing.assert_array_equal(port[f"shard_x_{r}"], x[r])
        np.testing.assert_array_equal(port[f"shard_w_{r}"], w[r])


def test_round_trips(runs):
    port, _ = runs
    np.testing.assert_array_equal(port["round_x"], FEAT)
    np.testing.assert_array_equal(port["round_lab"], LAB)
    np.testing.assert_array_equal(port["round_w"], W_E)


def test_comm_bytes_and_scaling_report(runs):
    port, ref = runs
    hg, hgbf = ref["hg"], ref["hgbf"]
    assert int(port["comm_bytes"]) == hg.comm_bytes_per_exchange
    assert int(port["bf16_comm_bytes"]) == hgbf.comm_bytes_per_exchange
    assert int(port["bf16_comm_bytes"]) * 2 == int(port["comm_bytes"])
    want = hg.scaling_report(feat_dim=128)
    for k, v in want.items():
        np.testing.assert_allclose(port[f"report_{k}"], np.asarray(v),
                                   rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(
        port["bf16_t_comm"],
        np.asarray(hgbf.scaling_report(feat_dim=128)["t_comm_s"]),
        rtol=1e-12)


# -- message passing --------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_send_u_recv(runs, op):
    port, ref = runs
    close(port[f"recv_{op}"], ref[f"recv_{op}"])


def test_one_dim_mean_is_the_graph_mean(runs):
    """``send_u_recv(x, "mean")`` on a 1-D feature: ``HaloGraph`` and
    ``ShardedGraph`` give the port's ``Graph`` mean, ``[N]`` (each node's
    sum over its in-degree; the reference's ``Graph`` broadcasts to
    ``[N, N]``, a departure pinned in ``tests/test_torch_graph.py``)."""
    port, _ = runs
    want = pgl_torch.Graph(EDGES, num_nodes=N).tensor("cpu").send_u_recv(
        torch.as_tensor(FEAT[:, 0]), "mean").numpy()
    assert want.shape == (N,)
    for name in ("recv_mean_1d", "sg_mean_1d"):
        assert port[name].shape == (N,), name
        close(port[name], want)


def test_degrees(runs):
    port, ref = runs
    for k in ("indegree", "outdegree"):
        np.testing.assert_array_equal(port[k], ref[k])


def test_feature_gradient_deterministic(runs):
    """The exchange's backward (K1 over the real send slots) against the
    reference's all_to_all transpose, and the same bits on two runs."""
    port, ref = runs
    close(port["grad_x_0"], ref["grad_x"], GRAD_RTOL)
    np.testing.assert_array_equal(port["grad_x_0"], port["grad_x_1"])


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_send_ue_recv_matrix(runs, message_op, reduce_op):
    port, ref = runs
    key = f"ue_{message_op}_{reduce_op}"
    close(port[key], ref[key])


@pytest.mark.parametrize("reduce_op", ["mean", "max"])
def test_send_ue_recv_vector_weights(runs, reduce_op):
    port, ref = runs
    close(port[f"ue_vec_{reduce_op}"], ref[f"ue_vec_{reduce_op}"])


def test_send_ue_recv_gradients(runs):
    """K1w's route on the shard layouts: both gradients (the weights' in
    the original edge order)."""
    port, ref = runs
    close(port["ue_grad_x"], ref["ue_grad_x"], GRAD_RTOL)
    close(port["ue_grad_w"], ref["ue_grad_w"], GRAD_RTOL)


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
def test_send_uv(runs, message_op):
    port, ref = runs
    close(port[f"uv_{message_op}"], ref[f"uv_{message_op}"])


def test_edge_softmax(runs):
    port, ref = runs
    close(port["uv_scalar"], ref["uv_scalar"])
    close(port["softmax"], ref["softmax"])


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_udf_send_recv(runs, op):
    port, ref = runs
    close(port[f"udf_{op}"], ref[f"udf_{op}"])


def test_bf16_wire(runs):
    """The bf16 wire rounds the same boundary rows as the reference's,
    the gradients too; a GCN layer on it is within bf16 rounding of the
    float32 wire's."""
    port, ref = runs
    close(port["bf16_sum"], ref["bf16_sum"])
    close(port["bf16_grad"], ref["bf16_grad"], GRAD_RTOL)
    assert np.abs(port["bf16_sum"] - port["recv_sum"]).max() > 0
    np.testing.assert_allclose(port["gcn_bf16_out"], port["gcn_out"],
                               rtol=2e-2, atol=2e-2)


# -- layers -----------------------------------------------------------------------

def _grads_close(port, name, want):
    got = {k[len(name) + 6:]: port[k] for k in port
           if k.startswith(f"{name}_grad/")}
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k].numpy(), GRAD_RTOL)


@pytest.mark.parametrize("name", ["gcn", "gat", "tc", "tc_mean", "tc_ef"])
def test_layers(runs, name):
    """GCNConv, GATConv (the per-shard additive attention) and
    TransformerConv (dot attention; mean heads; per-edge features in the
    edge layout) on the mesh and on the ranks: output, feature gradient,
    and the parameter gradients (summed over the ranks)."""
    port, ref = runs
    close(port[f"{name}_out"], ref[f"{name}_out"])
    close(port[f"{name}_grad_x"], ref[f"{name}_grad_x"], GRAD_RTOL)
    _grads_close(port, name, ref[f"{name}_grad"])


def test_gat_attention_dropout_masks(runs):
    """``gat_attention`` at rate 0.5 draws the reference's mask (seed ^
    rank, keyed by the shard's CSC position): its output equals the
    mesh's; the same seed twice gives the same bits, another seed another
    output; rate 0 equals the mesh's and the layer's output."""
    port, ref = runs
    close(port["gat_att_s"], ref["gat_att"])
    close(port["gat_att_r0"], ref["gat_att_r0"])
    close(port["gat_att_r0"], port["gat_out"])
    np.testing.assert_array_equal(port["gat_att_s"], port["gat_att_s_again"])
    assert np.abs(port["gat_att_s"] - port["gat_att_other"]).max() > 0


def test_gat_layer_dropout_same_seed(runs):
    """GATConv training at attention dropout 0.5, each side's seed pinned
    to the same value, equals the reference layer on the mesh (and
    ``gat_attention`` at that seed: the layer's attention inputs are its
    inputs)."""
    port, ref = runs
    close(port["gat_drop_out"], ref["gat_drop_out"])
    close(port["gat_drop_out"], ref["gat_att"])


def test_dot_attention(runs):
    """dot_attention and its gradients against the mesh's; dropout changes
    it."""
    port, ref = runs
    close(port["dot_att"], ref["dot_att"])
    for name in "qkv":
        close(port[f"dot_grad_{name}"], ref[f"dot_grad_{name}"], GRAD_RTOL)
    assert np.abs(port["dot_att_s5"] - port["dot_att"]).max() > 0


@pytest.mark.parametrize("name", sorted(_zoo()))
def test_layer_zoo(runs, name):
    """Every layer of the zoo runs unchanged on the halo layout and equals
    the reference's on its HaloGraph: output, feature gradient and the
    parameter gradients (summed over the ranks)."""
    port, ref = runs
    name = f"zoo_{name}"
    close(port[f"{name}_out"], ref[f"{name}_out"])
    close(port[f"{name}_grad_x"], ref[f"{name}_grad_x"], GRAD_RTOL)
    _grads_close(port, name, ref[f"{name}_grad"])


def test_attention_layouts_are_square(runs):
    """Each rank's attention layouts are square over ``n_loc = N_pad +
    S·H_pad`` (the unified source table): the CSC rows past ``N_pad``
    hold no edge (the work list gives them no warp; ``a_dst`` is
    zero-padded and the output cut to ``N_pad``)."""
    port, _ = runs
    for r in range(S):
        csc_rows, csr_rows, n_pad, n_halo, empty_past, edges, real = \
            port[f"att_layout_{r}"]
        assert csc_rows == csr_rows == n_pad + n_halo
        assert empty_past == n_halo
        assert edges == real


@pytest.mark.parametrize("tag", ["tiny", "zerocut"])
def test_degenerate_partitions(runs, tag):
    """5 nodes over 4 ranks (one rank of a single node, one empty) and a
    zero-cut partition (no halo; ``H_pad`` at its floor of 8): sums and
    a GAT layer against the mesh's and the whole graph's."""
    port, ref = runs
    close(port[f"{tag}_sum_halo"], ref[f"{tag}_sum"])
    close(port[f"{tag}_sum_halo"], port[f"{tag}_sum_one"])
    close(port[f"{tag}_gat_halo"], ref[f"{tag}_gat"])
    close(port[f"{tag}_gat_halo"], port[f"{tag}_gat_one"])
    assert int(port[f"{tag}_h_pad"]) == 8
    assert int(port[f"{tag}_halo_size"]) == ref[f"{tag}_halo_size"]
    owned = [int(port[f"{tag}_owned_{r}"]) for r in range(S)]
    if tag == "zerocut":
        assert int(port["zerocut_halo_size"]) == 0
        assert owned == [8] * S
    else:
        assert owned == [2, 2, 1, 0]


def test_save_load(runs):
    """The port's save round-trips; a partition the reference saved loads
    in the port and gives the reference's sums, and attention equal to the
    freshly built graph's."""
    port, ref = runs
    meta = [N, E, ref["hg"].halo_size]
    for tag in ("port", "ref"):
        np.testing.assert_array_equal(port[f"load_{tag}_meta"], meta)
        close(port[f"load_{tag}_sum"], ref["recv_sum"])
        np.testing.assert_array_equal(port[f"load_{tag}_gat"],
                                      port["load_fresh_gat"])


def test_reference_loads_port_partition(runs):
    """The npz the port writes is the reference's: the same arrays as the
    reference's file of the same partition, and the reference loads it."""
    port, ref = runs
    mine = np.load(os.path.join(port["_dir"], "port_halo.npz"))
    theirs = np.load(os.path.join(port["_dir"], "ref_halo.npz"))
    assert set(mine.files) == set(theirs.files)
    for k in theirs.files:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    hg = JHaloGraph.load(os.path.join(port["_dir"], "port_halo.npz"),
                         ref["mesh"])
    assert (hg.num_nodes, hg.num_edges, hg.halo_size) == (
        N, E, ref["hg"].halo_size)


# -- ShardedGraph -------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["dst_range", "dst_mod", "round_robin"])
def test_shard_edges_equal(strategy):
    got = shard_edges(EDGES, S, N, strategy)
    want = j_shard_edges(EDGES, S, N, strategy)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_edges_per_rank(runs):
    port, _ = runs
    stacked, _, _ = j_shard_edges(EDGES, S, N, "dst_range")
    for r in range(S):
        np.testing.assert_array_equal(port[f"sg_edges_{r}"], stacked[r])


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_sharded_send_u_recv(runs, op):
    port, ref = runs
    close(port[f"sg_{op}"], ref[f"sg_{op}"])


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_sharded_send_ue_recv(runs, message_op, reduce_op):
    port, ref = runs
    key = f"sg_ue_{message_op}_{reduce_op}"
    close(port[key], ref[key])


def test_sharded_degrees_uv_softmax(runs):
    port, ref = runs
    for k in ("sg_indegree", "sg_outdegree"):
        np.testing.assert_array_equal(port[k], ref[k])
    close(port["sg_uv"], ref["sg_uv"])
    close(port["sg_softmax"], ref["sg_softmax"])


def test_sharded_gradients(runs):
    """The convention: every rank's loss divided by the size, the
    all-reduce's backward summing the cotangents; the ranks' feature and
    parameter gradients summed equal the mesh's, and two runs give the
    same bits."""
    port, ref = runs
    close(port["sg_grad_0"], ref["sg_grad"], GRAD_RTOL)
    np.testing.assert_array_equal(port["sg_grad_0"], port["sg_grad_1"])
    close(port["sg_gcn_out"], ref["sg_gcn_out"])
    close(port["sg_gcn_grad_x"], ref["sg_gcn_grad_x"], GRAD_RTOL)
    _grads_close(port, "sg_gcn", ref["sg_gcn_grad"])


@pytest.mark.parametrize("strategy", ["dst_mod", "round_robin"])
def test_sharded_strategies(runs, strategy):
    port, _ = runs
    gj = _single()
    close(port[f"sg_{strategy}_sum"], gj.send_recv(gj.node_feat["h"],
                                                     "sum"))


# -- multihost --------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["all", "pair"])
def test_multihost_ranks(runs, tag):
    """Each rank loads its own shard: over the 4 ranks, and over a group
    of 2 (the reference on a mesh of 2)."""
    port, ref = runs
    n = S if tag == "all" else 2
    edges = np.concatenate(HOST_SHARDS[:n])
    g = pgl_tpu.Graph(edges, num_nodes=N).tensor()
    close(port[f"mh_{tag}_sum"], g.send_recv(jnp.asarray(FEAT), "sum"))
    close(port[f"mh_{tag}_mul"], g.send_ue_recv(
        jnp.asarray(FEAT), jnp.asarray(np.concatenate(HOST_W[:n])), "mul",
        "sum"))
    longest = max(len(s) for s in HOST_SHARDS[:n])
    assert int(port[f"mh_{tag}_e_pad"]) == (longest + 127) // 128 * 128
    if tag == "pair":
        close(port["mh_pair_sum"], ref["mh_pair_sum"])


@pytest.fixture
def world_of_one():
    comm.init(backend="gloo", init_method=f"tcp://127.0.0.1:"
              f"{ranks.free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_multihost_one_process(world_of_one):
    """World size 1, in this process: one shard, the reference's loader on
    a mesh of one device."""
    sg = multihost.sharded_graph_from_host_shards(
        lambda sid: HOST_SHARDS[sid], N, device="cpu")
    assert multihost.edge_mesh() is torch.distributed.group.WORLD
    want = jmultihost.sharded_graph_from_host_shards(
        lambda sid: HOST_SHARDS[sid], num_nodes=N, mesh=_mesh(1, "edge"))
    close(sg.send_u_recv(torch.as_tensor(FEAT), "sum").numpy(),
          want.send_u_recv(jnp.asarray(FEAT), "sum"))
    hg = HaloGraph.from_graph(
        pgl_torch.Graph(EDGES, num_nodes=N, node_feat={"h": FEAT}),
        device="cpu")
    assert hg.halo_size == 0
    gj = _single()
    close(hg.unshard_node_values(hg.send_u_recv(hg.node_feat["h"], "sum")),
          gj.send_recv(gj.node_feat["h"], "sum"))
    with pytest.raises(ValueError, match="shards"):
        HaloGraph(build_halo_partition(EDGES, N, 2), N, device="cpu")
    with pytest.raises(ValueError, match="partition"):
        HaloGraph.from_graph(pgl_torch.Graph(EDGES, num_nodes=N),
                             partition="random", device="cpu")


def test_departures():
    """No pytree hooks and no jit on the port's graphs (a rank holds
    tensors, not a traced mesh program), and no ``PGL_TPU_FUSED_ATTN``
    switch: the attention route is the port's own dispatch."""
    import pathlib
    for cls in (HaloGraph, ShardedGraph):
        assert not hasattr(cls, "tree_flatten")
    root = pathlib.Path(__file__).resolve().parents[1] / "pgl_tpu_torch"
    for path in (root / "parallel").glob("*.py"):
        assert "PGL_TPU_FUSED_ATTN" not in path.read_text(), path.name
    with pytest.raises(RuntimeError, match="process group"):
        comm.world()


# -- ShardedEmbedding ----------------------------------------------------------------

def test_embedding_table_bits(runs):
    """Rank r's block is rows [r·B, (r+1)·B) of the reference's draw, bit
    for bit."""
    port, ref = runs
    blocks = np.concatenate([port[f"emb_block_{r}"] for r in range(S)])
    np.testing.assert_array_equal(blocks, ref["emb_table"])


def test_embedding_lookup_and_update(runs):
    port, ref = runs
    rows = np.concatenate([port[f"emb_rows_{r}"] for r in range(S)])
    np.testing.assert_array_equal(rows, ref["emb_rows"])
    # the lookup's gradient: each rank's cotangent rows summed per id
    table = ref["emb_table"]
    want = np.zeros_like(table)
    np.add.at(want, np.concatenate(EMB_IDS), np.concatenate(EMB_G))
    got = np.concatenate([port[f"emb_grad_{r}"] for r in range(S)])
    close(got, want)
    after = np.concatenate([port[f"emb_after_{r}"] for r in range(S)])
    close(after, ref["emb_after"])


def test_no_jax_in_parallel():
    """The parallel modules import torch and the port only."""
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "pgl_tpu_torch" / "parallel").glob("*.py"))
    files.append(root / "tests" / "torch_parallel_ranks.py")
    assert len(files) >= 8
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "flax", "optax", "pgl_tpu"), \
                    f"{path.name} imports {name}"


# -- a max/min tie across the ranks (ShardedGraph, round_robin) ----------------

TIE_CASES = {
    # two edges 0 -> 1, one a rank: x[0] ties with itself across the ranks
    "pair": (np.array([[0, 1], [0, 1]]), np.array([[2.0], [0.5]],
                                                   np.float32)),
    # three sources of one value into node 3: two edges on rank 0, one on 1
    "uneven": (np.array([[0, 3], [1, 3], [2, 3]]),
               np.array([[2.0], [2.0], [2.0], [0.5]], np.float32)),
}


KG_SHAPE = (37, 5, 8)            # entities (not a multiple of 2), rels, D
KG_BATCH = [np.random.default_rng(40 + r) for r in range(2)]
KG = {k: np.stack([g.integers(0, n, shape) for g in KG_BATCH])
      for k, n, shape in (("H", 37, 6), ("R", 5, 6), ("T", 37, 6),
                          ("NEG", 37, (6, 4)))}


@pytest.fixture(scope="module")
def two_ranks():
    """The ``two`` suite on 2 gloo ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        inputs = {"KG_SHAPE": np.array(KG_SHAPE)}
        inputs.update({f"KG_{k}": v for k, v in KG.items()})
        for case, (edges, x) in TIE_CASES.items():
            inputs.update({f"TIE_{case}_EDGES": edges, f"TIE_{case}_X": x,
                           f"TIE_{case}_N": x.shape[0]})
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        yield ranks.finish(ranks.start("two", 2, tmp), tmp)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_sharded_extreme_tie_gradient(two_ranks, case, op):
    """A tie split over the ranks shares the cotangent evenly over the tied
    edges, as ``Graph.send_u_recv`` (and the reference's ``segment_max``)
    does on one graph: ``[1, 0]`` on the pair, a third each on the uneven
    tie (two tied edges on rank 0, one on rank 1). The reference's
    ``ShardedGraph`` cannot differentiate ``pmax`` at all."""
    edges, x = TIE_CASES[case]
    if case == "uneven":
        assert [int(two_ranks[f"tie_uneven_edges_{r}"]) for r in (0, 1)] \
            == [2, 1]
    g = pgl_torch.Graph(edges, num_nodes=x.shape[0]).tensor("cpu")
    xg = torch.as_tensor(x).requires_grad_(True)
    out = g.send_recv(xg, op)
    out.sum().backward()
    want = {"pair": [[1.0], [0.0]],
            "uneven": [[1 / 3], [1 / 3], [1 / 3], [0.0]]}[case]
    np.testing.assert_allclose(xg.grad.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(two_ranks[f"tie_{case}_{op}"],
                                  out.detach().numpy())
    np.testing.assert_allclose(two_ranks[f"tie_{case}_{op}_grad"], want,
                               rtol=1e-6)


def test_sharded_kg_params_two_ranks(two_ranks):
    """A TransE loss over ``sharded_kg_params`` on 2 ranks (the entity
    rows split, the relation table replicated; each rank its own batch)
    against the port's dense model on each rank's batch: the losses, the
    entity gradient (each rank's block, the pad row 0) and the summed
    relation gradient, and ``predict_all_tails`` over the gathered
    table."""
    from pgl_tpu_torch.models.kg import KGEModel
    model = KGEModel(*KG_SHAPE, score="transe", seed=3, device="cpu")
    for r in range(2):
        h, rel, t, neg = (torch.as_tensor(KG[k][r])
                          for k in ("H", "R", "T", "NEG"))
        loss = model.loss_fn(model.params, h, rel, t, neg)
        loss.backward()
        close(two_ranks[f"kg_loss_{r}"], loss.detach().numpy())
        with torch.no_grad():
            close(two_ranks[f"kg_pred_{r}"],
                  model.predict_all_tails(model.params, h, rel).numpy())
    ent = np.concatenate([two_ranks["kg_ent_grad_0"],
                          two_ranks["kg_ent_grad_1"]])
    assert ent.shape == (38, 8) and not ent[37].any()
    close(ent[:37], model.params["ent"].grad.numpy(), GRAD_RTOL)
    close(two_ranks["kg_rel_grad"], model.params["rel"].grad.numpy(),
          GRAD_RTOL)
