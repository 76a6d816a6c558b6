"""Port parity for the rest of ``Graph`` on the CPU against ``pgl_tpu``: the
native host kernels (``pgl_tpu_torch/native``), the neighbour queries and
sampling, batching, persistence across the two packages, the UDF
``send``/``recv`` with ``Message``, and the segment padding and top-k ops of
``pgl_tpu_torch.math``. Index arrays, samples and selections are compared
exactly; reductions at rtol 1e-5, atol 1e-5 (float32 sums in another
order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("flax")

import pgl_tpu
import pgl_tpu.math as jmath
from pgl_tpu.message import Message as JMessage
from pgl_tpu.native import graph_kernel as jgk
from pgl_tpu.utils.edge_index import EdgeIndex as JEdgeIndex
import pgl_tpu_torch.math as tmath
from pgl_tpu_torch import Graph
from pgl_tpu_torch.message import Message
from pgl_tpu_torch.native import graph_kernel as gk
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

RTOL = ATOL = 1e-5
FIELDS = ("degree", "sorted_u", "sorted_v", "sorted_eid", "indptr")


def make_graph(N=60, E=400, seed=0, D=6):
    """Numpy edges with a hub destination (node 2), nodes without edges
    (the top fifth) and node and edge features."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N - N // 5, E)
    dst[:E // 4] = 2
    edges = np.stack([rng.integers(0, N - N // 5, E), dst], axis=1)
    return edges, {"h": rng.normal(size=(N, D)).astype(np.float32)}, \
        {"w": rng.normal(size=(E, 3)).astype(np.float32)}


def both(seed=0, **kw):
    edges, nf, ef = make_graph(seed=seed, **kw)
    N = kw.get("N", 60)
    return (Graph(edges, num_nodes=N, node_feat=nf, edge_feat=ef),
            pgl_tpu.Graph(edges, num_nodes=N, node_feat=nf, edge_feat=ef))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def same_ragged(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_namespaces_bind_the_reference_names():
    """The package binds the reference's ported names
    (``pgl_tpu/__init__.py:12-29``), ``ops`` exports its message passing
    (``pgl_tpu/ops/__init__.py:4-11``), ``utils`` its ``transform``, and
    ``nn``, ``nn.functional`` and ``models`` export the reference's
    ``__all__``."""
    import pgl_tpu.models
    import pgl_tpu.nn
    import pgl_tpu.nn.functional
    import pgl_tpu.ops
    import pgl_tpu_torch

    for name in ("Graph", "BiGraph", "HeterGraph", "Message", "math", "ops",
                 "nn", "utils", "sampling", "datasets", "models",
                 "partition", "native"):
        assert getattr(pgl_tpu_torch, name) is not None, name
        assert name in pgl_tpu_torch.__all__ and name in pgl_tpu.__all__
    assert pgl_tpu_torch.Message is Message
    ops = pgl_tpu_torch.ops
    assert set(ops.__all__) == set(pgl_tpu.ops.__all__)
    for name in ops.__all__:
        assert getattr(ops, name) is not None, name
    edges, nf, _ = make_graph()
    x = nf["h"]
    close(ops.send_u_recv(torch.as_tensor(x), torch.as_tensor(edges[:, 0]),
                          torch.as_tensor(edges[:, 1]), 60),
          pgl_tpu.ops.send_u_recv(jnp.asarray(x), jnp.asarray(edges[:, 0]),
                                  jnp.asarray(edges[:, 1]), 60))
    assert pgl_tpu_torch.BiGraph is not None
    assert pgl_tpu_torch.utils.transform is not None
    assert "transform" in pgl_tpu_torch.utils.__all__
    assert set(pgl_tpu_torch.utils.transform.__all__) == set(
        pgl_tpu.utils.transform.__all__)
    import pgl_tpu.datasets
    import pgl_tpu.sampling
    import pgl_tpu.utils.data
    for mine, ref in ((pgl_tpu_torch.nn, pgl_tpu.nn),
                      (pgl_tpu_torch.nn.functional, pgl_tpu.nn.functional),
                      (pgl_tpu_torch.models, pgl_tpu.models),
                      (pgl_tpu_torch.datasets, pgl_tpu.datasets),
                      (pgl_tpu_torch.utils.data, pgl_tpu.utils.data)):
        assert set(mine.__all__) == set(ref.__all__)
        for name in mine.__all__:
            assert getattr(mine, name) is not None, name
    assert set(pgl_tpu.sampling.__all__) <= set(
        pgl_tpu_torch.sampling.__all__)
    assert "data" in pgl_tpu_torch.utils.__all__


# -- native host kernels ----------------------------------------------------

@pytest.mark.parametrize("N,E", [(50, 600), (9, 0), (1, 5)])
def test_native_build_index_equals_numpy_path(N, E):
    rng = np.random.default_rng(N)
    u, v = rng.integers(0, N, E), rng.integers(0, 10 * N, E)
    got = gk.build_index(u, v, N)
    for a, b in zip(got, gk.build_index_reference(u, v, N)):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    idx, ref = EdgeIndex.from_edges(u, v, N), JEdgeIndex.from_edges(u, v, N)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(idx, f), getattr(ref, f))
        assert getattr(idx, f).dtype == getattr(ref, f).dtype


@pytest.mark.parametrize("compiler", ["false", "/nonexistent/g++"])
def test_failed_host_build_raises(monkeypatch, tmp_path, compiler):
    """No quiet fallback: a build that fails (the compiler exits non-zero,
    or there is none) raises with its output. The reference falls back to
    numpy in the same case (``pgl_tpu/native/graph_kernel.py:1-6``)."""
    monkeypatch.setattr(gk, "CXX", compiler)
    monkeypatch.setattr(gk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(gk, "_lib", None)
    with pytest.raises(RuntimeError, match="host kernel build failed"):
        gk.build_index(np.array([0, 1]), np.array([1, 0]), 2)
    with pytest.raises(RuntimeError, match="host kernel build failed"):
        EdgeIndex.from_edges(np.array([0, 1]), np.array([1, 0]), 2)
    assert not list((tmp_path / "build").glob("*.so"))
    # the reference, its build failed, answers from numpy without a word
    monkeypatch.setattr(jgk, "_lib", None)
    monkeypatch.setattr(jgk, "_build_failed", True)
    assert not jgk.available()
    deg, *_ = jgk.build_index(np.array([0, 1, 1]), np.array([1, 0, 0]), 2)
    np.testing.assert_array_equal(deg, [1, 2])


def test_native_kernels_reject_out_of_range_ids():
    with pytest.raises(ValueError, match="out of range"):
        gk.build_index(np.array([0, 3]), np.array([1, 1]), 3)
    degree, sorted_v, sorted_eid, indptr = gk.build_index(
        np.array([0, 1]), np.array([1, 0]), 2)
    with pytest.raises(ValueError, match="out of range"):
        gk.sample_subset_with_eid(indptr, sorted_v, sorted_eid, [2], 1)


# -- neighbour queries and sampling -----------------------------------------

def test_host_queries_match_reference():
    g, jg = both(seed=1)
    nodes = np.array([2, 0, 7, 55, 2])
    for name in ("successor", "predecessor"):
        same_ragged(getattr(g, name)(), getattr(jg, name)())
        same_ragged(getattr(g, name)(nodes), getattr(jg, name)(nodes))
        got_v, got_e = getattr(g, name)(nodes, return_eids=True)
        want_v, want_e = getattr(jg, name)(nodes, return_eids=True)
        same_ragged(got_v, want_v)
        same_ragged(got_e, want_e)
    for sort_by in ("src", "dst"):
        for a, b in zip(g.sorted_edges(sort_by), jg.sorted_edges(sort_by)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.nodes, jg.nodes)
    with pytest.raises(ValueError, match="host-side query"):
        g.tensor("cpu").successor([0])


@pytest.mark.parametrize("max_degree", [0, 3, 1000])
def test_sampling_matches_reference_with_the_same_seed(max_degree):
    g, jg = both(seed=2)
    nodes = np.array([2, 1, 5, 2, 59])
    for name in ("sample_successor", "sample_predecessor"):
        for seed in (0, 11):
            got_v, got_e = getattr(g, name)(nodes, max_degree,
                                            return_eids=True, seed=seed)
            want_v, want_e = getattr(jg, name)(nodes, max_degree,
                                               return_eids=True, seed=seed)
            same_ragged(got_v, want_v)
            same_ragged(got_e, want_e)
            same_ragged(getattr(g, name)(nodes, max_degree, seed=seed),
                        want_v)
    # the hub (node 2, ~100 in-edges) is cut to max_degree distinct edges
    hub = g.sample_predecessor([2], 3, return_eids=True, seed=5)[1][0]
    assert len(np.unique(hub)) == len(hub) == 3


# -- batching ---------------------------------------------------------------

def three_graphs():
    out = []
    for seed, (N, E) in enumerate(((20, 80), (7, 0), (30, 150))):
        edges, nf, ef = make_graph(N, E, seed=seed)
        out.append((edges, N, nf, ef))
    return out


@pytest.mark.parametrize("on_device", [False, True])
def test_disjoint_matches_reference(on_device):
    parts = three_graphs()
    gs = [Graph(e, num_nodes=n, node_feat=nf, edge_feat=ef)
          for e, n, nf, ef in parts]
    jgs = [pgl_tpu.Graph(e, num_nodes=n, node_feat=nf, edge_feat=ef)
           for e, n, nf, ef in parts]
    if on_device:
        gs = [g.tensor("cpu") for g in gs]
        jgs = [g.tensor() for g in jgs]
    g, jg = Graph.batch(gs), pgl_tpu.Graph.disjoint(jgs)
    assert g.is_tensor == on_device and g.num_graph == jg.num_graph == 3
    assert (g.num_nodes, g.num_edges) == (jg.num_nodes, jg.num_edges)
    np.testing.assert_array_equal(np.asarray(g.edges), np.asarray(jg.edges))
    for name in ("graph_node_id", "graph_edge_id"):
        np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                      np.asarray(getattr(jg, name)))
    np.testing.assert_array_equal(np.asarray(g.node_feat["h"]),
                                  np.asarray(jg.node_feat["h"]))
    np.testing.assert_array_equal(np.asarray(g.edge_feat["w"]),
                                  np.asarray(jg.edge_feat["w"]))
    # the batching bookkeeping survives tensor() and numpy()
    back = (g.numpy() if on_device else g.tensor("cpu")).numpy()
    assert back.num_graph == 3
    np.testing.assert_array_equal(back.graph_node_id, jg.graph_node_id)
    np.testing.assert_array_equal(back.graph_edge_id, jg.graph_edge_id)
    assert "num_graph=3" in repr(g)
    # a merged graph reduces as one
    x = torch.randn(g.num_nodes, 4, generator=torch.Generator().manual_seed(0))
    gt = g if on_device else g.tensor("cpu")
    jt = jg if on_device else jg.tensor()
    close(gt.send_u_recv(x, "sum"), jt.send_u_recv(jnp.asarray(x.numpy()),
                                                   "sum"))


def test_single_graph_ids_and_node_batches_match_reference():
    g, jg = both(seed=3)
    assert g.num_graph == 1
    np.testing.assert_array_equal(g.graph_node_id, jg.graph_node_id)
    np.testing.assert_array_equal(g.tensor("cpu").graph_edge_id.numpy(),
                                  np.asarray(jg.tensor().graph_edge_id))
    for shuffle, seed in ((True, 4), (False, None)):
        got = list(g.node_batch_iter(16, shuffle=shuffle, seed=seed))
        want = list(jg.node_batch_iter(16, shuffle=shuffle, seed=seed))
        same_ragged(got, want)
    with pytest.raises(ValueError, match="mixes"):
        Graph.disjoint([g, g.tensor("cpu")])


# -- persistence ------------------------------------------------------------

def assert_same_graph(got, want):
    assert (got.num_nodes, got.num_edges, got.num_graph) == \
        (want.num_nodes, want.num_edges, want.num_graph)
    np.testing.assert_array_equal(np.asarray(got.edges),
                                  np.asarray(want.edges))
    assert sorted(got.node_feat) == sorted(want.node_feat)
    for feats in ("node_feat", "edge_feat"):
        for k, v in getattr(want, feats).items():
            np.testing.assert_array_equal(np.asarray(getattr(got, feats)[k]),
                                          np.asarray(v))
    for name in ("adj_src_index", "adj_dst_index"):
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(got, name), f)),
                np.asarray(getattr(getattr(want, name), f)))
    np.testing.assert_array_equal(np.asarray(got.graph_node_id),
                                  np.asarray(want.graph_node_id))


@pytest.mark.parametrize("batched", [False, True])
def test_dump_and_load_across_packages(tmp_path, batched):
    parts = three_graphs()
    if batched:
        g = Graph.disjoint([Graph(e, num_nodes=n, node_feat=nf,
                                  edge_feat=ef) for e, n, nf, ef in parts])
        jg = pgl_tpu.Graph.disjoint([
            pgl_tpu.Graph(e, num_nodes=n, node_feat=nf, edge_feat=ef)
            for e, n, nf, ef in parts])
    else:
        g, jg = both(seed=4)
    g.adj_dst_index, g.adj_src_index, jg.adj_dst_index, jg.adj_src_index
    # the port reads what the reference wrote, memory-mapped
    jg.dump(str(tmp_path / "ref"))
    got = Graph.load(str(tmp_path / "ref"))
    assert isinstance(got.node_feat["h"], np.memmap)
    assert_same_graph(got, jg)
    # the reference reads what the port wrote, and so does the port
    mm = g.to_mmap(str(tmp_path / "port"))
    assert isinstance(mm.adj_dst_index.sorted_v, np.memmap)
    assert_same_graph(pgl_tpu.Graph.load(str(tmp_path / "port")), g)
    assert_same_graph(mm, g)
    assert_same_graph(Graph.load(str(tmp_path / "port"), mmap_mode=None), g)
    # a loaded graph goes to the device and passes messages
    x = torch.randn(g.num_nodes, 5, generator=torch.Generator().manual_seed(1))
    close(mm.tensor("cpu").send_u_recv(x, "mean"),
          g.tensor("cpu").send_u_recv(x, "mean"))


def test_tensor_graph_dumps_its_host_form(tmp_path):
    g, _ = both(seed=5)
    g.tensor("cpu").dump(str(tmp_path / "t"))
    assert_same_graph(Graph.load(str(tmp_path / "t")), g)


# -- UDF send / recv --------------------------------------------------------

def message_func(src, dst, edge):
    return {"m": src["h"] * dst["h"][:, :1] + edge["w"][:, :1],
            "s": src["h"][:, :2]}


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("recv_mode", ["dst", "src"])
def test_send_recv_matches_reference(reduce, recv_mode):
    g, jg = both(seed=6)
    g, jg = g.tensor("cpu"), jg.tensor()
    msg = g.send(message_func, src_feat={"h": g.node_feat["h"]},
                 dst_feat={"h": g.node_feat["h"]},
                 edge_feat={"w": g.edge_feat["w"]})
    jmsg = jg.send(message_func, node_feat={"h": jg.node_feat["h"]},
                   edge_feat={"w": jg.edge_feat["w"]})
    for k in ("m", "s"):
        close(msg[k], jmsg[k])
    got = g.recv(reduce, msg, recv_mode=recv_mode)
    want = jg.recv(reduce, jmsg, recv_mode=recv_mode)
    assert sorted(got) == sorted(want)
    for k in got:
        close(got[k], want[k])
    close(g.recv(reduce, {"m": msg["m"]}, recv_mode),
          jg.recv(reduce, {"m": jmsg["m"]}, recv_mode))


def test_recv_with_a_callable_reduce_matches_reference():
    g, jg = both(seed=7)
    g, jg = g.tensor("cpu"), jg.tensor()

    def reduce(m):
        a = m["a"]
        att = m.reduce_softmax(a[:, :1])
        return m.reduce_sum(a * att) + m.reduce_max(a) - m.reduce_mean(a) \
            + m.edge_expand(m.reduce_min(a))[:1].sum() \
            + m.reduce(a, "sum")

    msg = g.send(lambda s, d, e: {"a": s["h"] - d["h"]},
                 node_feat={"h": g.node_feat["h"]})
    jmsg = jg.send(lambda s, d, e: {"a": s["h"] - d["h"]},
                   node_feat={"h": jg.node_feat["h"]})
    close(g.recv(reduce, msg), jg.recv(reduce, jmsg))
    with pytest.raises(ValueError, match="at the same time"):
        g.send(message_func, src_feat={}, node_feat={})
    with pytest.raises(ValueError, match="You must call Graph.tensor"):
        Graph(make_graph()[0]).recv("sum", msg)
    with pytest.raises(ValueError, match="recv_mode"):
        g.recv("sum", msg, recv_mode="both")


# -- segment ops and Message ------------------------------------------------

def segments(seed=8, n=200, S=12):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, S, n))
    seg[seg == 4] = 5                        # an empty segment
    return (seg, rng.normal(size=(n, 3)).astype(np.float32),
            np.round(rng.normal(size=n), 1).astype(np.float32), S)


@pytest.mark.parametrize("max_len", [None, 5])
def test_segment_padding_matches_reference(max_len):
    seg, data, _, S = segments()
    got = tmath.segment_padding(torch.tensor(data), torch.tensor(seg), S,
                                max_len)
    want = jmath.segment_padding(jnp.asarray(data), jnp.asarray(seg), S,
                                 max_len)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == want[2]


@pytest.mark.parametrize("ratio,min_score,shuffle", [
    (0.5, None, False), (0.3, None, False), (0.5, 0.2, False),
    (0.5, None, True), (0.3, None, True), (0.5, 0.7, True)])
def test_segment_topk_matches_reference(ratio, min_score, shuffle):
    seg, data, score, S = segments(seed=9)
    if shuffle:
        # segment ids in no order; 0.7 is not a float32, so the threshold
        # must be taken in float64 as the reference's host path takes it
        perm = np.random.default_rng(13).permutation(len(seg))
        seg, data, score = seg[perm], data[perm], score[perm]
        score[:3] = np.float32(0.7)
    mask = tmath.segment_topk_mask(torch.tensor(score), torch.tensor(seg), S,
                                   ratio, min_score)
    want = jmath.segment_topk_mask(jnp.asarray(score), jnp.asarray(seg), S,
                                   ratio, min_score)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))
    sel, keep = tmath.segment_topk(torch.tensor(data), score,
                                   torch.tensor(seg), S, ratio, min_score)
    jsel, jkeep = jmath.segment_topk(jnp.asarray(data), score, seg, S,
                                     ratio, min_score)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert torch.equal(tmath.segment_topk(torch.tensor(data), score,
                                          torch.tensor(seg), S, ratio,
                                          min_score, return_index=False),
                       sel)


def test_message_reductions_match_reference():
    seg, data, score, S = segments(seed=10)
    eid = np.random.default_rng(11).permutation(len(seg))
    m = Message({"x": torch.tensor(data)}, torch.tensor(seg), S,
                eid=torch.tensor(eid))
    jm = JMessage({"x": jnp.asarray(data)}, jnp.asarray(seg), S,
                  eid=jnp.asarray(eid))
    x, jx = m["x"], jm["x"]
    assert m["x"] is x                       # gathered once
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    for name in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
                 "reduce_softmax"):
        close(getattr(m, name)(x), getattr(jm, name)(jx))
    close(m.edge_expand(m.reduce_sum(x)), jm.edge_expand(jm.reduce_sum(jx)))
    assert torch.equal(m.segment_ids, torch.tensor(seg))


# -- the dtype rule of the CUDA kernels ---------------------------------------

@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16,
                                   torch.int64, torch.int32])
def test_cuda_dtype_rule(dtype, device_type):
    """The reference's dtype gate (``pgl_tpu/ops/dispatch.py:29-30``: float32
    and bf16 to the kernel, every other dtype to the segment path) on the
    card: ``dispatch.plain_on_cuda`` sends integer, float16 and float64
    CUDA tensors to the plain path; float32 launches every kernel; bf16
    launches K1 (``use_spmm_kernel``), K1w (``use_weighted_spmm_kernel``),
    the dedup SpMM K5/K6 (``use_dedup_kernel``), the per-edge attention
    K9/K10 (``use_attention_kernel``) and the count-matrix attention K7/K8
    (``use_dedup_attention_kernel``), and raises at K11
    (``use_sddmm_kernel``), whose reference kernel takes float32 alone;
    float16 raises at every wrapper, which the plain path keeps it from
    reaching. A CPU tensor is never plain-on-CUDA: it runs the wrappers'
    plain versions. A stand-in with a CUDA device holds the rule without a
    card."""
    from types import SimpleNamespace

    from pgl_tpu_torch.ops import dispatch
    t = SimpleNamespace(device=torch.device(device_type), dtype=dtype)
    plain = dtype in (torch.float64, torch.float16, torch.int64,
                      torch.int32)
    assert dispatch.plain_on_cuda(t) is (device_type == "cuda" and plain)
    assert dispatch.plain_on_cuda(None, t) is dispatch.plain_on_cuda(t)
    wrappers = (dispatch.use_spmm_kernel, dispatch.use_weighted_spmm_kernel,
                dispatch.use_dedup_kernel, dispatch.use_attention_kernel,
                dispatch.use_dedup_attention_kernel,
                dispatch.use_sddmm_kernel)
    bf16 = (dispatch.use_spmm_kernel, dispatch.use_weighted_spmm_kernel,
            dispatch.use_dedup_kernel, dispatch.use_attention_kernel,
            dispatch.use_dedup_attention_kernel)
    for use in wrappers:
        takes = dtype == torch.float32 or (
            dtype == torch.bfloat16 and use in bf16)
        if device_type == "cpu":
            assert use(t) is False
        elif takes:
            assert use(t) is True
        else:
            with pytest.raises(TypeError):
                use(t)


@pytest.mark.parametrize("entry", ["send_u_recv_sum", "send_u_recv_mean",
                                   "send_ue_recv", "GATConv",
                                   "TransformerConv"])
def test_plain_on_cuda_routes_around_the_kernels(monkeypatch, entry):
    """Where ``plain_on_cuda`` holds, ``Graph`` and the layers reach no
    kernel wrapper and give what the wrappers' plain versions give: the
    segment path for the SpMMs, GAT's unfused route and TransformerConv's
    edge space for attention (rtol/atol 1e-5: float32 sums in another
    order). Here a CPU graph stands in for the card's, with the predicate
    patched to True and the wrappers to raise."""
    from pgl_tpu_torch import graph as tgraph
    from pgl_tpu_torch.nn import GATConv, TransformerConv
    from pgl_tpu_torch.nn import conv as tconv
    from pgl_tpu_torch.ops import dispatch

    edges, nf, _ = make_graph()
    g = Graph(edges, num_nodes=60, node_feat=nf).tensor("cpu")
    x = g.node_feat["h"]
    w = torch.as_tensor(np.random.default_rng(1).normal(size=len(edges)),
                        dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    layer = {"GATConv": lambda: GATConv(6, 4, num_heads=2, generator=gen,
                                        device="cpu"),
             "TransformerConv": lambda: TransformerConv(
                 6, 4, num_heads=2, generator=gen, device="cpu")}
    model = layer[entry]() if entry in layer else None

    def run():
        if entry.startswith("send_u_recv"):
            return g.send_u_recv(x, entry.rsplit("_", 1)[1])
        if entry == "send_ue_recv":
            return g.send_ue_recv(x, w, "mul", "sum")
        return model(g, x)

    want = run()

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was reached")

    monkeypatch.setattr(dispatch, "plain_on_cuda", lambda *ts: True)
    monkeypatch.setattr(tconv, "plain_on_cuda", lambda *ts: True)
    for mod, names in ((tgraph, ("spmm", "spmm_weighted")),
                       (tconv, ("fused_gat_attention",
                                "fused_graph_attention",
                                "dedup_gat_attention",
                                "dedup_dot_attention"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    got = run()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["GATConv", "TransformerConv"])
def test_attention_routes_from_the_projections(monkeypatch, entry):
    """The layers decide their route from the tensors that the kernels
    would receive (the projections), not from the layer's input: under
    autocast a float32 input gives bf16 projections. Here the CPU's
    autocast stands in for the card's, with ``plain_on_cuda`` patched to
    hold for bf16 and the fused wrappers to raise: the layer must take its
    edge-space route, ask the predicate about its bf16 projections, and
    give the float32 run's output within bf16's rounding (rtol/atol 5e-2)."""
    from pgl_tpu_torch.nn import GATConv, TransformerConv
    from pgl_tpu_torch.nn import conv as tconv

    edges, nf, _ = make_graph()
    g = Graph(edges, num_nodes=60, node_feat=nf).tensor("cpu")
    x = g.node_feat["h"]
    gen = torch.Generator().manual_seed(0)
    model = {"GATConv": GATConv, "TransformerConv": TransformerConv}[entry](
        6, 4, num_heads=2, generator=gen, device="cpu")
    with torch.no_grad():
        want = model(g, x)
    asked = []

    def bf16_is_plain(*ts):
        asked.extend(t.dtype for t in ts if t is not None)
        return any(t is not None and t.dtype == torch.bfloat16 for t in ts)

    def refuse(*args, **kwargs):
        raise AssertionError("a fused attention wrapper was reached")

    monkeypatch.setattr(tconv, "plain_on_cuda", bf16_is_plain)
    for name in ("fused_gat_attention", "fused_graph_attention",
                 "dedup_gat_attention", "dedup_dot_attention"):
        monkeypatch.setattr(tconv, name, refuse)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = model(g, x)
    assert x.dtype == torch.float32 and torch.bfloat16 in asked
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=5e-2, atol=5e-2)
