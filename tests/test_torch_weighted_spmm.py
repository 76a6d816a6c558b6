"""Port parity for the weighted SpMMs: K1w (``spmm_weighted`` in
``pgl_tpu_torch/ops/kernels/segment_kernels.py``) and the weighted K6
(``spmm_dedup_weighted`` in ``dedup_kernels.py``).

On the CPU the port runs the kernels' plain PyTorch versions. They are held
against the Pallas kernels in interpret mode, as the reference's own tests
run them (``tests/test_pallas_kernels.py``: ``spmm_weighted``,
``spmm_dedup_weighted``), on the same numpy inputs: forward, dx and dw, the
reference's dw (in its layout's order) mapped back to the original edge
order. Tolerance rtol 1e-5, atol 1e-3 on sums, as
``tests/test_torch_segment_kernels.py`` (a hub row sums ~1000 terms of
magnitude ~1 in another order; one edge dropped or counted twice is off by
~1), rtol and atol 1e-4 on dw (a dot of D terms a head). The CUDA kernels
are held against the plain versions in ``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

from pgl_tpu.ops.pallas import dedup_kernels as jdk
from pgl_tpu.ops.pallas import segment_kernels as jsk
from pgl_tpu_torch import Graph
from pgl_tpu_torch.ops import dispatch
from pgl_tpu_torch.ops.kernels import dedup_kernels as tdk
from pgl_tpu_torch.ops.kernels import segment_kernels as tsk
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3
NB, ET = 128, 256    # the interpret-mode tile sizes of test_pallas_kernels


def make_edges(N, E, seed, hub=True, dups=True):
    """Edges in a shuffled order: a hub destination (node 3, a third of
    the edges, split over several pieces), a hub source (node 9), repeated
    (dst, src) pairs, and nodes with no in-edge."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N - N // 8, E)
    src = rng.integers(0, N, E)
    if hub:
        dst[:E // 3] = 3
        src[E // 3:E // 2] = 9
    if dups:
        src[E // 3:E // 3 + E // 10] = src[:E // 10]
        dst[E // 3:E // 3 + E // 10] = dst[:E // 10]
    perm = rng.permutation(E)
    return src[perm], dst[perm]


def port_layouts(src, dst, N):
    """The K1 layouts with edge ids (as ``Graph.tensor()`` builds them) and
    the CSC/CSR indexes."""
    csc_i = EdgeIndex.from_edges(dst, src, N)
    csr_i = EdgeIndex.from_edges(src, dst, N)
    lays = tuple(tsk.build_spmm_layout(i.indptr, i.sorted_v, N, kind=k,
                                       device="cpu", edge_id=i.sorted_eid)
                 for k, i in (("csc", csc_i), ("csr", csr_i)))
    return lays, csc_i, csr_i


# (N, E, D, H): scalar, per head, elementwise (H = D)
K1W_CASES = [(200, 3000, 16, 1), (200, 3000, 16, 4), (200, 3000, 16, 16),
             (150, 2000, 128, 1), (150, 2000, 128, 8)]


@pytest.mark.parametrize("msg_op", ["mul", "add"])
@pytest.mark.parametrize("N,E,D,H", K1W_CASES)
def test_k1w_matches_pallas(msg_op, N, E, D, H):
    src, dst = make_edges(N, E, seed=D + H)
    (csc, csr), csc_i, csr_i = port_layouts(src, dst, N)
    jcsc = jsk.build_blocked_layout(csc_i.indptr, csc_i.sorted_v, N, NB, ET)
    jcsr = jsk.build_blocked_layout(csr_i.indptr, csr_i.sorted_v, N, NB, ET)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(E, H)).astype(np.float32)
    cot = rng.normal(size=(N, D)).astype(np.float32)

    def padded(lay, idx):
        out = np.zeros((len(np.asarray(lay.padded_v)), H), np.float32)
        out[:E] = w[idx.sorted_eid]
        return jnp.asarray(out)

    w_csc, w_csr = padded(jcsc, csc_i), padded(jcsr, csr_i)

    def loss(a, wc):
        return (jsk.spmm_weighted(a, wc, w_csr, jcsc, jcsr, NB, ET, True,
                                  msg_op) * cot).sum()

    want = jsk.spmm_weighted(jnp.asarray(x), w_csc, w_csr, jcsc, jcsr, NB,
                             ET, True, msg_op)
    gx, gw_csc = jax.grad(loss, (0, 1))(jnp.asarray(x), w_csc)
    gw = np.zeros((E, H), np.float32)
    gw[csc_i.sorted_eid] = np.asarray(gw_csc)[:E]

    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tsk.spmm_weighted(xt, wt, csc, csr, msg_op)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), gw, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("msg_op", ["mul", "add"])
@pytest.mark.parametrize("H", [1, 2, 6])
def test_k1w_dw_is_in_the_original_edge_order(msg_op, H):
    """dw[e] from the definition on each edge of a shuffled edge list:
    ``<g[dst_e], x[src_e]>`` (mul) or the sum of ``g[dst_e]`` (add) over
    each head's columns; dx the transposed sum."""
    N, E, D = 90, 700, 6
    src, dst = make_edges(N, E, seed=H)
    (csc, csr), _, _ = port_layouts(src, dst, N)
    rng = np.random.default_rng(H)
    x = rng.normal(size=(N, D))
    w = rng.normal(size=(E, H))
    g = rng.normal(size=(N, D))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    (tsk.spmm_weighted(xt, wt, csc, csr, msg_op)
     * torch.as_tensor(g)).sum().backward()
    ge = g[dst].reshape(E, H, D // H)
    if msg_op == "mul":
        want_dw = (ge * x[src].reshape(E, H, D // H)).sum(-1)
        msgs = ge * w[:, :, None]
    else:
        want_dw = ge.sum(-1)
        msgs = ge
    want_dx = np.zeros((N, D))
    np.add.at(want_dx, src, msgs.reshape(E, D))
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=1e-12,
                               atol=1e-12)


def test_k1w_layouts_carry_edge_ids():
    """Each K1 layout position names its edge: the row and the gathered id
    at position p are the endpoints of edge ``edge_id[p]``, although the
    layout sorts each row's sources."""
    N, E = 120, 1500
    src, dst = make_edges(N, E, seed=3)
    (csc, csr), _, _ = port_layouts(src, dst, N)
    for lay, row, col in ((csc, dst, src), (csr, src, dst)):
        eid = lay.edge_id.numpy()
        assert np.array_equal(np.sort(eid), np.arange(E))
        assert np.array_equal(row[eid], lay.seg_ids.numpy())
        assert np.array_equal(col[eid], lay.indices.numpy())


def test_k1w_rejects_what_it_does_not_take():
    N, E = 40, 300
    src, dst = make_edges(N, E, seed=4)
    (csc, csr), csc_i, _ = port_layouts(src, dst, N)
    x = torch.randn(N, 6)
    with pytest.raises(ValueError, match="H \\| D"):
        tsk.spmm_weighted(x, torch.randn(E, 4), csc, csr)
    with pytest.raises(ValueError, match="H \\| D"):
        tsk.spmm_weighted(x, torch.randn(E - 1, 1), csc, csr)
    with pytest.raises(ValueError, match="'mul' or 'add'"):
        tsk.spmm_weighted(x, torch.randn(E, 1), csc, csr, "sub")
    with pytest.raises(ValueError, match="float64"):
        tsk.spmm_weighted(x, torch.randn(E, 1, dtype=torch.float64), csc,
                          csr)
    bare = tsk.build_spmm_layout(csc_i.indptr, csc_i.sorted_v, N,
                                 device="cpu")
    with pytest.raises(ValueError, match="edge ids"):
        tsk.spmm_weighted(x, torch.randn(E, 1), bare, csr)


def dedup_case(seed):
    """A graph with a hub destination and repeated (dst, src) pairs, its
    reference and port dedup layouts (no gates), and the port's K1 CSR
    layout."""
    N, E = 500, 6000
    src, dst = make_edges(N, E, seed)
    (_, csr), csc_i, csr_i = port_layouts(src, dst, N)
    jlays = tuple(jdk.build_dedup_layout(i.indptr, i.sorted_v, N)
                  for i in (csc_i, csr_i))
    tlays = tuple(tdk.build_dedup_layout(i.indptr, i.sorted_v, N, kind=k,
                                         device="cpu", edge_id=i.sorted_eid)
                  for k, i in (("csc", csc_i), ("csr", csr_i)))
    return N, E, src, dst, jlays, tlays, csr, (csc_i, csr_i)


@pytest.mark.parametrize("D", [16, 128])
def test_weighted_k6_matches_pallas(D):
    N, E, src, dst, (jcsc, jcsr), (csc_d, csr_d), csr, idxs = dedup_case(D)
    assert not csc_d.simple and csc_d.max_count > 1
    rng = np.random.default_rng(D)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=E).astype(np.float32)
    cot = rng.normal(size=(N, D)).astype(np.float32)

    def in_dedup_order(jlay, idx):
        out = np.zeros(jlay.padded_v.shape[0], np.float32)
        out[:E] = w[idx.sorted_eid][np.asarray(jlay.eid)]
        return jnp.asarray(out)

    w_csc, w_csr = (in_dedup_order(l, i) for l, i in zip((jcsc, jcsr), idxs))

    def loss(a, wc):
        return (jdk.spmm_dedup_weighted(a, wc, w_csr, jcsc, jcsr,
                                        interpret=True) * cot).sum()

    want = jdk.spmm_dedup_weighted(jnp.asarray(x), w_csc, w_csr, jcsc, jcsr,
                                   interpret=True)
    gx, gw_d = jax.grad(loss, (0, 1))(jnp.asarray(x), w_csc)
    gw = np.zeros(E, np.float32)
    gw[idxs[0].sorted_eid[np.asarray(jcsc.eid)]] = np.asarray(gw_d)[:E]

    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tdk.spmm_dedup_weighted(xt, wt, csc_d, csr_d, csr)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), gw, rtol=1e-4, atol=1e-4)


def test_weighted_k6_agrees_with_k1w():
    """The two weighted SpMMs compute one function: forward and both
    gradients in float64."""
    N, E, src, dst, _, (csc_d, csr_d), csr, (csc_i, csr_i) = dedup_case(5)
    csc = tsk.build_spmm_layout(csc_i.indptr, csc_i.sorted_v, N,
                                device="cpu", edge_id=csc_i.sorted_eid)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, 8))
    w = rng.normal(size=E)
    g = torch.as_tensor(rng.normal(size=(N, 8)))
    res = []
    for run in (lambda a, b: tdk.spmm_dedup_weighted(a, b, csc_d, csr_d,
                                                     csr),
                lambda a, b: tsk.spmm_weighted(a, b.unsqueeze(1), csc, csr)):
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        out = run(xt, wt)
        (out * g).sum().backward()
        res.append((out.detach(), xt.grad, wt.grad))
    for a, b in zip(*res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("side", [0, 1])
def test_dedup_cells_are_contiguous(side):
    """The weighted K6 sums each count cell's edges in layout order with no
    atomics: every cell is one run of consecutive positions
    (``build_dedup_layout`` raises otherwise)."""
    N, E, _, _, _, lays, _, _ = dedup_case(7)
    lay = lays[side]
    cell = lay.dst.numpy().astype(np.int64) * (len(lay.uv) + 1) \
        + lay.urow.numpy()
    runs = 1 + np.count_nonzero(np.diff(cell))
    assert runs == len(np.unique(cell)) < E


def test_graph_takes_the_weighted_k6_under_dedup(monkeypatch):
    """``send_ue_recv`` with a scalar mul on a graph with dedup layouts runs
    the weighted K6; add and per-head weights keep K1w there."""
    calls = []
    real_d, real_w = tdk.spmm_dedup_weighted, tsk.spmm_weighted
    from pgl_tpu_torch import graph as graph_module
    monkeypatch.setattr(graph_module.dk, "spmm_dedup_weighted",
                        lambda *a: calls.append("K6w") or real_d(*a))
    monkeypatch.setattr(graph_module, "spmm_weighted",
                        lambda *a: calls.append("K1w") or real_w(*a))
    src, dst = make_edges(500, 6000, seed=9)
    edges = np.stack([src, dst], axis=1)
    monkeypatch.setattr(dispatch, "DEDUP", True)
    monkeypatch.setattr(dispatch, "DEDUP_MIN_EDGES", 0)
    gd = Graph(edges, num_nodes=500).tensor("cpu")
    assert gd._dedup_layouts is not None
    monkeypatch.setattr(dispatch, "DEDUP", False)
    g = Graph(edges, num_nodes=500).tensor("cpu")
    x = torch.randn(500, 4, dtype=torch.float64)
    w = torch.randn(6000, dtype=torch.float64)
    out = gd.send_ue_recv(x, w, "mul")
    torch.testing.assert_close(out, g.send_ue_recv(x, w, "mul"))
    assert calls == ["K6w", "K1w"]
    gd.send_ue_recv(x, w, "add")
    gd.send_ue_recv(x, torch.randn(6000, 2, dtype=torch.float64), "mul")
    assert calls[2:] == ["K1w", "K1w"]
