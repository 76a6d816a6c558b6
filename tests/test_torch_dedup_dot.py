"""Parity of the port's count-matrix dot attention (K7/K8 in dot mode,
``dedup_dot_attention`` of ``pgl_tpu_torch/ops/kernels/dedup_attention.py``)
with ``pgl_tpu``'s ``dedup_dot_attention`` run in interpret mode, on the
CPU, each on its own dedup layout of the same numpy edges: the forward and
its ``lse``, the gradients (dk and dv straight onto node rows, where the
reference folds pair-slot rows over ``build_uniq_reduce``), the cell
dropout, and scores wider than one 128-lane tile. The cell lists the CUDA
kernels walk (row order for K7 and K8's row pass, node order for K8's node
walk) are held against the plain versions here too, evaluated in cell
space, and the node rows against the float64 fold of the reference's
pair-slot rows.
``TransformerConv`` and ``UniMP`` on a dedup-layout graph are held against
the reference in ``tests/test_torch_transformer.py``; the CUDA kernels
against the plain versions in ``tests/test_torch_kernels_gpu.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack: there this file skips
pytest.importorskip("flax")

from pgl_tpu.ops.pallas import dedup_kernels as jdk
from pgl_tpu.ops.pallas.dedup_attention import (
    _dedup_attn_fwd_call, build_uniq_reduce as j_uniq_reduce,
    dedup_dot_attention as j_dedup_dot)
from pgl_tpu_torch.ops.kernels import attention_kernels as ak
from pgl_tpu_torch.ops.kernels import dedup_attention as da
from pgl_tpu_torch.ops.kernels import dedup_kernels as tdk
from pgl_tpu_torch.ops.kernels import segment_kernels as sk
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

# The first torch.exp of a process on the CPU can differ from every later
# one by up to ~6e-5 (see tests/test_torch_dedup_attention.py): take it here.
torch.exp(torch.zeros(1 << 16))


def _edges(kind):
    """(edges [E, 2] as (src, dst), N) of a small graph of one kind, at the
    size of the reference's own test (tests/test_dedup_attention.py:170)."""
    rng = np.random.default_rng({"hub": 3, "dups": 4, "empty": 5,
                                 "simple": 6, "multi": 7}[kind])
    N, E = 700, 5000
    if kind == "empty":                 # every edge into nodes 0..199
        return np.stack([rng.integers(0, N, E),
                         rng.integers(0, 200, E)], 1), N
    if kind == "simple":                # no (dst, src) pair twice
        pairs = rng.choice(N * N, E, replace=False)
        return np.stack([pairs % N, pairs // N], 1), N
    e = rng.integers(0, N, (E, 2))
    if kind == "hub":                   # hub destination 0, hub source 1
        e[:E // 3, 1] = 0
        e[E // 3:E // 2, 0] = 1
    else:                               # "dups" and "multi": a multigraph
        e[-600:] = e[:600]
    return e, N


def _case(kind, H, dsh, dvh, scale=1.0):
    """Both packages' layouts of one graph and numpy q, k [N, H·dsh], v and
    a target [N, H·dvh]."""
    edges, N = _edges(kind)
    idx = EdgeIndex.from_edges(edges[:, 1], edges[:, 0], N)
    ref = jdk.build_dedup_layout(idx.indptr, idx.sorted_v, N,
                                 debug_rows=True)
    lay = tdk.build_dedup_layout(idx.indptr, idx.sorted_v, N, device="cpu")
    rng = np.random.default_rng(H * 1000 + dsh * 10 + dvh)
    q, k = (rng.normal(size=(N, H * dsh)).astype(np.float32)
            * np.float32(scale) for _ in range(2))
    v, tgt = (rng.normal(size=(N, H * dvh)).astype(np.float32)
              for _ in range(2))
    return N, ref, lay, q, k, v, tgt


def _pad_lanes(v):
    """v with its columns padded to a multiple of 128, as the reference's
    kernels take it."""
    width = -(-v.shape[1] // 128) * 128
    return jnp.zeros((v.shape[0], width)).at[:, :v.shape[1]].set(v)


def _reference(ref, N, H, dsh, dvh, q, k, v, tgt, rate, seed):
    """The reference's out, lse [N, H] and gradients of sum((out - tgt)^2)
    (interpret mode)."""
    red = j_uniq_reduce(ref, N)
    seed_j = None if seed is None else jnp.int32(seed)
    C = H * dvh
    out, lse = _dedup_attn_fwd_call(
        jnp.asarray(q), jnp.asarray(k), _pad_lanes(v), ref, H, dvh, dsh,
        False, 0.0, 256, 1024, 128, True, rate, seed_j)
    n_pad = lse.shape[0] // H
    lse = np.asarray(lse).reshape(n_pad // 256, H, 256).transpose(
        0, 2, 1).reshape(n_pad, H)[:N]

    def loss(a, b, c):
        o = j_dedup_dot(a, b, c, ref, red, H, dsh, dvh, 0.0, 256, 1024, True,
                        rate, seed_j)
        return ((o[:, :C] - tgt) ** 2).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), _pad_lanes(v))
    return (np.asarray(out)[:, :C], lse,
            [np.asarray(gr)[:, :w] for gr, w in zip(grads, (H * dsh, H * dsh,
                                                             C))])


def _port(lay, N, H, dsh, dvh, q, k, v, tgt, rate, seed):
    att = da.build_dedup_attention(lay, N)
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = da.dedup_dot_attention(*t, att, H, dsh, dvh, 0.0, rate, seed)
    ((out - torch.as_tensor(tgt)) ** 2).sum().backward()
    _, lse = da.dedup_dot_reference(*(x.detach() for x in t), lay, dsh, dvh,
                                    0.0, rate, seed)
    return out.detach().numpy(), lse.numpy(), [x.grad.numpy() for x in t]


# the reference's own tolerances (tests/test_dedup_attention.py:170-237):
# forward rtol 1e-4, atol 1e-4; gradients rtol 2e-3, atol 3e-4
FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=2e-3, atol=3e-4)


def _assert_matches(got, want):
    (out, lse, grads), (out_j, lse_j, grads_j) = got, want
    np.testing.assert_allclose(out, out_j, err_msg="out", **FWD)
    np.testing.assert_allclose(lse, lse_j, err_msg="lse", **FWD)
    for g, w, name in zip(grads, grads_j, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD)


@pytest.mark.parametrize("kind,H,dsh,dvh,scale", [
    ("hub", 4, 8, 8, 1.0), ("dups", 2, 16, 8, 0.5), ("empty", 1, 8, 16, 1.0),
    ("hub", 4, 64, 8, 0.2)])
def test_forward_lse_and_gradients_match_reference(kind, H, dsh, dvh, scale):
    """A hub destination and a hub source (the hub block has several
    windows), a multigraph with dsh != dvh, empty rows (zeros in out and
    lse), and scores 256 columns wide (H·dsh > 128, the reference's
    wide-score case)."""
    N, ref, lay, *ins = _case(kind, H, dsh, dvh, scale)
    got = _port(lay, N, H, dsh, dvh, *ins, 0.0, None)
    _assert_matches(got, _reference(ref, N, H, dsh, dvh, *ins, 0.0, None))
    if kind == "empty":
        assert (got[0][200:] == 0).all() and (got[1][200:] == 0).all()
    if kind == "hub":
        assert int(np.bincount(lay.pairs[:, 0].numpy())[0]) > 1
    if kind == "dups":
        assert not lay.simple


@pytest.mark.parametrize("kind", ["simple", "multi"])
def test_cell_dropout_matches_reference(kind):
    """Rate 0.3 at one seed: the plain version drops the cells the
    reference's in-kernel mask drops, on a simple graph (cell dropout is
    edge dropout there) and on a multigraph in cell mode (a cell's
    duplicates drop together); outputs and gradients."""
    H, dsh, dvh = 2, 8, 8
    N, ref, lay, *ins = _case(kind, H, dsh, dvh)
    assert lay.simple == (kind == "simple")
    _assert_matches(_port(lay, N, H, dsh, dvh, *ins, 0.3, -1234567),
                    _reference(ref, N, H, dsh, dvh, *ins, 0.3, -1234567))


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_backward_is_autograd_of_plain_forward(rate):
    """``dedup_dot_attention``'s backward (the plain K8, dk and dv on node
    rows) against torch autograd of the plain forward, in float64, at dsh
    != dvh with a leaky relu."""
    H, dsh, dvh = 3, 4, 5
    N, _, lay, q, k, v, g = _case("multi", H, dsh, dvh)
    att = da.build_dedup_attention(lay, N)
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
         for x in (q, k, v)]
    g = torch.as_tensor(g, dtype=torch.float64)
    out, _ = da.dedup_dot_reference(*t, lay, dsh, dvh, 0.2, rate, -77)
    want = torch.autograd.grad(out, t, g)
    got = torch.autograd.grad(
        da.dedup_dot_attention(*t, att, H, dsh, dvh, 0.2, rate, -77), t, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_counts_or_none_give_the_same_bits():
    """A layout with K4's counts and one without give the same outputs and
    gradients."""
    H, dsh, dvh = 2, 16, 8
    N, _, lay, *ins = _case("dups", H, dsh, dvh)
    with_counts = tdk.materialize_counts(lay)
    assert with_counts.counts is not None
    runs = [_port(lay_, N, H, dsh, dvh, *ins, 0.3, 99)
            for lay_ in (with_counts, dataclasses.replace(lay, counts=None))]
    flat = [np.concatenate([r[0].ravel(), r[1].ravel()]
                           + [g.ravel() for g in r[2]]) for r in runs]
    np.testing.assert_array_equal(flat[0], flat[1])


def test_plain_path_launches_nothing_and_checks_shapes():
    N, _, lay, q, k, v, _ = _case("empty", 2, 4, 3)
    att = da.build_dedup_attention(lay, N)
    da.reset_launches()
    out = da.dedup_dot_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                 att, 2)
    assert out.shape == (N, 6) and not da.LAUNCHES_BY_SHAPE
    with pytest.raises(ValueError, match="are not"):
        da.dedup_dot_attention(torch.zeros(N, 8), torch.zeros(N, 6),
                               torch.zeros(N, 8), att, 2)
    with pytest.raises(ValueError, match="device"):
        da.dedup_dot_attention(*(torch.zeros(N, 8, device="meta")
                                 for _ in range(3)), att, 2)


# -- the cell lists of the CUDA kernels -------------------------------------

def _zero_edge_case():
    """A 50-node graph without edges: its layout and float inputs."""
    N, H, dsh, dvh = 50, 2, 4, 3
    lay = tdk.build_dedup_layout(np.zeros(N + 1, np.int64),
                                 np.zeros(0, np.int64), N, device="cpu")
    rng = np.random.default_rng(0)
    q, k = (rng.normal(size=(N, H * dsh)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(N, H * dvh)).astype(np.float32)
    return N, lay, q, k, v


def _cells_from_edges(lay, N):
    """Every nonzero cell of ``lay`` built from its edges alone, sorted by
    (slot, dst): ``(slot, dst, urow, node, count)``, int64."""
    dst, urow, slot = da._edge_slots(lay)
    cells, cnt = torch.unique(slot * N + dst, return_counts=True)
    c_slot, c_dst = cells // N, cells % N
    c_urow = lay.pairs.long()[c_slot // tdk.W, 1] + c_slot % tdk.W
    return c_slot, c_dst, c_urow, lay.uv.long()[c_urow], cnt


def _covered(pieces, num_items, num_rows, item_rows, num_partials):
    """Checks that ``cut_rows`` pieces cover ``num_items`` items once, in
    order, at most ``ET`` a piece, one piece at least for each of the
    ``num_rows`` rows in order, each piece within its row (``item_rows``
    the row of each item), and ``num_partials`` partial slots."""
    row, begin, end, slot = pieces.long().T
    assert len(row) >= num_rows
    assert int(begin[0]) == 0 and int(end[-1]) == num_items
    assert torch.equal(begin[1:], end[:-1])
    assert int((end - begin).max()) <= da.ET
    assert torch.equal(torch.unique_consecutive(row), torch.arange(num_rows))
    assert torch.equal(torch.repeat_interleave(row, end - begin), item_rows)
    assert int((slot >= 0).sum()) == num_partials
    split = torch.bincount(row, minlength=num_rows) > 1
    assert torch.equal(slot >= 0, split[row])


@pytest.mark.parametrize("kind", ["hub", "dups", "empty", "simple", "multi",
                                  "zero"])
def test_node_order_holds_every_cell_once(kind):
    """The node-ordered cell list (K8's node walk) holds every nonzero cell
    once, sorted by (node, slot, dst), with its multiplicity (they sum to
    E) and its key, ``cell_idx`` of the cell's edges; its pieces cover it
    node by node (a hub source's cells split into several). The row-ordered
    list's keys are its cells' ``cell_idx`` too. A graph without edges has
    no cells and one empty piece a node."""
    if kind == "zero":
        N, lay, *_ = _zero_edge_case()
    else:
        N, _, lay, *_ = _case(kind, 1, 1, 1)
    att = da.build_dedup_attention(lay, N)
    c_slot, c_dst, c_urow, c_node, cnt = _cells_from_edges(lay, N)
    order = torch.as_tensor(np.lexsort((c_dst.numpy(), c_slot.numpy(),
                                        c_node.numpy())))
    n = att.num_cells
    assert n == len(cnt) == att.node_dst.shape[0]
    assert torch.equal(att.node_dst.long(), c_dst[order])
    assert torch.equal(att.node_cnt.long(), cnt[order])
    assert int(att.node_cnt.sum()) == lay.num_edges
    key = da.cell_idx(c_dst, c_urow)
    assert torch.equal(att.node_key, key[order])
    dst, urow, slot = da._edge_slots(lay)
    # each edge's cell_idx is its cell's key
    cell_of = torch.searchsorted(c_slot * N + c_dst, slot * N + dst)
    assert torch.equal(key[cell_of], da.cell_idx(dst, urow))
    _covered(att.node_pieces, n, N, c_node[order], att.num_node_partials)
    assert torch.equal(att.node_split_rows.long(), torch.unique(
        att.node_pieces.long()[att.node_pieces[:, 3] >= 0, 0]))
    # the row order: (dst, unique row), keyed by cell_idx
    by_row = torch.as_tensor(np.lexsort((c_urow.numpy(), c_dst.numpy())))
    assert torch.equal(att.cell_key, key[by_row])
    assert torch.equal(att.cell_cnt.long(), cnt[by_row])
    _covered(att.pieces, n, N, c_dst[by_row], att.num_partials)
    if kind == "hub":
        assert att.num_node_partials > 0
    if kind == "zero":
        assert n == 0 and att.node_pieces.shape[0] == N


def test_zero_edge_graph_gives_zeros():
    """Without edges the forward and every gradient are zeros (the kernels'
    empty pieces store zeros; the plain versions scatter nothing)."""
    N, lay, q, k, v = _zero_edge_case()
    att = da.build_dedup_attention(lay, N)
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = da.dedup_dot_attention(*t, att, 2, 4, 3, 0.0, 0.3, 5)
    out.square().sum().backward()
    assert out.shape == (N, 6) and not out.any()
    assert not any(x.grad.any() for x in t)


def _cell_walk(att, q, k, v, g, lse, delta, H, dsh, dvh, slope, rate,
               seed):
    """The kernels' arithmetic in float64 over the cell lists: ``dq`` from
    the row order (K8's row pass), ``dk`` and ``dv`` from the node order
    (the node walk), each cell's score q[dst]·k[node] per head, p = count ·
    exp(min(leaky(s) - lse[dst], 80)) and its keep bit from the list's key;
    rows and nodes summed piece by piece, then the pieces in order."""
    N = q.shape[0]

    def walk(nodes, dsts, cnt, keys, pieces, acc):
        s_raw = (q[dsts].reshape(-1, H, dsh)
                 * k[nodes].reshape(-1, H, dsh)).sum(-1)
        s = torch.where(s_raw >= 0, s_raw, slope * s_raw) if slope else s_raw
        p = cnt.double()[:, None] * torch.exp(
            torch.clamp(s - lse[dsts], max=80.0))
        qe = p
        if rate:
            qe = p * torch.stack([ak.drop_keep(keys, seed, h, rate)
                                  for h in range(H)], 1) / (1 - rate)
        gv = (g[dsts].reshape(-1, H, dvh) * v[nodes].reshape(-1, H, dvh)
              ).sum(-1)
        ds = qe * gv - p * delta[dsts]
        if slope:
            ds = torch.where(s_raw >= 0, ds, slope * ds)
        row, begin, end, _ = pieces.long().T
        piece = torch.repeat_interleave(torch.arange(len(row)), end - begin)
        part = [x.new_zeros(len(row), x.shape[1]).index_add_(0, piece, x)
                for x in acc(ds, qe, dsts, nodes)]
        return [x.new_zeros(N, x.shape[1]).index_add_(0, row, x)
                for x in part]

    def head(w, x):
        return (w[..., None] * x.reshape(len(w), H, -1)).reshape(len(w), -1)

    (dq,) = walk(att.cell_src.long(), _row_of(att.pieces),
                 att.cell_cnt, att.cell_key, att.pieces,
                 lambda ds, qe, d, n: [head(ds, k[n])])
    dk, dv = walk(_row_of(att.node_pieces), att.node_dst.long(),
                  att.node_cnt, att.node_key, att.node_pieces,
                  lambda ds, qe, d, n: [head(ds, q[d]), head(qe, g[d])])
    return dq, dk, dv


def _row_of(pieces):
    row, begin, end, _ = pieces.long().T
    return torch.repeat_interleave(row, end - begin)


@pytest.mark.parametrize("kind", ["hub", "multi"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_cell_walks_compute_the_plain_backward(kind, rate):
    """The row pass and the node walk, evaluated in float64 over their
    cell lists, equal the plain K8 in edge space (dq on rows, dk and dv on
    nodes), with a leaky relu, dsh != dvh and a hub source whose cells
    split."""
    H, dsh, dvh, slope, seed = 2, 4, 3, 0.2, -99
    N, _, lay, q, k, v, g = _case(kind, H, dsh, dvh)
    att = da.build_dedup_attention(lay, N)
    q, k, v, g = (torch.tensor(x, dtype=torch.float64) for x in (q, k, v, g))
    out, lse = da.dedup_dot_reference(q, k, v, lay, dsh, dvh, slope, rate,
                                      seed)
    delta = (g.reshape(N, H, dvh) * out.reshape(N, H, dvh)).sum(-1)
    ins = (q, k, v, g, lse, delta)
    want = da.dedup_dot_bwd_reference(*ins, lay, dsh, dvh, slope, rate, seed)
    got = _cell_walk(att, *ins, H, dsh, dvh, slope, rate, seed)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_node_rows_are_the_fold_of_the_slot_rows(rate):
    """dk and dv on node rows equal, in float64, the reference's pair-slot
    rows (per head ``Σ ds·q[dst]`` and ``Σ keep·p·g[dst]`` into slot ``p·W
    + c``) folded onto nodes by K1's plain version over ``build_uniq_reduce``'s
    layout."""
    H, dsh, dvh = 2, 8, 4
    N, _, lay, q, k, v, g = _case("dups", H, dsh, dvh)
    att = da.build_dedup_attention(lay, N)
    q, k, v, g = (torch.tensor(x, dtype=torch.float64) for x in (q, k, v, g))
    out, lse = da.dedup_dot_reference(q, k, v, lay, dsh, dvh, 0.0, rate, 7)
    delta = (g.reshape(N, H, dvh) * out.reshape(N, H, dvh)).sum(-1)
    ins = (q, k, v, g, lse, delta)
    _, dk, dv = da.dedup_dot_bwd_reference(*ins, lay, dsh, dvh, 0.0, rate, 7)
    dst, urow, slot = da._edge_slots(lay)
    src = lay.uv.long()[urow]
    qe, ds, g_e = ak.edge_grads(*ins, dst, src, da.cell_idx(dst, urow), 0.0,
                                dvh, rate, 7, dsh)
    S = lay.num_pairs * tdk.W
    red = da.build_uniq_reduce(lay, N)
    dk_slots = ak.head_scatter(ds, q[dst], slot, S)
    dv_slots = ak.head_scatter(qe, g_e.reshape(len(dst), -1), slot, S)
    torch.testing.assert_close(dk, sk.spmm_reference(dk_slots, red),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dv, sk.spmm_reference(dv_slots, red),
                               rtol=1e-12, atol=1e-12)
