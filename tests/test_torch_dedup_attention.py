"""Parity of the port's count-matrix GAT attention (K7/K8,
``pgl_tpu_torch/ops/kernels/dedup_attention.py``) with ``pgl_tpu``'s
``dedup_gat_attention`` run in interpret mode, on the CPU, each on its own
dedup layout of the same numpy edges: the forward and its ``lse``, the
gradients (the port's on node rows, the reference's through its fold over
``build_uniq_reduce``), the cell dropout, the cell key ``_cell_idx`` bit for
bit, and the fold layout array for array. The work lists that the CUDA
kernels walk (the cells in row order, and in node order for K8's node walk)
are held against the plain versions here too, evaluated in cell space; the
kernels themselves are held against the plain versions in
``tests/test_torch_kernels_gpu.py``."""

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
    _cell_idx, _dedup_attn_fwd_call, build_uniq_reduce as j_uniq_reduce,
    dedup_gat_attention as j_dedup_gat)
from pgl_tpu_torch.ops.kernels import attention_kernels as ak
from pgl_tpu_torch.ops.kernels import dedup_attention as da
from pgl_tpu_torch.ops.kernels import dedup_kernels as tdk
from pgl_tpu_torch.ops.kernels import segment_kernels as sk
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

# The first torch.exp of a process on the CPU can differ from every later
# one by up to ~6e-5 (seen on [6000, 4] float32 inputs, in about one
# process of five), which the tolerances below would flag: take it here,
# before any comparison.
torch.exp(torch.zeros(1 << 16))


def _edges(kind):
    """(edges [E, 2] as (src, dst), N) of a small graph of one kind."""
    rng = np.random.default_rng({"hub": 1, "dups": 2, "empty": 3,
                                 "simple": 4, "multi": 5}[kind])
    if kind == "empty":                 # every edge into nodes 0..99
        N = 300
        return np.stack([rng.integers(0, N, 1500),
                         rng.integers(0, 100, 1500)], 1), N
    if kind == "simple":                # no (dst, src) pair twice
        N, E = 600, 4000
        pairs = rng.choice(N * N, E, replace=False)
        return np.stack([pairs % N, pairs // N], 1), N
    N, E = 800, 6000
    e = rng.integers(0, N, (E, 2))
    if kind == "hub":                   # hub destination 0, hub source 1
        e[:E // 3, 1] = 0
        e[E // 3:E // 2, 0] = 1
    else:                               # "dups" and "multi": a multigraph
        e[-600:] = e[:600]
    return e, N


def _case(kind, H, dvh):
    """Both packages' layouts of one graph and numpy inputs."""
    edges, N = _edges(kind)
    idx = EdgeIndex.from_edges(edges[:, 1], edges[:, 0], N)
    ref = jdk.build_dedup_layout(idx.indptr, idx.sorted_v, N,
                                 debug_rows=True)
    lay = tdk.build_dedup_layout(idx.indptr, idx.sorted_v, N, device="cpu")
    rng = np.random.default_rng(H * 100 + dvh)
    a_dst, a_src = (rng.normal(size=(N, H)).astype(np.float32)
                    for _ in range(2))
    v = rng.normal(size=(N, H * dvh)).astype(np.float32)
    tgt = rng.normal(size=(N, H * dvh)).astype(np.float32)
    return N, ref, lay, a_dst, a_src, v, tgt


def _pad128(v):
    return jnp.zeros((v.shape[0], 128)).at[:, :v.shape[1]].set(v)


def _reference(ref, N, H, dvh, a_dst, a_src, v, tgt, rate, seed):
    """The reference's out, lse [N, H] and gradients of sum((out - tgt)^2)
    (interpret mode)."""
    red = j_uniq_reduce(ref, N)
    seed_j = None if seed is None else jnp.int32(seed)
    out, lse = _dedup_attn_fwd_call(
        jnp.asarray(a_dst), jnp.asarray(a_src), _pad128(v), ref, H, dvh, 0,
        True, 0.2, 256, 1024, 128, True, rate, seed_j)
    n_pad = lse.shape[0] // H
    lse = np.asarray(lse).reshape(n_pad // 256, H, 256).transpose(
        0, 2, 1).reshape(n_pad, H)[:N]

    def loss(a, b, c):
        o = j_dedup_gat(a, b, c, ref, red, H, dvh, 0.2, 256, 1024, True,
                        rate, seed_j)
        return ((o[:, :H * dvh] - tgt) ** 2).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(a_dst), jnp.asarray(a_src), _pad128(v))
    return (np.asarray(out)[:, :H * dvh], lse,
            [np.asarray(gr)[:, :w] for gr, w in zip(grads, (H, H, H * dvh))])


def _port(lay, N, a_dst, a_src, v, tgt, rate, seed):
    att = da.build_dedup_attention(lay, N)
    t = [torch.tensor(x, requires_grad=True) for x in (a_dst, a_src, v)]
    out = da.dedup_gat_attention(*t, att, 0.2, v.shape[1] // a_dst.shape[1],
                                 rate, seed)
    ((out - torch.as_tensor(tgt)) ** 2).sum().backward()
    _, lse = da.dedup_attention_reference(*(x.detach() for x in t),
                                          lay, 0.2, None, rate, seed)
    return out.detach().numpy(), lse.numpy(), [x.grad.numpy() for x in t]


def _assert_matches(got, want, fwd_tol, grad_tol):
    (out, lse, grads), (out_j, lse_j, grads_j) = got, want
    np.testing.assert_allclose(out, out_j, **fwd_tol)
    np.testing.assert_allclose(lse, lse_j, **fwd_tol)
    for g, w, name in zip(grads, grads_j, ("a_dst", "a_src", "v")):
        np.testing.assert_allclose(g, w, err_msg=name, **grad_tol)


# tighter than the reference's own tests (tests/test_dedup_attention.py:
# forward rtol 1e-4, atol 1e-5; gradients rtol 2e-3 with atol 2e-4, or 3e-4
# under dropout) where they hold: the port sums float32 in another order,
# edge by edge, and the hub's gradient sums (hundreds of terms) need the
# reference's atol. Measured worst cases: forward 1.9e-6 absolute,
# gradients 1.5e-4 (hub) and 1.4e-5 (the dropout cases).
FWD = dict(rtol=1e-5, atol=2e-6)
GRAD = dict(rtol=2e-3, atol=2e-4)
GRAD_DROP = dict(rtol=2e-3, atol=5e-5)


@pytest.mark.parametrize("kind,H,dvh", [("hub", 4, 8), ("dups", 8, 8),
                                        ("empty", 1, 16)])
def test_forward_lse_and_gradients_match_reference(kind, H, dvh):
    """A hub destination and a hub source (the hub block has several
    windows), a multigraph, and empty rows (zeros in out and lse)."""
    N, ref, lay, *ins = _case(kind, H, dvh)
    got = _port(lay, N, *ins, 0.0, None)
    _assert_matches(got, _reference(ref, N, H, dvh, *ins, 0.0, None), FWD,
                    GRAD)
    if kind == "empty":
        assert (got[0][100:] == 0).all() and (got[1][100:] == 0).all()
    if kind == "hub":
        assert int(np.bincount(lay.pairs[:, 0].numpy())[0]) > 1
    if kind == "dups":
        assert not lay.simple


@pytest.mark.parametrize("kind", ["simple", "multi"])
def test_cell_dropout_matches_reference(kind):
    """Rate 0.4 at one seed: on a simple graph (cell dropout is edge
    dropout there) and on a multigraph in cell mode (a cell's duplicates
    drop together), outputs and gradients against the reference's kernel."""
    H, dvh = 4, 8
    N, ref, lay, *ins = _case(kind, H, dvh)
    assert lay.simple == (kind == "simple")
    _assert_matches(_port(lay, N, *ins, 0.4, -1234567),
                    _reference(ref, N, H, dvh, *ins, 0.4, -1234567), FWD,
                    GRAD_DROP)


@pytest.mark.parametrize("kind", ["hub", "multi", "empty"])
def test_cell_idx_is_the_reference_key(kind):
    """Per edge, the port's key equals the reference kernel's ``_cell_idx``
    tile of its pair at (dst row, unique row), bit for bit."""
    edges, N = _edges(kind)
    idx = EdgeIndex.from_edges(edges[:, 1], edges[:, 0], N)
    lay = tdk.build_dedup_layout(idx.indptr, idx.sorted_v, N, device="cpu")
    blk, wb, start, end = lay.pairs.numpy().T
    dst, urow = lay.dst.numpy(), lay.urow.numpy()
    want = np.empty(lay.num_edges, np.int32)
    for p in range(lay.num_pairs):
        tile = np.asarray(_cell_idx(jnp.int32(blk[p]), jnp.int32(wb[p]),
                                    tdk.NB, tdk.W))
        s = slice(start[p], end[p])
        want[s] = tile[dst[s] - blk[p] * tdk.NB, urow[s] - wb[p]]
    got = da.cell_idx(lay.dst, lay.urow)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any()             # the int32 wrap-around is exercised


def test_uniq_reduce_matches_reference():
    """The fold's order (gather ids) and row pointer, array for array."""
    edges, N = _edges("hub")
    idx = EdgeIndex.from_edges(edges[:, 1], edges[:, 0], N)
    ref = j_uniq_reduce(jdk.build_dedup_layout(idx.indptr, idx.sorted_v, N),
                        N)
    red = da.build_uniq_reduce(
        tdk.build_dedup_layout(idx.indptr, idx.sorted_v, N, device="cpu"), N)
    S = red.num_edges
    assert (red.kind, red.num_rows, S) == ("uniq_reduce", N, ref.num_edges)
    np.testing.assert_array_equal(red.indices.numpy(),
                                  np.asarray(ref.padded_v)[:S])
    np.testing.assert_array_equal(
        red.seg_ids.numpy(), np.asarray(ref.padded_ids).reshape(-1)[:S])
    indptr = red.indptr.numpy()
    np.testing.assert_array_equal(
        indptr[np.minimum(np.arange(len(ref.tile_ends)) * 256 + 256, N)],
        np.asarray(ref.tile_ends))


def test_counts_or_none_give_the_same_bits():
    """A layout with K4's counts and one without give the same work lists,
    outputs and gradients."""
    N, _, lay, *ins = _case("dups", 8, 8)
    with_counts = tdk.materialize_counts(lay)
    assert with_counts.counts is not None
    runs = [_port(lay_, N, *ins, 0.4, 99)
            for lay_ in (with_counts, dataclasses.replace(lay, counts=None))]
    flat = [np.concatenate([r[0].ravel(), r[1].ravel()]
                           + [g.ravel() for g in r[2]]) for r in runs]
    np.testing.assert_array_equal(flat[0], flat[1])
    att = [da.build_dedup_attention(x, N)
           for x in (with_counts, dataclasses.replace(lay, counts=None))]
    for f in dataclasses.fields(da.DedupAttention):
        x, y = getattr(att[0], f.name), getattr(att[1], f.name)
        if torch.is_tensor(x):
            assert torch.equal(x, y), f.name


def _pieces_rows(att, pieces, num_partials):
    """The row (or node) of every cell of a cell list, from its ``cut_rows``
    pieces; checks that the pieces cover the cells once, in order, at most
    ``ET`` each, and every row."""
    row, begin, end, slot = pieces.long().T
    assert begin[0] == 0 and end[-1] == att.num_cells
    assert torch.equal(begin[1:], end[:-1])
    assert int((end - begin).max()) <= da.ET
    assert torch.equal(torch.unique(row), torch.arange(att.num_rows))
    assert int((slot >= 0).sum()) == num_partials
    return torch.repeat_interleave(row, end - begin)


@pytest.mark.parametrize("kind", ["hub", "multi"])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_work_lists_compute_the_plain_function(kind, rate):
    """The kernels' arithmetic, evaluated in float64 over the work lists
    (cells with counts in row order; in node order with their keys, K8's
    node walk), equals the plain versions in edge space: forward and lse,
    d a_dst, and d a_src and dv on node rows."""
    H, dvh = 3, 5
    N, _, lay, a_dst, a_src, v, g = _case(kind, H, dvh)
    att = da.build_dedup_attention(lay, N)
    a_dst, a_src, v, g = (torch.tensor(x, dtype=torch.float64)
                          for x in (a_dst, a_src, v, g))
    seed, E = 31337, lay.num_edges
    out_p, lse_p = da.dedup_attention_reference(a_dst, a_src, v, lay, 0.2,
                                                dvh, rate, seed)
    delta = (g.reshape(N, H, dvh) * out_p.reshape(N, H, dvh)).sum(-1)
    bwd = (a_dst, a_src, v, g, lse_p, delta)
    want = da.dedup_bwd_reference(*bwd, lay, 0.2, dvh, rate, seed)
    assert int(att.cell_cnt.sum()) == int(att.node_cnt.sum()) == E
    if kind == "multi":
        assert int(att.cell_cnt.max()) > 1 and att.num_cells < E

    def keep(key):
        k = torch.stack([ak.drop_keep(key, seed, h, rate)
                         for h in range(H)], 1)
        return k.double() / (1 - rate) if rate else torch.ones_like(
            k, dtype=torch.float64)

    def leaky(s):
        return torch.where(s >= 0, s, 0.2 * s)

    # row order: K7 and K8's row pass
    dst = _pieces_rows(att, att.pieces, att.num_partials)
    src, urow = att.cell_src.long(), att.cell_urow.long()
    cnt = att.cell_cnt.double()[:, None]
    s = leaky(a_dst[dst] + a_src[src])
    m = torch.full((N, H), -torch.inf, dtype=torch.float64).scatter_reduce_(
        0, dst[:, None].expand(-1, H), s, "amax")
    p = cnt * torch.exp(s - m[dst])
    l = torch.zeros(N, H, dtype=torch.float64).index_add_(0, dst, p)
    kp = keep(da.cell_idx(dst, urow))
    acc = torch.zeros(N, H, dvh, dtype=torch.float64).index_add_(
        0, dst, (kp * p)[..., None] * v[src].reshape(-1, H, dvh))
    has = l > 0
    out = torch.where(has[..., None], acc / l.clamp(min=1e-300)[..., None],
                      0.0).reshape(N, H * dvh)
    lse = torch.where(has, m + torch.log(l), 0.0)
    torch.testing.assert_close(out, out_p, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(lse, lse_p, rtol=1e-12, atol=1e-12)

    # K7's list (``k10_items``): every cell in one item, the rows without
    # cells apart; each item's softmax state (m, l, acc) from its cells with
    # their keys, a split row's partials merged in slot order
    items = att.k10_items.long()
    b, e = items[:, 1], items[:, 2]
    order = torch.argsort(b)
    assert torch.equal(b[order][1:], e[order][:-1])
    assert int(e.max()) == att.num_cells and int(b.min()) == 0
    assert torch.equal(torch.repeat_interleave(items[order, 0],
                                               (e - b)[order]), dst)
    assert set(att.empty_rows.tolist()) == set(range(N)) - set(
        dst.tolist())
    kkey = keep(att.cell_key)
    got_out = torch.zeros(N, H, dvh, dtype=torch.float64)
    got_lse = torch.zeros(N, H, dtype=torch.float64)
    parts = {}
    for r, b_, e_, slot in items.tolist():
        si = s[b_:e_]
        mi = si.max(0).values
        pi = cnt[b_:e_] * torch.exp(si - mi)
        state = (mi, pi.sum(0), ((kkey[b_:e_] * pi)[..., None]
                                 * v[src[b_:e_]].reshape(-1, H, dvh)).sum(0))
        if slot < 0:
            parts[-1 - r] = state
        else:
            parts[slot] = state
    finals = {-1 - k: st for k, st in parts.items() if k < 0}
    ptr = att.split_ptr.tolist()
    for j, r in enumerate(att.split_rows.tolist()):
        ms = torch.stack([parts[p][0] for p in range(ptr[j], ptr[j + 1])])
        mx = ms.max(0).values
        finals[r] = (mx, sum(parts[p][1] * torch.exp(parts[p][0] - mx)
                             for p in range(ptr[j], ptr[j + 1])),
                     sum(parts[p][2] * torch.exp(parts[p][0] - mx)[:, None]
                         for p in range(ptr[j], ptr[j + 1])))
    for r, (mi, li, ai) in finals.items():
        got_out[r] = ai / li[:, None]
        got_lse[r] = mi + torch.log(li)
    torch.testing.assert_close(got_out.reshape(N, H * dvh), out_p,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_lse, lse_p, rtol=1e-12, atol=1e-12)

    def cell_grads(dst, src, key, cnt):
        sr = a_dst[dst] + a_src[src]
        p = cnt * torch.exp(torch.clamp(leaky(sr) - lse_p[dst], max=80.0))
        q = keep(key) * p
        gv = (g[dst].reshape(-1, H, dvh) * v[src].reshape(-1, H, dvh)).sum(-1)
        ds = q * gv - p * delta[dst]
        return torch.where(sr >= 0, ds, 0.2 * ds), q

    ds, _ = cell_grads(dst, src, da.cell_idx(dst, urow), cnt)
    da_dst = torch.zeros(N, H, dtype=torch.float64).index_add_(0, dst, ds)
    torch.testing.assert_close(da_dst, want[0], rtol=1e-12, atol=1e-12)

    # node order: K8's node walk, each cell's key from the list, summed
    # piece by piece, then the pieces onto their nodes in order
    node = _pieces_rows(att, att.node_pieces, att.num_node_partials)
    ndst = att.node_dst.long()
    ds, q = cell_grads(ndst, node, att.node_key,
                       att.node_cnt.double()[:, None])
    row, begin, end, _ = att.node_pieces.long().T
    piece = torch.repeat_interleave(torch.arange(len(row)), end - begin)
    dv_cell = (q[..., None] * g[ndst].reshape(-1, H, dvh)).reshape(-1,
                                                                  H * dvh)
    got = [x.new_zeros(N, x.shape[1]).index_add_(
        0, row, x.new_zeros(len(row), x.shape[1]).index_add_(0, piece, x))
        for x in (ds, dv_cell)]
    torch.testing.assert_close(got[0], want[1], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got[1], want[2], rtol=1e-12, atol=1e-12)
    if kind == "hub":
        assert att.num_node_partials > 0     # the hub source's cells split


@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_node_rows_are_the_fold_of_the_slot_rows(rate):
    """d a_src and dv on node rows (the plain K8, as the node walk writes
    them) equal, in float64, the reference's pair-slot rows (``Σ ds`` and
    ``Σ keep·p·g[dst]`` into slot ``p·W + c``) folded onto nodes by K1's
    plain version over ``build_uniq_reduce``'s layout."""
    H, dvh = 3, 5
    N, _, lay, a_dst, a_src, v, g = _case("dups", H, dvh)
    a_dst, a_src, v, g = (torch.tensor(x, dtype=torch.float64)
                          for x in (a_dst, a_src, v, g))
    out, lse = da.dedup_attention_reference(a_dst, a_src, v, lay, 0.2, dvh,
                                            rate, 7)
    delta = (g.reshape(N, H, dvh) * out.reshape(N, H, dvh)).sum(-1)
    ins = (a_dst, a_src, v, g, lse, delta)
    _, dsrc, dv = da.dedup_bwd_reference(*ins, lay, 0.2, dvh, rate, 7)
    dst, urow, slot = da._edge_slots(lay)
    q, ds, g_e = ak.edge_grads(*ins, dst, lay.uv.long()[urow],
                               da.cell_idx(dst, urow), 0.2, dvh, rate, 7)
    S = lay.num_pairs * tdk.W
    red = da.build_uniq_reduce(lay, N)
    dsrc_slots = ds.new_zeros(S, H).index_add_(0, slot, ds)
    dv_slots = ds.new_zeros(S, H * dvh).index_add_(
        0, slot, (q[..., None] * g_e).reshape(-1, H * dvh))
    torch.testing.assert_close(dsrc, sk.spmm_reference(dsrc_slots, red),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dv, sk.spmm_reference(dv_slots, red),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_zero_edge_graph_gives_zeros(rate):
    """A 50-node graph without edges: zeros out and zero gradients (the
    kernels' empty pieces store zeros; the plain versions scatter
    nothing), as the reference returns."""
    N, H, dvh = 50, 2, 3
    lay = tdk.build_dedup_layout(np.zeros(N + 1, np.int64),
                                 np.zeros(0, np.int64), N, device="cpu")
    att = da.build_dedup_attention(lay, N)
    assert att.num_cells == 0 and att.node_pieces.shape[0] == N
    rng = np.random.default_rng(0)
    t = [torch.tensor(rng.normal(size=(N, w)).astype(np.float32),
                      requires_grad=True) for w in (H, H, H * dvh)]
    out = da.dedup_gat_attention(*t, att, 0.2, dvh, rate, 5)
    out.square().sum().backward()
    assert out.shape == (N, H * dvh) and not out.any()
    assert not any(x.grad.any() for x in t)


@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_backward_is_autograd_of_plain_forward(rate):
    """``dedup_gat_attention``'s backward (the plain K8, on node rows)
    against torch autograd of the plain forward, in float64."""
    H, dvh = 3, 5
    N, _, lay, a_dst, a_src, v, g = _case("multi", H, dvh)
    att = da.build_dedup_attention(lay, N)
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
         for x in (a_dst, a_src, v)]
    g = torch.as_tensor(g, dtype=torch.float64)
    out, _ = da.dedup_attention_reference(*t, lay, 0.2, dvh, rate, -77)
    want = torch.autograd.grad(out, t, g)
    got = torch.autograd.grad(
        da.dedup_gat_attention(*t, att, 0.2, dvh, rate, -77), t, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_plain_path_launches_nothing_and_checks_shapes():
    N, _, lay, a_dst, a_src, v, _ = _case("empty", 2, 3)
    att = da.build_dedup_attention(lay, N)
    da.reset_launches()
    da.dedup_gat_attention(*(torch.as_tensor(x) for x in (a_dst, a_src, v)),
                           att)
    assert not da.LAUNCHES_BY_SHAPE
    a = torch.zeros(N, 2)
    with pytest.raises(ValueError, match="not \\[N, H\\]"):
        da.dedup_gat_attention(a, torch.zeros(N, 3), torch.zeros(N, 6), att)
    with pytest.raises(ValueError, match="device"):
        da.dedup_gat_attention(*(x.to("meta") for x in (a, a, a)), att)
