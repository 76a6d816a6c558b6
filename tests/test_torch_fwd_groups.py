"""The additive forward's host side on the CPU (K9 per edge and K7 per
count-matrix cell, ``csrc/additive_groups.cuh`` ``gat_fwd_groups``): its
work lists (``attention_kernels.k10_work_list`` over the CSC edges and over
the cells in row order) and a numpy walk of them in the kernel's order (a
lane group's online state over its edges in order, the groups of a split
piece merged by a fixed xor tree, split rows' partials merged as
``gat_fwd_combine`` merges them, empty rows zero) against the plain forward
in float64 and ``pgl_tpu``'s ``_xla_additive_reference`` and
``dedup_attention``'s forward in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack: there this file skips
pytest.importorskip("flax")

from pgl_tpu.ops.pallas import dedup_kernels as jdk
from pgl_tpu.ops.pallas.attention_kernels import _xla_additive_reference
from pgl_tpu.ops.pallas.dedup_attention import _dedup_attn_fwd_call
from pgl_tpu_torch import Graph
from pgl_tpu_torch.ops.kernels import attention_kernels as ak
from pgl_tpu_torch.ops.kernels import dedup_attention as da
from pgl_tpu_torch.ops.kernels import dedup_kernels as tdk

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

N = 300
MASK = -1e30          # the kernels' running-max start (kMaskValue)
SLOPE = 0.2
SEED = -1640531535


def _hub_edges(seed=3, E=3000):
    """A hub destination (node 0, 700 edges from at most 300 sources:
    split over pieces, and cells of several edges), empty rows 1..149, a
    hub source (node 5), in shuffled order."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(700, np.int64),
                          rng.integers(N // 2, N, E - 700)])
    src = rng.integers(0, N, E)
    src[rng.choice(E, 600, replace=False)] = 5
    return np.stack([src, dst], axis=1)[rng.permutation(E)]


def _sixteen_edges(seed=4):
    """Every source sends 16 edges (rows of about 16 edges on CSC)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(N), 16)
    return np.stack([src, rng.integers(0, N, len(src))], axis=1)


GRAPHS = {"hub": _hub_edges, "sixteen": _sixteen_edges,
          "no_edges": lambda: np.zeros((0, 2), dtype=np.int64)}


def _graph(name):
    return Graph(GRAPHS[name](), num_nodes=N).tensor("cpu")


def _cells(g):
    """The count-matrix work lists (``DedupAttention``) of ``g``."""
    idx = g.adj_dst_index.numpy()
    lay = tdk.build_dedup_layout(idx.indptr, idx.sorted_v, N, device="cpu")
    return da.build_dedup_attention(lay, N)


def _lists(name):
    """(CSC attention layout, count-matrix work lists) of graph ``name``,
    each with its rows' pointer over its edges or cells."""
    g = _graph(name)
    csc, _ = g._attention_layouts()
    att = _cells(g)
    ptr_e = np.concatenate([[0], np.cumsum(np.bincount(
        csc.seg_ids.numpy(), minlength=N))]).astype(np.int64)
    row_of_cell = np.repeat(att.pieces[:, 0].numpy(),
                            (att.pieces[:, 2] - att.pieces[:, 1]).numpy())
    ptr_c = np.concatenate([[0], np.cumsum(np.bincount(
        row_of_cell, minlength=N))]).astype(np.int64)
    return (csc, ptr_e), (att, ptr_c)


@pytest.mark.parametrize("pack_row", [1, 4, 32, 256])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_forward_lists_take_every_edge_and_cell_once(name, pack_row,
                                                     monkeypatch):
    """K9's list over the CSC edges and K7's over the cells: every edge
    (cell) in exactly one item, the pieces of the rows past PACK_ROW in
    piece order (their split rows and slots ``cut_rows``'), every other
    nonempty row whole and longest first, every empty row once."""
    monkeypatch.setattr(ak, "PACK_ROW", pack_row)
    for lay, ptr in _lists(name):
        deg = np.diff(ptr)
        n = int(ptr[-1])
        items = lay.k10_items.numpy().astype(np.int64).reshape(-1, 4)
        n_long = lay.k10_long
        pieces = lay.pieces.numpy()
        np.testing.assert_array_equal(
            items[:n_long], pieces[deg[pieces[:, 0]] > pack_row])
        assert (items[:n_long, 2] - items[:n_long, 1] <= ak.ET).all()
        short = items[n_long:]
        assert (short[:, 3] == -1).all()
        np.testing.assert_array_equal(short[:, 1], ptr[short[:, 0]])
        np.testing.assert_array_equal(short[:, 2], ptr[short[:, 0] + 1])
        length = short[:, 2] - short[:, 1]
        assert ((length >= 1) & (length <= pack_row)).all()
        np.testing.assert_array_equal(np.lexsort((short[:, 0], -length)),
                                      np.arange(len(short)))
        hits = np.zeros(n, dtype=np.int64)
        for _, b, e, _ in items:
            hits[b:e] += 1
        assert (hits == 1).all()
        empty = lay.empty_rows.numpy()
        np.testing.assert_array_equal(empty, np.flatnonzero(deg == 0))
        rows = np.concatenate([np.unique(items[:n_long, 0]), short[:, 0],
                               empty])
        np.testing.assert_array_equal(np.sort(rows), np.arange(N))
        split = set(lay.split_rows.numpy())
        assert set(items[items[:, 3] >= 0, 0]) == split
        assert len(split) == int(lay.split_rows.shape[0])
    if name == "hub":
        (csc, _), (att, _) = _lists(name)
        assert csc.split_rows.tolist() == [0] == att.split_rows.tolist()
        assert int(att.cell_cnt.max()) > 1


def _combine_warps(H, dvh):
    """The warps of the forward's ``gat_fwd_combine`` block
    (``FwdCombineWarps``) at its slots a lane NC (``slots_per_lane``: H
    heads of dvh_p slots over 32 lanes, a power of two): 32 up to two
    slots a lane, else the dot mode's ``CombineWarps``, 64 / NC."""
    need = -(-H * ak._dvh_p(dvh) // 32)
    nc = 1 << (need - 1).bit_length()
    return 32 if nc <= 2 else 64 // nc


def _online(s, c, keep, vals):
    """A lane group's state (m [H], l [H], acc [H, dvh]) over its edges in
    order: the kernel's update with one exp, in float64."""
    H = vals.shape[1]
    m, l, acc = np.full(H, MASK), np.zeros(H), np.zeros(vals.shape[1:])
    for j in range(len(s)):
        t = np.exp(-np.abs(s[j] - m))
        up = s[j] > m
        sc = np.where(up, t, 1.0)
        p = c[j] * np.where(up, 1.0, t)
        m = np.where(up, s[j], m)
        l = l * sc + p
        acc = acc * sc[:, None] + np.where(keep[j], p, 0.0)[:, None] * vals[j]
    return m, l, acc


def _merge(a, b):
    """``merge``: the state a with the partial b (in that order)."""
    (M, L, A), (m, l, x) = a, b
    mn = np.maximum(M, m)
    s1, s2 = np.exp(M - mn), np.exp(m - mn)
    return mn, L * s1 + l * s2, A * s1[:, None] + x * s2[:, None]


def _finish(state, inv_keep):
    m, l, acc = state
    row = l > 0
    out = np.where(row[:, None], acc * (inv_keep / np.maximum(l, 1e-300))
                   [:, None], 0.0)
    return out.reshape(-1), np.where(row, m + np.log(np.where(row, l, 1)),
                                     0.0)


def _walk(lay, s, c, keep, vals, H, dvh, rate):
    """The kernel's walk of ``lay``'s work list: each item's lane groups
    (32 / group a warp; a long piece's W groups take even shares and meet
    by the xor tree at group 0), split rows' partials merged in
    ``gat_fwd_combine``'s order (warp w of its W' merges pieces p0 + w, p0
    + w + W', ... in order, then warp 0 the W' states in order), empty
    rows zero. Returns out, lse and how many times each row was
    written."""
    W = 32 // ak.k10_lanes(H, dvh)[2]
    inv_keep = 1.0 / (1.0 - rate) if rate else 1.0
    items = lay.k10_items.numpy().astype(np.int64).reshape(-1, 4)
    out = np.full((N, H * dvh), np.nan)
    lse = np.full((N, H), np.nan)
    written = np.zeros(N, dtype=np.int64)
    parts = {}
    for i, (r, b, e, slot) in enumerate(items):
        if i < lay.k10_long:
            n = e - b
            groups = [_online(*(x[b + g * n // W:b + (g + 1) * n // W]
                                for x in (s, c, keep, vals)))
                      for g in range(W)]
            off = 1
            while off < W:
                groups = [_merge(groups[g], groups[g ^ off])
                          for g in range(W)]
                off <<= 1
            state = groups[0]
        else:
            state = _online(s[b:e], c[b:e], keep[b:e], vals[b:e])
        if slot < 0:
            out[r], lse[r] = _finish(state, inv_keep)
            written[r] += 1
        else:
            parts[slot] = state
    Wc = _combine_warps(H, dvh)
    ptr = lay.split_ptr.numpy()
    init = (np.full(H, MASK), np.zeros(H), np.zeros((H, dvh)))
    for j, r in enumerate(lay.split_rows.numpy()):
        warps = []
        for w in range(Wc):
            state = init
            for p in range(ptr[j] + w, ptr[j + 1], Wc):
                state = _merge(state, parts[p])
            warps.append(state)
        total = warps[0]
        for state in warps[1:]:
            total = _merge(total, state)
        out[r], lse[r] = _finish(total, inv_keep)
        written[r] += 1
    empty = lay.empty_rows.numpy()
    out[empty], lse[empty] = 0.0, 0.0
    written[empty] += 1
    return out, lse, written


def _inputs(H, dvh):
    rng = np.random.default_rng(H * 100 + dvh)
    return [rng.normal(size=(N, w)).astype(np.float32)
            for w in (H, H, H * dvh)]


def _keep(keys, H, rate):
    """[n, H] keep bits of the keys (all kept without dropout)."""
    if not rate:
        return np.ones((len(keys), H), dtype=bool)
    keys = torch.as_tensor(keys)
    return np.stack([ak.drop_keep(keys, SEED, h, rate).numpy()
                     for h in range(H)], axis=1)


def _terms(a_dst, a_src, v, rows, src, H, dvh):
    """Per edge (cell) in list order: its leaky score [n, H] and gathered
    value row [n, H, dvh], float64."""
    sr = a_dst[rows].astype(np.float64) + a_src[src]
    return (np.where(sr >= 0, sr, SLOPE * sr),
            v[src].astype(np.float64).reshape(-1, H, dvh))


SHAPES = [(8, 8), (1, 16), (3, 3), (42, 1)]


@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("H,dvh", SHAPES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_of_k9_list_is_the_plain_forward(name, H, dvh, rate):
    """K9 walked over the CSC list equals the plain forward in float64
    (1e-12) and, but for the no-edge graph, ``_xla_additive_reference``
    (out; 1e-5), every row written once."""
    (csc, _), _ = _lists(name)
    a_dst, a_src, v = _inputs(H, dvh)
    rows, src = csc.seg_ids.numpy(), csc.indices.numpy()
    s, vals = _terms(a_dst, a_src, v, rows, src, H, dvh)
    E = len(src)
    keep = _keep(np.arange(E, dtype=np.int32), H, rate)
    out, lse, written = _walk(csc, s, np.ones(E), keep, vals, H, dvh, rate)
    assert (written == 1).all()
    t = [torch.as_tensor(x, dtype=torch.float64) for x in (a_dst, a_src, v)]
    want_out, want_lse = ak.gat_attention_reference(*t, csc, SLOPE, dvh,
                                                    rate, SEED)
    np.testing.assert_allclose(out, want_out.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(lse, want_lse.numpy(), rtol=1e-12,
                               atol=1e-12)
    if E:
        ref = _xla_additive_reference(
            jnp.asarray(a_dst), jnp.asarray(a_src), jnp.asarray(v),
            jnp.asarray(src.astype(np.int32)),
            jnp.asarray(rows.astype(np.int32)), N, SLOPE, dvh, H * dvh,
            rate, jnp.int32(SEED) if rate else None)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def _jax_dedup(g, a_dst, a_src, v, H, dvh, rate):
    """``pgl_tpu``'s count-matrix forward (interpret mode) on its own
    dedup layout of ``g``: out [N, C] and lse [N, H]."""
    idx = g.adj_dst_index.numpy()
    ref = jdk.build_dedup_layout(idx.indptr, idx.sorted_v, N,
                                 debug_rows=True)
    out, lse = _dedup_attn_fwd_call(
        jnp.asarray(a_dst), jnp.asarray(a_src),
        jnp.zeros((N, 128)).at[:, :H * dvh].set(v), ref, H, dvh, 0, True,
        SLOPE, 256, 1024, 128, True, rate,
        jnp.int32(SEED) if rate else None)
    n_pad = lse.shape[0] // H
    lse = np.asarray(lse).reshape(n_pad // 256, H, 256).transpose(
        0, 2, 1).reshape(n_pad, H)[:N]
    return np.asarray(out)[:, :H * dvh], lse


@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("H,dvh", SHAPES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_of_k7_list_is_the_plain_forward(name, H, dvh, rate):
    """K7 walked over the cells' list (each cell's count multiplying p, its
    key ``cell_key`` keying the dropout) equals the plain forward in
    float64 (1e-12) and, on the hub graph (a multigraph whose hub row's
    cells split), ``pgl_tpu``'s count-matrix forward in interpret mode
    (out and lse, 1e-5); every row written once."""
    g = _graph(name)
    att = _cells(g)
    a_dst, a_src, v = _inputs(H, dvh)
    row_of_cell = np.repeat(att.pieces[:, 0].numpy(),
                            (att.pieces[:, 2] - att.pieces[:, 1]).numpy())
    src = att.cell_src.numpy()
    s, vals = _terms(a_dst, a_src, v, row_of_cell, src, H, dvh)
    keep = _keep(att.cell_key.numpy(), H, rate)
    out, lse, written = _walk(att, s, att.cell_cnt.numpy().astype(
        np.float64), keep, vals, H, dvh, rate)
    assert (written == 1).all()
    t = [torch.as_tensor(x, dtype=torch.float64) for x in (a_dst, a_src, v)]
    want_out, want_lse = da.dedup_attention_reference(
        *t, att.layout, SLOPE, dvh, rate, SEED)
    np.testing.assert_allclose(out, want_out.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(lse, want_lse.numpy(), rtol=1e-12,
                               atol=1e-12)
    if name == "hub":
        assert att.k10_long and int(att.cell_cnt.max()) > 1
        ref_out, ref_lse = _jax_dedup(g, a_dst, a_src, v, H, dvh, rate)
        np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 32])
def test_group_merge_tree_is_order_free_on_equal_scores(W):
    """The xor tree of online states at group 0 equals one state over all
    the groups' edges: exactly where every score is equal (every rescale
    1, the sums integers)."""
    rng = np.random.default_rng(W)
    n = 3 * W + 1
    s = np.zeros((n, 2))
    c = rng.integers(1, 5, n).astype(np.float64)
    vals = rng.integers(-4, 5, (n, 2, 3)).astype(np.float64)
    keep = np.ones((n, 2), dtype=bool)
    groups = [_online(*(x[g * n // W:(g + 1) * n // W]
                        for x in (s, c, keep, vals))) for g in range(W)]
    off = 1
    while off < W:
        groups = [_merge(groups[g], groups[g ^ off]) for g in range(W)]
        off <<= 1
    for got, want in zip(groups[0], _online(s, c, keep, vals)):
        assert np.array_equal(got, want)
