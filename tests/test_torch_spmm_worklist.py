"""K1's packed work list (``segment_kernels.pack_rows``, built at
``build_spmm_layout``), which K1w walks too, on the CPU.

The CUDA kernels walk ``SpmmLayout.items``: rows longer than ``PACK_ROW``
edges as items of their own, cut into pieces past ``MIN_PIECE`` edges (a
split row's pieces write partials that a second launch sums in piece
order), and packs of consecutive short rows. Here the list's structure
is checked directly (every edge once, items ending only at row ends or at a
piece of a split row, sources sorted within rows, empty and zero-edge
graphs), and a walk of the list in numpy, item by item as the kernel does,
is held against the Pallas kernels in interpret mode: ``spmm`` (K1) and
``sorted_segment_sum`` (K2's contract). Tolerance rtol 1e-5, atol 1e-3, as
``test_torch_segment_kernels.py``: float32 sums taken in another order.

K1w's walk of the same list (forward, dx with dw, dw alone; weights and dw
through the layout's edge ids) is modelled in float64 and held against the
plain versions at 1e-12 (one sum order against another), every dw written
once; ``spmm_weighted`` on these lists against the Pallas kernel; and the
kernel's per-head reduction of dw (``head_tree`` over ``Heads`` in
``csrc/segment_kernels.cu``) is modelled lane by lane on integers, so its
sums are exact, at every lane configuration ``items_config`` picks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("flax")

from pgl_tpu.ops.pallas import segment_kernels as jsk
from pgl_tpu_torch.ops.kernels import segment_kernels as tsk
from pgl_tpu_torch.utils.edge_index import EdgeIndex

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3
NB, ET = 128, 256    # the interpret-mode tile sizes of test_pallas_kernels
PACK = tsk.PACK


def degrees(kind, seed=0):
    """Row degrees of one kind of work list."""
    rng = np.random.default_rng(seed)
    if kind == "mixed":       # every kind of item
        deg = rng.choice([0, 0, 1, 2, 5, 9], size=400)
        deg[rng.choice(400, 12, replace=False)] = rng.integers(33, 600, 12)
        deg[3] = 2 * tsk.ET + 5                # split into pieces
        deg[50:90] = 0                          # more than a pack of rows
        return deg
    if kind == "boundaries":  # packs that fill exactly, then one more edge
        return np.array([PACK, 0, PACK - 1, 1, 0, PACK + 1, 16, 16, 1, PACK])
    if kind == "short_only":
        return rng.integers(0, 4, size=300)
    if kind == "empty_rows":
        return np.zeros(70, dtype=np.int64)
    raise ValueError(kind)


KINDS = ["mixed", "boundaries", "short_only", "empty_rows"]


def layout_of(deg, seed=1):
    deg = np.asarray(deg, dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    E = int(indptr[-1])
    rng = np.random.default_rng(seed)
    src = rng.integers(0, max(E, 1), E)
    return indptr, tsk.build_spmm_layout(indptr, src, len(deg),
                                         device="cpu")


def piece_length(d):
    """The length of K1's pieces of a row of ``d`` edges."""
    return int(np.clip(-(-d // tsk.ROW_PIECES), tsk.MIN_PIECE, tsk.ET))


def walk_items(x, lay):
    """The kernel's walk of ``lay.items`` in numpy: a piece sums its edges
    into its row (slot -1) or its partial slot, a pack sums each of its
    rows' edges into that row; split rows add their partials in slot
    order."""
    x = np.asarray(x, dtype=np.float64)
    indptr, idx = lay.indptr.numpy(), lay.indices.numpy()
    out = np.full((lay.num_rows, x.shape[1]), np.nan)
    part = np.full((lay.item_partials, x.shape[1]), np.nan)
    for row, begin, end, w in lay.items.numpy():
        if w >= -1:
            (part[w] if w >= 0 else out[row])[:] = x[idx[begin:end]].sum(0)
        else:
            for r in range(row, row - w):
                out[r] = x[idx[indptr[r]:indptr[r + 1]]].sum(0)
    for i, r in enumerate(lay.item_split_rows.numpy()):
        p0, p1 = lay.item_split_ptr.numpy()[i:i + 2]
        out[r] = part[p0:p1].sum(0)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_items_cover_every_edge_once(kind):
    indptr, lay = layout_of(degrees(kind))
    items = lay.items.numpy()
    covered = np.concatenate([np.arange(b, e) for _, b, e, _ in items]
                             + [np.zeros(0, np.int64)])
    assert len(covered) == lay.num_edges
    np.testing.assert_array_equal(np.sort(covered), np.arange(lay.num_edges))
    # every row in one item, a split row in one item a piece
    count = np.zeros(lay.num_rows, dtype=np.int64)
    for row, _, _, w in items:
        count[row:row + max(1, -w)] += 1
    want = np.ones(lay.num_rows, dtype=np.int64)
    want[lay.item_split_rows.numpy()] = np.diff(lay.item_split_ptr.numpy())
    np.testing.assert_array_equal(count, want)
    # the rows' items, then the packs, each part in row order
    packs = items[:, 3] < -1
    assert lay.item_packs == packs.sum()
    assert packs[len(items) - lay.item_packs:].all()
    for part in (items[~packs], items[packs]):
        assert (np.diff(part[:, 0]) >= 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_items_end_only_at_row_ends_or_pieces(kind):
    indptr, lay = layout_of(degrees(kind))
    deg = np.diff(indptr)
    for row, begin, end, w in lay.items.numpy():
        if w < -1:                       # a pack of -w short rows
            n = -w
            assert 2 <= n <= PACK and end - begin <= PACK
            assert begin == indptr[row] and end == indptr[row + n]
            assert (deg[row:row + n] <= tsk.PACK_ROW).all()
        elif w == -1:                    # one whole row
            assert (begin, end) == (indptr[row], indptr[row + 1])
            assert deg[row] <= tsk.MIN_PIECE
        else:                            # a piece of a split row
            assert deg[row] > tsk.MIN_PIECE
            assert end - begin <= piece_length(deg[row])
            assert indptr[row] <= begin < end <= indptr[row + 1]


def test_packs_are_greedy():
    """A pack stops only where the next row would pass ``PACK`` edges or
    rows, or is longer than ``PACK_ROW`` edges."""
    indptr, lay = layout_of(degrees("mixed"))
    deg = np.diff(indptr)
    R = len(deg)
    for row, begin, end, w in lay.items.numpy():
        if w > -1:
            continue
        n = max(1, -w)
        nxt = row + n
        if nxt < R and deg[nxt] <= tsk.PACK_ROW and deg[row] <= tsk.PACK_ROW:
            assert (end - begin + deg[nxt] > PACK or n == PACK)


@pytest.mark.parametrize("d", [0, 1, tsk.MIN_PIECE, tsk.MIN_PIECE + 1,
                               6600, tsk.ET * tsk.ROW_PIECES + 1, 803866])
def test_piece_length_follows_the_row(d):
    """A row of more than ``MIN_PIECE`` edges is cut into pieces of
    ``clip(ceil(d / ROW_PIECES), MIN_PIECE, ET)`` edges in order (partial
    slots in piece order), and a row past ``PACK_ROW`` edges keeps them
    in the layout's work list, which K1 and K1w walk."""
    indptr = np.array([0, 3, 3 + d, 3 + d + 5])
    pieces, split_rows, split_ptr = tsk.cut_spmm_rows(indptr)
    mine = pieces[pieces[:, 0] == 1]
    size = piece_length(d)
    n = max(1, -(-d // size))
    assert len(mine) == n
    np.testing.assert_array_equal(mine[:, 1], 3 + size * np.arange(n))
    np.testing.assert_array_equal(mine[:, 2],
                                  np.minimum(3 + size * np.arange(1, n + 1),
                                             3 + d))
    if n > 1:
        np.testing.assert_array_equal(split_rows, [1])
        np.testing.assert_array_equal(mine[:, 3], np.arange(n))
    else:
        assert len(split_rows) == 0 and (pieces[:, 3] == -1).all()
    lay = tsk.build_spmm_layout(indptr, np.arange(3 + d + 5), 3,
                                device="cpu")
    items = lay.items.numpy()
    if d > tsk.PACK_ROW:
        np.testing.assert_array_equal(items[items[:, 0] == 1], mine)
    assert lay.item_partials == (n if n > 1 else 0)


@pytest.mark.parametrize("kind", KINDS)
def test_sources_stay_sorted_within_rows(kind):
    indptr, lay = layout_of(degrees(kind), seed=3)
    idx = lay.indices.numpy()
    for r in range(lay.num_rows):
        assert (np.diff(idx[indptr[r]:indptr[r + 1]]) >= 0).all()


def test_empty_and_zero_edge_graphs():
    for R in (0, 1, 5, PACK + 3):
        indptr = np.zeros(R + 1, dtype=np.int64)
        lay = tsk.build_spmm_layout(indptr, np.zeros(0, np.int64), R,
                                    device="cpu")
        items = lay.items.numpy()
        assert items.shape == (-(-R // PACK), 4)
        assert (items[:, 1] == 0).all() and (items[:, 2] == 0).all()
        # every row once: packs of up to PACK rows, a lone row as -1
        assert int(np.maximum(1, -items[:, 3]).sum()) == R
        out = tsk.spmm_reference(torch.zeros(1, 4), lay)
        assert out.shape == (R, 4) and not out.any()
        np.testing.assert_array_equal(walk_items(np.zeros((1, 4)), lay),
                                      np.zeros((R, 4)))


@pytest.mark.parametrize("kind", KINDS)
def test_item_walk_is_the_plain_sum(kind):
    indptr, lay = layout_of(degrees(kind))
    x = np.random.default_rng(2).normal(size=(max(lay.num_edges, 1), 5))
    want = tsk.spmm_reference(torch.as_tensor(x), lay).numpy()
    np.testing.assert_allclose(walk_items(x, lay), want, rtol=1e-12,
                               atol=1e-12)


def graph(N, E, D, seed=0):
    """A hub destination of E/2 edges, many empty rows, uniform sources;
    features and a cotangent."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(E // 2, np.int64),
                          rng.integers(N // 2, N, E - E // 2)])
    src = rng.integers(0, N, E)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(N, D)).astype(np.float32)
    return (EdgeIndex.from_edges(dst, src, N),
            EdgeIndex.from_edges(src, dst, N), x, w)


@pytest.mark.parametrize("D", [1, 3, 16, 256])
def test_spmm_and_item_walk_match_pallas(D):
    """``spmm`` (the plain version here) and the walk of the new work list
    against the Pallas K1 in interpret mode, forward and gradient (the walk
    over the CSR list)."""
    N, E = 400, 3000        # the hub's 1,500 edges split into pieces
    csc, csr, x, w = graph(N, E, D)
    jl = [jsk.build_blocked_layout(i.indptr, i.sorted_v, N, NB, ET)
          for i in (csc, csr)]
    want = np.asarray(jsk.spmm(jnp.asarray(x), jl[0], jl[1], NB, ET, True))
    lays = [tsk.build_spmm_layout(i.indptr, i.sorted_v, N, kind=k,
                                  device="cpu")
            for k, i in (("csc", csc), ("csr", csr))]
    assert lays[0].item_partials > 0 and (lays[0].items[:, 3] < -1).any()
    f = torch.tensor(x, requires_grad=True)
    out = tsk.spmm(f, *lays)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(walk_items(x, lays[0]), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(walk_items(w, lays[1]), f.grad.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D", [1, 3, 16, 256])
def test_sorted_segment_sum_and_item_walk_match_pallas(D):
    """The identity gather (``sorted_segment_sum``) over the new work list
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(D)
    N, E = 300, 2000
    seg = np.sort(np.concatenate([np.full(E // 2, 7),
                                  rng.integers(150, N, E - E // 2)]))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=N))])
    msgs = rng.normal(size=(E, D)).astype(np.float32)
    want = np.asarray(jsk.sorted_segment_sum(
        jnp.asarray(msgs), jnp.asarray(seg.astype(np.int32)),
        jnp.asarray(indptr.astype(np.int32)), N, NB, ET, True))
    out = tsk.sorted_segment_sum(torch.as_tensor(msgs), torch.as_tensor(seg),
                                 indptr, N)
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)
    lay = tsk.build_spmm_layout(indptr, np.arange(E), N, kind="segment",
                                device="cpu")
    np.testing.assert_allclose(walk_items(msgs, lay), want, rtol=RTOL,
                               atol=ATOL)


# -- K1w ---------------------------------------------------------------------

def weighted_layout_of(deg, seed=1):
    """A layout of one kind of work list over a square table (sources in
    [0, R)) with its edges' original ids a random permutation."""
    deg = np.asarray(deg, dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    E, R = int(indptr[-1]), len(deg)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, R, E)
    return tsk.build_spmm_layout(indptr, src, R, device="cpu",
                                 edge_id=rng.permutation(E))


def walk_k1w(x, w, lay, wop, dwop=None, xrow=None, store=True):
    """K1w's walk of ``lay.items`` in float64, as the kernels take it: each
    item's edges in order, every message ``x[indices[e]]`` combined with its
    weight ``w[edge_id[e]]`` by ``wop`` ("mul", "add", or None for the
    unweighted dx beside ``dwop``) into its row or its partial slot (split
    rows then sum their partials in slot order); with ``dwop`` each edge's
    dw per head (``<g, xrow[row]>`` for "mul", the sum of g for "add") at
    its original id, checked to be written exactly once. ``store=False`` is
    dw alone. Returns (out or None, dw or None)."""
    x = np.asarray(x, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    H, D = w.shape[1], x.shape[1]
    dh = D // H
    indptr, idx = lay.indptr.numpy(), lay.indices.numpy()
    eid = lay.edge_id.numpy()
    out = np.full((lay.num_rows, D), np.nan) if store else None
    part = np.full((lay.item_partials, D), np.nan)
    dw = np.full((lay.num_edges, H), np.nan) if dwop else None
    written = np.zeros(lay.num_edges, dtype=np.int64)

    def msgs(b, e):
        m = x[idx[b:e]].reshape(-1, H, dh)
        we = w[eid[b:e]][:, :, None]
        if wop == "mul":
            m = m * we
        elif wop == "add":
            m = m + we
        return m.reshape(-1, D)

    for row, begin, end, k in lay.items.numpy():
        if k >= -1:
            spans = [(row, begin, end)]
        else:
            spans = [(r, indptr[r], indptr[r + 1])
                     for r in range(row, row - k)]
        for r, b, e in spans:
            if store:
                (part[k] if k >= 0 else out[r])[:] = msgs(b, e).sum(0)
            if dwop:
                ge = x[idx[b:e]].reshape(-1, H, dh)
                if dwop == "mul":
                    ge = ge * np.asarray(xrow, np.float64)[r].reshape(H, dh)
                dw[eid[b:e]] = ge.sum(-1)
                written[eid[b:e]] += 1
    if store:
        ptr = lay.item_split_ptr.numpy()
        for i, r in enumerate(lay.item_split_rows.numpy()):
            out[r] = part[ptr[i]:ptr[i + 1]].sum(0)
    if dwop:
        assert (written == 1).all()
    return out, dw


@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("H,D", [(1, 3), (2, 8)])
@pytest.mark.parametrize("kind", KINDS)
def test_k1w_item_walk_is_the_plain_function(kind, H, D, op):
    """Forward, dx with dw, and dw alone over every kind of item (packs,
    split rows, empty rows) against ``spmm_weighted_reference``,
    ``spmm_reference`` (add's dx) and ``weight_grad_reference``."""
    lay = weighted_layout_of(degrees(kind))
    rng = np.random.default_rng(H * 10 + D)
    N, E = lay.num_rows, lay.num_edges
    x, g = (rng.normal(size=(N, D)) for _ in range(2))
    w = rng.normal(size=(E, H))
    xt, gt, wt = (torch.as_tensor(a) for a in (x, g, w))
    tol = dict(rtol=1e-12, atol=1e-12)

    out, _ = walk_k1w(x, w, lay, op)
    np.testing.assert_allclose(
        out, tsk.spmm_weighted_reference(xt, wt, lay, op).numpy(), **tol)
    mul = op == "mul"
    dx, dw = walk_k1w(g, w, lay, op if mul else None, op, x)
    want_dx = (tsk.spmm_weighted_reference(gt, wt, lay, "mul") if mul
               else tsk.spmm_reference(gt, lay))
    want_dw = tsk.weight_grad_reference(gt, xt, lay, H, op).numpy()
    np.testing.assert_allclose(dx, want_dx.numpy(), **tol)
    np.testing.assert_allclose(dw, want_dw, **tol)
    none, dw_alone = walk_k1w(g, w, lay, None, op, x, store=False)
    assert none is None
    np.testing.assert_allclose(dw_alone, want_dw, **tol)


@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("H,D", [(1, 16), (4, 16), (3, 9)])
def test_k1w_on_the_item_list_matches_pallas(H, D, op):
    """``spmm_weighted`` (the plain version here) on a graph whose layouts
    hold every kind of item, against the Pallas ``spmm_weighted`` in
    interpret mode: forward, dx and dw in the original edge order."""
    import jax

    N, E = 400, 3000
    csc_i, csr_i, _, _ = graph(N, E, 1, seed=H + D)
    lays = [tsk.build_spmm_layout(i.indptr, i.sorted_v, N, kind=k,
                                  device="cpu", edge_id=i.sorted_eid)
            for k, i in (("csc", csc_i), ("csr", csr_i))]
    assert lays[0].item_partials > 0 and (lays[0].items[:, 3] < -1).any()
    jl = [jsk.build_blocked_layout(i.indptr, i.sorted_v, N, NB, ET)
          for i in (csc_i, csr_i)]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(E, H)).astype(np.float32)
    cot = rng.normal(size=(N, D)).astype(np.float32)

    def padded(jlay, idx):
        out = np.zeros((len(np.asarray(jlay.padded_v)), H), np.float32)
        out[:E] = w[idx.sorted_eid]
        return jnp.asarray(out)

    w_csc, w_csr = padded(jl[0], csc_i), padded(jl[1], csr_i)

    def loss(a, wc):
        return (jsk.spmm_weighted(a, wc, w_csr, jl[0], jl[1], NB, ET, True,
                                  op) * cot).sum()

    want = jsk.spmm_weighted(jnp.asarray(x), w_csc, w_csr, jl[0], jl[1], NB,
                             ET, True, op)
    gx, gw_csc = jax.grad(loss, (0, 1))(jnp.asarray(x), w_csc)
    gw = np.zeros((E, H), np.float32)
    gw[csc_i.sorted_eid] = np.asarray(gw_csc)[:E]
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tsk.spmm_weighted(xt, wt, *lays, op)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), gw, rtol=1e-4, atol=1e-4)


def items_config(D, vec4):
    """``items_config`` of ``csrc/segment_kernels.cu``: (L lanes a row, NV
    vectors a lane) at width D."""
    vecs = D // 4 if vec4 else D
    lanes = 1
    while lanes < vecs and lanes < 32:
        lanes <<= 1
    cap = 4 if vec4 else 16
    nv = 1
    while nv < cap and lanes * nv < vecs:
        nv <<= 1
    return lanes, nv


def head_tree_dw(vals, D, H, vec4):
    """The kernel's dw of one edge from per-column values ``vals`` [D]: for
    each column pass, lane l of the group holds slot s = k·L + l (vector k,
    columns c0 + s·VEC), each slot's partial the sum of its vector; the
    masks of ``Heads`` and the levels of ``head_tree`` (shuffle down within
    the vector, up from vector k + 1, or this lane's vector k + 2^j / L),
    then the stores of ``store_dw`` (a head's first slot writes, adding
    where the head began in an earlier pass)."""
    vec = 4 if vec4 else 1
    L, NV = items_config(D, vec4)
    dh = D // H
    dw = np.full(H, np.nan)
    for c0 in range(0, D, L * NV * vec):
        col = c0 + (np.arange(NV)[:, None] * L + np.arange(L)) * vec
        live = col < D
        p = np.array([[vals[c:c + vec].sum() if c < D else 0 for c in row]
                      for row in col], dtype=np.float64)
        head = np.where(live, col // max(dh, 1), H - 1)
        hend = np.minimum(D, head * dh + dh)
        s = np.arange(NV)[:, None] * L + np.arange(L)
        j = 0
        while (1 << j) < L * NV:
            o = 1 << j
            same = live & (s + o < L * NV) & (col + o * vec < hend)
            t = np.zeros_like(p)
            for k in range(NV):
                for l in range(L):
                    if o < L:
                        if l + o < L:
                            t[k, l] = p[k, l + o]
                        elif k + 1 < NV:
                            t[k, l] = p[k + 1, l + o - L]
                    elif k + o // L < NV:
                        t[k, l] = p[k + o // L, l]
            p = p + np.where(same, t, 0.0)
            j += 1
        first = live & ((s == 0) | (col == head * dh))
        cont = live & (s == 0) & (col != head * dh)
        for k, l in zip(*np.nonzero(first)):
            h = head[k, l]
            dw[h] = dw[h] + p[k, l] if cont[k, l] else p[k, l]
    return dw


@pytest.mark.parametrize("D,H", [(1, 1), (3, 1), (3, 3), (8, 2), (9, 3),
                                 (16, 1), (16, 4), (64, 1), (64, 8),
                                 (96, 48), (100, 4), (128, 2), (200, 2),
                                 (256, 1), (512, 8), (600, 1), (600, 3),
                                 (1024, 2)])
def test_head_tree_sums_each_head_once(D, H):
    """The model of K1w's per-head reduction gives each head's sum exactly
    (integer values), on 16-byte vectors where the kernel takes them (4 |
    D / H) and on the scalar path; past 512 columns a head crosses a column
    pass and is finished by the later one."""
    vals = np.random.default_rng(D * 7 + H).integers(-9, 10, D).astype(
        np.float64)
    want = vals.reshape(H, D // H).sum(-1)
    for vec4 in (False, True):
        if vec4 and (D // H) % 4:
            continue
        np.testing.assert_array_equal(head_tree_dw(vals, D, H, vec4), want)
