"""The additive K10's host side on the CPU: its work list
(``attention_kernels.k10_work_list``), its lane map (``k10_lanes``), and a
numpy walk of the list in the kernels' order (``csrc/attention_kernels.cu``
``gat_dq_groups``, ``gat_dkv_groups``: a lane group's edges in order, the
groups of a split piece summed by a fixed xor tree, split rows' partials
summed in slot order, empty rows zeroed) against the plain K10 in float64.
Imports no ``pgl_tpu``; the parity with it is
``tests/test_torch_attention_kernels.py``'s."""

import numpy as np
import pytest
import torch

from pgl_tpu_torch import Graph
from pgl_tpu_torch.ops.kernels import attention_kernels as ak
from pgl_tpu_torch.ops.kernels.segment_kernels import cut_rows

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

N = 300


def _hub_edges(seed=3, E=3000):
    """A hub destination (node 0, 700 edges: split over pieces of
    ``ak.ET``), a hub source (node 5, 600 out-edges), empty rows 1..149,
    in shuffled order."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(700, np.int64),
                          rng.integers(N // 2, N, E - 700)])
    src = rng.integers(0, N, E)
    src[rng.choice(E, 600, replace=False)] = 5
    return np.stack([src, dst], axis=1)[rng.permutation(E)]


def _sixteen_edges(seed=4):
    """Every source sends 16 edges (the bench GAT graph's CSR rows)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(N), 16)
    return np.stack([src, rng.integers(0, N, len(src))], axis=1)


GRAPHS = {"hub": _hub_edges, "sixteen": _sixteen_edges,
          "no_edges": lambda: np.zeros((0, 2), dtype=np.int64)}


def _layouts(name):
    return Graph(GRAPHS[name](), num_nodes=N).tensor("cpu")._attention_layouts()


def _indptr(lay):
    return np.concatenate([[0], np.cumsum(np.bincount(
        lay.seg_ids.numpy(), minlength=lay.num_rows))]).astype(np.int64)


@pytest.mark.parametrize("pack_row", [1, 4, 32, 256])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_work_list_takes_every_edge_once(name, pack_row, monkeypatch):
    """Every edge in exactly one item, in the side's order within its
    row; the pieces of the rows past PACK_ROW are K9's (so the split rows
    and slots too), the other nonempty rows whole, longest first; every
    empty row listed once."""
    monkeypatch.setattr(ak, "PACK_ROW", pack_row)
    for lay in _layouts(name):
        indptr = _indptr(lay)
        deg = np.diff(indptr)
        items = lay.k10_items.numpy().astype(np.int64)
        n_long = lay.k10_long
        pieces = lay.pieces.numpy()
        np.testing.assert_array_equal(
            items[:n_long], pieces[deg[pieces[:, 0]] > pack_row])
        assert (items[:n_long, 2] - items[:n_long, 1] <= ak.ET).all()
        short = items[n_long:]
        assert (short[:, 3] == -1).all()
        np.testing.assert_array_equal(short[:, 1], indptr[short[:, 0]])
        np.testing.assert_array_equal(short[:, 2], indptr[short[:, 0] + 1])
        n_edges = short[:, 2] - short[:, 1]
        assert ((n_edges >= 1) & (n_edges <= pack_row)).all()
        order = np.lexsort((short[:, 0], -n_edges))
        np.testing.assert_array_equal(order, np.arange(len(short)))
        # every edge once: the items' ranges tile [0, E)
        hits = np.zeros(lay.num_edges, dtype=np.int64)
        for _, b, e, _ in items:
            hits[b:e] += 1
        assert (hits == 1).all()
        assert (indptr[items[:, 0]] <= items[:, 1]).all()
        assert (items[:, 2] <= indptr[items[:, 0] + 1]).all()
        # every row once: its pieces, its whole row or the empty list
        empty = lay.empty_rows.numpy()
        np.testing.assert_array_equal(empty, np.flatnonzero(deg == 0))
        rows = np.concatenate([np.unique(items[:n_long, 0]), short[:, 0],
                               empty])
        np.testing.assert_array_equal(np.sort(rows), np.arange(N))
        # the split rows are K9's: the hub rows, cut at ET
        _, split_rows, _ = cut_rows(indptr, ak.ET)
        np.testing.assert_array_equal(lay.split_rows.numpy(), split_rows)
        assert set(items[items[:, 3] >= 0, 0]) == set(split_rows)
    if name == "hub":
        csc, csr = _layouts(name)
        assert csc.split_rows.tolist() == [0] and csr.split_rows.tolist() == [5]


SHAPES = [(8, 8), (1, 16), (4, 32), (3, 5), (2, 3), (1, 1), (16, 32),
          (1, 512), (42, 1), (512, 1), (2, 256), (7, 9), (64, 8)]


@pytest.mark.parametrize("H,dvh", SHAPES)
def test_lane_map_holds_every_column_once(H, dvh):
    """The vector slots of ``VecSlots`` (slot s = lane + 32 k of a group,
    head s // lh, columns from (s % lh) * vec) hold every column of every
    head once; each head has one first vector, and its slots are the
    aligned block the head sums' shuffles span (within a group where lh
    <= 32, else lh / 32 whole rows of k)."""
    vec, lh, group, nv = ak.k10_lanes(H, dvh)
    assert vec in (1, 4) and group <= 32 and group & (group - 1) == 0
    assert lh & (lh - 1) == 0 and lh * vec >= dvh
    assert H * lh <= group * nv and (nv == 1 or group == 32)
    if nv > 1:
        assert H * lh > 32 * (nv // 2)       # the fewest vectors a lane
    seen = np.zeros(H * dvh, dtype=np.int64)
    leads = np.zeros(H, dtype=np.int64)
    for lane in range(group):
        for k in range(nv):
            s = lane + 32 * k
            h, w = s // lh, (s % lh) * vec
            if h >= H or w >= dvh:
                continue
            assert h * lh <= s < (h + 1) * lh
            seen[h * dvh + w:h * dvh + min(w + vec, dvh)] += 1
            leads[h] += w == 0
    assert (seen == 1).all() and (leads == 1).all()
    assert group % lh == 0 if lh <= 32 else lh % 32 == 0


def test_lane_map_takes_several_edges_a_warp():
    """2 edges a warp at GAT's layer 0 (8, 8), 8 at its layer 1 (1, 16),
    with no idle lane at (1, 16)."""
    assert ak.k10_lanes(8, 8) == (4, 2, 16, 1)
    assert ak.k10_lanes(1, 16) == (4, 4, 4, 1)


def _tree(x):
    """The kernels' merge of a split piece's groups: level m adds group
    g ^ m (``__shfl_xor_sync`` at offset m * group), m = 1, 2, 4, ...;
    group 0's value."""
    x = np.array(x)
    idx = np.arange(len(x))
    m = 1
    while m < len(x):
        x = x + x[idx ^ m]
        m <<= 1
    return x[0]


@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 32])
def test_group_tree_is_pairwise(W):
    """The xor tree at group 0 is the pairwise sum ((g0 + g1) + (g2 + g3))
    ... bit for bit in float32, and exact on integers."""
    rng = np.random.default_rng(W)
    x = rng.normal(size=(W, 5)).astype(np.float32)

    def pairwise(v):
        return v[0] if len(v) == 1 else (pairwise(v[:len(v) // 2])
                                         + pairwise(v[len(v) // 2:]))

    assert np.array_equal(_tree(x), pairwise(list(x)))
    ints = rng.integers(-1000, 1000, size=(W, 5)).astype(np.float32)
    assert np.array_equal(_tree(ints), ints.sum(0))


def _edge_terms(lay, ins, slope, dvh, rate, seed):
    """Per edge of ``lay`` in its order (numpy, float64): the dq / d a_src
    term ds [E, H] and the dv term q * g[dst] [E, H * dvh]."""
    a_dst, a_src, v, g, lse, delta = (t.numpy() for t in ins)
    rows = lay.seg_ids.numpy()
    other = lay.indices.numpy()
    dst, src = (rows, other) if lay.kind == "csc" else (other, rows)
    E, H = len(dst), a_dst.shape[1]
    sr = a_dst[dst] + a_src[src]
    s = np.where(sr >= 0, sr, sr * slope) if slope else sr
    p = np.exp(s - lse[dst])
    q = p
    if rate:
        pos = lay.positions()
        keep = np.stack([ak.drop_keep(pos, seed, h, rate).numpy()
                         for h in range(H)], axis=1)
        q = np.where(keep, p, 0.0) / (1.0 - rate)
    ge = g[dst].reshape(E, H, dvh)
    gv = (ge * v[src].reshape(E, H, dvh)).sum(-1)
    ds = q * gv - p * delta[dst]
    if slope:
        ds = np.where(sr >= 0, ds, ds * slope)
    return ds, (q[..., None] * ge).reshape(E, H * dvh)


def _walk(lay, terms, W):
    """The kernels' walk of ``lay``'s K10 list at W lane groups a warp:
    each item's groups sum their edges' terms in order, a split piece's
    groups by ``_tree``, split rows' partials in slot order, empty rows
    zero. Returns the rows and how many times each was written."""
    items = lay.k10_items.numpy().astype(np.int64)
    out = np.full((lay.num_rows, terms.shape[1]), np.nan)
    written = np.zeros(lay.num_rows, dtype=np.int64)
    parts = {}
    for i, (r, b, e, slot) in enumerate(items):
        if i < lay.k10_long:
            n = e - b
            groups = [terms[b + g * n // W:b + (g + 1) * n // W].sum(0)
                      for g in range(W)]
            total = _tree(groups)
        else:
            total = terms[b:e].sum(0)
        if slot < 0:
            out[r] = total
            written[r] += 1
        else:
            parts[slot] = total
    split_rows = lay.split_rows.numpy()
    ptr = lay.split_ptr.numpy()
    for j, r in enumerate(split_rows):
        out[r] = sum(parts[p] for p in range(ptr[j], ptr[j + 1]))
        written[r] += 1
    out[lay.empty_rows.numpy()] = 0.0
    written[lay.empty_rows.numpy()] += 1
    return out, written


@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_of_the_list_is_the_plain_k10(name, rate):
    """d a_dst over CSC, d a_src and dv over CSR, walked as the kernels
    walk the list at every lane-group count, equal the plain K10 in
    float64 (1e-12), every row written once."""
    H, dvh, slope, seed = 3, 5, 0.2, -77
    csc, csr = _layouts(name)
    rng = np.random.default_rng(8)
    ins = tuple(torch.as_tensor(rng.normal(size=(N, w)))
                for w in (H, H, H * dvh, H * dvh, H, H))
    want_dq = ak.gat_dq_reference(*ins, csc, slope, dvh, rate, seed).numpy()
    want_ds, want_dv = (t.numpy() for t in ak.gat_dkv_reference(
        *ins, csr, slope, dvh, rate, seed))
    dq_terms, _ = _edge_terms(csc, ins, slope, dvh, rate, seed)
    ds_terms, dv_terms = _edge_terms(csr, ins, slope, dvh, rate, seed)
    for W in (1, 2, 4, 8, 16, 32):
        dq, n1 = _walk(csc, dq_terms, W)
        dkv, n2 = _walk(csr, np.concatenate([ds_terms, dv_terms], 1), W)
        assert (n1 == 1).all() and (n2 == 1).all()
        np.testing.assert_allclose(dq, want_dq, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(dkv[:, :H], want_ds, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(dkv[:, H:], want_dv, rtol=1e-12,
                                   atol=1e-12)
