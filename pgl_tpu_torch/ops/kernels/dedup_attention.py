"""Count-matrix ("dedup") graph attention: the kernels behind ``GATConv``
and ``TransformerConv`` on a graph that carries dedup layouts.

Port of ``pgl_tpu/ops/pallas/dedup_attention.py`` in both of its score
modes (``_attn_fwd_kernel`` forward, K7; ``_attn_bwd_kernel`` backward, K8;
``build_uniq_reduce``; ``_cell_idx``) onto hand-written CUDA kernels for
Hopper, ``csrc/dedup_attention.cu``, whose note gives the design: additive
(``dedup_gat_attention``, GAT's ``a_dst + a_src``) and dot
(``dedup_dot_attention``, per-head ``q·k``, UniMP's TransformerConv).

Both scores depend only on the two ends of an edge, so the softmax over a
row's edges is a softmax over its count-matrix cells: the cell (r, u) of
the CSC dedup layout (``dedup_kernels.py``) stands for the ``C[r, u]``
edges into row r from unique row u (node ``uv[u]``), which share one score.

* :func:`build_dedup_attention` builds, once on the host (numpy), what the
  kernels walk: the nonzero cells with their multiplicities and dropout
  keys, in row order (cut into pieces of at most ``ET`` cells by
  ``segment_kernels.cut_rows``; the additive K7 walks them by
  ``attention_kernels.k10_work_list``, as the per-edge K9 walks its edges)
  and in node order (by the node of the cell's unique row, then slot, then
  row; K8's node walk, cut into pieces the same way). :func:`build_uniq_reduce` is the reference's K1 layout
  that folds pair-slot rows onto nodes; the node walk writes node rows, so
  the port's kernels need no fold.
* :func:`dedup_gat_attention` and :func:`dedup_dot_attention` are autograd
  ``Function``s with the reference's contracts (``:727-768`` and
  ``:771-805``): the forward (K7) saves ``lse``; the backward computes
  ``delta = Σ g·out`` in torch and runs K8: ``d a_dst`` (dot: ``dq``) per
  row from the row pass, ``d a_src`` and ``dv`` (dot: ``dk`` and ``dv``)
  per node from the node walk, with no slot rows and no fold. The dropout
  seed is saved, so every pass draws the same mask.
* :func:`dedup_attention_reference` and :func:`dedup_bwd_reference`
  (additive), :func:`dedup_dot_reference` and :func:`dedup_dot_bwd_reference`
  (dot) are the plain PyTorch versions, in edge space over the dedup order
  (``index_add_``, ``segment_softmax``). CPU tensors run them; CUDA tensors
  launch the kernels or raise.
* :func:`cell_idx` is ``_cell_idx`` per edge: the dropout key of a cell,
  shared by its duplicate edges.
* A forward that ``torch.export`` or ``torch.compile`` traces
  (``dispatch.traced``) is a custom op, ``torch.ops.pgl_tpu_torch.
  dedup_gat_attention`` or ``::dedup_dot_attention`` (the row-ordered
  cells and the dedup layout's tensors as its arguments; its CUDA
  implementation the launch of K7 and its merge, its CPU one the plain
  version, its fake one the shapes of ``(out, lse)``), so an exported
  program calls K7; an eager call launches directly.

* The kernels take float32 or bf16 tables (``pgl_dedup_*_f32`` in the
  library ``dedup_attention``, ``pgl_dedup_*_bf16`` in
  ``dedup_attention_bf16``, the same source built apart): bf16 loaded and
  widened to float32, every score, exp and sum float32, ``lse`` and
  ``delta`` (formed in float32 from the widened ``g`` and ``out``) float32,
  and ``out``, ``d a_dst`` / ``dq``, ``d a_src`` / ``dk`` and ``dv`` each
  rounded once to bf16. The plain versions compute bf16 (or fp16) tables
  the same way: the kernels' contract. The dropout masks are keyed by the
  cell either way, so bf16 drops what float32 drops.

``LAUNCHES_BY_SHAPE`` counts float32 launches by ``(kernel, H, dvh)`` in
additive mode, kernel one of ``dedup_fwd`` (K7) and ``dedup_bwd`` (K8: its
row pass and node walk), and by ``(kernel, H, dsh, dvh)`` in dot mode,
kernel one of ``dedup_dot_fwd`` and ``dedup_dot_bwd``; where a row has
several pieces, each kernel's second launch counts under its name with
``_combine``, and where a node's cells have several, K8's under
``dedup_bwd_node_combine`` (dot: ``dedup_dot_bwd_node_combine``).
``LAUNCHES_BF16`` counts the bf16 launches apart, by the same keys.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..dispatch import traced, use_dedup_attention_kernel
from . import _build
from . import segment_kernels as sk
from .attention_kernels import (_SUFFIX, _check, _delta, _drop_args, _f32,
                                _f32_empty, _k10_args, _lse_like,
                                _seed_tensor, _stream, edge_grads,
                                head_scatter, k10_work_list,
                                plain_attention)
from .dedup_kernels import W, DedupLayout

__all__ = ["DedupAttention", "build_dedup_attention", "build_uniq_reduce",
           "cell_idx", "dedup_attention_reference", "dedup_bwd_reference",
           "dedup_gat_attention", "dedup_dot_reference",
           "dedup_dot_bwd_reference", "dedup_dot_attention", "ET",
           "LAUNCHES_BY_SHAPE", "LAUNCHES_BF16", "reset_launches"]

# most cells in one piece (one warp's work); read when a work list is built
ET = 256

LAUNCHES_BY_SHAPE: Counter = Counter()
LAUNCHES_BF16: Counter = Counter()

_MASK32 = 0xFFFFFFFF


def reset_launches():
    """Set the launch counts to 0."""
    LAUNCHES_BY_SHAPE.clear()
    LAUNCHES_BF16.clear()


def build_uniq_reduce(layout: DedupLayout, num_nodes: int) -> sk.SpmmLayout:
    """K1 layout from the pair-slot rows ``[P·W, ·]`` back to nodes
    (``:62-79``): slot row ``p·W + k`` belongs to node ``uv[wb_p + k]``, and
    a stable argsort of those nodes makes the fold a sorted segment sum.
    Slot rows whose unique row has no edge in the pair carry zeros."""
    uv = layout.uv.cpu().numpy().astype(np.int64)
    wb = layout.pairs[:, 1].cpu().numpy().astype(np.int64)
    slot_uv = uv[(wb[:, None] + np.arange(W, dtype=np.int64)).ravel()]
    order = np.argsort(slot_uv, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        slot_uv, minlength=num_nodes))])
    return sk.build_spmm_layout(indptr, order, num_nodes, kind="uniq_reduce",
                                device=layout.device)


@dataclass(frozen=True)
class DedupAttention:
    """What K7 and K8 read of a CSC dedup layout (int32 tensors on one
    device), with the layout itself (the plain versions' edge space).

    Row order (K7, K8's row pass): the nonzero cells sorted by (dst, unique
    row); ``cell_src`` [n] the cell's node ``uv[u]``, ``cell_urow`` [n] its
    unique row u, ``cell_cnt`` [n] its multiplicity, ``cell_key`` [n] its
    dropout key (:func:`cell_idx`); ``pieces``, ``split_rows``,
    ``split_ptr``: the work list of ``cut_rows`` (K8's row pass and the
    dot mode); ``k10_items`` [P, 4], ``k10_long`` and ``empty_rows`` [Z]:
    the additive K7's (``attention_kernels.k10_work_list`` over the rows'
    cells: ``k10_long`` pieces of the rows past ``PACK_ROW`` cells, then
    the other rows with cells whole, and the rows without cells, which K7
    zeroes).
    Node order (K8's node walk, both modes): the cells sorted by (node
    ``uv[u]``, slot ``p·W + c``, dst), so a node's terms come in the order
    the reference's slot rows and their fold sum them; ``node_dst`` [n],
    ``node_cnt`` [n] and ``node_key`` [n] the cells' rows, multiplicities
    and keys; ``node_pieces``, ``node_split_rows``, ``node_split_ptr``:
    ``cut_rows`` over the nodes' cell counts.
    """
    layout: DedupLayout
    num_cells: int
    num_partials: int
    num_node_partials: int
    k10_long: int
    cell_src: torch.Tensor
    cell_urow: torch.Tensor
    cell_cnt: torch.Tensor
    cell_key: torch.Tensor
    pieces: torch.Tensor
    split_rows: torch.Tensor
    split_ptr: torch.Tensor
    k10_items: torch.Tensor
    empty_rows: torch.Tensor
    node_dst: torch.Tensor
    node_cnt: torch.Tensor
    node_key: torch.Tensor
    node_pieces: torch.Tensor
    node_split_rows: torch.Tensor
    node_split_ptr: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.layout.device

    @property
    def num_rows(self) -> int:
        return self.layout.num_segments

    @property
    def max_index(self) -> int:
        return self.layout.max_index


def _edge_slots(layout: DedupLayout):
    """``(dst, urow, slot)`` of every edge in dedup order, int64 on the
    layout's device: its row, its unique row and its pair slot
    ``p·W + urow - wb_p``."""
    pairs = layout.pairs.long()
    pair = torch.repeat_interleave(
        torch.arange(layout.num_pairs, device=layout.device),
        pairs[:, 3] - pairs[:, 2])
    urow = layout.urow.long()
    return layout.dst.long(), urow, pair * W + urow - pairs[pair, 1]


def build_dedup_attention(layout: DedupLayout,
                          num_nodes: int) -> DedupAttention:
    """Host-side (numpy) build from a CSC dedup layout, O(E log E); call
    once per graph (``Graph._dedup_attn_aux``)."""
    dst, urow, slot = (t.cpu().numpy() for t in _edge_slots(layout))
    E, N = len(dst), int(num_nodes)
    # the dedup order sorts a block's edges by unique row and keeps the CSC
    # order (by dst) among equals: slots ascend, and a cell's duplicate
    # edges are neighbours
    first = np.ones(E, dtype=bool)
    first[1:] = (slot[1:] != slot[:-1]) | (dst[1:] != dst[:-1])
    starts = np.flatnonzero(first)
    cnt = np.diff(np.append(starts, E))
    c_dst, c_urow = dst[starts], urow[starts]
    uv = layout.uv.cpu().numpy().astype(np.int64)
    c_node = uv[c_urow]
    c_key = cell_idx(*map(torch.from_numpy, (c_dst, c_urow))).numpy()
    by_row = np.lexsort((c_urow, c_dst))
    row_ptr = _row_ptr(c_dst, N)
    pieces, split_rows, split_ptr = sk.cut_rows(row_ptr, ET)
    items, n_long, empty = k10_work_list(row_ptr, pieces)
    # the cells are in (slot, dst) order, so a stable sort by node gives
    # (node, slot, dst)
    by_node = np.argsort(c_node, kind="stable")
    node_pieces, node_split_rows, node_split_ptr = sk.cut_rows(
        _row_ptr(c_node, N), ET)
    device = layout.device

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return DedupAttention(
        layout=layout, num_cells=len(starts),
        num_partials=int(split_ptr[-1]),
        num_node_partials=int(node_split_ptr[-1]), k10_long=n_long,
        cell_src=put(c_node[by_row]), cell_urow=put(c_urow[by_row]),
        cell_cnt=put(cnt[by_row]), cell_key=put(c_key[by_row]),
        pieces=put(pieces), split_rows=put(split_rows),
        split_ptr=put(split_ptr), k10_items=put(items),
        empty_rows=put(empty), node_dst=put(c_dst[by_node]),
        node_cnt=put(cnt[by_node]), node_key=put(c_key[by_node]),
        node_pieces=put(node_pieces),
        node_split_rows=put(node_split_rows),
        node_split_ptr=put(node_split_ptr))


def _row_ptr(rows, num_rows):
    """CSR pointer [num_rows + 1] of items sorted by ``rows``."""
    return np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=num_rows))]).astype(np.int64)


def cell_idx(dst: torch.Tensor, urow: torch.Tensor) -> torch.Tensor:
    """The reference's ``_cell_idx`` (``:93-99``) per edge: ``dst ·
    0x9E3779B1 + urow`` with int32 wrap-around, as int32 (taken in int64
    masked to 32 bits; the product stays below 2**63)."""
    x = (dst.long() * 0x9E3779B1 + urow.long()) & _MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# -- plain versions ---------------------------------------------------------

def dedup_attention_reference(a_dst, a_src, v, layout: DedupLayout,
                              leaky_slope: float = 0.2, dvh=None,
                              attn_drop: float = 0.0, seed=None):
    """The plain K7: ``(out [N, H·dvh], lse [N, H])`` over the edges of the
    CSC dedup ``layout``, duplicates one by one (their scores are equal, so
    this is the softmax over cells weighted by their counts), with the cell
    dropout; an empty row gives zeros in both. bf16 tables: computed in
    float32, ``out`` rounded once, ``lse`` float32."""
    dtype = v.dtype
    a_dst, a_src, v = _f32(a_dst, a_src, v)
    dst, urow, _ = _edge_slots(layout)
    out, lse = plain_attention(a_dst, a_src, v, dst, layout.uv.long()[urow],
                               cell_idx(dst, urow), leaky_slope,
                               dvh or v.shape[1] // a_dst.shape[1], attn_drop,
                               seed)
    return out.to(dtype), lse


def dedup_bwd_reference(a_dst, a_src, v, g, lse, delta, layout: DedupLayout,
                        leaky_slope: float = 0.2, dvh=None,
                        attn_drop: float = 0.0, seed=None):
    """The plain K8: ``(d a_dst [N, H], d a_src [N, H], dv [N, H·dvh])``,
    ``Σ ds`` into destination rows and ``Σ ds``, ``Σ keep·p·g[dst]`` into
    source nodes, as the kernels' node walk writes them (no slot rows, no
    fold). bf16 tables: computed in float32, each output rounded once."""
    N, H = a_dst.shape
    dvh = dvh or v.shape[1] // H
    dtype = v.dtype
    a_dst, a_src, v, g = _f32(a_dst, a_src, v, g)
    dst, urow, _ = _edge_slots(layout)
    src = layout.uv.long()[urow]
    q, ds, g_e = edge_grads(a_dst, a_src, v, g, lse, delta, dst, src,
                            cell_idx(dst, urow), leaky_slope, dvh, attn_drop,
                            seed)
    dv = (q[..., None] * g_e).reshape(-1, H * dvh)
    return (ds.new_zeros(N, H).index_add_(0, dst, ds).to(dtype),
            ds.new_zeros(N, H).index_add_(0, src, ds).to(dtype),
            dv.new_zeros(N, H * dvh).index_add_(0, src, dv).to(dtype))


def dedup_dot_reference(q, k, v, layout: DedupLayout, dsh: int, dvh: int,
                        leaky_slope: float = 0.0, attn_drop: float = 0.0,
                        seed=None):
    """The plain dot-mode K7: ``(out [N, H·dvh], lse [N, H])`` from q, k
    [N, H·dsh] over the edges of the CSC dedup ``layout``, as
    :func:`dedup_attention_reference` (cell dropout; an empty row gives
    zeros in both; bf16 tables computed in float32, ``out`` rounded once,
    ``lse`` float32)."""
    dtype = v.dtype
    q, k, v = _f32(q, k, v)
    dst, urow, _ = _edge_slots(layout)
    out, lse = plain_attention(q, k, v, dst, layout.uv.long()[urow],
                               cell_idx(dst, urow), leaky_slope, dvh,
                               attn_drop, seed, dsh)
    return out.to(dtype), lse


def dedup_dot_bwd_reference(q, k, v, g, lse, delta, layout: DedupLayout,
                            dsh: int, dvh: int, leaky_slope: float = 0.0,
                            attn_drop: float = 0.0, seed=None):
    """The plain dot-mode K8: ``(dq [N, H·dsh], dk [N, H·dsh], dv [N,
    H·dvh])``, per head ``Σ ds·k[src]`` into destination rows and ``Σ
    ds·q[dst]``, ``Σ keep·p·g[dst]`` into source nodes, as the kernels'
    node walk writes them (no slot rows, no fold; bf16 tables computed in
    float32, each output rounded once)."""
    dtype = v.dtype
    q, k, v, g = _f32(q, k, v, g)
    dst, urow, _ = _edge_slots(layout)
    src = layout.uv.long()[urow]
    qe, ds, g_e = edge_grads(q, k, v, g, lse, delta, dst, src,
                             cell_idx(dst, urow), leaky_slope, dvh, attn_drop,
                             seed, dsh)
    N = q.shape[0]
    return (head_scatter(ds, k[src], dst, N).to(dtype),
            head_scatter(ds, q[dst], src, N).to(dtype),
            head_scatter(qe, g_e.flatten(1), src, N).to(dtype))


# -- CUDA --------------------------------------------------------------------

def _lib(dtype=torch.float32):
    """The library of the entry points on ``dtype``: ``dedup_attention``
    (``pgl_dedup_*_f32``) or, for bf16, ``dedup_attention_bf16``
    (``pgl_dedup_*_bf16``: the same source built apart, so the two build
    in parallel)."""
    suffix = _SUFFIX[dtype]
    lib = _build.load("dedup_attention" if suffix == "f32"
                      else "dedup_attention_bf16")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (..., pieces, n_pieces, split_rows, split_ptr, n_split, ...)
    rows = [p, i, p, p, i]
    tail = [i, i, f, p, i, f]     # H, dvh, slope, seed, thresh, inv_keep
    dot = [i] + tail              # H, dsh, dvh, ...
    cells = [p] * 3 + rows        # (node or dst, count, key), the work list
    # K7: (items, n_long, n_short, empty_rows, n_empty, split_rows,
    # split_ptr, n_split, H, dvh, vec, lh, group, nv, slope, seed, thresh,
    # inv_keep)
    k7 = [p, i, i, p, i, p, p, i] + [i] * 6 + [f, p, i, f]
    sigs = {"pgl_dedup_attn_fwd": [i] + [p] * 6 + k7 + [p] * 4,
            "pgl_dedup_attn_bwd": [i] + [p] * 6 + cells + cells + tail
            + [p] * 6,
            "pgl_dedup_dot_fwd": [i] + [p] * 3 + cells + dot + [p] * 4,
            "pgl_dedup_dot_bwd": [i] + [p] * 6 + cells + cells + dot
            + [p] * 6}
    for name, argtypes in sigs.items():
        fn = getattr(lib, f"{name}_{suffix}")
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _entry(name, t):
    """The entry point ``name`` for the tables' dtype of ``t``."""
    return getattr(_lib(t.dtype), f"{name}_{_SUFFIX[t.dtype]}")


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"dedup_attention {name} launch failed: CUDA "
                           f"error {rc}")


def _count(name, att, t, *shape, nodes=False):
    """One launch of ``name`` on the tables' dtype of ``t``, its merge where
    rows split, and (``nodes``: K8) the node walk's where nodes split."""
    counts = LAUNCHES_BF16 if t.dtype == torch.bfloat16 else LAUNCHES_BY_SHAPE
    counts[(name, *shape)] += 1
    if att.num_partials:
        counts[(f"{name}_combine", *shape)] += 1
    if nodes and att.num_node_partials:
        counts[(f"{name}_node_combine", *shape)] += 1


def _rows(att):
    return (att.cell_src.data_ptr(), att.cell_urow.data_ptr(),
            att.cell_cnt.data_ptr(), att.pieces.data_ptr(),
            att.pieces.shape[0], att.split_rows.data_ptr(),
            att.split_ptr.data_ptr(), att.split_rows.shape[0])


def _cells(att):
    """The row-ordered cells as the dot-mode entry points take them: nodes,
    counts, keys, then the work list."""
    return (att.cell_src.data_ptr(), att.cell_cnt.data_ptr(),
            att.cell_key.data_ptr(), att.pieces.data_ptr(),
            att.pieces.shape[0], att.split_rows.data_ptr(),
            att.split_ptr.data_ptr(), att.split_rows.shape[0])


def _node_cells(att):
    """The node-ordered cells (K8's node walk): rows, counts, keys, then
    the work list."""
    return (att.node_dst.data_ptr(), att.node_cnt.data_ptr(),
            att.node_key.data_ptr(), att.node_pieces.data_ptr(),
            att.node_pieces.shape[0], att.node_split_rows.data_ptr(),
            att.node_split_ptr.data_ptr(), att.node_split_rows.shape[0])


def _fwd_cuda(a_dst, a_src, v, att, slope, dvh, rate, seed):
    """K7 (and its merge of split rows): ``(out, lse)``."""
    N, H = a_dst.shape
    _check(att, H, dvh, a_dst, a_src, v)
    out = torch.empty(N, H * dvh, dtype=v.dtype, device=v.device)
    lse = _f32_empty(N, H, like=v)
    part = _f32_empty(att.num_partials, H * dvh + 2 * H, like=v)
    _raise_on(_entry("pgl_dedup_attn_fwd", v)(
        v.device.index, a_dst.data_ptr(), a_src.data_ptr(), v.data_ptr(),
        att.cell_src.data_ptr(), att.cell_cnt.data_ptr(),
        att.cell_key.data_ptr(),
        *_k10_args(att, H, dvh, slope, rate, seed, v.dtype),
        out.data_ptr(), lse.data_ptr(), part.data_ptr(), _stream(v)),
        "forward")
    _count("dedup_fwd", att, v, H, dvh)
    return out, lse


def _bwd_cuda(a_dst, a_src, v, g, lse, delta, att, slope, dvh, rate, seed):
    """K8 (row pass, node walk, the sums of split rows and split nodes):
    ``(d a_dst, d a_src, dv)``, all on node rows; the row pass's partials
    are ``H`` wide, the node walk's ``H + H·dvh`` (float32)."""
    N, H = a_dst.shape
    _check(att, H, dvh, a_dst, a_src, v, g, lse, delta)
    da, dsrc = (torch.empty(N, H, dtype=v.dtype, device=v.device)
                for _ in range(2))
    dv = torch.empty(N, H * dvh, dtype=v.dtype, device=v.device)
    part = _f32_empty(att.num_partials, H, like=v)
    node_part = _f32_empty(att.num_node_partials, H * (1 + dvh), like=v)
    thresh, inv_keep = _drop_args(rate)
    _raise_on(_entry("pgl_dedup_attn_bwd", v)(
        v.device.index, a_dst.data_ptr(), a_src.data_ptr(), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), *_rows(att),
        *_node_cells(att), H, dvh, slope, seed.data_ptr(), thresh, inv_keep,
        da.data_ptr(), dsrc.data_ptr(), dv.data_ptr(), part.data_ptr(),
        node_part.data_ptr(), _stream(v)), "backward")
    _count("dedup_bwd", att, v, H, dvh, nodes=True)
    return da, dsrc, dv


# -- K7's forward as custom ops ---------------------------------------------

# the ops' arguments: what the forward reads of the row-ordered cells and of
# the dedup layout (its plain version walks the layout's edges), and their
# integers (the layout's rows, edges and largest source, the cells, the
# split rows' partials, the work list's long pieces)
_OP_CELLS = ("cell_src", "cell_cnt", "cell_key", "pieces", "split_rows",
             "split_ptr", "k10_items", "empty_rows")
_OP_LAYOUT = ("uv", "pairs", "dst", "urow")


def _op_args(att: DedupAttention):
    lay = att.layout
    return ([getattr(att, n) for n in _OP_CELLS]
            + [getattr(lay, n) for n in _OP_LAYOUT],
            [lay.num_segments, lay.num_edges, lay.max_index, att.num_cells,
             att.num_partials, att.k10_long])


def _op_att(tensors, ints) -> DedupAttention:
    """The forward's view of the cells and the layout, rebuilt from the
    op's arguments (the node-ordered cells, which only K8 reads, absent)."""
    cells = dict(zip(_OP_CELLS, tensors))
    N, E, max_index, num_cells, num_partials, k10_long = ints
    layout = DedupLayout(
        kind="csc", num_segments=N, num_edges=E, max_index=max_index,
        simple=False, max_count=0, num_partials=0, eid=None, groups=None,
        split_blocks=None, split_ptr=None,
        **dict(zip(_OP_LAYOUT, tensors[len(_OP_CELLS):])))
    return DedupAttention(
        layout=layout, num_cells=num_cells, num_partials=num_partials,
        num_node_partials=0, k10_long=k10_long, cell_urow=None,
        node_dst=None, node_cnt=None, node_key=None, node_pieces=None,
        node_split_rows=None, node_split_ptr=None, **cells)


@torch.library.custom_op("pgl_tpu_torch::dedup_gat_attention",
                         mutates_args=(), device_types="cpu")
def _gat_op(a_dst: torch.Tensor, a_src: torch.Tensor, v: torch.Tensor,
            tensors: List[torch.Tensor], ints: List[int], leaky_slope: float,
            dvh: int, rate: float,
            seed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The additive K7 as an operator: the plain version on the CPU."""
    return dedup_attention_reference(a_dst, a_src, v,
                                     _op_att(tensors, ints).layout,
                                     leaky_slope, dvh, rate, seed)


@_gat_op.register_kernel("cuda")
def _gat_op_cuda(a_dst, a_src, v, tensors, ints, leaky_slope, dvh, rate,
                 seed):
    use_dedup_attention_kernel(v)
    return _fwd_cuda(a_dst, a_src, v, _op_att(tensors, ints), leaky_slope,
                     dvh, rate, seed)


@_gat_op.register_fake
def _gat_op_fake(a_dst, a_src, v, tensors, ints, leaky_slope, dvh, rate,
                 seed):
    N, H = a_dst.shape
    return v.new_empty(N, H * dvh), _lse_like(v, N, H)


@torch.library.custom_op("pgl_tpu_torch::dedup_dot_attention",
                         mutates_args=(), device_types="cpu")
def _dot_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            tensors: List[torch.Tensor], ints: List[int], leaky_slope: float,
            dsh: int, dvh: int, rate: float,
            seed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dot-mode K7 as an operator: the plain version on the CPU."""
    return dedup_dot_reference(q, k, v, _op_att(tensors, ints).layout, dsh,
                               dvh, leaky_slope, rate, seed)


@_dot_op.register_kernel("cuda")
def _dot_op_cuda(q, k, v, tensors, ints, leaky_slope, dsh, dvh, rate, seed):
    use_dedup_attention_kernel(v)
    return _dot_fwd_cuda(q, k, v, _op_att(tensors, ints), leaky_slope, dsh,
                         dvh, rate, seed)


@_dot_op.register_fake
def _dot_op_fake(q, k, v, tensors, ints, leaky_slope, dsh, dvh, rate, seed):
    N, H = q.shape[0], q.shape[1] // dsh
    return v.new_empty(N, H * dvh), _lse_like(v, N, H)


class _DedupGatAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a_dst, a_src, v, att, leaky_slope, dvh, rate, seed):
        args = (leaky_slope, dvh, rate, seed)
        if traced(v):
            use_dedup_attention_kernel(v)   # raises on what K7 does not take
            out, lse = _gat_op(a_dst, a_src, v, *_op_args(att),
                               float(leaky_slope), dvh, rate, seed)
        elif use_dedup_attention_kernel(v):
            out, lse = _fwd_cuda(a_dst, a_src, v, att, *args)
        else:
            out, lse = dedup_attention_reference(a_dst, a_src, v, att.layout,
                                                 *args)
        ctx.save_for_backward(a_dst, a_src, v, out, lse, seed)
        ctx.meta = (att, leaky_slope, dvh, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        a_dst, a_src, v, out, lse, seed = ctx.saved_tensors
        att, slope, dvh, rate = ctx.meta
        H = a_dst.shape[1]
        g = g.contiguous()
        ins = (a_dst, a_src, v, g, lse, _delta(g, out, H, dvh))
        if use_dedup_attention_kernel(v):
            da_dst, dsrc, dv = _bwd_cuda(*ins, att, slope, dvh, rate, seed)
        else:
            da_dst, dsrc, dv = dedup_bwd_reference(*ins, att.layout, slope,
                                                   dvh, rate, seed)
        return da_dst, dsrc, dv, None, None, None, None, None


def dedup_gat_attention(a_dst, a_src, v, att: DedupAttention,
                        leaky_slope: float = 0.2, dvh=None,
                        attn_drop: float = 0.0, drop_seed=None):
    """GAT additive attention over the count matrix: ``out[r] = Σ_{e:
    dst=r} softmax_r(leaky(a_dst[r] + a_src[src_e])) · v[src_e]`` per head,
    the same function as :func:`attention_kernels.fused_gat_attention`,
    with the dropout keyed by cell (``cell_idx``, the int32 ``drop_seed``
    and the head): a cell's duplicate edges drop together, and on a simple
    graph that is edge dropout. The softmax denominator stays undropped.

    Args:
      a_dst, a_src: [N, H] attention coefficients of destination and source.
      v: [N, H·dvh] values (no lane padding, unlike the reference's).
      att: the graph's :func:`build_dedup_attention` (``Graph.
        _dedup_attn_aux()``), which carries the CSC dedup layout and the
        cell lists.
      dvh: per-head value width (default ``v.shape[1] // H``).
    Returns [N, H·dvh]; rows with no incoming edge are 0.
    """
    N, H = a_dst.shape
    dvh = dvh or v.shape[1] // H
    if a_src.shape != (N, H) or v.shape != (N, H * dvh):
        raise ValueError(f"a_dst {tuple(a_dst.shape)}, a_src "
                         f"{tuple(a_src.shape)} and v {tuple(v.shape)} are "
                         f"not [N, H], [N, H] and [N, H * {dvh}]")
    seed = _seed_tensor(drop_seed, v.device)
    return _DedupGatAttention.apply(a_dst.contiguous(), a_src.contiguous(),
                                    v.contiguous(), att, leaky_slope, dvh,
                                    float(attn_drop), seed)


# -- dot mode ----------------------------------------------------------------

def _dot_fwd_cuda(q, k, v, att, slope, dsh, dvh, rate, seed):
    """Dot-mode K7 (and its merge of split rows): ``(out, lse)``."""
    N, H = q.shape[0], q.shape[1] // dsh
    _check(att, H, dvh, q, k, v, dsh=dsh)
    out = torch.empty(N, H * dvh, dtype=v.dtype, device=v.device)
    lse = _f32_empty(N, H, like=v)
    part = _f32_empty(att.num_partials, H * dvh + 2 * H, like=v)
    thresh, inv_keep = _drop_args(rate)
    _raise_on(_entry("pgl_dedup_dot_fwd", v)(
        v.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *_cells(att), H, dsh, dvh, slope, seed.data_ptr(), thresh, inv_keep,
        out.data_ptr(), lse.data_ptr(), part.data_ptr(), _stream(v)),
        "dot forward")
    _count("dedup_dot_fwd", att, v, H, dsh, dvh)
    return out, lse


def _dot_bwd_cuda(q, k, v, g, lse, delta, att, slope, dsh, dvh, rate, seed):
    """Dot-mode K8 (row pass, node walk, the sums of split rows and split
    nodes): ``(dq, dk, dv)``, all on node rows; the row pass's partials
    are ``H·dsh`` wide, the node walk's ``H·(dsh + dvh)`` (float32)."""
    N, H = q.shape[0], q.shape[1] // dsh
    _check(att, H, dvh, q, k, v, g, lse, delta, dsh=dsh)
    dq, dk = (torch.empty(N, H * dsh, dtype=v.dtype, device=v.device)
              for _ in range(2))
    dv = torch.empty(N, H * dvh, dtype=v.dtype, device=v.device)
    part = _f32_empty(att.num_partials, H * dsh, like=v)
    node_part = _f32_empty(att.num_node_partials, H * (dsh + dvh), like=v)
    thresh, inv_keep = _drop_args(rate)
    _raise_on(_entry("pgl_dedup_dot_bwd", v)(
        v.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), *_cells(att),
        *_node_cells(att), H, dsh, dvh, slope, seed.data_ptr(), thresh,
        inv_keep, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        part.data_ptr(), node_part.data_ptr(), _stream(v)), "dot backward")
    _count("dedup_dot_bwd", att, v, H, dsh, dvh, nodes=True)
    return dq, dk, dv


class _DedupDotAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, att, leaky_slope, dsh, dvh, rate, seed):
        if traced(v):
            use_dedup_attention_kernel(v)   # raises on what K7 does not take
            out, lse = _dot_op(q, k, v, *_op_args(att), float(leaky_slope),
                               dsh, dvh, rate, seed)
        elif use_dedup_attention_kernel(v):
            out, lse = _dot_fwd_cuda(q, k, v, att, leaky_slope, dsh, dvh,
                                     rate, seed)
        else:
            out, lse = dedup_dot_reference(q, k, v, att.layout, dsh, dvh,
                                           leaky_slope, rate, seed)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.meta = (att, leaky_slope, dsh, dvh, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, seed = ctx.saved_tensors
        att, slope, dsh, dvh, rate = ctx.meta
        H = q.shape[1] // dsh
        g = g.contiguous()
        ins = (q, k, v, g, lse, _delta(g, out, H, dvh))
        if use_dedup_attention_kernel(v):
            dq, dk, dv = _dot_bwd_cuda(*ins, att, slope, dsh, dvh, rate,
                                       seed)
        else:
            dq, dk, dv = dedup_dot_bwd_reference(*ins, att.layout, dsh, dvh,
                                                 slope, rate, seed)
        return dq, dk, dv, None, None, None, None, None, None


def dedup_dot_attention(q, k, v, att: DedupAttention, num_heads: int,
                        dsh=None, dvh=None, leaky_slope: float = 0.0,
                        attn_drop: float = 0.0, drop_seed=None):
    """Dot-score attention over the count matrix: ``out[r] = Σ_{e: dst=r}
    softmax_r(leaky(q[r] · k[src_e])) · v[src_e]`` per head, the same
    function as :func:`attention_kernels.fused_graph_attention`, with the
    dropout keyed by cell as :func:`dedup_gat_attention`'s.

    Args:
      q: [N, H·dsh] destination-side score features.
      k: [N, H·dsh] source-side score features.
      v: [N, H·dvh] values (no lane padding, unlike the reference's).
      att: the graph's :func:`build_dedup_attention` (``Graph.
        _dedup_attn_aux()``), which carries the CSC dedup layout and the
        cell lists.
      num_heads: H.
      dsh, dvh: per-head score and value widths (default ``q.shape[1] //
        H`` and ``v.shape[1] // H``).
      leaky_slope: nonzero applies a leaky relu to the scores.
    Returns [N, H·dvh]; rows with no incoming edge are 0.
    """
    N, H = q.shape[0], int(num_heads)
    dsh = dsh or q.shape[1] // H
    dvh = dvh or v.shape[1] // H
    if q.shape != (N, H * dsh) or k.shape != (N, H * dsh) \
            or v.shape != (N, H * dvh):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not [N, {H} * {dsh}], "
                         f"[N, {H} * {dsh}] and [N, {H} * {dvh}]")
    seed = _seed_tensor(drop_seed, v.device)
    return _DedupDotAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), att, float(leaky_slope),
                                    dsh, dvh, float(attn_drop), seed)
