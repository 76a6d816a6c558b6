"""Two-phase unique-source ("dedup") SpMM: the kernels behind ``send_u_recv``
sum and mean on graphs whose row blocks repeat their sources.

Port of ``pgl_tpu/ops/pallas/dedup_kernels.py`` (``_LayoutPrefix``,
``build_dedup_layout``, ``materialize_counts``, ``spmm_dedup``,
``spmm_dedup_weighted``; the Pallas kernels ``_materialize_kernel``,
``_dedup_cached_kernel`` and ``_dedup_kernel``, unweighted and weighted)
onto the CUDA source ``csrc/dedup_kernels.cu``, whose note gives the
design.

The destination rows are cut into blocks of ``NB`` = 256. Each block keeps a
table of its distinct sources, densely packed into one array ``uv`` for all
blocks, and its edges are sorted by their source's row in that table. The
table is cut into windows of ``W`` = 128 rows; one (block, window) pair owns
one contiguous span of edges. Per pair p the count matrix ``C_p[r, c]`` is
the number of its edges with destination ``blk_p·NB + r`` whose source is
``uv[wb_p + c]``, and

    out[blk_p·NB : +NB] += C_p @ feature[uv[wb_p : wb_p + W]].

* :func:`build_dedup_layout` is the host (numpy) builder, a copy of the
  reference's: ``uv`` (with its ``+W`` tail: a window may run past its
  block's rows into the next block's), the pair enumeration, ``eid``,
  ``max_count`` and ``simple`` equal the reference's array for array. The
  TPU-only padding (``padded_ids`` as ``[Ep/128, 128]``, 128-aligned
  ``pair_ts``, the ``rank_iv`` interval table for the MXU's transposed
  one-hot) is replaced by what the Hopper kernels read: each edge's
  destination (``dst``) and unique row (``urow``) in dedup order, and each
  pair's exact ``[start, end)`` span. Pairs are grouped (at most
  ``PAIRS_PER_GROUP`` of one block to a group, one CUDA block each); a
  block of several groups writes partials that a second launch sums in
  order, as K1 does with the pieces of a split row.
* :func:`materialize_counts` is K4: the counts as bf16 ``[P·NB, W]``,
  exactly the reference's; a no-op when ``max_count > COUNTS_MAX``.
* :func:`spmm_dedup` is an autograd ``Function``: the forward runs K5 over
  the CSC layout when it has counts and K6 (counts rebuilt per call) when
  not; the backward runs the same over the CSR layout. The kernels gather
  the window rows ``feature[uv[...]]`` themselves; no ``[U, D]`` table of
  unique rows is written. K5 and K6 give identical bits.
* :func:`spmm_dedup_weighted` is the weighted K6 as an autograd
  ``Function``: ``out[d] = Σ_e w_e · feature[src_e]`` with scalar weights in
  the graph's original edge order, C[r, c] the sum of the cell's weights.
  Its backward is the weighted K6 over the CSR layout for dx and K1w's
  weight-gradient pass over the K1 CSR layout for dw.
* An apply that ``torch.export`` or ``torch.compile`` traces
  (``dispatch.traced``) is the custom op ``torch.ops.pgl_tpu_torch.
  spmm_dedup``: K5 given the counts, K6 without them, the weighted K6 given
  weights (its CUDA implementation the launch, its CPU one the plain
  version), so an exported program calls the apply; K4 stays set-up work,
  its counts a constant of the program.
* :func:`counts_reference`, :func:`apply_reference` and
  :func:`apply_weighted_reference` are the plain PyTorch versions
  (``bincount``; ``bmm`` and ``index_add_``; ``index_select``, a product and
  ``index_add_``). CPU tensors run them; CUDA tensors launch the kernels or
  raise.
* The apply takes float32 and bf16 tables: ``pgl_dedup_apply_f32`` in the
  library ``dedup_kernels``, ``pgl_dedup_apply_bf16`` in
  ``dedup_kernels_bf16`` (the same source built apart): bf16 rows gathered
  as they are, the sums float32, each output (and dx, and the weighted
  K6's dw through K1w) rounded once to bf16; the partials of split blocks
  stay float32. The plain versions compute a bf16 (or fp16) table in
  float32 and round each output once, the kernels' contract. K4 reads no
  feature and stays in ``dedup_kernels``.

``LAUNCHES_BY_SHAPE`` counts float32 launches by ``(kernel, layout kind,
D)`` with kernel ``"counts"`` (K4; D is None), ``"dedup_cached"`` (K5),
``"dedup"`` (K6) or ``"dedup_weighted"`` (the weighted K6); one per call,
which is two CUDA launches when a block has several groups (more, one a
128-column tile, for bf16 past 128 columns). ``LAUNCHES_BF16`` counts the
bf16 launches apart, by the same keys. ``LAUNCHES`` is the sum of both.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ... import resolve_device
from ..dispatch import COUNTS_MAX, traced, use_dedup_kernel
from . import _build
from .segment_kernels import _HALF, SpmmLayout, _weighted_backward, cut_rows

__all__ = ["DedupLayout", "build_dedup_layout", "materialize_counts",
           "spmm_dedup", "spmm_dedup_weighted", "counts_reference",
           "apply_reference", "apply_weighted_reference", "NB", "W",
           "PAIRS_PER_GROUP", "LAUNCHES", "LAUNCHES_BY_SHAPE",
           "LAUNCHES_BF16", "reset_launches"]

NB = 256      # destination rows per block (NBD_DEFAULT of the reference)
W = 128       # unique rows per window (W_DEFAULT of the reference)
# most pairs of one block in one CUDA block: fewer spread a block of many
# windows (the headline's hub block has 1,024) over more SMs, more cut the
# partials the combine launch sums; read when a layout is built
PAIRS_PER_GROUP = 8

LAUNCHES_BY_SHAPE: Counter = Counter()
LAUNCHES_BF16: Counter = Counter()


def __getattr__(name):
    if name == "LAUNCHES":
        return sum(LAUNCHES_BY_SHAPE.values()) + sum(LAUNCHES_BF16.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches():
    """Set the launch counts to 0."""
    LAUNCHES_BY_SHAPE.clear()
    LAUNCHES_BF16.clear()


@dataclass(frozen=True)
class DedupLayout:
    """A sorted adjacency in dedup order, as the kernels read it (int32
    tensors on one device; ``counts`` bf16).

    uv:           [Upad + W] source id of each unique row, blocks' runs
                  packed densely (each padded to 8 rows); pad rows are 0
    pairs:        [P, 4] (blk, wb, start, end): the pair's block, the
                  first unique row of its window, and its exact edge span
    dst:          [E] destination of each edge, dedup order
    urow:         [E] unique row of each edge's source, dedup order
    eid:          [E] for each dedup position, its CSC/CSR edge position
    groups:       [NG, 4] (blk, pair_begin, pair_end, slot): at most
                  ``PAIRS_PER_GROUP`` consecutive pairs of one block;
                  ``slot`` is the group's partial block, or -1 when its
                  block has one group and the kernel stores directly
    split_blocks: [S] blocks of more than one group
    split_ptr:    [S+1] their ranges of partial slots, in group order
    counts:       None, or [P·NB, W] bf16 count matrices (K4)
    edge_id:      None, or [E] original edge id of each dedup position
                  (the weighted K6 reads its weights through it)
    """
    kind: str
    num_segments: int
    num_edges: int
    max_index: int        # largest source id (-1 without edges)
    simple: bool          # no (dst, src) pair occurs twice
    max_count: int        # largest (dst, src) multiplicity
    num_partials: int
    uv: torch.Tensor
    pairs: torch.Tensor
    dst: torch.Tensor
    urow: torch.Tensor
    eid: torch.Tensor
    groups: torch.Tensor
    split_blocks: torch.Tensor
    split_ptr: torch.Tensor
    counts: Optional[torch.Tensor] = None
    edge_id: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.uv.device

    @property
    def num_pairs(self) -> int:
        return self.pairs.shape[0]

    @property
    def n_pad(self) -> int:
        return -(-self.num_segments // NB) * NB

    @property
    def counts_bytes(self) -> int:
        """Device bytes of the bf16 count matrices."""
        return self.num_pairs * NB * W * 2


class _LayoutPrefix:
    """Host build shared with the reference (``pgl_tpu/ops/pallas/
    dedup_kernels.py:150-270``): the per-block unique-source table, the
    dedup edge order and the (block, window) pairs with exact edge spans,
    at ``nb`` destination rows a block and ``w`` unique rows a window (the
    SpMM and attention layouts take the defaults; the SDDMM layout of
    ``sddmm_kernels`` takes 128 and 128, as the reference does).
    ``rejected`` is set, and nothing else built, when the padded
    unique-row count exceeds ``max_ratio * E``."""

    def __init__(self, indptr, sorted_v, num_segments: int,
                 max_ratio: float = 0.0, nb: int = NB, w: int = W):
        indptr = np.asarray(indptr, dtype=np.int64)
        src = np.asarray(sorted_v, dtype=np.int64)
        E = len(src)
        N = int(num_segments)
        G = -(-N // nb)
        dst = np.repeat(np.arange(N, dtype=np.int64), np.diff(indptr))
        blk = dst // nb

        # per-block unique sources and each edge's rank among them; source
        # ids may exceed N, so the composite key has its own modulus
        M = max(N, int(src.max()) + 1 if E else 1)
        uniq, inv = np.unique(blk * M + src, return_inverse=True)
        ublk = uniq // M
        ub = np.bincount(ublk, minlength=G)
        ubp = -(-ub // w) * w
        self.ratio = float(ubp.sum()) / E if E else 0.0
        self.rejected = bool(max_ratio and E and self.ratio > max_ratio)
        if self.rejected:
            return
        # dense packing: each block's run padded to 8 rows only, so a
        # window may run into the next block's rows (those cells count 0)
        uv_off = np.zeros(G + 1, np.int64)
        np.cumsum(-(-ub // 8) * 8, out=uv_off[1:])
        Upad = int(uv_off[-1])
        blk_first = np.concatenate([[0], np.cumsum(ub)[:-1]])
        rank = np.arange(len(uniq), dtype=np.int64) - blk_first[ublk]
        uv = np.zeros(Upad + w, np.int32)
        uv[uv_off[ublk] + rank] = (uniq % M).astype(np.int32)

        grow = uv_off[blk] + rank[inv]            # each edge's unique row
        order = np.lexsort((grow, blk))
        blk_o = blk[order]
        self.grow_o = grow[order]
        self.dst_o = dst[order]
        self.src_o = src[order]
        self.order = order

        # windows per block: max(ceil(ub / w), 1), so an empty block still
        # owns one (empty) pair and its rows are written
        nw = np.maximum(ubp // w, 1)
        P = int(nw.sum())
        pair_blk = np.repeat(np.arange(G, dtype=np.int64), nw)
        win_in_blk = np.arange(P, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(nw)[:-1]]), nw)
        self.pair_wb = uv_off[pair_blk] + win_in_blk * w
        ekey = blk_o * (int(nw.max()) + 1) + (self.grow_o - uv_off[blk_o]) // w
        pkey = pair_blk * (int(nw.max()) + 1) + win_in_blk
        self.starts = np.searchsorted(ekey, pkey, side="left")
        self.ends = np.searchsorted(ekey, pkey, side="right")
        # (dst, unique row) identifies a count cell: its multiplicity. The
        # stable sort keeps a cell's edges contiguous (same block and unique
        # row, CSC order within: destinations ascending), which the
        # weighted K6 needs to sum each cell in edge order without atomics
        if E:
            cell = self.dst_o * (Upad + 1) + self.grow_o
            _, cell_counts = np.unique(cell, return_counts=True)
            self.n_cells, self.max_count = (len(cell_counts),
                                            int(cell_counts.max()))
            runs = 1 + int(np.count_nonzero(cell[1:] != cell[:-1]))
            if runs != self.n_cells:
                raise RuntimeError("dedup layout: a count cell's edges "
                                     "are not contiguous")
        else:
            self.n_cells, self.max_count = 0, 0
        self.E, self.N, self.G, self.P = E, N, G, P
        self.uv, self.nw, self.pair_blk = uv, nw, pair_blk


def build_dedup_layout(indptr, sorted_v, num_segments: int,
                       kind: str = "csc", max_ratio: float = 0.0,
                       device=None, edge_id=None) -> Optional[DedupLayout]:
    """Host-side (numpy) build from a sorted adjacency, O(E log E); call
    once, at ``Graph.tensor()`` time. ``kind`` names the layout in the
    launch counts; ``edge_id`` [E], the original edge id of each sorted
    position (the index's ``sorted_eid``), lets the weighted K6 run on it.

    Returns None when ``max_ratio`` > 0 and the padded unique-row count
    exceeds ``max_ratio * E``: such a graph repeats few sources within a
    block, and the caller stays on K1.
    """
    E = len(sorted_v)
    if E >= 2 ** 31 or num_segments >= 2 ** 31:
        raise ValueError(f"int32 layout: {E} edges / {num_segments} rows "
                         "would wrap — shard the graph first")
    pre = _LayoutPrefix(indptr, sorted_v, num_segments, max_ratio)
    if pre.rejected:
        return None
    # each block's pairs in groups of at most PAIRS_PER_GROUP, cut as K1
    # cuts a row into pieces
    groups, split_blocks, split_ptr = cut_rows(
        np.concatenate([[0], np.cumsum(pre.nw)]), PAIRS_PER_GROUP)
    device = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return DedupLayout(
        kind=kind, num_segments=pre.N, num_edges=pre.E,
        max_index=int(pre.src_o.max()) if pre.E else -1,
        simple=pre.n_cells == pre.E, max_count=pre.max_count,
        num_partials=int(split_ptr[-1]),
        uv=put(pre.uv),
        pairs=put(np.stack([pre.pair_blk, pre.pair_wb, pre.starts,
                            pre.ends], axis=1).reshape(-1, 4)),
        dst=put(pre.dst_o), urow=put(pre.grow_o), eid=put(pre.order),
        groups=put(groups), split_blocks=put(split_blocks),
        split_ptr=put(split_ptr),
        edge_id=(None if edge_id is None
                 else put(np.asarray(edge_id, dtype=np.int64)[pre.order])))


# -- plain versions ---------------------------------------------------------

def _count_cells(layout: DedupLayout, dtype) -> torch.Tensor:
    """``[P·NB, W]`` counts of ``dtype`` by ``bincount``."""
    P = layout.num_pairs
    pairs = layout.pairs.long()
    pair = torch.repeat_interleave(torch.arange(P, device=layout.device),
                                   pairs[:, 3] - pairs[:, 2])
    r = layout.dst.long() - pairs[pair, 0] * NB
    c = layout.urow.long() - pairs[pair, 1]
    flat = (pair * NB + r) * W + c
    return torch.bincount(flat, minlength=P * NB * W).reshape(
        P * NB, W).to(dtype)


def counts_reference(layout: DedupLayout) -> torch.Tensor:
    """The plain version of K4: bf16 ``[P·NB, W]`` counts."""
    return _count_cells(layout, torch.bfloat16)


def _acc(x: torch.Tensor):
    """The dtype the plain versions compute ``x`` in: float32 for bf16 and
    fp16 (each output rounded once to ``x``'s dtype), else ``x``'s."""
    return torch.float32 if x.dtype in _HALF else x.dtype


def apply_reference(x: torch.Tensor, layout: DedupLayout,
                    counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of K5 (``counts`` given) and K6 (counts rebuilt):
    ``out[blk_p·NB + r] += Σ_c C_p[r, c] · x[uv[wb_p + c]]``, in ``x``'s
    dtype (a bf16 ``x`` summed in float32, each output rounded once). The
    two agree bit for bit wherever the counts are exact."""
    P = layout.num_pairs
    acc = _acc(x)
    if counts is None:
        counts = _count_cells(layout, acc)
    pairs = layout.pairs.long()
    ar_w = torch.arange(W, device=x.device)
    win = x.index_select(0, layout.uv.long()[pairs[:, 1:2] + ar_w].reshape(
        -1)).reshape(P, W, -1).to(acc)
    prod = torch.bmm(counts.to(acc).reshape(P, NB, W), win)
    rows = (pairs[:, 0:1] * NB + torch.arange(NB, device=x.device)).reshape(
        -1)
    out = win.new_zeros(layout.n_pad, x.shape[1]).index_add_(
        0, rows, prod.reshape(P * NB, -1))
    return out[:layout.num_segments].to(x.dtype)


def apply_weighted_reference(x: torch.Tensor, w: torch.Tensor,
                             layout: DedupLayout) -> torch.Tensor:
    """The plain version of the weighted K6: ``out[dst_e] += w[edge_id_e] ·
    x[uv[urow_e]]`` over the layout's edges, ``w`` [E] in the original edge
    order (bf16 tables: the messages and sums float32, each output rounded
    once)."""
    acc = _acc(x)
    msgs = x.index_select(0, layout.uv.index_select(0, layout.urow)).to(acc) \
        * w.index_select(0, layout.edge_id).to(acc).unsqueeze(1)
    return msgs.new_zeros(layout.num_segments, x.shape[1]).index_add_(
        0, layout.dst, msgs).to(x.dtype)


# -- the CUDA kernels -------------------------------------------------------

def _lib(dtype=torch.float32):
    """The library of the entry points on ``dtype``: ``dedup_kernels`` (K4,
    ``pgl_dedup_apply_f32``) or, for bf16, ``dedup_kernels_bf16``
    (``pgl_dedup_apply_bf16``: the same source built apart, so the two
    build in parallel); each has ``pgl_dedup_apply_smem``."""
    bf16 = dtype == torch.bfloat16
    lib = _build.load("dedup_kernels_bf16" if bf16 else "dedup_kernels")
    if lib.pgl_dedup_apply_smem.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        apply = (lib.pgl_dedup_apply_bf16 if bf16
                 else lib.pgl_dedup_apply_f32)
        apply.argtypes = [i, i, p, p, p, p, i, p, p, i, p, p, p, p, p, i, i,
                          p, p, p]
        apply.restype = ctypes.c_int
        lib.pgl_dedup_apply_smem.argtypes = [i, i, i, i]
        lib.pgl_dedup_apply_smem.restype = ctypes.c_int
        if not bf16:
            lib.pgl_dedup_counts.argtypes = [i, p, i, p, p, p, p]
            lib.pgl_dedup_counts.restype = ctypes.c_int
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_counts(layout: DedupLayout, counts: torch.Tensor):
    """K4 into preallocated bf16 ``counts`` [P·NB, W]; raises when the
    launch is refused."""
    rc = _lib().pgl_dedup_counts(
        layout.device.index, layout.pairs.data_ptr(), layout.num_pairs,
        layout.dst.data_ptr(), layout.urow.data_ptr(), counts.data_ptr(),
        _stream(layout.device))
    if rc != 0:
        raise RuntimeError(f"dedup_kernels counts launch failed: CUDA "
                           f"error {rc}")


def _launch_apply(x, layout: DedupLayout, counts, out, partials, w=None):
    """K5 (``counts`` given), K6 (``counts`` None) or the weighted K6
    (weights ``w`` [E] given) into preallocated ``out`` [n_pad, D] (``x``'s
    dtype, float32 or bf16, as ``w``) and ``partials`` [num_partials·NB, D]
    (float32)."""
    mode = 2 if w is not None else 0 if counts is not None else 1
    lib = _lib(x.dtype)
    fn = (lib.pgl_dedup_apply_bf16 if x.dtype == torch.bfloat16
          else lib.pgl_dedup_apply_f32)
    rc = fn(
        x.device.index, mode, x.data_ptr(),
        layout.uv.data_ptr(), layout.pairs.data_ptr(),
        layout.groups.data_ptr(), layout.groups.shape[0],
        layout.split_blocks.data_ptr(), layout.split_ptr.data_ptr(),
        layout.split_blocks.shape[0], layout.dst.data_ptr(),
        layout.urow.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        layout.edge_id.data_ptr() if w is not None else None,
        w.data_ptr() if w is not None else None, layout.max_count,
        x.shape[1], out.data_ptr(), partials.data_ptr(), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"dedup_kernels apply launch failed: CUDA "
                           f"error {rc}")


def _check_cuda_layout(layout: DedupLayout):
    if layout.device.type != "cuda":
        raise ValueError(f"layout on {layout.device}, not on a CUDA device")


def materialize_counts(layout: DedupLayout) -> DedupLayout:
    """K4: the layout with ``counts`` set (bf16 ``[P·NB, W]``). A no-op
    when the counts exist or ``max_count`` exceeds ``COUNTS_MAX`` (bf16
    would not hold them exactly)."""
    if layout.counts is not None or layout.max_count > COUNTS_MAX:
        return layout
    if layout.device.type == "cpu":
        return dataclasses.replace(layout, counts=counts_reference(layout))
    _check_cuda_layout(layout)
    counts = torch.empty(layout.num_pairs * NB, W, dtype=torch.bfloat16,
                         device=layout.device)
    _launch_counts(layout, counts)
    LAUNCHES_BY_SHAPE[("counts", layout.kind, None)] += 1
    return dataclasses.replace(layout, counts=counts)


def _apply_cuda(x: torch.Tensor, layout: DedupLayout,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x.device != layout.device:
        raise ValueError(f"features on {x.device}, layout on "
                         f"{layout.device}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("the CUDA dedup SpMM takes a contiguous [N, D] "
                         f"tensor, got shape {tuple(x.shape)} with strides "
                         f"{x.stride()}")
    if x.shape[0] <= layout.max_index:
        raise ValueError(f"feature table of {x.shape[0]} rows; the layout "
                         f"gathers row {layout.max_index}")
    if w is not None and not w.is_contiguous():
        raise ValueError("the CUDA weighted dedup SpMM takes contiguous "
                         "weights")
    D = x.shape[1]
    out = torch.empty(layout.n_pad, D, dtype=x.dtype, device=x.device)
    # a split block's partial sums stay float32 whatever x's dtype
    partials = torch.empty(layout.num_partials * NB, D, dtype=torch.float32,
                           device=x.device)
    _launch_apply(x, layout, layout.counts, out, partials, w)
    kernel = ("dedup_weighted" if w is not None
              else "dedup" if layout.counts is None else "dedup_cached")
    (LAUNCHES_BF16 if x.dtype == torch.bfloat16
     else LAUNCHES_BY_SHAPE)[(kernel, layout.kind, D)] += 1
    return out[:layout.num_segments]


def _apply_plain(x: torch.Tensor, layout: DedupLayout,
                 w: Optional[torch.Tensor] = None) -> torch.Tensor:
    if w is not None:
        return apply_weighted_reference(x, w, layout)
    return apply_reference(x, layout, layout.counts)


def _apply_one(x: torch.Tensor, layout: DedupLayout,
               w: Optional[torch.Tensor] = None) -> torch.Tensor:
    if traced(x):
        use_dedup_kernel(x)         # raises on what K5/K6 do not take
        return _apply_op(x, [getattr(layout, n) for n in _OP_TENSORS],
                         [getattr(layout, n) for n in _OP_INTS],
                         layout.counts,
                         None if w is None else layout.edge_id, w,
                         layout.kind)
    if use_dedup_kernel(x):
        return _apply_cuda(x, layout, w)
    return _apply_plain(x, layout, w)


# the apply op's arguments: the layout's tensors and ints (its counts, and
# for the weighted K6 its edge ids and the weights, apart: either may be
# absent), its kind
_OP_TENSORS = ("uv", "pairs", "dst", "urow", "groups", "split_blocks",
               "split_ptr")
_OP_INTS = ("num_segments", "num_edges", "max_index", "max_count",
            "num_partials")


def _op_layout(tensors, ints, counts, edge_id, kind) -> DedupLayout:
    """The layout the apply reads (no ``eid``; ``simple`` unread)."""
    return DedupLayout(kind=kind, simple=False, eid=None, counts=counts,
                       edge_id=edge_id, **dict(zip(_OP_INTS, ints)),
                       **dict(zip(_OP_TENSORS, tensors)))


@torch.library.custom_op("pgl_tpu_torch::spmm_dedup", mutates_args=(),
                         device_types="cpu")
def _apply_op(x: torch.Tensor, layout: List[torch.Tensor], ints: List[int],
              counts: Optional[torch.Tensor], edge_id: Optional[torch.Tensor],
              w: Optional[torch.Tensor], kind: str) -> torch.Tensor:
    """K5, K6 or the weighted K6 as an operator: the plain version on the
    CPU."""
    return _apply_plain(x, _op_layout(layout, ints, counts, edge_id, kind),
                        w)


@_apply_op.register_kernel("cuda")
def _apply_op_cuda(x, layout, ints, counts, edge_id, w, kind):
    use_dedup_kernel(x)
    return _apply_cuda(x, _op_layout(layout, ints, counts, edge_id, kind), w)


@_apply_op.register_fake
def _apply_op_fake(x, layout, ints, counts, edge_id, w, kind):
    return x.new_empty(ints[0], x.shape[1])


class _SpMMDedup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feature, csc_d, csr_d):
        ctx.csr_d = csr_d
        return _apply_one(feature, csc_d)

    @staticmethod
    def backward(ctx, g):
        # d/dfeature: the transposed SpMM over the layout grouped by source
        return _apply_one(g.contiguous(), ctx.csr_d), None, None


def spmm_dedup(feature: torch.Tensor, csc_d: DedupLayout,
               csr_d: DedupLayout) -> torch.Tensor:
    """``out[d] = Σ_{edges s→d} feature[s]`` through the dedup layout
    ``csc_d`` (K5 with cached counts, else K6); the gradient runs the same
    over ``csr_d``."""
    return _SpMMDedup.apply(feature, csc_d, csr_d)


class _SpMMDedupWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feature, w, csc_d, csr_d, csr):
        ctx.csr_d, ctx.csr = csr_d, csr
        ctx.save_for_backward(feature, w)
        return _apply_one(feature, csc_d, w)

    @staticmethod
    def backward(ctx, g):
        feature, w = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        g = g.contiguous()
        # dx: the weighted K6 over the layout grouped by source
        dx = _apply_one(g, ctx.csr_d, w) if need_dx else None
        dw = None
        if need_dw:
            # dw_e = <g[dst_e], x[src_e]>: K1w's weight-gradient pass
            _, dw = _weighted_backward(g, feature, w.unsqueeze(1), ctx.csr,
                                       "mul", False, True)
            dw = dw.reshape(-1)
        return dx, dw, None, None, None


def spmm_dedup_weighted(feature: torch.Tensor, w: torch.Tensor,
                        csc_d: DedupLayout, csr_d: DedupLayout,
                        csr: SpmmLayout) -> torch.Tensor:
    """The weighted K6: ``out[d] = Σ_{edges e: s→d} w[e] · feature[s]``
    through the dedup layout ``csc_d``, ``w`` [E] in the graph's original
    edge order. The gradient: dx by the weighted K6 over ``csr_d``, dw (in
    the original edge order) by K1w's weight-gradient pass over the K1
    layout ``csr``. All three layouts need their ``edge_id``."""
    for layout in (csc_d, csr_d, csr):
        if layout.edge_id is None:
            raise ValueError(f"the {layout.kind} layout was built without "
                             "edge ids; the weighted SpMM reads its weights "
                             "through them")
    if w.shape != (csc_d.num_edges,) or w.dtype != feature.dtype \
            or w.device != feature.device:
        raise ValueError(f"weights {w.dtype} of shape {tuple(w.shape)} on "
                         f"{w.device} for {csc_d.num_edges} edges and "
                         f"{feature.dtype} features on {feature.device}")
    return _SpMMDedupWeighted.apply(feature, w, csc_d, csr_d, csr)
