"""Sorted-segment SpMM: the kernel behind ``send_u_recv`` sum and mean, and
on weighted messages (K1w) behind ``send_ue_recv``.

Port of ``pgl_tpu/ops/pallas/segment_kernels.py`` (``_kernel`` and
``_fused_kernel``; ``spmm``, ``sorted_segment_sum`` and ``spmm_weighted``)
onto one CUDA kernel for Hopper, ``csrc/segment_kernels.cu``, whose note
gives the design.

* :func:`build_spmm_layout` builds K1's work list on the host (numpy):
  every row longer than ``MIN_PIECE`` edges cut into pieces
  (:func:`cut_spmm_rows`), runs of short rows packed into items of at most
  ``PACK`` edges and rows (:func:`pack_rows`); a warp walks one item at a
  time. It is :func:`build_spmm_layout_host` (numpy arrays only: a
  dataloader worker builds a minibatch's layouts in its collate) followed
  by :meth:`SpmmLayout.to`; :func:`pack_spmm_layout` puts a host layout
  into one int32 array and :func:`unpack_spmm_layout` reads it back, as
  views of one device buffer.
* :func:`spmm` is an autograd ``Function``: forward over the CSC layout,
  backward the same kernel over the CSR layout (the transposed SpMM).
* :func:`sorted_segment_sum` is the same kernel with the identity gather;
  its backward is a gather.
* :func:`spmm_weighted` (K1w) is an autograd ``Function`` on weighted
  messages, ``out[d] = Σ_e x[src_e] ⊛ w_e`` with ⊛ mul or add and ``w``
  scalar ``[E, 1]`` or per head ``[E, H]`` (H | D) in the graph's original
  edge order: the same kernels over the same work list, the forward over
  CSC, the backward one launch over CSR that gives dx and dw (in the
  original edge order) together.
* :func:`spmm_reference`, :func:`spmm_weighted_reference` and
  :func:`weight_grad_reference` are the plain PyTorch versions. CPU tensors
  run them; CUDA tensors launch the kernel or raise.

``LAUNCHES_BY_SHAPE`` counts kernel launches: K1's by ``(layout.kind, D)``,
K1w's by ``(op, layout.kind, D, H)`` with op ``"mul"`` or ``"add"`` (the
backward launch, dx with or without dw, is keyed by the CSR layout; add's
dx alone is K1's unweighted sum and counts as K1), and ``"mul_dw"`` or
``"add_dw"`` for a launch that gives dw alone; one per call, which is two
CUDA launches when a row was split and dx is written.
``LAUNCHES`` is their sum. ``LAUNCHES_BY_LAYOUT`` counts K1's launches
again by ``((layout.kind, D), id(layout))``, so that the launches on each of
several graphs of one shape (the relations of a heterogeneous graph) are
read apart.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ... import resolve_device
from ..dispatch import use_spmm_kernel
from . import _build

__all__ = ["SpmmLayout", "build_spmm_layout", "build_spmm_layout_host",
           "pack_spmm_layout", "unpack_spmm_layout",
           "packed_layout_words_max", "cut_rows",
           "cut_spmm_rows",
           "pack_rows", "spmm", "spmm_reference", "spmm_weighted",
           "spmm_weighted_reference", "weight_grad_reference",
           "sorted_segment_sum", "ET", "MIN_PIECE", "ROW_PIECES", "PACK",
           "PACK_ROW", "LAUNCHES", "LAUNCHES_BY_SHAPE", "LAUNCHES_BY_LAYOUT",
           "reset_launches"]

# The pieces of K1's work list (:func:`cut_spmm_rows`, K1w's too): a row of
# more than MIN_PIECE edges is cut into about ROW_PIECES pieces of MIN_PIECE
# to ET edges. Shorter pieces spread a row over more warps, so a row of a
# few thousand edges is no longer one warp's chain of gathers; longer ones
# cut the partials that the second launch sums in order, which a hub of
# 800k edges needs (experiments/torch_spmm/sweep.py). Read when a layout is
# built.
ET = 512
MIN_PIECE = 64
ROW_PIECES = 128
# most edges, and most rows, of a packed item of K1's work list: one index
# (and one row pointer) a lane, loaded by the warp in one coalesced load;
# csrc/segment_kernels.cu's kPack, the size of its staging arrays
PACK = 32
# the longest row that joins a pack: longer rows are items of their own,
# whose lane groups share the row's edges (rows of ~16 edges ran slower
# packed two an item; experiments/torch_spmm/sweep.py)
PACK_ROW = 8

LAUNCHES_BY_SHAPE: Counter = Counter()
LAUNCHES_BY_LAYOUT: Counter = Counter()


def __getattr__(name):
    if name == "LAUNCHES":
        return sum(LAUNCHES_BY_SHAPE.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches():
    """Set the launch counts to 0."""
    LAUNCHES_BY_SHAPE.clear()
    LAUNCHES_BY_LAYOUT.clear()


@dataclass(frozen=True)
class SpmmLayout:
    """A sorted adjacency as the kernel reads it (all int32 on one device,
    or int32 numpy arrays in the host form of :func:`build_spmm_layout_host`).

    indptr:      [R+1] row pointer
    indices:     [E]   gather ids (the source node of each edge for CSC),
                 ascending within each row
    seg_ids:     [E]   row of each edge (the plain version's scatter ids)
    items:       [I, 4] K1's and K1w's work list (:func:`pack_rows`): the
                 pieces (row, begin, end, slot) of :func:`cut_spmm_rows` of
                 rows longer than ``PACK_ROW`` edges (``slot`` the piece's
                 partial-sum row, or -1 for a whole row), then the last
                 ``item_packs`` items, packs of consecutive short rows
                 (row0, begin, end, -rows); each part in row order (one
                 kernel each)
    item_split_rows: [S] rows of more than one piece
    item_split_ptr:  [S+1] their ranges of partial slots, in piece order
    edge_id:     [E]   original edge id of each position (None when built
                 without edge ids): K1w reads ``w`` and writes ``dw``
                 through it
    """
    kind: str
    num_rows: int
    num_edges: int
    max_index: int        # largest gather id (-1 without edges)
    item_partials: int    # partial rows of the split rows' pieces
    item_packs: int       # packs at the end of ``items``
    indptr: torch.Tensor
    indices: torch.Tensor
    seg_ids: torch.Tensor
    items: torch.Tensor
    item_split_rows: torch.Tensor
    item_split_ptr: torch.Tensor
    edge_id: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def to(self, device) -> "SpmmLayout":
        """This layout's arrays on ``device`` (a host layout's put there
        once, as int32 tensors)."""
        device = resolve_device(device)

        def put(a):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                return a.to(device)
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                   device=device)

        return replace(self, **{name: put(getattr(self, name))
                                for name in _ARRAYS})


# the array fields of a layout, in the order pack_spmm_layout writes them
_ARRAYS = ("indptr", "indices", "seg_ids", "items", "item_split_rows",
           "item_split_ptr", "edge_id")
# the integer fields a packed layout's header carries, before the arrays'
# lengths
_SCALARS = ("num_rows", "num_edges", "max_index", "item_partials",
            "item_packs")


def build_spmm_layout(indptr, indices, num_rows: int, kind: str = "csc",
                      device=None, edge_id=None) -> SpmmLayout:
    """Host-side (numpy) build put on ``device``; call once, at
    ``Graph.tensor()`` time.

    ``indptr`` [R+1] and ``indices`` [E] are a sorted adjacency (CSC:
    ``indices`` are the sources grouped by destination row). ``kind`` names
    the layout in the launch counts. ``edge_id`` [E], the original edge id
    of each position (the index's ``sorted_eid``), follows the positions
    and lets K1w run on the layout.
    """
    device = resolve_device(device)
    return build_spmm_layout_host(indptr, indices, num_rows, kind,
                                  edge_id).to(device)


def build_spmm_layout_host(indptr, indices, num_rows: int,
                           kind: str = "csc", edge_id=None) -> SpmmLayout:
    """:func:`build_spmm_layout` with int32 numpy arrays for fields: numpy
    only, no torch call, so a forked dataloader worker can run it. Put it
    on a device with :meth:`SpmmLayout.to`."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    E, R = len(indices), int(num_rows)
    if E >= 2 ** 31 or R >= 2 ** 31:
        raise ValueError(f"int32 layout: {E} edges / {R} rows would wrap "
                         "— shard the graph first")
    if indptr.shape != (R + 1,) or indptr[0] != 0 or indptr[-1] != E:
        raise ValueError(f"indptr of shape {indptr.shape} ending at "
                         f"{indptr[-1] if len(indptr) else None} does not "
                         f"describe {R} rows over {E} edges")
    if E and indices.min() < 0:
        raise ValueError("negative gather index")
    deg = np.diff(indptr)
    seg_ids = np.repeat(np.arange(R), deg)
    # sources ascending within each row: the pieces of a hub row then read
    # narrow, nearly disjoint bands of x, which concurrent warps share in
    # L2 (the sum is the same up to float32 rounding order)
    order = np.lexsort((indices, seg_ids))
    indices = indices[order]
    pieces, item_split_rows, item_split_ptr = cut_spmm_rows(indptr)
    items = pack_rows(indptr, pieces)
    packs = items[:, 3] < -1
    items = np.concatenate([items[~packs], items[packs]])

    def put(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    return SpmmLayout(
        kind=kind, num_rows=R, num_edges=E,
        max_index=int(indices.max()) if E else -1,
        item_partials=int(item_split_ptr[-1]),
        item_packs=int(packs.sum()),
        indptr=put(indptr), indices=put(indices),
        seg_ids=put(seg_ids), items=put(items),
        item_split_rows=put(item_split_rows),
        item_split_ptr=put(item_split_ptr),
        edge_id=(None if edge_id is None
                 else put(np.asarray(edge_id, dtype=np.int64)[order])))


def _words16(n: int) -> int:
    """``n`` int32 words rounded up to 16 bytes."""
    return -(-n // 4) * 4


def pack_spmm_layout(layout: SpmmLayout) -> np.ndarray:
    """A host layout as one int32 array: a header of 12 words
    (``_SCALARS``, then each array's length, -1 for a missing
    ``edge_id``), then the arrays of ``_ARRAYS`` in order, each padded to
    16 bytes: the kernel loads its work list in 16-byte vectors, so each
    array must start 16-byte aligned in the buffer, and the buffer at a
    16-byte offset."""
    arrays = [getattr(layout, name) for name in _ARRAYS]
    if any(isinstance(a, torch.Tensor) for a in arrays):
        raise ValueError("pack_spmm_layout takes a host layout "
                         "(build_spmm_layout_host)")
    head = [getattr(layout, name) for name in _SCALARS]
    head += [-1 if a is None else np.size(a) for a in arrays]
    parts = [np.asarray(head, dtype=np.int32)]
    for a in arrays:
        if a is not None:
            a = np.asarray(a, dtype=np.int32).reshape(-1)
            parts += [a, np.zeros(_words16(a.size) - a.size, np.int32)]
    return np.concatenate(parts)


def packed_layout_words_max(num_rows: int, num_edges: int) -> int:
    """The most int32 words :func:`pack_spmm_layout` writes for a layout of
    ``num_rows`` rows and ``num_edges`` edges (edge ids included), so a
    buffer reused for many batches is sized once. A row of ``d`` edges is
    at most ``ceil(d / MIN_PIECE) <= d // MIN_PIECE + 1`` pieces (a pack
    joins pieces, so the items are no more), and only a row of more than
    ``MIN_PIECE`` edges splits."""
    R, E = int(num_rows), int(num_edges)
    items = R + E // MIN_PIECE
    split = E // (MIN_PIECE + 1)
    return (_words16(len(_SCALARS) + len(_ARRAYS)) + _words16(R + 1)
            + 3 * _words16(E) + _words16(4 * items) + _words16(split)
            + _words16(split + 1))


def unpack_spmm_layout(buf, kind: str, offset: int = 0, host=None):
    """The layout :func:`pack_spmm_layout` wrote at ``buf[offset:]``, ``buf``
    a 1-D int32 tensor (its arrays become views of it) or numpy array, and
    ``offset`` a multiple of 4 words. The header is read from ``host``, a
    host copy of ``buf`` (default ``buf`` itself), so a buffer on a card is
    read without a copy back: a buffer off the CPU needs it. Returns
    ``(layout, the offset past it)``."""
    if host is None and isinstance(buf, torch.Tensor) and \
            buf.device.type != "cpu":
        raise ValueError(f"a packed layout on {buf.device} is read through "
                         "its host copy: pass host= (the buffer as it was "
                         "before the copy)")
    if offset % 4:
        raise ValueError(f"a packed layout starts 16-byte aligned; offset "
                         f"{offset} words is not")
    host = buf if host is None else host
    n_s = len(_SCALARS)
    head = [int(v) for v in np.asarray(host[offset:offset + n_s
                                            + len(_ARRAYS)])]
    fields = dict(zip(_SCALARS, head[:n_s]))
    o = offset + _words16(n_s + len(_ARRAYS))
    for name, n in zip(_ARRAYS, head[n_s:]):
        if n < 0:
            fields[name] = None
            continue
        fields[name] = buf[o:o + n]
        o += _words16(n)
    fields["items"] = fields["items"].reshape(-1, 4)
    return SpmmLayout(kind=kind, **fields), o


def cut_rows(indptr, size):
    """Cut every row of ``indptr`` into pieces of at most ``size`` items
    (an int, or one length a row; an empty row is one empty piece), the
    work list of a kernel that sums each row's pieces into partials and
    combines them in a second launch.

    Returns ``pieces`` [P, 4] int64 (row, begin, end, slot), where ``slot``
    is the piece's partial row, or -1 when its row has one piece;
    ``split_rows``, the rows of more than one piece; and ``split_ptr``
    [S+1], their ranges of partial slots, in piece order.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    R = len(indptr) - 1
    size = np.broadcast_to(np.asarray(size, dtype=np.int64), (R,))
    n_pc = np.maximum(1, -(-np.diff(indptr) // size))
    first = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(n_pc, out=first[1:])
    row = np.repeat(np.arange(R, dtype=np.int64), n_pc)
    begin = indptr[row] + (np.arange(len(row)) - first[row]) * size[row]
    end = np.minimum(begin + size[row], indptr[row + 1])
    split = n_pc[row] > 1
    slot = np.full(len(row), -1, dtype=np.int64)
    slot[split] = np.arange(int(split.sum()))
    split_rows = np.flatnonzero(n_pc > 1)
    split_ptr = np.zeros(len(split_rows) + 1, dtype=np.int64)
    np.cumsum(n_pc[split_rows], out=split_ptr[1:])
    return (np.stack([row, begin, end, slot], axis=1).reshape(-1, 4),
            split_rows, split_ptr)


def cut_spmm_rows(indptr):
    """The pieces of K1's work list, :func:`cut_rows` with a length for
    each row: a row of ``d > MIN_PIECE`` edges is cut into pieces of
    ``clip(ceil(d / ROW_PIECES), MIN_PIECE, ET)`` edges (the last one
    shorter), any other row is one piece."""
    deg = np.diff(np.asarray(indptr, dtype=np.int64))
    return cut_rows(indptr, np.clip(-(-deg // ROW_PIECES), MIN_PIECE, ET))


def pack_rows(indptr, pieces):
    """K1's work list: ``pieces`` (:func:`cut_spmm_rows`' over ``indptr``)
    with each maximal run of consecutive rows of at most ``PACK_ROW`` edges
    packed greedily, in row order, into items of at most ``PACK`` edges and
    ``PACK`` rows.

    Returns ``items`` [I, 4] int64 in row order. A row of more than
    ``PACK_ROW`` edges keeps its pieces (row, begin, end, slot); a pack of
    one short row is its piece (row, begin, end, -1); a pack of ``n >= 2``
    rows is (first row, its begin, the last row's end, -n). No item ends
    inside a row except a piece of a split row.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    pieces = np.asarray(pieces, dtype=np.int64).reshape(-1, 4)
    R = len(indptr) - 1
    if R <= 0:
        return np.zeros((0, 4), dtype=np.int64)
    rows = np.arange(R, dtype=np.int64)
    short = np.diff(indptr) <= min(PACK_ROW, PACK)
    # nxt[r]: the row after the item that would start at row r
    longs = np.flatnonzero(~short)
    stop = np.append(longs, R)[np.searchsorted(longs, rows, side="right")]
    fits = np.searchsorted(indptr, indptr[:-1] + PACK, side="right") - 1
    nxt = np.where(short, np.minimum(np.minimum(fits, rows + PACK), stop),
                   rows + 1)
    # the items' first rows, the chain 0 -> nxt[0] -> ... -> R, by doubling:
    # with ``jump`` = nxt applied 2^k times, ``starts`` holds the chain's
    # first 2^k rows and ``jump[starts]`` the next 2^k
    jump = np.append(nxt, R)
    starts = np.zeros(1, dtype=np.int64)
    while starts[-1] < R:
        starts = np.concatenate([starts, jump[starts]])
        jump = jump[jump]
    starts = starts[starts < R]
    n_rows = nxt[starts] - starts
    single = np.zeros(R, dtype=bool)
    single[starts[n_rows == 1]] = True
    kept = pieces[single[pieces[:, 0]]]
    packed = starts[n_rows > 1]
    n_packed = n_rows[n_rows > 1]
    packs = np.stack([packed, indptr[packed], indptr[packed + n_packed],
                      -n_packed], axis=1)
    items = np.concatenate([kept, packs])
    # each row is in one of the two lists: a stable sort by first row keeps
    # a split row's pieces in piece order
    return items[np.argsort(items[:, 0], kind="stable")]


def spmm_reference(x: torch.Tensor, layout: SpmmLayout) -> torch.Tensor:
    """The plain version: ``out[r] = Σ_{e in row r} x[indices[e]]``."""
    return x.new_zeros(layout.num_rows, x.shape[1]).index_add_(
        0, layout.seg_ids, x.index_select(0, layout.indices))


def spmm_weighted_reference(x: torch.Tensor, w: torch.Tensor,
                            layout: SpmmLayout,
                            msg_op: str = "mul") -> torch.Tensor:
    """The plain version of K1w: ``out[r] = Σ_{e in row r} x[indices[e]] ⊛
    w[edge_id[e]]``, ``w`` [E, H] broadcast over each head's ``D / H``
    columns, ⊛ mul or add."""
    E, H, D = layout.num_edges, w.shape[1], x.shape[1]
    msgs = x.index_select(0, layout.indices).reshape(E, H, D // H)
    we = w.index_select(0, layout.edge_id).unsqueeze(-1)
    msgs = msgs * we if msg_op == "mul" else msgs + we
    return x.new_zeros(layout.num_rows, D).index_add_(
        0, layout.seg_ids, msgs.reshape(E, D))


def weight_grad_reference(g: torch.Tensor, x: torch.Tensor,
                          layout: SpmmLayout, H: int,
                          msg_op: str = "mul") -> torch.Tensor:
    """The plain version of K1w's dw, over the transposed (CSR) layout,
    whose rows are the sources: ``dw[edge_id[e], h]`` is the sum over head
    h's columns of ``g[indices[e]] · x[seg_ids[e]]`` (mul) or of
    ``g[indices[e]]`` (add); [E, H] in the original edge order."""
    E, D = layout.num_edges, g.shape[1]
    ge = g.index_select(0, layout.indices)
    if msg_op == "mul":
        ge = ge * x.index_select(0, layout.seg_ids)
    dw = ge.reshape(E, H, D // H).sum(-1)
    return torch.empty_like(dw).index_copy_(0, layout.edge_id.long(), dw)


_OPS = {"mul": 1, "add": 2}


def _lib():
    lib = _build.load("segment_kernels")
    if lib.pgl_spmm_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pgl_spmm_f32.argtypes = [i, p, p, p, p, i, i, p, p, i, i, p,
                                       p, p]
        lib.pgl_spmm_f32.restype = ctypes.c_int
        lib.pgl_spmm_weighted_f32.argtypes = [i, i, i, p, p, p, p, p, i, p,
                                              i, i, p, p, i, i, p, p, p, p,
                                              p]
        lib.pgl_spmm_weighted_f32.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_weighted(x, w, layout, out, partials, wop, dwop=0, xrow=None,
                     dw=None):
    """One K1w launch over ``layout.items`` on the current stream: ``wop``
    1 (mul), 2 (add) or 0 (unweighted, only beside ``dwop`` 2) into
    preallocated ``out`` (None: dw alone, with ``wop`` 0) and ``partials``
    [item_partials, D]; ``dwop`` 1 (mul, with ``xrow``) or 2 (add) also
    writes ``dw`` [E, H]. Raises when the launch is refused."""
    rc = _lib().pgl_spmm_weighted_f32(
        x.device.index, wop, dwop, x.data_ptr(), layout.indices.data_ptr(),
        layout.indptr.data_ptr(), layout.edge_id.data_ptr(), w.data_ptr(),
        w.shape[1], layout.items.data_ptr(),
        layout.items.shape[0] - layout.item_packs, layout.item_packs,
        layout.item_split_rows.data_ptr(), layout.item_split_ptr.data_ptr(),
        layout.item_split_rows.shape[0], x.shape[1], _ptr(out),
        _ptr(partials), _ptr(xrow), _ptr(dw),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_kernels weighted SpMM launch failed: "
                           f"CUDA error {rc}")


def _launch(x, layout, out, partials):
    """One SpMM (K1, over ``layout.items``) on the current stream into
    preallocated ``out`` and ``partials``; raises when the launch is
    refused."""
    rc = _lib().pgl_spmm_f32(
        x.device.index, x.data_ptr(), layout.indices.data_ptr(),
        layout.indptr.data_ptr(), layout.items.data_ptr(),
        layout.items.shape[0] - layout.item_packs, layout.item_packs,
        layout.item_split_rows.data_ptr(),
        layout.item_split_ptr.data_ptr(), layout.item_split_rows.shape[0],
        x.shape[1],
        out.data_ptr(), partials.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_kernels SpMM launch failed: CUDA error "
                           f"{rc}")


def _check_features(x: torch.Tensor, layout: SpmmLayout):
    if x.device != layout.device:
        raise ValueError(f"features on {x.device}, layout on "
                         f"{layout.device}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("the CUDA SpMM takes a contiguous [N, D] tensor, "
                         f"got shape {tuple(x.shape)} with strides "
                         f"{x.stride()}")
    if x.shape[0] <= layout.max_index:
        raise ValueError(f"feature table of {x.shape[0]} rows; the layout "
                         f"gathers row {layout.max_index}")


def _spmm_cuda(x: torch.Tensor, layout: SpmmLayout) -> torch.Tensor:
    _check_features(x, layout)
    D = x.shape[1]
    out = torch.empty(layout.num_rows, D, dtype=x.dtype, device=x.device)
    partials = torch.empty(layout.item_partials, D, dtype=x.dtype,
                           device=x.device)
    _launch(x, layout, out, partials)
    LAUNCHES_BY_SHAPE[(layout.kind, D)] += 1
    LAUNCHES_BY_LAYOUT[((layout.kind, D), id(layout))] += 1
    return out


def _spmm_one(x: torch.Tensor, layout: SpmmLayout) -> torch.Tensor:
    if use_spmm_kernel(x):
        return _spmm_cuda(x, layout)
    return spmm_reference(x, layout)


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feature, csc, csr):
        ctx.csr = csr
        return _spmm_one(feature, csc)

    @staticmethod
    def backward(ctx, g):
        # d/dfeature: the transposed SpMM — cotangents summed over out-edges
        return _spmm_one(g.contiguous(), ctx.csr), None, None


def spmm(feature: torch.Tensor, csc: SpmmLayout,
         csr: SpmmLayout) -> torch.Tensor:
    """``out[d] = Σ_{edges s→d} feature[s]`` over ``csc``; the gradient
    runs the same kernel over ``csr`` (the graph grouped by source)."""
    return _SpMM.apply(feature, csc, csr)


def _check_weights(x: torch.Tensor, w: torch.Tensor, layout: SpmmLayout,
                   msg_op: str):
    """Raise on what K1w does not take (on any device: the plain version
    computes the same function)."""
    if msg_op not in _OPS:
        raise ValueError(f"msg_op must be 'mul' or 'add', got {msg_op!r}")
    if layout.edge_id is None:
        raise ValueError(f"the {layout.kind} layout was built without edge "
                         "ids; K1w reads its weights through them")
    if (w.ndim != 2 or w.shape[0] != layout.num_edges or w.shape[1] < 1
            or x.ndim != 2 or x.shape[1] % w.shape[1]):
        raise ValueError(f"weights of shape {tuple(w.shape)} for "
                         f"{layout.num_edges} edges and features of shape "
                         f"{tuple(x.shape)}: K1w takes [E, H] with H | D")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"weights {w.dtype} on {w.device}, features "
                         f"{x.dtype} on {x.device}")


def _weighted_forward(x, w, layout, msg_op):
    if not use_spmm_kernel(x):
        return spmm_weighted_reference(x, w, layout, msg_op)
    _check_features(x, layout)
    if not w.is_contiguous():
        raise ValueError("the CUDA weighted SpMM takes contiguous weights")
    D, H = x.shape[1], w.shape[1]
    out = torch.empty(layout.num_rows, D, dtype=x.dtype, device=x.device)
    partials = torch.empty(layout.item_partials, D, dtype=x.dtype,
                           device=x.device)
    _launch_weighted(x, w, layout, out, partials, _OPS[msg_op])
    LAUNCHES_BY_SHAPE[(msg_op, layout.kind, D, H)] += 1
    return out


def _weighted_backward(g, x, w, csr, msg_op, need_dx, need_dw):
    """(dx, dw) of K1w over the transposed layout ``csr``: one launch on a
    CUDA tensor, the plain versions on a CPU one; None for a gradient not
    needed."""
    H = w.shape[1]
    if not use_spmm_kernel(g):
        dx = dw = None
        if need_dx:
            dx = (spmm_weighted_reference(g, w, csr, "mul")
                  if msg_op == "mul" else spmm_reference(g, csr))
        if need_dw:
            dw = weight_grad_reference(g, x, csr, H, msg_op)
        return dx, dw
    mul = msg_op == "mul"
    if not (mul or need_dw):
        return _spmm_cuda(g, csr), None  # add's dx is K1's transposed sum
    _check_features(g, csr)
    D = g.shape[1]
    dx = partials = dw = None
    if need_dx:
        dx = torch.empty(csr.num_rows, D, dtype=g.dtype, device=g.device)
        partials = torch.empty(csr.item_partials, D, dtype=g.dtype,
                               device=g.device)
    if need_dw:
        dw = torch.empty(csr.num_edges, H, dtype=g.dtype, device=g.device)
    _launch_weighted(g, w, csr, dx, partials, 1 if mul and need_dx else 0,
                     _OPS[msg_op] if need_dw else 0,
                     x if mul and need_dw else None, dw)
    key = msg_op if need_dx else f"{msg_op}_dw"
    LAUNCHES_BY_SHAPE[(key, csr.kind, D, H)] += 1
    return dx, dw


class _SpMMWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feature, w, csc, csr, msg_op):
        ctx.csr, ctx.msg_op = csr, msg_op
        ctx.save_for_backward(feature, w)
        return _weighted_forward(feature, w, csc, msg_op)

    @staticmethod
    def backward(ctx, g):
        feature, w = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        if not (need_dx or need_dw):
            return None, None, None, None, None
        dx, dw = _weighted_backward(g.contiguous(), feature, w, ctx.csr,
                                    ctx.msg_op, need_dx, need_dw)
        return dx, dw, None, None, None


def spmm_weighted(feature: torch.Tensor, w: torch.Tensor, csc: SpmmLayout,
                  csr: SpmmLayout, msg_op: str = "mul") -> torch.Tensor:
    """K1w: ``out[d] = Σ_{edges e: s→d} feature[s] ⊛ w[e]`` over ``csc``,
    ⊛ ``msg_op`` ("mul" or "add"), ``feature`` [N, D], ``w`` [E, H] with
    H | D in the graph's original edge order (H = 1: a scalar a edge; H =
    D: elementwise; between: one weight a head of ``D / H`` columns). The
    gradient runs over ``csr``: dx is the transposed SpMM (weighted for
    mul), dw comes back in the original edge order. Both layouts need
    their ``edge_id``."""
    for layout in (csc, csr):
        _check_weights(feature, w, layout, msg_op)
    return _SpMMWeighted.apply(feature, w, csc, csr, msg_op)


class _SegSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, layout):
        ctx.layout = layout
        return _spmm_one(msgs, layout)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.layout.seg_ids), None


def sorted_segment_sum(msgs: torch.Tensor, seg_ids, indptr,
                       num_segments: int) -> torch.Tensor:
    """Sum of the rows of ``msgs`` [E, D] by sorted segment ids.

    Builds the layout from the concrete ``indptr`` (``seg_ids`` must be
    its expansion); meant for tests and one-off use — hot paths build a
    :class:`SpmmLayout` once and call :func:`spmm`. Backward is a gather.
    """
    indptr = np.asarray(indptr.cpu() if torch.is_tensor(indptr) else indptr)
    seg = np.asarray(seg_ids.cpu() if torch.is_tensor(seg_ids) else seg_ids)
    layout = build_spmm_layout(indptr, np.arange(msgs.shape[0]),
                               num_segments, kind="segment",
                               device=msgs.device)
    if not np.array_equal(seg, np.asarray(layout.seg_ids.cpu())):
        raise ValueError("seg_ids must be sorted and agree with indptr")
    return _SegSum.apply(msgs, layout)
