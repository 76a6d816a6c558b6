"""Sorted-segment SpMM: the kernel behind ``send_u_recv`` sum and mean.

Port of ``pgl_tpu/ops/pallas/segment_kernels.py`` (``_kernel`` and
``_fused_kernel``; ``spmm`` and ``sorted_segment_sum``) onto one CUDA kernel
for Hopper, ``csrc/segment_kernels.cu``, whose note gives the design.

* :func:`build_spmm_layout` cuts every row of a sorted adjacency into
  pieces of at most ``ET`` edges on the host (numpy) — the work list the
  kernel walks, one warp per piece.
* :func:`spmm` is an autograd ``Function``: forward over the CSC layout,
  backward the same kernel over the CSR layout (the transposed SpMM).
* :func:`sorted_segment_sum` is the same kernel with the identity gather;
  its backward is a gather.
* :func:`spmm_reference` is the plain PyTorch version. CPU tensors run it;
  CUDA tensors launch the kernel or raise.

``LAUNCHES_BY_SHAPE`` counts kernel launches by ``(layout.kind, D)``: one per
SpMM call, which is two CUDA launches when a row was split. ``LAUNCHES`` is
their sum.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ... import resolve_device
from ..dispatch import use_spmm_kernel
from . import _build

__all__ = ["SpmmLayout", "build_spmm_layout", "spmm", "spmm_reference",
           "sorted_segment_sum", "ET", "LAUNCHES",
           "LAUNCHES_BY_SHAPE", "reset_launches"]

# most edges in one piece (one warp's work): shorter pieces spread a hub
# over more warps, longer ones cut the partials the second launch sums;
# 512 was the fastest of 256..2048 over the GCN step's CSC shapes
# (experiments/torch_spmm/sweep.py); read when a layout is built
ET = 512

LAUNCHES_BY_SHAPE: Counter = Counter()


def __getattr__(name):
    if name == "LAUNCHES":
        return sum(LAUNCHES_BY_SHAPE.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches():
    """Set the launch counts to 0."""
    LAUNCHES_BY_SHAPE.clear()


@dataclass(frozen=True)
class SpmmLayout:
    """A sorted adjacency as the kernel reads it (all int32 on one device).

    indptr:      [R+1] row pointer
    indices:     [E]   gather ids (the source node of each edge for CSC),
                 ascending within each row
    seg_ids:     [E]   row of each edge (the plain version's scatter ids)
    pieces:      [P, 4] (row, begin, end, slot): every row cut into pieces
                 of at most ``ET`` edges; an empty row is one empty piece;
                 ``slot`` is the piece's partial-sum row, or -1 when the row
                 has one piece and the kernel stores its sum directly
    split_rows:  [S]   rows of more than one piece
    split_ptr:   [S+1] their ranges of partial slots, in piece order
    """
    kind: str
    num_rows: int
    num_edges: int
    max_index: int        # largest gather id (-1 without edges)
    num_partials: int
    indptr: torch.Tensor
    indices: torch.Tensor
    seg_ids: torch.Tensor
    pieces: torch.Tensor
    split_rows: torch.Tensor
    split_ptr: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.indices.device


def build_spmm_layout(indptr, indices, num_rows: int, kind: str = "csc",
                      device=None) -> SpmmLayout:
    """Host-side (numpy) build; call once, at ``Graph.tensor()`` time.

    ``indptr`` [R+1] and ``indices`` [E] are a sorted adjacency (CSC:
    ``indices`` are the sources grouped by destination row). ``kind`` names
    the layout in the launch counts.
    """
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
    indices = indices[np.lexsort((indices, seg_ids))]
    pieces, split_rows, split_ptr = cut_rows(indptr, ET)

    device = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return SpmmLayout(
        kind=kind, num_rows=R, num_edges=E,
        max_index=int(indices.max()) if E else -1,
        num_partials=int(split_ptr[-1]),
        indptr=put(indptr), indices=put(indices),
        seg_ids=put(seg_ids), pieces=put(pieces),
        split_rows=put(split_rows), split_ptr=put(split_ptr))


def cut_rows(indptr, size: int):
    """Cut every row of ``indptr`` into pieces of at most ``size`` items
    (an empty row is one empty piece), the work list of a kernel that sums
    each row's pieces into partials and combines them in a second launch.

    Returns ``pieces`` [P, 4] int64 (row, begin, end, slot), where ``slot``
    is the piece's partial row, or -1 when its row has one piece;
    ``split_rows``, the rows of more than one piece; and ``split_ptr``
    [S+1], their ranges of partial slots, in piece order.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    R = len(indptr) - 1
    n_pc = np.maximum(1, -(-np.diff(indptr) // size))
    first = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(n_pc, out=first[1:])
    row = np.repeat(np.arange(R, dtype=np.int64), n_pc)
    begin = indptr[row] + (np.arange(len(row)) - first[row]) * size
    end = np.minimum(begin + size, indptr[row + 1])
    split = n_pc[row] > 1
    slot = np.full(len(row), -1, dtype=np.int64)
    slot[split] = np.arange(int(split.sum()))
    split_rows = np.flatnonzero(n_pc > 1)
    split_ptr = np.zeros(len(split_rows) + 1, dtype=np.int64)
    np.cumsum(n_pc[split_rows], out=split_ptr[1:])
    return (np.stack([row, begin, end, slot], axis=1).reshape(-1, 4),
            split_rows, split_ptr)


def spmm_reference(x: torch.Tensor, layout: SpmmLayout) -> torch.Tensor:
    """The plain version: ``out[r] = Σ_{e in row r} x[indices[e]]``."""
    return x.new_zeros(layout.num_rows, x.shape[1]).index_add_(
        0, layout.seg_ids, x.index_select(0, layout.indices))


def _lib():
    lib = _build.load("segment_kernels")
    fn = lib.pgl_spmm_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, p, p, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, layout, out, partials):
    """One SpMM on the current stream into preallocated ``out`` and
    ``partials``; raises when the launch is refused."""
    rc = _lib()(x.device.index, x.data_ptr(), layout.indices.data_ptr(),
                layout.pieces.data_ptr(), layout.pieces.shape[0],
                layout.split_rows.data_ptr(), layout.split_ptr.data_ptr(),
                layout.split_rows.shape[0], x.shape[1], out.data_ptr(),
                partials.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_kernels SpMM launch failed: CUDA error "
                           f"{rc}")


def _spmm_cuda(x: torch.Tensor, layout: SpmmLayout) -> torch.Tensor:
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
    D = x.shape[1]
    out = torch.empty(layout.num_rows, D, dtype=x.dtype, device=x.device)
    partials = torch.empty(layout.num_partials, D, dtype=x.dtype,
                           device=x.device)
    _launch(x, layout, out, partials)
    LAUNCHES_BY_SHAPE[(layout.kind, D)] += 1
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
