"""Dedup SDDMM: the per-edge combine of endpoint rows behind
``Graph.sddmm_csc``.

Port of ``pgl_tpu/ops/pallas/sddmm_kernels.py`` (``build_sddmm_layout``,
``sddmm_xla_slots``, ``sddmm_dedup``; the Pallas kernel ``_sddmm_kernel``)
onto the CUDA source ``csrc/sddmm_kernels.cu`` (K11), whose note gives the
design.

The output is in the layout's **slot order**: the dedup edge order of
``dedup_kernels._LayoutPrefix`` at 128 destination rows a block and 128
unique sources a window, each (block, window) pair's span of edges padded to
a multiple of 128 slots. ``out[slot] = src[slot_src] ⊛ dst[slot_dst]`` with
⊛ add, sub, mul or div, and pads are 0; ``eid`` maps a slot back to its CSC
edge position (-1 at pads).

* :func:`build_sddmm_layout` is the host (numpy) builder: ``slots``,
  ``eid``, ``slot_src``, ``uv`` and ``slot_dst`` (the reference's
  ``slot_ids``, sentinel ``n_pad`` at pads) equal the reference's array for
  array. The TPU-only tables (``rank_iv``, ``pair_*``, ``tile_*``, which
  drive VMEM copies) are dropped. Two K1 layouts over slot positions carry
  the backward: ``by_src`` (a row a source, its real slots as indices) and
  ``by_dst`` (a row a destination); pads belong to no row.
* :func:`sddmm_reference` is the plain version, the reference's
  ``sddmm_xla_slots``: ``index_select`` gathers, ⊛ in float32, pads 0.
* :func:`sddmm_dedup` is an autograd ``Function``: the forward runs K11 on a
  CUDA tensor and the plain version on a CPU one. The backward has the
  reference's math (``_sddmm_bwd``) and sums the per-slot factors with K1
  over ``by_src`` and ``by_dst`` (the reference: ``segment_sum``), which
  cuts a hub into pieces without atomics, so the gradient has the same bits
  on every run. A forward that ``torch.export`` or ``torch.compile``
  traces (``dispatch.traced``) is the custom op
  ``torch.ops.pgl_tpu_torch.sddmm`` (the slot tables as its arguments; its
  CUDA implementation K11's launch, its CPU one the plain version), so an
  exported program calls K11.

``LAUNCHES_BY_SHAPE`` counts K11's launches by ``("sddmm", op, D)``; the
backward's K1 launches are counted by ``segment_kernels`` under
``("sddmm_src", D)`` and ``("sddmm_dst", D)``. ``LAUNCHES`` is the sum.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ... import resolve_device
from ..dispatch import traced, use_sddmm_kernel
from ..message_passing import _COMBINE
from . import _build
from .dedup_kernels import _LayoutPrefix
from .segment_kernels import SpmmLayout, _spmm_one, build_spmm_layout

__all__ = ["SddmmLayout", "build_sddmm_layout", "sddmm_dedup",
           "sddmm_reference", "NB_SDDMM", "W_SDDMM", "QUANT", "LAUNCHES",
           "LAUNCHES_BY_SHAPE", "reset_launches"]

NB_SDDMM = 128    # destination rows a block (the reference's NB_SDDMM)
W_SDDMM = 128     # unique sources a window (the reference's W_SDDMM)
QUANT = 128       # a pair's span padded to a multiple of this many slots

_OPS = {"add": 0, "sub": 1, "mul": 2, "div": 3}

LAUNCHES_BY_SHAPE: Counter = Counter()


def __getattr__(name):
    if name == "LAUNCHES":
        return sum(LAUNCHES_BY_SHAPE.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches():
    """Set the launch counts to 0."""
    LAUNCHES_BY_SHAPE.clear()


@dataclass(frozen=True)
class SddmmLayout:
    """The slot layout of the dedup SDDMM (tensors on one device, but
    ``uv``).

    uv:        [Upad + W] int32 numpy, on the host: the unique source of
               each row of the blocks' windows (the reference's, with its
               ``+W`` tail); neither K11 nor the backward reads it
    slot_src:  [S] int32 source of each slot (0 at pads)
    slot_dst:  [S] int32 destination of each slot (``n_pad`` at pads)
    eid:       [S] int64 CSC edge position of each slot (-1 at pads)
    by_src:    K1 layout, a row a source over its real slots (backward)
    by_dst:    K1 layout, a row a destination over its real slots
    """
    num_segments: int
    num_edges: int
    slots: int
    n_pad: int
    uv: np.ndarray
    slot_src: torch.Tensor
    slot_dst: torch.Tensor
    eid: torch.Tensor
    by_src: SpmmLayout
    by_dst: SpmmLayout

    @property
    def device(self) -> torch.device:
        return self.slot_src.device


def build_sddmm_layout(indptr, sorted_v, num_segments: int,
                       device=None) -> Optional[SddmmLayout]:
    """Host-side (numpy) build from the CSC index (``indptr`` [N+1],
    ``sorted_v`` [E] the sources grouped by destination); O(E log E).
    Returns None for a graph without edges. Sources must lie in ``[0,
    num_segments)``: the gradient has a row for each of them."""
    indptr = np.asarray(indptr, dtype=np.int64)
    sorted_v = np.asarray(sorted_v, dtype=np.int64)
    E, N = len(sorted_v), int(num_segments)
    if E == 0:
        return None
    if sorted_v.min() < 0 or sorted_v.max() >= N:
        raise ValueError(f"source ids in [{sorted_v.min()}, "
                         f"{sorted_v.max()}] outside [0, {N})")
    pre = _LayoutPrefix(indptr, sorted_v, N, nb=NB_SDDMM, w=W_SDDMM)
    n_pad = -(-N // NB_SDDMM) * NB_SDDMM
    span = pre.ends - pre.starts
    span_pad = -(-span // QUANT) * QUANT    # each pair owns whole quanta
    slot_off = np.zeros(pre.P + 1, np.int64)
    np.cumsum(span_pad, out=slot_off[1:])
    S = int(slot_off[-1])
    if S >= 2 ** 31 or n_pad >= 2 ** 31:
        raise ValueError(f"int32 layout: {S} slots / {N} rows would wrap "
                         "— shard the graph first")
    # the slot of edge k of the dedup order: its pair's first slot plus its
    # position in the pair's span
    epair = np.repeat(np.arange(pre.P, dtype=np.int64), span)
    eslot = slot_off[epair] + np.arange(E) - np.repeat(pre.starts, span)
    slot_dst = np.full(S, n_pad, np.int64)
    slot_dst[eslot] = pre.dst_o
    slot_src = np.zeros(S, np.int64)
    slot_src[eslot] = pre.src_o
    eid = np.full(S, -1, np.int64)
    eid[eslot] = pre.order
    # the backward's K1 layouts: destinations keep the CSC row pointer (the
    # slot of each CSC position as indices), sources are grouped by a
    # stable sort
    csc_slot = np.empty(E, np.int64)
    csc_slot[pre.order] = eslot
    by_src_order = np.argsort(pre.src_o, kind="stable")
    src_ptr = np.zeros(N + 1, np.int64)
    np.cumsum(np.bincount(pre.src_o, minlength=N), out=src_ptr[1:])
    device = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return SddmmLayout(
        num_segments=N, num_edges=E, slots=S, n_pad=n_pad,
        uv=np.asarray(pre.uv, dtype=np.int32), slot_src=put(slot_src), slot_dst=put(slot_dst),
        eid=torch.as_tensor(eid, device=device),
        by_src=build_spmm_layout(src_ptr, eslot[by_src_order], N,
                                 kind="sddmm_src", device=device),
        by_dst=build_spmm_layout(indptr, csc_slot, N, kind="sddmm_dst",
                                 device=device))


def _slots_layout(slot_src, slot_dst, num_segments: int) -> SddmmLayout:
    """A layout of the slot tables alone: what K11 and its plain version
    read (the custom op's arguments)."""
    return SddmmLayout(num_segments=num_segments, num_edges=-1,
                       slots=slot_src.shape[0], n_pad=-1, uv=None,
                       slot_src=slot_src, slot_dst=slot_dst, eid=None,
                       by_src=None, by_dst=None)


def _gather_dst(dst: torch.Tensor, layout: SddmmLayout) -> torch.Tensor:
    """``dst[slot_dst]`` with pads reading the last row (the reference's
    ``min(ids, N - 1)``)."""
    return dst.index_select(0, layout.slot_dst.clamp(
        max=layout.num_segments - 1))


def sddmm_reference(src: torch.Tensor, dst: torch.Tensor,
                    layout: SddmmLayout, op: str = "mul") -> torch.Tensor:
    """The plain version of K11 (the reference's ``sddmm_xla_slots``):
    ``[S, D]`` float32, ``src[slot_src] ⊛ dst[slot_dst]``, pads 0."""
    out = _COMBINE[op](src.index_select(0, layout.slot_src).float(),
                       _gather_dst(dst, layout).float())
    pad = (layout.slot_dst >= layout.num_segments).unsqueeze(1)
    return out.masked_fill(pad, 0.0)


def _lib():
    lib = _build.load("sddmm_kernels")
    if lib.pgl_sddmm_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pgl_sddmm_f32.argtypes = [i, i, p, p, p, p, ctypes.c_longlong, i,
                                      i, p, p]
        lib.pgl_sddmm_f32.restype = ctypes.c_int
    return lib


def _launch(src, dst, layout: SddmmLayout, op: str, out):
    """One K11 launch on the current stream into preallocated ``out`` [S,
    D]; raises when the launch is refused."""
    rc = _lib().pgl_sddmm_f32(
        src.device.index, _OPS[op], src.data_ptr(), dst.data_ptr(),
        layout.slot_src.data_ptr(), layout.slot_dst.data_ptr(), layout.slots,
        layout.num_segments, src.shape[1], out.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sddmm_kernels launch failed: CUDA error {rc}")


def _forward(src, dst, layout: SddmmLayout, op: str) -> torch.Tensor:
    if traced(src):
        use_sddmm_kernel(src)       # raises on what K11 does not take
        return _sddmm_op(src, dst, layout.slot_src, layout.slot_dst,
                         layout.num_segments, op)
    if not use_sddmm_kernel(src):
        return sddmm_reference(src, dst, layout, op)
    return _forward_cuda(src, dst, layout, op)


def _forward_cuda(src, dst, layout: SddmmLayout, op: str) -> torch.Tensor:
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("the CUDA SDDMM takes contiguous [N, D] tensors")
    D = src.shape[1]
    out = torch.empty(layout.slots, D, dtype=torch.float32, device=src.device)
    _launch(src, dst, layout, op, out)
    LAUNCHES_BY_SHAPE[("sddmm", op, D)] += 1
    return out


@torch.library.custom_op("pgl_tpu_torch::sddmm", mutates_args=(),
                         device_types="cpu")
def _sddmm_op(src: torch.Tensor, dst: torch.Tensor, slot_src: torch.Tensor,
              slot_dst: torch.Tensor, num_segments: int,
              op: str) -> torch.Tensor:
    """K11 as an operator: the plain version on the CPU."""
    return sddmm_reference(src, dst, _slots_layout(slot_src, slot_dst,
                                                   num_segments), op)


@_sddmm_op.register_kernel("cuda")
def _sddmm_op_cuda(src, dst, slot_src, slot_dst, num_segments, op):
    use_sddmm_kernel(src)
    return _forward_cuda(src, dst, _slots_layout(slot_src, slot_dst,
                                                 num_segments), op)


@_sddmm_op.register_fake
def _sddmm_op_fake(src, dst, slot_src, slot_dst, num_segments, op):
    return src.new_empty(slot_src.shape[0], src.shape[1],
                         dtype=torch.float32)


class _SddmmDedup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, dst, layout, op):
        ctx.layout, ctx.op = layout, op
        if op in ("mul", "div"):           # add/sub's backward reads neither
            ctx.save_for_backward(src, dst)
        return _forward(src, dst, layout, op)

    @staticmethod
    def backward(ctx, g):
        lay, op = ctx.layout, ctx.op
        need_src, need_dst = ctx.needs_input_grad[:2]
        g = g.contiguous()
        # the per-slot factors of _sddmm_bwd; pads need no mask, as no row
        # of by_src or by_dst reads them
        gs = gd = g
        if op in ("mul", "div"):
            src, dst = ctx.saved_tensors
            # mul's ddst needs xs alone
            xd = (_gather_dst(dst, lay) if need_src or op == "div"
                  else None)
            xs = src.index_select(0, lay.slot_src) if need_dst else None
            if op == "mul":
                gs = g * xd if need_src else None
                gd = g * xs if need_dst else None
            else:
                gs = g / xd if need_src else None
                gd = -g * xs / (xd * xd) if need_dst else None
        dsrc = _spmm_one(gs, lay.by_src) if need_src else None
        ddst = _spmm_one(gd, lay.by_dst) if need_dst else None
        if op == "sub" and ddst is not None:
            ddst = -ddst                       # the sum of -g, exactly
        return dsrc, ddst, None, None


def sddmm_dedup(src: torch.Tensor, dst: torch.Tensor, layout: SddmmLayout,
                op: str = "mul") -> torch.Tensor:
    """``out[slot] = src[slot_src] ⊛ dst[slot_dst]`` in the layout's slot
    order: ``[S, D]`` float32, pads 0; map real slots to CSC edge positions
    with ``layout.eid``. ``src`` and ``dst`` are ``[N, D]`` float32 on the
    layout's device. The gradient sums the per-slot factors with K1 over
    ``by_src`` and ``by_dst``."""
    if op not in _OPS:
        raise ValueError(f"op must be one of add/sub/mul/div, got {op!r}")
    N = layout.num_segments
    if (src.ndim != 2 or src.shape != dst.shape or src.shape[0] != N):
        raise ValueError(f"the SDDMM takes two [N, D] features with N = {N}, "
                         f"got src {tuple(src.shape)} and dst "
                         f"{tuple(dst.shape)}")
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.float32:
            raise TypeError(f"the SDDMM takes float32 features, {name} is "
                            f"{t.dtype}")
        if t.device != layout.device:
            raise ValueError(f"{name} on {t.device}, layout on "
                             f"{layout.device}")
    return _SddmmDedup.apply(src, dst, layout, op)
