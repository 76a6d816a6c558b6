"""Message passing on plain segment ops: copy-send, edge-weighted send and
the per-edge combine of endpoint rows.

Port of ``pgl_tpu/ops/message_passing.py:32-104``. Every gather is
``index_select``, whose backward is ``index_add_``: an advanced-index
gather (``x[idx]``) sums a hub's duplicates in one warp in its backward.
Nodes receiving no message produce zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import segment as S

__all__ = ["gather_rows", "send_u_recv", "send_ue_recv", "send_uv"]

_COMBINE = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
}


def gather_rows(feature, index):
    """Row gather ``feature[index]``."""
    return feature.index_select(0, index)


def _broadcast_edge(edge_feat, target_ndim):
    """Right-align broadcast of per-edge values onto gathered [E, ...] rows:
    trailing axes of size 1 appended up to ``target_ndim``."""
    return edge_feat.reshape(edge_feat.shape
                             + (1,) * (target_ndim - edge_feat.ndim))


def _check_op(message_op):
    if message_op not in _COMBINE:
        raise ValueError("message_op must be one of add/sub/mul/div")


def send_u_recv(feature, src, dst, num_nodes: Optional[int] = None,
                reduce_op: str = "sum"):
    """Gather ``feature[src]`` and reduce it onto ``dst`` with ``reduce_op``
    ('sum' | 'mean' | 'max' | 'min')."""
    if num_nodes is None:
        num_nodes = feature.shape[0]
    return S.segment_pool(gather_rows(feature, src), dst, reduce_op,
                          num_segments=num_nodes)


def send_ue_recv(feature, edge_feat, src, dst,
                 num_nodes: Optional[int] = None, message_op: str = "mul",
                 reduce_op: str = "sum"):
    """Gather ``feature[src]``, combine it with ``edge_feat`` ([E] or
    [E, ...], broadcast against the gathered rows) by ``message_op``
    (add/sub/mul/div) and reduce onto ``dst`` with ``reduce_op``."""
    _check_op(message_op)
    if num_nodes is None:
        num_nodes = feature.shape[0]
    msg = gather_rows(feature, src)
    msg = _COMBINE[message_op](msg, _broadcast_edge(edge_feat, msg.ndim))
    return S.segment_pool(msg, dst, reduce_op, num_segments=num_nodes)


def send_uv(src_feat, dst_feat, src, dst, message_op: str = "add"):
    """Per-edge combine of the gathered source and destination rows, in
    edge order: ``[E, ...]``."""
    _check_op(message_op)
    return _COMBINE[message_op](gather_rows(src_feat, src),
                                gather_rows(dst_feat, dst))
