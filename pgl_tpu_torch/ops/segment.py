"""Segment reductions on ``index_add_`` and ``scatter_reduce``.

Port of ``pgl_tpu/ops/segment.py:43-127`` with the reference contract:
a segment that receives no element gives 0, and the mean divides by
max(count, 1).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_count", "segment_sum", "segment_mean", "segment_max",
           "segment_min", "segment_pool", "segment_softmax"]


def _num_segments(segment_ids, num_segments: Optional[int]) -> int:
    if num_segments is not None:
        return int(num_segments)
    return int(segment_ids.max()) + 1 if segment_ids.numel() else 0


def _column(v, like):
    """Reshape a per-segment vector to broadcast against ``like``'s rows."""
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def segment_count(segment_ids, num_segments: Optional[int] = None):
    """Number of elements in each segment, shape ``[num_segments]``."""
    n = _num_segments(segment_ids, num_segments)
    return torch.bincount(segment_ids, minlength=n)[:n]


def segment_sum(data, segment_ids, num_segments: Optional[int] = None):
    """Sum of ``data`` rows sharing a segment id."""
    n = _num_segments(segment_ids, num_segments)
    return data.new_zeros((n,) + data.shape[1:]).index_add_(
        0, segment_ids, data)


def segment_mean(data, segment_ids, num_segments: Optional[int] = None):
    """Mean per segment; empty segments yield 0."""
    n = _num_segments(segment_ids, num_segments)
    total = segment_sum(data, segment_ids, n)
    count = segment_count(segment_ids, n).clamp(min=1).to(total.dtype)
    return total / _column(count, total)


def _segment_extreme(data, segment_ids, n, reduce):
    index = _column(segment_ids.long(), data).expand_as(data)
    # include_self=False leaves empty segments at their initial 0
    return data.new_zeros((n,) + data.shape[1:]).scatter_reduce(
        0, index, data, reduce=reduce, include_self=False)


def segment_max(data, segment_ids, num_segments: Optional[int] = None):
    """Max per segment; empty segments yield 0."""
    return _segment_extreme(data, segment_ids,
                            _num_segments(segment_ids, num_segments), "amax")


def segment_min(data, segment_ids, num_segments: Optional[int] = None):
    """Min per segment; empty segments yield 0."""
    return _segment_extreme(data, segment_ids,
                            _num_segments(segment_ids, num_segments), "amin")


_POOLS = {"sum": segment_sum, "mean": segment_mean,
          "max": segment_max, "min": segment_min}


def segment_pool(data, segment_ids, pool_type: str,
                 num_segments: Optional[int] = None):
    """Dispatch by pool type."""
    fn = _POOLS.get(pool_type.lower())
    if fn is None:
        raise ValueError(
            "We only support sum, mean, max, min pool types in segment_pool.")
    return fn(data, segment_ids, num_segments)


def segment_softmax(data, segment_ids, num_segments: Optional[int] = None):
    """Softmax within each segment, one probability per row of ``data``:
    shift by the segment's max (no gradient through it; an empty segment's
    shift is 0), exponentiate, divide by the segment's sum floored at the
    dtype's ``tiny`` (``pgl_tpu/ops/segment.py:108-127``). The two gathers
    are ``index_select``, whose backward is ``index_add_``."""
    n = _num_segments(segment_ids, num_segments)
    seg_max = segment_max(data.detach(), segment_ids, n)
    exp = torch.exp(data - seg_max.index_select(0, segment_ids))
    denom = segment_sum(exp, segment_ids, n).clamp(
        min=torch.finfo(exp.dtype).tiny)
    return exp / denom.index_select(0, segment_ids)
