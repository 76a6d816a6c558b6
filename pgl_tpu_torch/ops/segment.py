"""Segment reductions on ``index_add_`` and ``scatter_reduce``, and the
segment padding and top-k selections built on them.

Port of ``pgl_tpu/ops/segment.py:43-240`` with the reference contract:
a segment that receives no element gives 0, and the mean divides by
max(count, 1).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_count", "segment_sum", "segment_mean", "segment_max",
           "segment_min", "segment_pool", "segment_softmax",
           "segment_padding", "segment_topk", "segment_topk_mask"]


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
    shift by the segment's max (no gradient through it; the shift of an
    empty segment, or of one whose max is not finite, is 0, so an all
    ``-inf`` segment gives zeros), exponentiate, divide by the segment's sum
    floored at the dtype's ``tiny`` (``pgl_tpu/ops/segment.py:108-127``).
    The two gathers are ``index_select``, whose backward is ``index_add_``."""
    n = _num_segments(segment_ids, num_segments)
    seg_max = segment_max(data.detach(), segment_ids, n)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    exp = torch.exp(data - seg_max.index_select(0, segment_ids))
    denom = segment_sum(exp, segment_ids, n).clamp(
        min=torch.finfo(exp.dtype).tiny)
    return exp / denom.index_select(0, segment_ids)


def segment_padding(data, segment_ids, num_segments: Optional[int] = None,
                    max_len: Optional[int] = None):
    """Scatter sorted segments into a dense ``[num_segments, max_len, ...]``
    tensor (``pgl_tpu/ops/segment.py:130-163``). Returns ``(padded, mask,
    max_len)``, ``mask`` a bool ``[num_segments, max_len]`` of the valid
    positions; ``max_len`` defaults to the largest segment, and a segment
    longer than it keeps its first ``max_len`` elements."""
    segment_ids = segment_ids.long()
    n = _num_segments(segment_ids, num_segments)
    count = segment_count(segment_ids, n)
    if max_len is None:
        max_len = int(count.max()) if count.numel() else 0
    starts = torch.cumsum(count, 0) - count
    pos = torch.arange(segment_ids.shape[0], device=segment_ids.device) \
        - starts.index_select(0, segment_ids)
    keep = pos < max_len
    flat = (segment_ids * max_len + pos)[keep]
    padded = data.new_zeros((n * max_len,) + data.shape[1:]).index_copy(
        0, flat, data[keep])
    padded = padded.reshape((n, max_len) + data.shape[1:])
    mask = (torch.arange(max_len, device=count.device)[None, :]
            < count.clamp(max=max_len)[:, None])
    return padded, mask, max_len


def segment_topk_mask(score, segment_ids, num_segments: Optional[int] = None,
                      ratio: float = 0.5, min_score: Optional[float] = None):
    """Per-segment top-k as a bool keep-mask over the elements
    (``pgl_tpu/ops/segment.py:166-204``): an element is kept when it is
    among the ``ceil(ratio * segment_size)`` highest scores of its segment
    (ties toward the earlier index), or, with ``min_score``, when its score
    is at least ``min(segment max, min_score)``, so every segment keeps its
    best element."""
    score = score.reshape(-1)
    n = _num_segments(segment_ids, num_segments)
    if min_score is not None:
        thresh = segment_max(score, segment_ids, n).clamp(max=min_score)
        return score >= thresh.index_select(0, segment_ids)
    count = segment_count(segment_ids, n)
    # order by (segment, score descending, index): two stable sorts
    by_score = torch.argsort(-score, stable=True)
    order = by_score.index_select(0, torch.argsort(
        segment_ids.index_select(0, by_score), stable=True))
    starts = torch.cumsum(count, 0) - count
    seg_sorted = segment_ids.index_select(0, order)
    pos = torch.arange(score.shape[0], device=score.device) \
        - starts.index_select(0, seg_sorted)
    k = torch.ceil(ratio * count.to(score.dtype)).long()
    keep = torch.zeros(score.shape[0], dtype=torch.bool, device=score.device)
    keep[order] = pos < k.index_select(0, seg_sorted)
    return keep


def segment_topk(data, score, segment_ids, num_segments: Optional[int] = None,
                 ratio: float = 0.5, min_score: Optional[float] = None,
                 return_index: bool = True):
    """Per-segment top-k selection with dynamic output shapes
    (``pgl_tpu/ops/segment.py:207-240``): the elements
    :func:`segment_topk_mask` keeps, taken in float64 as the reference's
    host path takes its thresholds and ``k``. Returns ``(data[keep],
    keep)`` or ``data[keep]``, ``keep`` int64 on ``data``'s device: in index
    order with ``min_score``, otherwise segment by segment and in index
    order within each, as the reference orders them."""
    data = torch.as_tensor(data)
    seg = torch.as_tensor(segment_ids, device=data.device).long()
    score = torch.as_tensor(score, device=data.device).reshape(-1).double()
    keep = segment_topk_mask(score, seg, num_segments, ratio,
                             min_score).nonzero().reshape(-1)
    if min_score is None:
        keep = keep.index_select(0, torch.argsort(seg.index_select(0, keep),
                                                  stable=True))
    selected = data.index_select(0, keep)
    return (selected, keep) if return_index else selected
