"""pgl_tpu_torch.math — the segment operator namespace (port of
``pgl_tpu/math.py``)."""

from .ops.segment import (
    segment_pool,
    segment_sum,
    segment_mean,
    segment_max,
    segment_min,
    segment_softmax,
    segment_padding,
    segment_topk,
    segment_topk_mask,
    segment_count,
)

__all__ = [
    "segment_pool",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "segment_padding",
    "segment_topk",
    "segment_topk_mask",
    "segment_count",
]
