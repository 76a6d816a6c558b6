"""Message — the segment-bucketed view handed to ``Graph.recv``'s reduce
functions.

Port of ``pgl_tpu/message.py``: the message dict is paired with the sorted
segment ids of the graph's CSC (or CSR) index, so every reduce is a sorted
segment reduce. Messages arrive in the original edge order and are put in
segment order through ``eid`` on first access; every gather is
``index_select``.
"""

from __future__ import annotations

from typing import Dict

from .ops import segment as S

__all__ = ["Message"]


class Message:
    def __init__(self, msg: Dict, segment_ids, num_segments: int, eid=None):
        """``msg`` maps a name to a per-edge tensor in the original edge
        order; ``eid`` (optional) is each segment-order position's edge."""
        self._msg = msg
        self._segment_ids = segment_ids
        self._num_segments = num_segments
        self._eid = eid
        self._permuted = {}

    @property
    def segment_ids(self):
        return self._segment_ids

    def __getitem__(self, name):
        """The message ``name`` in segment order (gathered once)."""
        value = self._msg[name]
        if self._eid is None:
            return value
        if name not in self._permuted:
            self._permuted[name] = value.index_select(0, self._eid)
        return self._permuted[name]

    def reduce(self, msg, pool_type: str = "sum"):
        """Reduce a per-edge tensor (in segment order) by segment."""
        return S.segment_pool(msg, self._segment_ids, pool_type,
                              num_segments=self._num_segments)

    def reduce_sum(self, msg):
        return self.reduce(msg, "sum")

    def reduce_mean(self, msg):
        return self.reduce(msg, "mean")

    def reduce_max(self, msg):
        return self.reduce(msg, "max")

    def reduce_min(self, msg):
        return self.reduce(msg, "min")

    def reduce_softmax(self, msg):
        """Softmax of per-edge logits within each segment."""
        return S.segment_softmax(msg, self._segment_ids,
                                 num_segments=self._num_segments)

    def edge_expand(self, msg):
        """Per-segment values broadcast back onto the edges (the inverse of
        a reduce)."""
        return msg.index_select(0, self._segment_ids)
