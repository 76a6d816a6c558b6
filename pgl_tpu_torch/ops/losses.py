"""Loss functions (port of ``pgl_tpu/ops/losses.py``)."""

from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy_integer"]


def softmax_cross_entropy_integer(logits: torch.Tensor,
                                  labels: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy for integer labels: log-sum-exp minus the
    label's logit, selected by a one-hot mask as the reference does
    (``pgl_tpu/ops/losses.py:28-32``). A label outside ``[0, C)`` selects
    nothing, so its loss is the row's log-sum-exp; no index is read, so
    the card raises no device-side assert."""
    classes = torch.arange(logits.shape[-1], device=labels.device)
    onehot = classes == labels.unsqueeze(-1)
    label_logit = torch.where(onehot, logits, 0.0).sum(-1)
    return torch.logsumexp(logits, dim=-1) - label_logit
