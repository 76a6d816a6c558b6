"""Shared pieces of the walk-based unsupervised trainers (port of
``pgl_tpu/apps/common.py``).

The trainers (UnsupervisedGraphTrainer, PGLBox; Graph4Rec in the
reference) train skip-gram objectives with in-batch shuffled negatives (the
PGLBox ``shuffle_batch`` analog, reference
``apps/PGLBox/src/models/gnn_model.py:158-161``); the negative drawing and
the loss live here so a fix lands once.

:func:`inbatch_skipgram_loss` draws its permutation from a
``torch.Generator`` and calls :func:`_inbatch_skipgram_loss`, a function of
the draw: fed the reference's ``jax.random.permutation``, it gives the
reference's loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["inbatch_skipgram_loss"]


def inbatch_skipgram_loss(h, pos_ctx, generator: torch.Generator,
                          neg_num: int, valid=None,
                          neg_reduce: str = "mean"):
    """Skip-gram loss with negatives drawn from other batch rows' contexts.

    Args:
      h: ``[B, D]`` source embeddings.
      pos_ctx: ``[B, D]`` positive context embeddings.
      generator: draws the ``B * neg_num`` permutation (on ``h``'s device).
      valid: optional ``[B]`` float mask for zero-padded tail batches.
        Negatives are drawn ONLY from the valid prefix — padded rows must
        not leak into other examples' negatives.
      neg_reduce: "mean" averages the negative term over B*neg_num
        (Graph4Rec/UnsupervisedGraphTrainer convention); "sum" sums the
        per-example negatives before the masked mean (PGLBox convention).
    """
    perm = torch.randperm(h.shape[0] * neg_num, generator=generator,
                          device=h.device)
    return _inbatch_skipgram_loss(h, pos_ctx, perm, neg_num, valid,
                                  neg_reduce)


def _inbatch_skipgram_loss(h, pos_ctx, perm, neg_num: int, valid=None,
                           neg_reduce: str = "mean"):
    """:func:`inbatch_skipgram_loss` given its permutation ``perm`` of
    ``B * neg_num``."""
    B = h.shape[0]
    nv = B if valid is None else valid.sum().to(torch.int64).clamp(min=1)
    neg_ctx = pos_ctx[perm.to(h.device) % nv].reshape(B, neg_num, -1)
    pos = (h * pos_ctx).sum(-1)
    negs = torch.einsum("bd,bkd->bk", h, neg_ctx)
    if valid is None:
        if neg_reduce == "mean":
            return -F.logsigmoid(pos).mean() - F.logsigmoid(-negs).mean()
        per = -F.logsigmoid(pos) - F.logsigmoid(-negs).sum(-1)
        return per.mean()
    if neg_reduce == "mean":
        denom = valid.sum().clamp(min=1.0)
        pos_t = (-F.logsigmoid(pos) * valid).sum() / denom
        neg_t = (-F.logsigmoid(-negs) * valid[:, None]).sum() / (
            denom * neg_num)
        return pos_t + neg_t
    per = -F.logsigmoid(pos) - F.logsigmoid(-negs).sum(-1)
    return (per * valid).sum() / valid.sum().clamp(min=1.0)
