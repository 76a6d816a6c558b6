"""Knowledge-graph embedding models — Graph4KG capability (port of
``pgl_tpu/models/kg.py``; reference: ``apps/Graph4KG``: score functions in
``models/score_funcs.py``, training loop ``train.py:34-120``, negative
sampling modes full/batch/chunk, filtered MRR/Hits@k evaluation).

Entities and relations are dense tensors (or, for the entity table, a
row-sharded :class:`~pgl_tpu_torch.parallel.ShardedEmbedding`, one block
a rank: :func:`sharded_kg_params`); scoring is batched — negative scores
are computed against candidate *matrices* (a GEMM for the bilinear
scores, a broadcast elsewhere) rather than per-sample loops. Every score
takes leading batch dimensions: ``neg_score`` of ``[..., B, d]`` rows
against ``[..., K, d]`` candidates is ``[..., B, K]``, so a chunked batch
is one call. Gathers and elementwise math only: no kernel of ours.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

__all__ = ["TransEScore", "DistMultScore", "ComplExScore", "RotatEScore",
           "QuatEScore", "OTEScore", "KGEModel", "filtered_ranks",
           "sample_negatives", "sharded_kg_params", "mrr_hits"]


class ScoreFunc:
    """score(h, r, t) — higher is better. ``neg_score`` scores each positive
    (h, r) against a ``[..., K, d]`` candidate tail matrix (or heads when
    ``neg_head``)."""

    def __call__(self, head, rel, tail):
        raise NotImplementedError

    def neg_score(self, head, rel, tail, candidates, neg_head: bool = False):
        cand = candidates.unsqueeze(-3)
        if neg_head:
            return self(cand, rel.unsqueeze(-2), tail.unsqueeze(-2))
        return self(head.unsqueeze(-2), rel.unsqueeze(-2), cand)


class TransEScore(ScoreFunc):
    """γ - ||h + r - t||_p (Bordes et al., 2013)."""

    def __init__(self, gamma: float = 12.0, p: int = 1):
        self.gamma = gamma
        self.p = p

    def __call__(self, head, rel, tail):
        diff = head + rel - tail
        if self.p == 1:
            dist = diff.abs().sum(-1)
        else:
            dist = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        return self.gamma - dist


class DistMultScore(ScoreFunc):
    """Σ h∘r∘t (Yang et al., 2015)."""

    def __call__(self, head, rel, tail):
        return (head * rel * tail).sum(-1)

    def neg_score(self, head, rel, tail, candidates, neg_head: bool = False):
        # bilinear: one [B, d] x [d, K] GEMM instead of a [B, K, d] reduce
        lhs = rel * (tail if neg_head else head)
        return lhs @ candidates.transpose(-1, -2)


class ComplExScore(ScoreFunc):
    """Re(<h, r, conj(t)>) with interleaved complex halves
    (Trouillon et al., 2016)."""

    def __call__(self, head, rel, tail):
        hr, hi = head.chunk(2, -1)
        rr, ri = rel.chunk(2, -1)
        tr, ti = tail.chunk(2, -1)
        return (hr * rr * tr + hi * rr * ti
                + hr * ri * ti - hi * ri * tr).sum(-1)

    def neg_score(self, head, rel, tail, candidates, neg_head: bool = False):
        # linear in the candidate side: fold (fixed, rel) into per-half
        # coefficients and run one GEMM against the raw candidate matrix
        rr, ri = rel.chunk(2, -1)
        if neg_head:
            tr, ti = tail.chunk(2, -1)
            a = rr * tr + ri * ti          # coeff of candidate real half
            b = rr * ti - ri * tr          # coeff of candidate imag half
        else:
            hr, hi = head.chunk(2, -1)
            a = hr * rr - hi * ri
            b = hi * rr + hr * ri
        return torch.cat([a, b], -1) @ candidates.transpose(-1, -2)


class RotatEScore(ScoreFunc):
    """γ - ||h ∘ e^{iθ_r} - t|| — relations as unit complex rotations
    (Sun et al., 2019). Relation embeddings hold the phases θ (dim d/2)."""

    def __init__(self, gamma: float = 12.0, embed_dim: int = 256,
                 epsilon: float = 2.0):
        self.gamma = gamma
        # phase scale as in the paper: (γ+ε)/d per dimension
        self.emb_init = (gamma + epsilon) / (embed_dim // 2)

    def __call__(self, head, rel, tail):
        hr, hi = head.chunk(2, -1)
        tr, ti = tail.chunk(2, -1)
        phase = rel / (self.emb_init / np.pi)
        rr, ri = torch.cos(phase), torch.sin(phase)
        dr = hr * rr - hi * ri - tr
        di = hr * ri + hi * rr - ti
        dist = torch.sqrt(dr * dr + di * di + 1e-12).sum(-1)
        return self.gamma - dist


class QuatEScore(ScoreFunc):
    """Quaternion rotations (Zhang et al., 2019): normalize r to unit
    quaternions, rotate h, inner-product with t."""

    def __call__(self, head, rel, tail):
        ha, hb, hc, hd = head.chunk(4, -1)
        ra, rb, rc, rd = rel.chunk(4, -1)
        ta, tb, tc, td = tail.chunk(4, -1)
        norm = torch.sqrt(ra**2 + rb**2 + rc**2 + rd**2 + 1e-12)
        ra, rb, rc, rd = ra / norm, rb / norm, rc / norm, rd / norm
        # Hamilton product h ⊗ r
        a = ha * ra - hb * rb - hc * rc - hd * rd
        b = ha * rb + hb * ra + hc * rd - hd * rc
        c = ha * rc - hb * rd + hc * ra + hd * rb
        d = ha * rd + hb * rc - hc * rb + hd * ra
        return (a * ta + b * tb + c * tc + d * td).sum(-1)


class OTEScore(ScoreFunc):
    """Orthogonal transform embedding (Tang et al., 2020): relation holds
    ``num_blocks`` square matrices, orthonormalized by a QR (Householder,
    as LAPACK's and ``jnp.linalg.qr``'s), applied blockwise to the head;
    score is γ - ||OTE(h, r) - t||."""

    def __init__(self, gamma: float = 12.0, num_blocks: int = 4):
        self.gamma = gamma
        self.num_blocks = num_blocks

    def _orthonormal(self, rel, sub):
        mats = rel.reshape(rel.shape[:-1] + (self.num_blocks, sub, sub))
        q, _ = torch.linalg.qr(mats)
        return q

    def __call__(self, head, rel, tail):
        d = head.shape[-1]
        sub = d // self.num_blocks
        q = self._orthonormal(rel, sub)
        h = head.reshape(head.shape[:-1] + (self.num_blocks, sub, 1))
        out = (q @ h).squeeze(-1)
        out = out.reshape(out.shape[:-2] + (d,))
        return self.gamma - (out - tail).abs().sum(-1)


SCORE_FUNCS = {
    "transe": TransEScore,
    "distmult": DistMultScore,
    "complex": ComplExScore,
    "rotate": RotatEScore,
    "quate": QuatEScore,
    "ote": OTEScore,
}


def _rows(table, ids):
    """``table[ids]`` of a tensor, or a ``ShardedEmbedding``'s lookup (a
    collective: every rank calls it together)."""
    if hasattr(table, "lookup"):
        return table.lookup(ids)
    return table[ids]


class KGEModel:
    """Dense-tensor KG embedding trainer state and its loss.

    Args:
      num_ents / num_rels / embed_dim: table shapes (relation dim may differ
        per score func: rotate uses d/2, ote uses num_blocks*sub^2 — pass
        ``rel_dim``).
      score: name in SCORE_FUNCS or a ScoreFunc instance.
      adversarial_temp: self-adversarial negative weighting (RotatE paper);
        0 disables.
      seed: the tables are ``np.random.default_rng(seed)``'s uniform draws,
        the entity table first, equal bit for bit to ``pgl_tpu``'s.
      device: where ``params`` live (default: the CUDA card). They are leaf
        tensors that require grad, for a ``torch.optim`` optimizer.
    """

    def __init__(self, num_ents: int, num_rels: int, embed_dim: int,
                 score="transe", rel_dim: Optional[int] = None,
                 gamma: float = 12.0, adversarial_temp: float = 1.0,
                 seed: int = 0, device=None):
        if isinstance(score, str):
            cls = SCORE_FUNCS[score.lower()]
            if cls is TransEScore:
                self.score = cls(gamma)
            elif cls is RotatEScore:
                self.score = cls(gamma, embed_dim)
            elif cls is OTEScore:
                self.score = cls(gamma)
            else:
                self.score = cls()
            self._score_name = score.lower()
        else:
            self.score = score
            # 'RotatEScore' -> 'rotate', so rel_dim/init logic applies to
            # instances the same as to string names
            name = type(score).__name__.lower()
            self._score_name = name[:-5] if name.endswith("score") else name
        self.device = resolve_device(device)
        self.num_ents = num_ents
        self.num_rels = num_rels
        self.embed_dim = embed_dim
        rel_dim = rel_dim or {
            "rotate": embed_dim // 2}.get(self._score_name, embed_dim)
        rng = np.random.default_rng(seed)
        # RotatE's embedding range is (γ+ε)/complex_dim — the score maps
        # phases by the SAME constant, so a /embed_dim init would confine
        # rotations to half the phase space
        if self._score_name == "rotate":
            scale = (gamma + 2.0) / (embed_dim // 2)
        else:
            scale = (gamma + 2.0) / embed_dim
        self.params = {
            "ent": torch.tensor(rng.uniform(
                -scale, scale, (num_ents, embed_dim)).astype(np.float32),
                device=self.device, requires_grad=True),
            "rel": torch.tensor(rng.uniform(
                -scale, scale, (num_rels, rel_dim)).astype(np.float32),
                device=self.device, requires_grad=True),
        }
        self.adversarial_temp = adversarial_temp

    def loss_fn(self, params, h, r, t, neg_ents, neg_head: bool = False):
        """Logsigmoid loss with self-adversarial negative weighting.

        ``neg_ents`` encodes the reference's three negative modes
        (``apps/Graph4KG/dataset/dataset.py:115-131``):

        * ``[K]``    — one candidate pool shared by the whole batch.
        * ``[C, K]`` — ``C`` chunks (``C`` divides B) each sharing a pool
          ('chunk' mode; with ``C == B`` this is per-triplet negatives,
          i.e. the 'batch'/'full' modes after sampling).

        ``params["ent"]`` may be a ``ShardedEmbedding`` (every rank calls
        together, each with its own batch).
        """
        ent, rel = params["ent"], params["rel"]
        he, re_, te = _rows(ent, h), rel[r], _rows(ent, t)
        pos = self.score(he, re_, te)
        cand = _rows(ent, neg_ents)                # [K, d] or [C, K, d]
        if neg_ents.ndim == 2:
            C, B = neg_ents.shape[0], he.shape[0]

            def chunks(x):
                return x.reshape((C, B // C) + tuple(x.shape[1:]))

            neg = self.score.neg_score(chunks(he), chunks(re_), chunks(te),
                                       cand, neg_head).reshape(B, -1)
        else:
            neg = self.score.neg_score(he, re_, te, cand, neg_head)
        pos_loss = -F.logsigmoid(pos).mean()
        if self.adversarial_temp > 0:
            w = torch.softmax(neg.detach() * self.adversarial_temp, dim=-1)
            neg_loss = -(w * F.logsigmoid(-neg)).sum(-1).mean()
        else:
            neg_loss = -F.logsigmoid(-neg).mean()
        return (pos_loss + neg_loss) / 2

    def predict_all_tails(self, params, h, r):
        """[B, num_ents] scores for ranking evaluation (pad rows of a
        sharded table excluded; a ``ShardedEmbedding``'s blocks are
        gathered whole first, every rank calling together)."""
        ent, rel = params["ent"], params["rel"]
        if hasattr(ent, "lookup"):
            from ..parallel import comm
            ent = comm.all_gather(ent.table, ent.group).reshape(
                -1, ent.embedding_dim)
        return self.score.neg_score(ent[h], rel[r], None,
                                    ent[:self.num_ents], neg_head=False)


def sample_negatives(h, t, num_ents: int, mode: str, neg_size: int,
                     rng, num_chunks: int = 1):
    """Draw negative entity ids per the reference's three modes
    (``apps/Graph4KG/dataset/dataset.py:115-131``) from the numpy
    generator ``rng``, as ``pgl_tpu``'s draws them:

    * ``'batch'`` — per-triplet negatives drawn from the batch's own
      entities → ``[B, neg_size]``.
    * ``'full'``  — per-triplet negatives drawn uniformly from all
      entities → ``[B, neg_size]``.
    * ``'chunk'`` — the batch splits into ``num_chunks`` groups, each
      sharing ``max(B, neg_size) // num_chunks`` negatives drawn from all
      entities → ``[num_chunks, K]``.

    numpy in, numpy out (ids of a tensor are read back first).
    """
    h = np.asarray(h.cpu() if torch.is_tensor(h) else h)
    t = np.asarray(t.cpu() if torch.is_tensor(t) else t)
    B = len(h)
    if mode == "batch":
        pool = np.unique(np.concatenate([h, t]))
        return pool[rng.integers(0, len(pool), (B, neg_size))]
    if mode == "full":
        return rng.integers(0, num_ents, (B, neg_size))
    if mode == "chunk":
        k = max(B, neg_size) // max(num_chunks, 1)
        return rng.integers(0, num_ents, (num_chunks, k))
    raise ValueError(f"neg_sample_type {mode!r} not supported "
                     "(batch/full/chunk)")


def sharded_kg_params(model: "KGEModel", group=None, device=None):
    """The model's entity table row-sharded over the ranks of ``group``
    (a :class:`~pgl_tpu_torch.parallel.ShardedEmbedding`: this rank's
    block of the model's rows, pad rows 0) and the (small) relation table
    replicated on this rank's device — the rank-a-process form of the
    reference's multi-GPU ``dist_train`` path
    (``apps/Graph4KG/train.py:34-120``). Every rank builds the same model
    (same seed) and calls this together. ``pgl_tpu``'s takes a mesh and an
    axis instead."""
    from ..parallel import ShardedEmbedding
    ent = model.params["ent"].detach()
    emb = ShardedEmbedding(model.num_ents, model.embed_dim, group=group,
                           device=device)
    lo = emb.rank * emb.block_rows
    block = torch.zeros_like(emb.table)
    rows = ent[lo:lo + emb.block_rows].to(block.device)
    block[:rows.shape[0]] = rows
    emb.set_params(block)
    rel = model.params["rel"].detach().to(emb.device).clone()
    return {"ent": emb, "rel": rel.requires_grad_(True)}


def filtered_ranks(scores, true_idx, filter_mask=None):
    """Ranks of the true entities under optional filtering.

    ``scores`` [B, N] (higher better), ``true_idx`` [B];
    ``filter_mask`` [B, N] True at known-positive entries to exclude
    (the true entry is always kept).
    """
    scores = torch.as_tensor(scores)
    true_idx = torch.as_tensor(true_idx, device=scores.device).to(
        torch.int64)
    B = scores.shape[0]
    true_scores = scores[torch.arange(B, device=scores.device), true_idx]
    if filter_mask is not None:
        filter_mask = torch.as_tensor(filter_mask, device=scores.device)
        keep_true = F.one_hot(true_idx, scores.shape[1]).to(torch.bool)
        scores = torch.where(filter_mask & ~keep_true,
                             torch.full_like(scores, -math.inf), scores)
    return (scores > true_scores[:, None]).sum(-1) + 1


def mrr_hits(ranks, ks=(1, 3, 10)) -> Dict[str, float]:
    if torch.is_tensor(ranks):
        ranks = ranks.cpu().numpy()
    ranks = np.asarray(ranks, dtype=np.float64)
    out = {"mrr": float((1.0 / ranks).mean())}
    for k in ks:
        out[f"hits@{k}"] = float((ranks <= k).mean())
    return out
