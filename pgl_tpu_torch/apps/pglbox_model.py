"""PGLBox model assembly (port of ``pgl_tpu/apps/pglbox_model.py``; the
reference's yaml-configured GNN model stack,
``apps/PGLBox/src/models/gnn_model.py:39``, ``auto_heter_gnn.py:68``,
``layers.py:25-280``).

Sparse id + slot embeddings, an ``AutoHeterEgoGNN`` (per-edge-type
relation layers + feature interaction + heterogeneous residual) over the
padded ego blocks of :class:`~pgl_tpu_torch.sampling.HeteroNeighborSampler`
(``[M, k, D]`` neighbour blocks a relation a depth), and the in-batch
``shuffle_batch`` negative-sampling loss. No kernel of ours runs here: the
blocks are gathers, the layers dense products and reductions over ``k``.

The submodules carry flax's names (``rel_{l}_{etype}``, ``interact_{l}``,
``id_emb``, ``slot_{name}``), so :func:`~pgl_tpu_torch.utils.convert.
load_pglbox_model_params` takes the reference's parameter tree as it is.
A sampled neighbour id may be ``INT32_MIN`` (a masked slot, the padded
sampler's fill); the embedding lookups clamp ids as ``jnp`` indexing
does, and every layer masks those slots.

Config keys mirror the reference yaml surface: ``emb_size``, ``slots``,
``samples``, ``sage_layer_type`` (sage_mean/sage_bow/sage_max/gin/gat/
lightgcn), ``sage_act``, ``sage_alpha`` (residual), ``interact_mode``
(sum/gatne), ``softsign``, ``neg_num``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..nn.conv import lecun_normal_

__all__ = ["RelationLayer", "FeatureInteraction", "AutoHeterEgoGNN",
           "PGLBoxGNNModel", "inbatch_negative_loss", "LAYER_TYPES"]

LAYER_TYPES = ("sage_mean", "sage_bow", "sage_max", "gin", "gat",
               "lightgcn")


def _act(name):
    """``jax.nn``'s activation of that name (gelu its tanh form, as
    ``jax.nn.gelu``'s default); None, "" or "none": the identity."""
    if name in (None, "", "none"):
        return lambda x: x
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    fn = getattr(F, name, None)
    return fn if fn is not None else getattr(torch, name)


def _l2(h):
    return h / torch.linalg.vector_norm(h, dim=-1,
                                        keepdim=True).clamp(min=1e-12)


def _linear(fan_in: int, fan_out: int, bias: bool,
            generator: torch.Generator) -> nn.Linear:
    """flax ``nn.Dense``: lecun-normal weight, zero bias."""
    linear = nn.Linear(fan_in, fan_out, bias=bias)
    lecun_normal_(linear.weight, generator)
    if bias:
        nn.init.zeros_(linear.bias)
    return linear


def _clamp(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp`` indexing's rule for ids into ``n`` rows: a negative id
    counts from the end, then every id is clamped into range."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def _embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (clamped) by ``F.embedding``, whose backward sums a
    row's many duplicates by a sort (an index's backward serialises them:
    a slot table of 100 rows takes 2M ids a step at full width)."""
    return F.embedding(_clamp(ids, table.shape[0]), table)


def _neighbour_max(h_neigh: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``[M, k, D] → [M, D]``: the largest neighbour a column where ``m``
    is set, the dtype's min where no neighbour is."""
    neg_inf = torch.finfo(h_neigh.dtype).min
    return torch.where(m > 0, h_neigh,
                       torch.full_like(h_neigh, neg_inf)).amax(1)


class RelationLayer(nn.Module):
    """One per-edge-type conv over a padded ego block
    (reference ``apps/PGLBox/src/models/layers.py``: GraphSAGEMean ``:57``,
    Bow ``:81``, Max ``:101``, GIN ``:25``, GAT ``:123``, LightGCN)."""

    def __init__(self, kind: str, hidden: int, act: Optional[str] = "relu",
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in LAYER_TYPES:
            raise ValueError(f"unknown relation layer {kind!r}; choose "
                             f"from {LAYER_TYPES}")
        self.kind = kind
        self.act = _act(act)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        # inputs are as wide as the outputs (the residuals add them)
        if kind in ("sage_mean", "sage_max"):
            self.lin = _linear(2 * hidden, hidden, True, gen)
        elif kind == "gin":
            self.lin = _linear(hidden, hidden, True, gen)
        elif kind == "gat":
            self.w = _linear(hidden, hidden, False, gen)
            self.a_l = _linear(hidden, 1, False, gen)
            self.a_r = _linear(hidden, 1, False, gen)

    def forward(self, h_self, h_neigh, mask):
        """h_self [M, D], h_neigh [M, k, D], mask [M, k] → [M, D]."""
        m = mask.unsqueeze(-1).to(h_self.dtype)
        denom = m.sum(1).clamp(min=1.0)
        mean_n = (h_neigh * m).sum(1) / denom
        if self.kind == "sage_mean":
            return _l2(self.act(self.lin(torch.cat([h_self, mean_n], -1))))
        if self.kind == "sage_bow":
            return _l2(h_self + mean_n)
        if self.kind == "sage_max":
            max_n = _neighbour_max(h_neigh, m)
            max_n = torch.where(mask.any(-1, keepdim=True), max_n,
                                torch.zeros_like(max_n))
            return _l2(self.act(self.lin(torch.cat([h_self, max_n], -1))))
        if self.kind == "gin":
            sum_n = (h_neigh * m).sum(1)
            return self.act(self.lin(h_self + sum_n)) + h_self
        if self.kind == "gat":
            hw, nw = self.w(h_self), self.w(h_neigh)
            score = F.leaky_relu(self.a_l(hw) + self.a_r(nw)[..., 0],
                                 negative_slope=0.2)
            score = torch.where(mask, score, torch.full_like(score, -1e9))
            alpha = (torch.softmax(score, -1)
                     * mask.any(-1, keepdim=True).to(score.dtype))
            return self.act(hw + torch.einsum("mk,mkd->md", alpha, nw))
        return (h_self + mean_n) * 0.5          # lightgcn


class FeatureInteraction(nn.Module):
    """Combine per-etype outputs: plain sum or GATNE-style attention
    (reference ``auto_heter_gnn.py:28-54``). Built for ``num_inputs``
    relations: with one, the input is the output and there are no
    weights (as flax creates none)."""

    def __init__(self, mode: str, hidden: int, num_inputs: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mode = mode
        if mode == "gatne" and num_inputs > 1:
            gen = generator if generator is not None \
                else torch.Generator().manual_seed(0)
            self.lin1 = _linear(hidden, hidden, False, gen)
            self.lin2 = _linear(hidden, 1, True, gen)

    def forward(self, feature_list: List[torch.Tensor]) -> torch.Tensor:
        if len(feature_list) == 1:
            return feature_list[0]
        if self.mode == "gatne":
            U = torch.stack(feature_list, dim=1)            # [M, R, D]
            scores = self.lin2(torch.tanh(self.lin1(U)))[..., 0]
            alpha = torch.softmax(scores, -1)               # [M, R]
            return torch.einsum("mr,mrd->md", alpha, U)
        out = feature_list[0]
        for f in feature_list[1:]:
            out = out + f
        return out


class AutoHeterEgoGNN(nn.Module):
    """L hetero layers over HeteroNeighborSampler ego blocks
    (reference ``AutoHeterGNN.forward``, ``auto_heter_gnn.py:112-170``):
    per-etype relation layer → interaction → ``alpha``-residual with the
    *initial* feature (the heter residual, ``:161-165``)."""

    def __init__(self, etypes: Sequence[str], num_layers: int, hidden: int,
                 layer_type: str = "sage_mean", act: Optional[str] = "relu",
                 alpha_residual: float = 0.9, interact_mode: str = "sum", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.etypes = list(etypes)
        self.num_layers = num_layers
        self.alpha_residual = alpha_residual
        for l in range(num_layers):
            layer_act = act if l < num_layers - 1 else None
            for e in self.etypes:
                self.add_module(f"rel_{l}_{e}", RelationLayer(
                    layer_type, hidden, layer_act, generator=generator))
            self.add_module(f"interact_{l}", FeatureInteraction(
                interact_mode, hidden, len(self.etypes),
                generator=generator))

    def forward(self, embed_fn, sampled, final_frontier):
        """``sampled``: HeteroNeighborSampler output (deepest-first list of
        ``(frontier, {etype: (neigh [M,k], mask)})``); ``final_frontier``
        the deepest node array. Returns [B, D] for the seeds."""
        entries = sampled[::-1]            # shallow-first
        L = len(entries)
        if L != self.num_layers:
            raise ValueError(f"sampled has {L} blocks, model expects "
                             f"{self.num_layers}")
        # initial features per depth; depth i+1 array = concat(frontier_i,
        # per-etype neighbor blocks) by HeteroNeighborSampler construction
        hs = [embed_fn(f) for f, _ in entries] + [embed_fn(final_frontier)]
        h0s = list(hs)
        a = self.alpha_residual
        for l in range(self.num_layers):
            inter = getattr(self, f"interact_{l}")
            nxt = []
            for i in range(L - l):
                frontier, per_etype = entries[i]
                n_i = frontier.shape[0]
                arr = hs[i + 1]
                h_self = arr[:n_i]
                outs, off = [], n_i
                for etype in self.etypes:
                    neigh, mask = per_etype[etype]
                    k = neigh.shape[1]
                    blk = arr[off:off + n_i * k].reshape(n_i, k, -1)
                    off += n_i * k
                    outs.append(getattr(self, f"rel_{l}_{etype}")(
                        h_self, blk, mask))
                # heterogeneous residual with the initial embedding
                nxt.append(h0s[i] * a + inter(outs) * (1.0 - a))
            hs = nxt
        return hs[0]


class PGLBoxGNNModel(nn.Module):
    """id + slot sparse embeddings → softsign → AutoHeterEgoGNN
    (reference ``gnn_model.py:119-152``).

    ``slot_tables`` (the forward's): dict slot name → [N] int tensor
    mapping each node to its discrete slot value (the reference's per-slot
    feature holders); per-slot embedding tables are learned and summed
    into the id embedding (``model_util.get_sparse_embedding`` +
    ``paddle.add_n``). The tables start ``normal(0.1)`` from
    ``generator``; the model lives on ``device`` (default: the card).
    """

    def __init__(self, num_nodes: int, emb_size: int, etypes: Sequence[str],
                 num_layers: int, slot_sizes: Optional[Dict[str, int]] = None,
                 layer_type: str = "sage_mean", act: Optional[str] = "relu",
                 alpha_residual: float = 0.9, interact_mode: str = "sum",
                 softsign: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.softsign = softsign
        self.id_emb = nn.Parameter(
            torch.randn(num_nodes, emb_size, generator=gen) * 0.1)
        self.slot_names = list(slot_sizes or {})
        for name, size in (slot_sizes or {}).items():
            self.register_parameter(f"slot_{name}", nn.Parameter(
                torch.randn(size, emb_size, generator=gen) * 0.1))
        self.gnn = AutoHeterEgoGNN(
            etypes, num_layers, emb_size, layer_type, act, alpha_residual,
            interact_mode, generator=gen)
        self.to(resolve_device(device))

    def forward(self, slot_tables, sampled, final_frontier):
        def embed(ids):
            h = _embed(self.id_emb, ids)
            for name in self.slot_names:
                table = slot_tables[name]
                h = h + _embed(getattr(self, f"slot_{name}"),
                               table[_clamp(ids, table.shape[0])])
            return F.softsign(h) if self.softsign else h

        return self.gnn(embed, sampled, final_frontier)


def inbatch_negative_loss(src_emb, dst_emb,
                          generator: Optional[torch.Generator] = None,
                          neg_num: int = 5, perms=None):
    """The reference's ``shuffle_batch`` in-batch negative loss
    (``gnn_model.py:155-163`` + nce loss): logits of src against its
    positive dst and ``neg_num`` batch-shuffled dsts, CE with the positive
    at index 0. The shuffles are ``torch.randperm`` draws from
    ``generator``, or ``perms`` ([neg_num, B] indices, e.g. the
    reference's ``jax.random.permutation`` draws)."""
    B = src_emb.shape[0]
    if perms is None:
        perms = [torch.randperm(B, generator=generator,
                                device=generator.device if generator
                                is not None else dst_emb.device)
                 for _ in range(neg_num)]
    negs = [dst_emb[torch.as_tensor(p, device=dst_emb.device).long()]
            for p in list(perms)[:neg_num]]
    cands = torch.stack([dst_emb] + negs, dim=1)          # [B, 1+neg, D]
    logits = torch.einsum("bd,bkd->bk", src_emb, cands)
    return -torch.log_softmax(logits, -1)[:, 0].mean()
