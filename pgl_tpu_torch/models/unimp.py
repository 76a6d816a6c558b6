"""UniMP and R-UniMP (port of ``pgl_tpu/models/unimp.py``): stacks of graph
transformer layers over node features plus an embedding of the labels the
model may see (Shi et al., 2020; the reference's OGB leaderboard code,
``ogb_examples/nodeproppred/unimp``), R-UniMP with one layer per edge type
of a ``HeterGraph``; and the pinned-label propagation that smooths their
predictions."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..nn import TransformerConv

__all__ = ["UniMP", "RUniMP", "label_propagation_smooth"]


def label_propagation_smooth(graph, probs, gold_onehot, train_mask,
                             alpha: float = 0.2, hops: int = 3):
    """Pinned-label propagation (``pgl_tpu/models/unimp.py:27-60``): each
    hop replaces every node's class distribution by ``(1 - alpha) (Σ_in y
    + y) / (indegree + 1) + alpha y0``, renormalised, with the rows of
    ``train_mask`` pinned to ``gold_onehot``. ``probs`` and
    ``gold_onehot`` are [N, C], ``train_mask`` [N] (bool or float). Each
    hop's sum is ``graph.send_recv``: K1 on the card."""
    m = train_mask.to(probs.dtype)[..., None]
    y0 = probs * (1 - m) + gold_onehot * m
    norm = (1.0 / (graph.indegree().to(probs.dtype) + 1.0))[..., None]
    y = y0
    for _ in range(hops):
        agg = graph.send_recv(y, "sum") + y
        y = (1 - alpha) * agg * norm + alpha * y0
        y = y / y.sum(-1, keepdim=True).clamp(min=1e-12)
        y = y * (1 - m) + gold_onehot * m
    return y


def _label_embed(num_class: int, input_size: int,
                 gen: torch.Generator) -> nn.Embedding:
    """flax ``Embed``'s draw: a normal of std ``1 / √input_size``."""
    embed = nn.Embedding(num_class, input_size)
    with torch.no_grad():
        embed.weight.normal_(0.0, input_size ** -0.5, generator=gen)
    return embed


def _add_labels(embed, feature, label, label_mask):
    """``feature`` plus the embedding of ``label`` where ``label_mask``."""
    e = embed(label.clamp(min=0))
    if label_mask is None:
        label_mask = torch.zeros_like(label, dtype=torch.bool)
    return feature + torch.where(label_mask[..., None], e,
                                 torch.zeros_like(e))


class UniMP(nn.Module):
    """TransformerConv stack with a masked label embedding
    (``pgl_tpu/models/unimp.py:62-98``).

    ``label_embed`` (``nn.Embedding(num_class, input_size)``, drawn as
    flax's ``Embed``: a normal of std ``1 / √input_size``) is added to the
    features where ``label_mask`` is true. Layer ``i`` is ``conv_{i}``: the
    hidden layers have ``num_heads`` heads of ``hidden_size``, concatenated,
    layer norm and relu; the last has one head of ``num_class``, a gated
    skip, no layer norm and no activation."""

    def __init__(self, input_size: int, num_class: int, num_layers: int = 3,
                 hidden_size: int = 128, num_heads: int = 2,
                 dropout: float = 0.3, use_label_embed: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.num_layers = num_layers
        self.label_embed = _label_embed(num_class, input_size, gen) \
            if use_label_embed else None
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"conv_{i}", TransformerConv(
                input_size if i == 0 else hidden_size * num_heads,
                num_class if last else hidden_size,
                num_heads=1 if last else num_heads, feat_drop=dropout,
                attn_drop=dropout, concat=not last, gate=last,
                layer_norm=not last, activation=None if last else "relu",
                generator=gen, device=device))
        self.to(device)

    def forward(self, graph, feature, label=None, label_mask=None,
                training: bool = False):
        """``label``: [N] int labels; ``label_mask``: [N] bool, true where
        the model may see the label (the train nodes, less those the caller
        masks out while training)."""
        if self.label_embed is not None and label is not None:
            feature = _add_labels(self.label_embed, feature, label,
                                  label_mask)
        for i in range(self.num_layers):
            feature = getattr(self, f"conv_{i}")(graph, feature,
                                                 training=training)
        return feature


class RUniMP(nn.Module):
    """Relation-wise UniMP over a ``HeterGraph``
    (``pgl_tpu/models/unimp.py:101-141``): each layer runs one
    ``TransformerConv`` per edge type (``conv_{i}_{etype}``, no activation
    of its own) and sums them, with relu between layers; the hidden layers
    have ``num_heads`` heads of ``hidden_size``, concatenated, and layer
    norm, the last one head of ``num_class``, no layer norm. The label
    embedding is added where ``label_mask`` is true whenever ``label`` is
    given. On the card a hidden layer's attention is the dot-mode K9/K10
    once per edge type; the last layer (``concat=False``) takes the
    layer's edge-space composition."""

    def __init__(self, input_size: int, num_class: int, etypes,
                 num_layers: int = 2, hidden_size: int = 128,
                 num_heads: int = 2, dropout: float = 0.3, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.etypes = list(etypes)
        self.num_layers = num_layers
        self.label_embed = _label_embed(num_class, input_size, gen)
        for i in range(num_layers):
            last = i == num_layers - 1
            for etype in self.etypes:
                self.add_module(f"conv_{i}_{etype}", TransformerConv(
                    input_size if i == 0 else hidden_size * num_heads,
                    num_class if last else hidden_size,
                    num_heads=1 if last else num_heads, feat_drop=dropout,
                    attn_drop=dropout, concat=not last, layer_norm=not last,
                    activation=None, generator=gen, device=device))
        self.to(device)

    def forward(self, hetergraph, feature, label=None, label_mask=None,
                training: bool = False):
        if label is not None:
            feature = _add_labels(self.label_embed, feature, label,
                                  label_mask)
        for i in range(self.num_layers):
            feature = sum(getattr(self, f"conv_{i}_{etype}")(
                hetergraph[etype], feature, training=training)
                for etype in self.etypes)
            if i < self.num_layers - 1:
                feature = torch.relu(feature)
        return feature
