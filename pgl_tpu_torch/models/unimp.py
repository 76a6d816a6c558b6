"""UniMP (port of ``pgl_tpu/models/unimp.py``): a stack of graph
transformer layers over node features plus an embedding of the labels the
model may see (Shi et al., 2020; the reference's OGB leaderboard code,
``ogb_examples/nodeproppred/unimp``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..nn import TransformerConv

__all__ = ["UniMP"]


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
        self.label_embed = None
        if use_label_embed:
            self.label_embed = nn.Embedding(num_class, input_size)
            with torch.no_grad():
                self.label_embed.weight.normal_(0.0, input_size ** -0.5,
                                                generator=gen)
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
            embed = self.label_embed(label.clamp(min=0))
            if label_mask is None:
                label_mask = torch.zeros_like(label, dtype=torch.bool)
            feature = feature + torch.where(label_mask[..., None], embed,
                                            torch.zeros_like(embed))
        for i in range(self.num_layers):
            feature = getattr(self, f"conv_{i}")(graph, feature,
                                                 training=training)
        return feature
