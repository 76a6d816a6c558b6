"""GNN model assemblies (port of ``pgl_tpu/models/gnn.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..nn import FAConv, GATConv, GATv2Conv, GCNConv
from ..nn.conv import _dense, _dropout, _layer_generator

__all__ = ["GCN", "GAT", "GATv2", "FAGCN"]


class GCN(nn.Module):
    """Multi-layer GCN: ``num_layers`` GCNConv, relu between them, dropout
    before each when training. Layer ``i`` is the submodule ``gcn_{i}``,
    the name of its flax counterpart."""

    def __init__(self, input_size: int, num_class: int, num_layers: int = 2,
                 hidden_size: int = 16, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.dropout = dropout
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"gcn_{i}", GCNConv(
                input_size if i == 0 else hidden_size,
                num_class if last else hidden_size,
                activation=None if last else "relu",
                generator=gen, device=device))

    def forward(self, graph, feature, training: bool = False):
        for i in range(self.num_layers):
            if training and self.dropout > 0:
                feature = nn.functional.dropout(feature, self.dropout,
                                                training=True)
            feature = getattr(self, f"gcn_{i}")(graph, feature)
        return feature


class GAT(nn.Module):
    """2-layer GAT as in the citation benchmark (``pgl_tpu/models/gnn.py:
    50-70``): ``gat_0`` with ``num_heads`` heads of ``hidden_size``,
    concatenated, then elu; ``gat_1`` with one head of ``num_class``."""

    def __init__(self, input_size: int, num_class: int, num_heads: int = 8,
                 hidden_size: int = 8, feat_drop: float = 0.6,
                 attn_drop: float = 0.6, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.gat_0 = GATConv(input_size, hidden_size, feat_drop=feat_drop,
                             attn_drop=attn_drop, num_heads=num_heads,
                             activation="elu", generator=gen, device=device)
        self.gat_1 = GATConv(hidden_size * num_heads, num_class,
                             feat_drop=feat_drop, attn_drop=attn_drop,
                             num_heads=1, concat=False, generator=gen,
                             device=device)

    def forward(self, graph, feature, training: bool = False):
        feature = self.gat_0(graph, feature, training)
        return self.gat_1(graph, feature, training)


class GATv2(nn.Module):
    """2-layer GATv2 (``pgl_tpu/models/gnn.py:235-258``): ``gatv2_0`` with
    ``num_heads`` heads of ``hidden_size``, concatenated, then elu;
    ``gatv2_1`` with one head of ``num_class``."""

    def __init__(self, input_size: int, num_class: int, num_heads: int = 8,
                 hidden_size: int = 8, feat_drop: float = 0.6,
                 attn_drop: float = 0.6, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.gatv2_0 = GATv2Conv(input_size, hidden_size,
                                 feat_drop=feat_drop, attn_drop=attn_drop,
                                 num_heads=num_heads, activation="elu",
                                 generator=gen, device=device)
        self.gatv2_1 = GATv2Conv(hidden_size * num_heads, num_class,
                                 feat_drop=feat_drop, attn_drop=attn_drop,
                                 num_heads=1, concat=False, generator=gen,
                                 device=device)

    def forward(self, graph, feature, training: bool = False):
        feature = self.gatv2_0(graph, feature, training)
        return self.gatv2_1(graph, feature, training)


class FAGCN(nn.Module):
    """FAGCN (``pgl_tpu/models/gnn.py:280-301``): dropout, the Dense ``t1``
    and relu, dropout; ``num_layer`` ``FAConv`` hops ``fa_{i}``, each added
    to ``eps`` times the first hop's input; the Dense ``t2`` to the
    classes. Dropout draws from the model's own generator (the features)
    and each layer's (the edge weights)."""

    def __init__(self, input_size: int, num_class: int, hidden_size: int = 64,
                 num_layer: int = 3, eps: float = 0.2, dropout: float = 0.6,
                 *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.num_layer = num_layer
        self.eps = eps
        self.dropout = dropout
        self.t1 = _dense(input_size, hidden_size, gen)
        for i in range(num_layer):
            self.add_module(f"fa_{i}", FAConv(hidden_size, drop=dropout,
                                              generator=gen, device=device))
        self.t2 = _dense(hidden_size, num_class, gen)
        self.generator = _layer_generator(gen, device)
        self.to(device)

    def _drop(self, x, training):
        if training and self.dropout > 0:
            return _dropout(x, self.dropout, self.generator)
        return x

    def forward(self, graph, feature, training: bool = False):
        h = self._drop(torch.relu(self.t1(self._drop(feature, training))),
                       training)
        h0 = h
        for i in range(self.num_layer):
            h = self.eps * h0 + getattr(self, f"fa_{i}")(graph, h, training)
        return self.t2(h)
