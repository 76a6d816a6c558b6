"""GNN model assemblies (port of ``pgl_tpu/models/gnn.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..nn import (APPNP, BernProp, ChebProp, FAConv, GATConv, GATv2Conv,
                  GCNConv, GCNII, GINConv, GPRConv, GraphPool, GraphSageConv,
                  LSTMAggregation, SGCConv, SSGCConv)
from ..nn.conv import _dense, _dropout, _layer_generator

__all__ = ["GCN", "GAT", "GraphSage", "GIN", "DeepGCNII", "APPNPModel",
           "SGC", "SSGC", "GATv2", "GPRGNN", "FAGCN", "BernNet",
           "ChebNetII", "LSTMSage"]


def _remat(fn, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward, as the reference's
    ``nn.remat`` does. Checkpoint replays the global CPU and CUDA RNG
    states only; ``generator``, the dropout generator ``fn`` draws from,
    is set back to its state at the forward for the recompute (so it draws
    the same masks) and then restored to where it stood."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    at_forward = generator.get_state()
    first = True

    def run(*a):
        nonlocal first
        if first:
            first = False
            return fn(*a)
        now = generator.get_state()
        generator.set_state(at_forward)
        try:
            return fn(*a)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


class _Dropout:
    """Dropout from a model's own generator, active when training at a
    positive rate (the models' ``drop``)."""

    def _drop(self, x, training: bool):
        if training and self.dropout > 0:
            return _dropout(x, self.dropout, self.generator)
        return x


class GCN(_Dropout, nn.Module):
    """Multi-layer GCN: ``num_layers`` GCNConv, relu between them, dropout
    before each when training, from the model's own generator. Layer ``i``
    is the submodule ``gcn_{i}``, the name of its flax counterpart.
    ``remat`` recomputes each layer's activations in the backward
    (``pgl_tpu/models/gnn.py:28-35``)."""

    def __init__(self, input_size: int, num_class: int, num_layers: int = 2,
                 hidden_size: int = 16, dropout: float = 0.5,
                 remat: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.dropout = dropout
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"gcn_{i}", GCNConv(
                input_size if i == 0 else hidden_size,
                num_class if last else hidden_size,
                activation=None if last else "relu",
                generator=gen, device=device))
        self.generator = _layer_generator(gen, device)

    def forward(self, graph, feature, training: bool = False):
        for i in range(self.num_layers):
            feature = self._drop(feature, training)
            conv = getattr(self, f"gcn_{i}")
            feature = _remat(conv, graph, feature) if self.remat \
                else conv(graph, feature)
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


class FAGCN(_Dropout, nn.Module):
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

    def forward(self, graph, feature, training: bool = False):
        h = self._drop(torch.relu(self.t1(self._drop(feature, training))),
                       training)
        h0 = h
        for i in range(self.num_layer):
            h = self.eps * h0 + getattr(self, f"fa_{i}")(graph, h, training)
        return self.t2(h)


class GraphSage(_Dropout, nn.Module):
    """Stacked GraphSAGE (``pgl_tpu/models/gnn.py:73-98``): ``sage_{i}``
    with relu and L2 normalisation but on the last, dropout after each but
    the last when training. ``remat`` recomputes each layer's activations
    in the backward."""

    def __init__(self, input_size: int, num_class: int, num_layers: int = 2,
                 hidden_size: int = 128, aggr_func: str = "mean",
                 dropout: float = 0.5, remat: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.num_layers = num_layers
        self.dropout = dropout
        self.remat = remat
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"sage_{i}", GraphSageConv(
                input_size if i == 0 else hidden_size,
                num_class if last else hidden_size, aggr_func=aggr_func,
                normalize=not last, generator=gen, device=device))
        self.generator = _layer_generator(gen, device)

    def forward(self, graph, feature, training: bool = False):
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            conv = getattr(self, f"sage_{i}")
            act = None if last else "relu"
            feature = _remat(conv, graph, feature, act) if self.remat \
                else conv(graph, feature, act)
            if not last:
                feature = self._drop(feature, training)
        return feature


class GIN(nn.Module):
    """Stacked GIN for graph classification (``pgl_tpu/models/
    gnn.py:101-118``): ``gin_{i}`` with relu, each layer's output summed
    over every subgraph (``GraphPool``), the pools concatenated into the
    Dense ``classifier``: logits ``[num_graph, num_class]``."""

    def __init__(self, input_size: int, num_class: int, num_layers: int = 5,
                 hidden_size: int = 64, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"gin_{i}", GINConv(
                input_size if i == 0 else hidden_size, hidden_size,
                activation="relu", generator=gen, device=device))
        self.pool = GraphPool("sum")
        self.classifier = _dense(num_layers * hidden_size, num_class, gen)
        self.to(device)

    def forward(self, graph, feature, training: bool = False):
        outs = []
        for i in range(self.num_layers):
            feature = getattr(self, f"gin_{i}")(graph, feature)
            outs.append(self.pool(graph, feature))
        return self.classifier(torch.cat(outs, dim=-1))


class DeepGCNII(_Dropout, nn.Module):
    """The citation benchmark's GCNII (``pgl_tpu/models/gnn.py:121-144``):
    dropout, the Dense ``in`` and relu, ``GCNII`` (``gcnii``, relu, the
    same dropout), dropout, the Dense ``out``. Dropout draws from the
    model's generator and the ``GCNII``'s own. ``remat`` recomputes the
    whole ``GCNII``'s activations in the backward, with its dropout
    masks."""

    def __init__(self, input_size: int, num_class: int,
                 hidden_size: int = 64, k_hop: int = 64,
                 lambda_l: float = 0.5, alpha: float = 0.1,
                 dropout: float = 0.6, remat: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.dropout = dropout
        self.remat = remat
        self.add_module("in", _dense(input_size, hidden_size, gen))
        self.gcnii = GCNII(hidden_size, activation="relu", lambda_l=lambda_l,
                           alpha=alpha, k_hop=k_hop, dropout=dropout,
                           generator=gen, device=device)
        self.out = _dense(hidden_size, num_class, gen)
        self.generator = _layer_generator(gen, device)
        self.to(device)

    def forward(self, graph, feature, training: bool = False):
        feature = torch.relu(getattr(self, "in")(
            self._drop(feature, training)))
        if self.remat:
            feature = _remat(self.gcnii, graph, feature, None, training,
                             generator=self.gcnii.generator)
        else:
            feature = self.gcnii(graph, feature, None, training)
        return self.out(self._drop(feature, training))


class _MLPThenProp(_Dropout, nn.Module):
    """Dropout, the Dense ``l1`` and relu, dropout, the Dense ``l2``, then
    a propagation without dropout: the shape of ``APPNPModel``,
    ``BernNet`` and ``ChebNetII`` (``pgl_tpu/models/gnn.py:147-216``)."""

    def __init__(self, input_size, num_class, hidden_size, dropout, gen,
                 device):
        super().__init__()
        self.dropout = dropout
        self.l1 = _dense(input_size, hidden_size, gen)
        self.l2 = _dense(hidden_size, num_class, gen)
        self.generator = _layer_generator(gen, device)

    def _mlp(self, feature, training):
        feature = torch.relu(self.l1(self._drop(feature, training)))
        return self.l2(self._drop(feature, training))


class APPNPModel(_MLPThenProp):
    """The MLP, then ``APPNP`` (``appnp``) (``pgl_tpu/models/
    gnn.py:147-164``)."""

    def __init__(self, input_size: int, num_class: int,
                 hidden_size: int = 64, dropout: float = 0.5,
                 k_hop: int = 10, alpha: float = 0.1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        super().__init__(input_size, num_class, hidden_size, dropout, gen,
                         device)
        self.appnp = APPNP(alpha=alpha, k_hop=k_hop)
        self.to(device)

    def forward(self, graph, feature, training: bool = False):
        return self.appnp(graph, self._mlp(feature, training))


class BernNet(_MLPThenProp):
    """The MLP, then ``BernProp`` (``prop``) (``pgl_tpu/models/
    gnn.py:179-196``)."""

    def __init__(self, input_size: int, num_class: int,
                 hidden_size: int = 64, k_hop: int = 10,
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device=None):
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        super().__init__(input_size, num_class, hidden_size, dropout, gen,
                         device)
        self.prop = BernProp(k_hop=k_hop, device=device)
        self.to(device)

    def forward(self, graph, feature, training: bool = False):
        return self.prop(graph, self._mlp(feature, training))


class ChebNetII(_MLPThenProp):
    """The MLP, then ``ChebProp`` (``prop``) (``pgl_tpu/models/
    gnn.py:199-216``)."""

    def __init__(self, input_size: int, num_class: int,
                 hidden_size: int = 64, k_hop: int = 10,
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device=None):
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        super().__init__(input_size, num_class, hidden_size, dropout, gen,
                         device)
        self.prop = ChebProp(k_hop=k_hop, device=device)
        self.to(device)

    def forward(self, graph, feature, training: bool = False):
        return self.prop(graph, self._mlp(feature, training))


class SGC(nn.Module):
    """One ``SGCConv`` (``sgc``) without its cache (``pgl_tpu/models/
    gnn.py:167-176``)."""

    def __init__(self, input_size: int, num_class: int, k_hop: int = 2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.sgc = SGCConv(input_size, num_class, k_hop=k_hop, cached=False,
                           generator=generator, device=device)

    def forward(self, graph, feature, training: bool = False):
        return self.sgc(graph, feature)


class SSGC(nn.Module):
    """One ``SSGCConv`` (``ssgc``) without its cache (``pgl_tpu/models/
    gnn.py:219-232``)."""

    def __init__(self, input_size: int, num_class: int, k_hop: int = 16,
                 alpha: float = 0.05, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.ssgc = SSGCConv(input_size, num_class, k_hop=k_hop, alpha=alpha,
                             cached=False, generator=generator,
                             device=device)

    def forward(self, graph, feature, training: bool = False):
        return self.ssgc(graph, feature)


class GPRGNN(nn.Module):
    """One ``GPRConv`` (``gpr``) at its default dropouts (``pgl_tpu/
    models/gnn.py:261-277``)."""

    def __init__(self, input_size: int, num_class: int,
                 hidden_size: int = 64, k_hop: int = 10, alpha: float = 0.1,
                 init_method: str = "PPR", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.gpr = GPRConv(input_size, hidden_size, num_class, k_hop=k_hop,
                           alpha=alpha, init_method=init_method,
                           generator=generator, device=device)

    def forward(self, graph, feature, training: bool = False):
        return self.gpr(graph, feature, training=training)


class LSTMSage(_Dropout, nn.Module):
    """GraphSAGE with LSTM aggregation (``pgl_tpu/models/gnn.py:304-336``):
    each layer projects (``proj_{i}``), sends each edge its source's row,
    aggregates each destination's messages with ``lstm_{i}``
    (``LSTMAggregation``, at most ``max_degree`` a node) and applies
    ``out_{i}`` to ``[h | aggregate]``, relu between layers; dropout on
    each layer's input when training, from the model's own generator."""

    def __init__(self, input_size: int, num_class: int, num_layers: int = 2,
                 hidden_size: int = 16, max_degree: int = 32,
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.num_layers = num_layers
        self.dropout = dropout
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"proj_{i}", _dense(
                input_size if i == 0 else hidden_size, hidden_size, gen))
            self.add_module(f"lstm_{i}", LSTMAggregation(
                hidden_size, max_degree, generator=gen, device=device))
            self.add_module(f"out_{i}", _dense(
                2 * hidden_size, num_class if last else hidden_size, gen))
        self.generator = _layer_generator(gen, device)
        self.to(device)

    def forward(self, graph, feature, training: bool = False):
        src = graph.edges[:, 0]
        for i in range(self.num_layers):
            feature = self._drop(feature, training)
            h = getattr(self, f"proj_{i}")(feature)
            agg = getattr(self, f"lstm_{i}")(graph, h.index_select(0, src))
            feature = getattr(self, f"out_{i}")(torch.cat([h, agg], dim=-1))
            if i < self.num_layers - 1:
                feature = torch.relu(feature)
        return feature
