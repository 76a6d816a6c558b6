"""Graph convolution layers (port of ``pgl_tpu/nn/conv.py``).

Layers are ``nn.Module``s called as ``layer(graph, feature)``. Weights are
drawn from the distributions of flax's defaults (lecun-normal kernels, zero
biases) with an explicit ``torch.Generator``, and live on ``device``
(default: the CUDA card). Parameter names are those of the flax layers, so
``utils/convert.py`` carries their trees across.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
from torch import nn

from .. import resolve_device
from ..ops.dispatch import plain_on_cuda
from ..ops.kernels.attention_kernels import (fused_gat_attention,
                                             fused_graph_attention,
                                             gat_score_features)
from ..ops.kernels.dedup_attention import (dedup_dot_attention,
                                           dedup_gat_attention)
from ..ops.segment import segment_softmax, segment_sum
from .functional import graph_op as GF

__all__ = ["GCNConv", "GATConv", "GATv2Conv", "PinSageConv", "FAConv",
           "TransformerConv", "lecun_normal_"]

# std of a unit normal truncated to [-2, 2]; flax's lecun_normal divides by
# it so that the truncated draw keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax ``lecun_normal`` for an ``nn.Linear`` weight [out, in]:
    truncated normal at ±2 std with variance 1 / fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std,
                                     2.0 * std, generator=generator)


def _dense(input_size: int, output_size: int,
           generator: torch.Generator) -> nn.Linear:
    """flax ``nn.Dense``: lecun-normal weight, zero bias."""
    linear = nn.Linear(input_size, output_size)
    lecun_normal_(linear.weight, generator)
    nn.init.zeros_(linear.bias)
    return linear


def _resolve_act(activation) -> Optional[Callable]:
    """A callable, or a name looked up in ``torch.nn.functional`` and then
    on ``torch`` (``"elu"`` lives only in the first)."""
    if activation is None or callable(activation):
        return activation
    fn = getattr(nn.functional, activation, None)
    return fn if fn is not None else getattr(torch, activation)


def _l2_normalize(x, eps: float = 1e-12):
    """``x / sqrt(max(Σ x², eps))`` over the last axis (the reference's
    ``_l2_normalize``)."""
    return x / (x * x).sum(-1, keepdim=True).clamp(min=eps).sqrt()


def _merge_heads(output, concat: bool, activation):
    """Concatenate (``concat``) or average the heads of ``output`` [N, H,
    Dh], then the activation."""
    N, H, Dh = output.shape
    output = output.reshape(N, H * Dh) if concat else output.mean(dim=1)
    return activation(output) if activation is not None else output


def _check_drop_mode(mode):
    if mode not in ("edge", "cell"):
        raise ValueError(
            f"attn_drop_mode must be 'edge' or 'cell', got {mode!r}")


def _dropout(x, rate: float, generator: torch.Generator):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    by 1 / (1 - rate); the mask comes from ``generator``."""
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


def _layer_generator(gen: torch.Generator, device) -> torch.Generator:
    """A layer's own dropout generator on ``device``, seeded from ``gen``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(int(torch.randint(0, 2 ** 62, (1,),
                                            generator=gen)))
    return generator


def _attn_seed(generator: torch.Generator, rate: float):
    """One int32 seed for the kernels' hash dropout (the counterpart of
    ``_attn_drop_seed``), None at rate 0."""
    if rate <= 1e-15:
        return None
    return torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                         generator=generator, device=generator.device)


def _dedup_route(graph, rate: float, mode: str) -> bool:
    """True where the reference takes the count-matrix attention (K7/K8):
    a graph with dedup layouts, unless it is a multigraph under edge-mode
    dropout (``pgl_tpu/nn/conv.py:217-227,517-523``)."""
    dedup = graph._dedup_layouts
    return dedup is not None and not (rate > 0.0 and not dedup[0].simple
                                      and mode != "cell")


class PinSageConv(nn.Module):
    """PinSage: edge-weighted neighbour sum, a Dense on it and one on the
    node's own feature, added, then L2-normalised (``pgl_tpu/nn/conv.py:
    84-100``). ``efeat`` weighs each edge (``[E]`` or ``[E, 1]``): K1w on
    the aggregation for ``aggr_func="sum"``."""

    def __init__(self, input_size: int, hidden_size: int,
                 aggr_func: str = "sum", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.aggr_func = aggr_func
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.self_linear = _dense(input_size, hidden_size, gen)
        self.neigh_linear = _dense(input_size, hidden_size, gen)
        self.to(resolve_device(device))

    def forward(self, graph, nfeat, efeat, act=None):
        neigh = graph.send_ue_recv(nfeat, efeat, "mul", self.aggr_func)
        output = self.self_linear(nfeat) + self.neigh_linear(neigh)
        act = _resolve_act(act)
        if act is not None:
            output = act(output)
        return _l2_normalize(output)


class FAConv(nn.Module):
    """FAGCN's layer: a tanh gate on each edge's endpoints, scaled by both
    endpoints' degree norms, weighs the neighbour sum (``pgl_tpu/nn/conv.py:
    756-778``). As in the reference the ``gate`` Dense on ``[h_s | h_d]`` is
    split into node-side halves combined per edge by ``send_uv``: ``h_s ·
    W[:D] + h_d · W[D:] + b``. The per-edge weight is a scalar, so the sum
    runs K1w (the weighted K6 on a graph with dedup layouts). Dropout on
    the weights draws from the layer's own generator."""

    def __init__(self, hidden_size: int, drop: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.drop = drop
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.gate = _dense(2 * hidden_size, 1, gen)
        self.generator = _layer_generator(gen, device)
        self.to(device)

    def forward(self, graph, feature, training: bool = False):
        D = self.hidden_size
        norm = GF.degree_norm(graph, dtype=feature.dtype)
        weight = self.gate.weight
        s_src = nn.functional.linear(feature, weight[:, :D])
        s_dst = nn.functional.linear(feature, weight[:, D:], self.gate.bias)
        alpha = torch.tanh(graph.send_uv(s_src, s_dst, "add"))
        alpha = alpha * graph.send_uv(norm, norm, "mul")
        if training and self.drop > 0:
            alpha = _dropout(alpha, self.drop, self.generator)
        return graph.send_ue_recv(feature, alpha, "mul", "sum")


class GCNConv(nn.Module):
    """GCN layer with the D^-1/2 A D^-1/2 normalization; the linear runs
    before propagation when ``input_size > output_size`` (fewer columns to
    send), after it otherwise."""

    def __init__(self, input_size: int, output_size: int,
                 activation: Any = None, norm: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.activation = _resolve_act(activation)
        self.norm = norm
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.linear = nn.Linear(input_size, output_size, bias=False)
        lecun_normal_(self.linear.weight, gen)
        self.bias = nn.Parameter(torch.zeros(output_size))
        self.to(resolve_device(device))

    def forward(self, graph, feature, norm=None):
        if self.norm and norm is None:
            norm = GF.degree_norm(graph, dtype=feature.dtype)
        if self.input_size > self.output_size:
            feature = self.linear(feature)
        if norm is not None:
            feature = feature * norm
        output = graph.send_recv(feature, "sum")
        if self.input_size <= self.output_size:
            output = self.linear(output)
        if norm is not None:
            output = output * norm
        output = output + self.bias
        if self.activation is not None:
            output = self.activation(output)
        return output


class GATConv(nn.Module):
    """GAT: additive attention, edge softmax and weighted aggregation in
    one fused call (``pgl_tpu/nn/conv.py:134-274``), on the reference's
    route: on a graph that carries dedup layouts, the count-matrix kernels
    K7/K8 (``ops/kernels/dedup_attention.py``), unless it is a multigraph
    under edge-mode dropout; otherwise the per-edge kernels K9/K10
    (``ops/kernels/attention_kernels.py``), in additive mode for ``3·H <=
    128`` and in dot mode past it, the score written as a dot by
    ``gat_score_features`` (the reference's many-head fallback).

    Dropout draws from the layer's own generator on its device
    (``self.generator``, seeded from ``generator`` at construction): the
    feature mask, and on each training forward one int32 seed for the
    attention's hash dropout (the counterpart of ``_attn_drop_seed``).
    ``attn_drop_mode="cell"`` keeps a multigraph under dropout on K7/K8,
    whose mask drops a cell's duplicate edges together (the same
    expectation as edge dropout).

    Training with attention dropout at ``3·H > 128`` takes the reference's
    unfused path (``:258-266``): ``send_uv`` scores, ``edge_softmax``,
    dropout on the probabilities and ``send_ue_recv``, whose per-head
    weights run K1w. So does a projected feature that the kernels leave to
    the plain path (an integer or float64 one on the card,
    ``dispatch.plain_on_cuda``), whose ``send_ue_recv`` then takes the
    segment path.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 feat_drop: float = 0.6, attn_drop: float = 0.6,
                 num_heads: int = 1, concat: bool = True,
                 attn_drop_mode: str = "edge", activation: Any = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _check_drop_mode(attn_drop_mode)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.num_heads = num_heads
        self.concat = concat
        self.attn_drop_mode = attn_drop_mode
        self.activation = _resolve_act(activation)
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.linear = _dense(input_size, num_heads * hidden_size, gen)
        # flax xavier_uniform on [H, Dh]: fan_in H, fan_out Dh, as torch's
        self.weight_src = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(num_heads, hidden_size), generator=gen))
        self.weight_dst = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(num_heads, hidden_size), generator=gen))
        self.generator = _layer_generator(gen, device)
        self.to(device)

    def _route(self, graph, inputs, rate: float) -> str:
        """``"dedup"`` where the reference takes K7/K8
        (``pgl_tpu/nn/conv.py:202-256``), ``"additive"`` or ``"dot"`` where
        it takes K9/K10 in that mode, ``"unfused"`` where it leaves the
        fused kernels (attention dropout at ``3·H > 128``, or ``inputs``,
        the projected feature and scores that the kernels would receive,
        that ``dispatch.plain_on_cuda`` leaves to the plain path)."""
        H = self.num_heads
        if (rate > 1e-15 and 3 * H > 128) or plain_on_cuda(*inputs):
            return "unfused"
        if _dedup_route(graph, rate, self.attn_drop_mode):
            return "dedup"
        return "additive" if 3 * H <= 128 else "dot"

    def forward(self, graph, feature, training: bool = False):
        H, Dh = self.num_heads, self.hidden_size
        rate = float(self.attn_drop) if training else 0.0
        if training and self.feat_drop > 1e-15:
            feature = _dropout(feature, self.feat_drop, self.generator)
        feature = self.linear(feature)
        heads = feature.reshape(-1, H, Dh)
        attn_src = (heads * self.weight_src).sum(-1)
        attn_dst = (heads * self.weight_dst).sum(-1)
        route = self._route(graph, (feature, attn_src, attn_dst), rate)
        if route == "unfused":
            alpha = graph.send_uv(attn_src, attn_dst, "add")
            alpha = nn.functional.leaky_relu(alpha, 0.2)
            alpha = GF.edge_softmax(graph, alpha).reshape(-1, H, 1)
            alpha = _dropout(alpha, rate, self.generator)
            return _merge_heads(graph.send_ue_recv(heads, alpha, "mul", "sum"),
                                self.concat, self.activation)
        seed = _attn_seed(self.generator, rate)
        if route == "dedup":
            out = dedup_gat_attention(attn_dst, attn_src, feature,
                                      graph._dedup_attn_aux(), 0.2, dvh=Dh,
                                      attn_drop=rate, drop_seed=seed)
        elif route == "additive":
            out = fused_gat_attention(attn_dst, attn_src, feature,
                                      *graph._attention_layouts(), 0.2,
                                      dvh=Dh, attn_drop=rate, drop_seed=seed)
        else:
            q, k = gat_score_features(attn_dst, attn_src)
            out = fused_graph_attention(q, k, feature,
                                        *graph._attention_layouts(), H, 0.2,
                                        dsh=q.shape[1] // H, dvh=Dh)
        return _merge_heads(out.reshape(-1, H, Dh), self.concat,
                            self.activation)


class GATv2Conv(nn.Module):
    """GATv2 (``pgl_tpu/nn/conv.py:277-318``): the score ``a · leaky(h_s +
    h_d)`` of each edge from ``send_uv``, ``edge_softmax`` over each
    destination, dropout on the probabilities, and the per-head weighted
    sum by ``send_ue_recv`` (K1w with H weights an edge on the ``[N, H,
    Dh]`` heads). ``attn`` is flax's ``[1, H, Dh]``, xavier-uniform as
    there. Dropout draws from the layer's own generator."""

    def __init__(self, input_size: int, hidden_size: int,
                 feat_drop: float = 0.6, attn_drop: float = 0.6,
                 num_heads: int = 1, concat: bool = True,
                 activation: Any = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.num_heads = num_heads
        self.concat = concat
        self.activation = _resolve_act(activation)
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.linear = _dense(input_size, num_heads * hidden_size, gen)
        # flax xavier_uniform on [1, H, Dh]: fan_in H, fan_out Dh (the
        # receptive field 1), as torch's on the same shape
        self.attn = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(1, num_heads, hidden_size), generator=gen))
        self.generator = _layer_generator(gen, device)
        self.to(device)

    def forward(self, graph, feature, training: bool = False):
        H, Dh = self.num_heads, self.hidden_size
        if training and self.feat_drop > 1e-15:
            feature = _dropout(feature, self.feat_drop, self.generator)
        heads = self.linear(feature).reshape(-1, H, Dh)
        alpha = graph.send_uv(heads, heads, "add")
        alpha = nn.functional.leaky_relu(alpha, 0.2)
        alpha = (alpha * self.attn).sum(-1)
        alpha = GF.edge_softmax(graph, alpha).unsqueeze(-1)
        if training and self.attn_drop > 1e-15:
            alpha = _dropout(alpha, self.attn_drop, self.generator)
        return _merge_heads(graph.send_ue_recv(heads, alpha, "mul", "sum"),
                            self.concat, self.activation)


class TransformerConv(nn.Module):
    """UniMP's graph transformer layer (``pgl_tpu/nn/conv.py:444-581``):
    per-head ``q·k / √D`` attention over each node's incoming edges, an
    optional edge feature added to k and v, a (gated) skip connection,
    layer norm and the activation. Parameters carry the flax names: ``q``,
    ``k``, ``v``, ``skip_feat``, ``gate`` and ``ln`` (``LayerNorm`` at
    flax's ``eps=1e-6``).

    The route is the reference's (``:513-565``) without its TPU gates
    (``_MIN_EDGES``, the backend, ``(H·D) % 128 == 0``):

    * without ``edge_feat`` and with ``concat``, on a graph with dedup
      layouts: the count-matrix dot attention (``dedup_dot_attention``,
      K7/K8 in dot mode) with in-kernel dropout keyed by cell, unless the
      graph is a multigraph under edge-mode dropout;
    * the same case otherwise: the per-edge kernels K9/K10 in dot mode
      (``fused_graph_attention``) with in-kernel attention dropout;
    * otherwise (``edge_feat`` given, or ``concat=False``, or projections
      q, k, v that ``dispatch.plain_on_cuda`` leaves to the plain path):
      the reference's edge-space composition (``:545-565``) in torch.

    The reference keeps ``(H·D) % 128 != 0`` off its fused kernels even on
    a dedup-layout graph; the port takes K7/K8 there too: the same
    function, with the dropout mask keyed by cell. Dropout draws from the
    layer's own generator, as ``GATConv``'s; ``attn_drop_mode="cell"``
    keeps a multigraph under dropout on K7/K8.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 num_heads: int = 4, feat_drop: float = 0.6,
                 attn_drop: float = 0.6, concat: bool = True,
                 skip_feat: bool = True, gate: bool = False,
                 layer_norm: bool = True, attn_drop_mode: str = "edge",
                 activation: Any = "relu", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _check_drop_mode(attn_drop_mode)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.concat = concat
        self.attn_drop_mode = attn_drop_mode
        self.activation = _resolve_act(activation)
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        HD = num_heads * hidden_size
        width = HD if concat else hidden_size
        self.q = _dense(input_size, HD, gen)
        self.k = _dense(input_size, HD, gen)
        self.v = _dense(input_size, HD, gen)
        self.skip_feat = _dense(input_size, width, gen) if skip_feat \
            else None
        self.gate = _dense(3 * width, 1, gen) if skip_feat and gate else None
        self.ln = nn.LayerNorm(width, eps=1e-6) if layer_norm else None
        self.generator = _layer_generator(gen, device)
        self.to(device)

    def forward(self, graph, feature, edge_feat=None,
                training: bool = False):
        H, D = self.num_heads, self.hidden_size
        rate = float(self.attn_drop) if training else 0.0
        dropping = training and self.feat_drop > 1e-5
        if dropping:
            feature = _dropout(feature, self.feat_drop, self.generator)
        q = self.q(feature) / D ** 0.5
        k = self.k(feature)
        v = self.v(feature)
        fused = (edge_feat is None and self.concat
                 and not plain_on_cuda(q, k, v))
        dedup = fused and _dedup_route(graph, rate, self.attn_drop_mode)
        if edge_feat is not None and dropping:
            edge_feat = _dropout(edge_feat, self.feat_drop, self.generator)
        if dedup:
            output = dedup_dot_attention(
                q, k, v, graph._dedup_attn_aux(), H, D, D, 0.0,
                attn_drop=rate, drop_seed=_attn_seed(self.generator, rate))
        elif fused:
            output = fused_graph_attention(
                q, k, v, *graph._attention_layouts(), H, 0.0, dsh=D, dvh=D,
                attn_drop=rate, drop_seed=_attn_seed(self.generator, rate))
        else:
            output = self._edge_attention(graph, q, k, v, edge_feat, rate)
        if self.skip_feat is not None:
            skip = self.skip_feat(feature)
            if self.gate is not None:
                g = torch.sigmoid(self.gate(
                    torch.cat([skip, output, skip - output], dim=-1)))
                output = g * skip + (1 - g) * output
            else:
                output = skip + output
        if self.ln is not None:
            output = self.ln(output)
        if self.activation is not None:
            output = self.activation(output)
        return output

    def _edge_attention(self, graph, q, k, v, edge_feat, rate: float):
        """The reference's composition in edge space: gather, per-head
        scores, softmax over each destination's edges, dropout on the
        probabilities, weighted sum (``:545-565``)."""
        H, D = self.num_heads, self.hidden_size
        src, dst = graph.edges[:, 0], graph.edges[:, 1]
        q_e = q.reshape(-1, H, D)[dst]
        k_e = k.reshape(-1, H, D)[src]
        v_e = v.reshape(-1, H, D)[src]
        if edge_feat is not None:
            edge_feat = edge_feat.reshape(-1, H, D)
            k_e = k_e + edge_feat
            v_e = v_e + edge_feat
        alpha = segment_softmax((q_e * k_e).sum(-1), dst, graph.num_nodes)
        if rate > 1e-15:
            alpha = _dropout(alpha, rate, self.generator)
        msg = v_e * alpha[..., None]
        msg = msg.reshape(-1, H * D) if self.concat else msg.mean(dim=1)
        return segment_sum(msg, dst, graph.num_nodes)
