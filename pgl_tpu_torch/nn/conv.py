"""Graph convolution layers (port of ``pgl_tpu/nn/conv.py``).

Layers are ``nn.Module``s called as ``layer(graph, feature)``. Weights are
drawn from the distributions of flax's defaults (lecun-normal kernels, zero
biases) with an explicit ``torch.Generator``, and live on ``device``
(default: the CUDA card). Parameter names are those of the flax layers, so
``utils/convert.py`` carries their trees across.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..ops.dispatch import fused_attention_graph, plain_on_cuda
from ..ops.kernels.attention_kernels import (fused_gat_attention,
                                             fused_graph_attention,
                                             gat_score_features)
from ..ops.kernels.dedup_attention import (dedup_dot_attention,
                                           dedup_gat_attention)
from ..ops.segment import segment_softmax, segment_sum
from .functional import graph_op as GF

__all__ = ["GCNConv", "GATConv", "GATv2Conv", "APPNP", "GPRConv", "GCNII",
           "TransformerConv", "GINConv", "GraphSageConv", "PinSageConv",
           "RGCNConv", "SGCConv", "SSGCConv", "NGCFConv", "LightGCNConv", "FAConv",
           "BernProp", "ChebProp", "gpr_init_weights", "sgc_precompute",
           "ssgc_precompute", "lecun_normal_"]

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

    On a ``HaloGraph`` the attention is the graph's ``gat_attention``
    (``pgl_tpu/nn/conv.py:181-197``): one exchange of the ``a_src | v``
    rows, then the same route over the shard's owned rows, the mask
    seeded ``seed ^ rank``.

    Training with attention dropout at ``3·H > 128`` takes the reference's
    unfused path (``:258-266``): ``send_uv`` scores, ``edge_softmax``,
    dropout on the probabilities and ``send_ue_recv``, whose per-head
    weights run K1w. So does a projected feature that the kernels leave to
    the plain path (an integer, float16 or float64 one on the card,
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
        that ``dispatch.plain_on_cuda`` leaves to the plain path, or a graph
        without attention work lists: a ``BiGraph``)."""
        H = self.num_heads
        if ((rate > 1e-15 and 3 * H > 128) or plain_on_cuda(*inputs)
                or not fused_attention_graph(graph)):
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
        if hasattr(graph, "gat_attention"):
            # a HaloGraph: one exchange, then the attention per shard (its
            # own route; dropout keyed by the shard's CSC positions)
            out = graph.gat_attention(attn_dst, attn_src, feature, 0.2, rate,
                                      _attn_seed(self.generator, rate))
            return _merge_heads(out.reshape(-1, H, Dh), self.concat,
                                self.activation)
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

    On a ``HaloGraph`` (``:483-512``): ``graph.dot_attention`` (the dot
    K9/K10 over the shard's owned rows and its halo) without
    ``edge_feat``, ``concat=False`` averaging the heads after; with
    ``edge_feat``, the composition in the rank's edge layout.

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
        halo = hasattr(graph, "dot_attention")
        fused = (edge_feat is None and self.concat and not halo
                 and not plain_on_cuda(q, k, v)
                 and fused_attention_graph(graph))
        dedup = fused and _dedup_route(graph, rate, self.attn_drop_mode)
        if edge_feat is not None and dropping:
            edge_feat = _dropout(edge_feat, self.feat_drop, self.generator)
        if halo:
            output = self._halo_attention(graph, q, k, v, edge_feat, rate)
        elif dedup:
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

    def _halo_attention(self, graph, q, k, v, edge_feat, rate: float):
        """On a HaloGraph (``pgl_tpu/nn/conv.py:483-512``): the shards' dot
        attention without ``edge_feat``; with it, the composition in the
        rank's edge layout (one exchange of the ``k | v`` rows, the
        destination side local, ``recv_edge_values``). ``concat=False``
        averages the heads after."""
        H, D = self.num_heads, self.hidden_size
        if edge_feat is None:
            output = graph.dot_attention(q, k, v, H, rate,
                                         _attn_seed(self.generator, rate))
        else:
            kv_e = graph.gather_src_values(torch.cat([k, v], dim=-1))
            q_e = graph.gather_dst_values(q).reshape(-1, H, D)
            k_e = (kv_e[:, :H * D] + edge_feat).reshape(-1, H, D)
            v_e = (kv_e[:, H * D:] + edge_feat).reshape(-1, H, D)
            alpha = GF.edge_softmax(graph, (q_e * k_e).sum(-1))
            if rate > 1e-15:
                alpha = _dropout(alpha, rate, self.generator)
            output = graph.recv_edge_values(
                (v_e * alpha[..., None]).reshape(-1, H * D))
        if not self.concat:
            output = output.reshape(-1, H, D).mean(dim=1)
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


# -- the propagation zoo: every aggregation is Graph.send_recv, so K1 on the
# card for a float32 sum or mean

def _propagate(graph, x, norm):
    """``Â x`` with ``Â = D^-1/2 A D^-1/2``: one sum over the in-edges."""
    return graph.send_recv(x * norm, "sum") * norm


def _no_self_loop(name: str, self_loop: bool):
    if self_loop:
        raise ValueError(
            f"{name}(self_loop=True): adding self loops rebuilds the edge "
            "set; rebuild the host graph with "
            "pgl_tpu_torch.utils.transform.add_self_loops(replace=True) "
            "before tensor()")


class GraphSageConv(nn.Module):
    """GraphSAGE: a Dense on the node's own feature plus one on its
    neighbours' ``aggr_func`` (``sum`` or ``mean``: K1 on the card;
    ``max`` or ``min``: the segment path), the activation, then L2
    normalisation when ``normalize`` (``pgl_tpu/nn/conv.py:59-81``).
    ``feature`` is one tensor or a ``(source, self)`` pair."""

    def __init__(self, input_size: int, hidden_size: int,
                 aggr_func: str = "sum", normalize: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if aggr_func not in ("sum", "mean", "max", "min"):
            raise ValueError(f"aggr_func must be sum, mean, max or min, got "
                             f"{aggr_func!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.aggr_func = aggr_func
        self.normalize = normalize
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.self_linear = _dense(input_size, hidden_size, gen)
        self.neigh_linear = _dense(input_size, hidden_size, gen)
        self.to(resolve_device(device))

    def forward(self, graph, feature, act=None):
        if not isinstance(feature, (tuple, list)):
            feature = (feature, feature)
        neigh = self.neigh_linear(graph.send_recv(feature[0], self.aggr_func))
        output = self.self_linear(feature[1]) + neigh
        act = _resolve_act(act)
        if act is not None:
            output = act(output)
        return _l2_normalize(output) if self.normalize else output


class APPNP(nn.Module):
    """Personalized-PageRank propagation: ``k_hop`` hops of ``Â``, each
    blended with the input by ``alpha`` (``pgl_tpu/nn/conv.py:321-346``).
    No parameters. Self loops are added to the graph before ``tensor()``,
    as in the reference."""

    def __init__(self, alpha: float = 0.2, k_hop: int = 10,
                 self_loop: bool = False):
        super().__init__()
        self.alpha = alpha
        self.k_hop = k_hop
        self.self_loop = self_loop

    def forward(self, graph, feature, norm=None):
        _no_self_loop("APPNP", self.self_loop)
        if norm is None:
            norm = GF.degree_norm(graph, dtype=feature.dtype)
        h0 = feature
        for _ in range(self.k_hop):
            feature = _propagate(graph, feature, norm)
            feature = self.alpha * h0 + (1 - self.alpha) * feature
        return feature


def gpr_init_weights(init_method: str, alpha: float, k_hop: int,
                     gamma=None, seed: int = 0) -> np.ndarray:
    """The five GPR-GNN hop-weight initialisations (``SGC``, ``PPR``,
    ``NPPR``, ``Random`` from ``np.random.default_rng(seed)``, ``WS``),
    float32 [k_hop + 1]: the port's copy of ``pgl_tpu/nn/conv.py:349-370``,
    the same numbers for the same arguments."""
    if init_method == "SGC":
        temp = np.zeros(k_hop + 1)
        temp[int(alpha)] = 1.0
    elif init_method == "PPR":
        temp = alpha * (1 - alpha) ** np.arange(k_hop + 1)
        temp[-1] = (1 - alpha) ** k_hop
    elif init_method == "NPPR":
        temp = alpha ** np.arange(k_hop + 1)
        temp = temp / np.sum(np.abs(temp))
    elif init_method == "Random":
        bound = np.sqrt(3 / (k_hop + 1))
        temp = np.random.default_rng(seed).uniform(-bound, bound, k_hop + 1)
        temp = temp / np.sum(np.abs(temp))
    elif init_method == "WS":
        temp = np.asarray(gamma)
    else:
        raise ValueError(f"unknown init_method {init_method}")
    return temp.astype(np.float32)


class GPRConv(nn.Module):
    """GPR-GNN: a two-layer MLP (``linear_1``, ``linear_2``), then
    ``k_hop`` hops of ``Â`` summed with the learnable weights ``temp``
    (``pgl_tpu/nn/conv.py:373-412``). Dropout draws from the layer's own
    generator."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 drop: float = 0.5, dprate: float = 0.5,
                 activation: Any = "relu", self_loop: bool = False,
                 alpha: float = 0.1, k_hop: int = 10,
                 init_method: str = "PPR", gamma: Any = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.drop = drop
        self.dprate = dprate
        self.activation = _resolve_act(activation)
        self.self_loop = self_loop
        self.k_hop = k_hop
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.temp = nn.Parameter(torch.as_tensor(
            gpr_init_weights(init_method, alpha, k_hop, gamma)))
        self.linear_1 = _dense(input_size, hidden_size, gen)
        self.linear_2 = _dense(hidden_size, output_size, gen)
        self.generator = _layer_generator(gen, device)
        self.to(device)

    def _drop(self, x, rate, training):
        if training and rate > 0.0:
            return _dropout(x, rate, self.generator)
        return x

    def forward(self, graph, feature, norm=None, training: bool = False):
        _no_self_loop("GPRConv", self.self_loop)
        feature = self._drop(feature, self.drop, training)
        feature = self.activation(self.linear_1(feature))
        feature = self._drop(feature, self.drop, training)
        feature = self._drop(self.linear_2(feature), self.dprate, training)
        if norm is None:
            norm = GF.degree_norm(graph, dtype=feature.dtype)
        hidden = feature * self.temp[0]
        for k in range(self.k_hop):
            feature = _propagate(graph, feature, norm)
            hidden = hidden + self.temp[k + 1] * feature
        return hidden


class GCNII(nn.Module):
    """GCNII: ``k_hop`` hops, each dropout (training), ``Â``, the initial
    residual ``alpha``, and the identity map ``beta_i`` with the Dense
    ``mlp_{i}``, then the activation (``pgl_tpu/nn/conv.py:415-441``).
    The input is ``hidden_size`` wide. Dropout draws from the layer's own
    generator."""

    def __init__(self, hidden_size: int, activation: Any = None,
                 lambda_l: float = 0.5, alpha: float = 0.2, k_hop: int = 10,
                 dropout: float = 0.6, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.activation = _resolve_act(activation)
        self.lambda_l = lambda_l
        self.alpha = alpha
        self.k_hop = k_hop
        self.dropout = dropout
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        for i in range(k_hop):
            self.add_module(f"mlp_{i}", _dense(hidden_size, hidden_size, gen))
        self.generator = _layer_generator(gen, device)
        self.to(device)

    def forward(self, graph, feature, norm=None, training: bool = False):
        if norm is None:
            norm = GF.degree_norm(graph, dtype=feature.dtype)
        h0 = feature
        for i in range(self.k_hop):
            beta_i = float(np.log(1.0 * self.lambda_l / (i + 1) + 1))
            if training and self.dropout > 0.0:
                feature = _dropout(feature, self.dropout, self.generator)
            feature = _propagate(graph, feature, norm)
            feature = self.alpha * h0 + (1 - self.alpha) * feature
            transed = getattr(self, f"mlp_{i}")(feature)
            feature = beta_i * transed + (1 - beta_i) * feature
            if self.activation is not None:
                feature = self.activation(feature)
        return feature


class GINConv(nn.Module):
    """GIN: ``(1 + eps) x`` plus the neighbours' sum, then ``linear1``,
    ``layer_norm`` (flax's epsilon, 1e-6), the activation and ``linear2``
    (``pgl_tpu/nn/conv.py:584-609``). ``epsilon`` is a ``(1, 1)``
    parameter only with ``train_eps``."""

    def __init__(self, input_size: int, output_size: int,
                 activation: Any = None, init_eps: float = 0.0,
                 train_eps: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.activation = _resolve_act(activation)
        self.init_eps = init_eps
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.epsilon = nn.Parameter(torch.full((1, 1), float(init_eps))) \
            if train_eps else None
        self.linear1 = _dense(input_size, output_size, gen)
        self.layer_norm = nn.LayerNorm(output_size, eps=1e-6)
        self.linear2 = _dense(output_size, output_size, gen)
        self.to(resolve_device(device))

    def forward(self, graph, feature):
        eps = self.epsilon if self.epsilon is not None else self.init_eps
        output = graph.send_recv(feature, "sum") + feature * (eps + 1.0)
        output = self.layer_norm(self.linear1(output))
        if self.activation is not None:
            output = self.activation(output)
        return self.linear2(output)


def _xavier_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """flax ``xavier_uniform`` on ``shape``: the last axis is fan out, the
    second last fan in, each times the product of the others."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class RGCNConv(nn.Module):
    """R-GCN: for each edge type ``r`` of ``etypes``, the mean over the
    in-edges of ``feat @ weight[r]``, summed over the types
    (``pgl_tpu/nn/conv.py:612-643``). With ``0 < num_bases < len(etypes)``
    the weights are ``w_comp`` [R, B] combinations of ``weight`` [B, in,
    out] (basis decomposition); otherwise ``weight`` is [R, in, out].
    ``graph`` is a ``HeterGraph`` or a dict etype -> ``Graph``; each mean
    is K1 on the card, once a type each way."""

    def __init__(self, in_dim: int, out_dim: int, etypes, num_bases: int = 0,
                 *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.etypes = list(etypes)
        num_rels = len(self.etypes)
        if num_bases <= 0 or num_bases >= num_rels:
            num_bases = num_rels
        self.num_bases = num_bases
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.weight = nn.Parameter(_xavier_uniform(
            (num_bases, in_dim, out_dim), gen))
        self.w_comp = nn.Parameter(_xavier_uniform(
            (num_rels, num_bases), gen)) if num_bases < num_rels else None
        self.to(resolve_device(device))

    def forward(self, graph, feat):
        weight = self.weight
        if self.w_comp is not None:
            weight = torch.einsum("rb,bio->rio", self.w_comp, weight)
        return sum(graph[etype].send_recv(feat @ weight[i], "mean")
                   for i, etype in enumerate(self.etypes))


class _CachedPropagation(nn.Module):
    """A propagation with no parameters (``_precompute``), then the Dense
    ``linear`` without bias, an optional ``bias`` and the activation: SGC
    and SSGC (``pgl_tpu/nn/conv.py:643-727``).

    With ``cached`` the propagated features are kept on the module for the
    graph they came from (held weakly), and reused while the same graph
    comes back; another graph recomputes them, and ``clear_cache()`` drops
    them. The kept copy is detached: the first call's gradient reaches the
    input, later calls read a constant, as the reference's ``'cache'``
    collection is one."""

    def __init__(self, input_size: int, output_size: int, cached: bool,
                 activation: Any, bias: bool, generator, device):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.cached = cached
        self.activation = _resolve_act(activation)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.linear = nn.Linear(input_size, output_size, bias=False)
        lecun_normal_(self.linear.weight, gen)
        self.bias = nn.Parameter(torch.zeros(output_size)) if bias else None
        self._cache = None           # (weakref to the graph, features)
        self.to(resolve_device(device))

    def clear_cache(self):
        """Drop the propagated features kept by ``cached``."""
        self._cache = None

    def forward(self, graph, feature):
        if not self.cached:
            feature = self._precompute(graph, feature)
        elif self._cache is not None and self._cache[0]() is graph:
            feature = self._cache[1]
        else:
            feature = self._precompute(graph, feature)
            self._cache = (weakref.ref(graph), feature.detach())
        output = self.linear(feature)
        if self.bias is not None:
            output = output + self.bias
        if self.activation is not None:
            output = self.activation(output)
        return output


def sgc_precompute(graph, feature, k_hop: int):
    """``Â^k_hop x`` (``pgl_tpu/nn/conv.py:679-683``)."""
    norm = GF.degree_norm(graph, dtype=feature.dtype)
    for _ in range(k_hop):
        feature = _propagate(graph, feature, norm)
    return feature


class SGCConv(_CachedPropagation):
    """SGC: ``k_hop`` hops of ``Â``, then the Dense (``pgl_tpu/nn/
    conv.py:643-676``); ``cached`` as in :class:`_CachedPropagation`."""

    def __init__(self, input_size: int, output_size: int, k_hop: int = 2,
                 cached: bool = True, activation: Any = None,
                 bias: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_size, output_size, cached, activation, bias,
                         generator, device)
        self.k_hop = k_hop

    def _precompute(self, graph, feature):
        return sgc_precompute(graph, feature, self.k_hop)


def ssgc_precompute(graph, feature, k_hop: int, alpha: float):
    """The mean of ``k_hop`` hops of ``(1 - alpha) Â`` and the input, plus
    ``alpha`` times the input (``pgl_tpu/nn/conv.py:718-726``)."""
    norm = GF.degree_norm(graph, dtype=feature.dtype)
    ori = acc = feature
    for _ in range(k_hop):
        feature = (1 - alpha) * _propagate(graph, feature, norm)
        acc = acc + feature
    return acc / k_hop + alpha * ori


class SSGCConv(_CachedPropagation):
    """SSGC: ``ssgc_precompute``, then the Dense (``pgl_tpu/nn/
    conv.py:686-715``); ``cached`` as in :class:`_CachedPropagation`."""

    def __init__(self, input_size: int, output_size: int, k_hop: int = 16,
                 alpha: float = 0.05, cached: bool = True,
                 activation: Any = None, bias: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(input_size, output_size, cached, activation, bias,
                         generator, device)
        self.k_hop = k_hop
        self.alpha = alpha

    def _precompute(self, graph, feature):
        return ssgc_precompute(graph, feature, self.k_hop, self.alpha)


class NGCFConv(nn.Module):
    """NGCF: ``o = (Σ neighbours + x) · norm``, then ``linear(o) +
    linear2(x ⊙ o)`` and leaky relu at slope 0.2 (``pgl_tpu/nn/
    conv.py:729-743``)."""

    def __init__(self, input_size: int, output_size: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.linear = _dense(input_size, output_size, gen)
        self.linear2 = _dense(input_size, output_size, gen)
        self.to(resolve_device(device))

    def forward(self, graph, feature):
        norm = GF.degree_norm(graph, dtype=feature.dtype)
        output = (graph.send_recv(feature, "sum") + feature) * norm
        output = self.linear(output) + self.linear2(feature * output)
        return nn.functional.leaky_relu(output, 0.2)


class LightGCNConv(nn.Module):
    """LightGCN: ``Â x``, no parameters (``pgl_tpu/nn/conv.py:746-753``)."""

    def forward(self, graph, feature):
        return _propagate(graph, feature,
                          GF.degree_norm(graph, dtype=feature.dtype))


class BernProp(nn.Module):
    """BernNet's propagation: the Bernstein basis of the normalised
    Laplacian from chains of ``(I + Â)`` and ``(I - Â)``, weighted by
    ``relu(temp)`` (``pgl_tpu/nn/conv.py:781-810``): ``k_hop`` + ``k_hop
    (k_hop + 1) / 2`` hops."""

    def __init__(self, k_hop: int = 10, *, device=None):
        super().__init__()
        self.k_hop = k_hop
        self.temp = nn.Parameter(torch.ones(k_hop + 1,
                                            device=resolve_device(device)))

    def forward(self, graph, feature, norm=None):
        K = self.k_hop
        temp = torch.relu(self.temp)
        if norm is None:
            norm = GF.degree_norm(graph, dtype=feature.dtype)
        tmp = [feature]
        for _ in range(K):
            feature = feature + _propagate(graph, feature, norm)
            tmp.append(feature)
        out = (math.comb(K, 0) / (2 ** K)) * temp[0] * tmp[K]
        for i in range(K):
            feature = tmp[K - i - 1]
            for _ in range(i + 1):
                feature = feature - _propagate(graph, feature, norm)
            out = out + (math.comb(K, i + 1) / (2 ** K)) * temp[i + 1] \
                * feature
        return out


class ChebProp(nn.Module):
    """ChebNetII's propagation: learnable values ``relu(temp)`` at the
    Chebyshev nodes, interpolated into coefficients of ``T_k(Â)`` and
    summed by the three-term recurrence (``pgl_tpu/nn/conv.py:813-851``):
    ``k_hop`` hops."""

    def __init__(self, k_hop: int = 10, *, device=None):
        super().__init__()
        self.k_hop = k_hop
        self.temp = nn.Parameter(torch.ones(k_hop + 1,
                                            device=resolve_device(device)))

    def forward(self, graph, feature, norm=None):
        K = self.k_hop
        temp = torch.relu(self.temp)
        # the Chebyshev nodes x_j, j = K..0, in the reference's order
        xs = [math.cos((K - j + 0.5) * math.pi / (K + 1))
              for j in range(K + 1)]
        coes = []
        for i in range(K + 1):
            c = sum(temp[j] * math.cos(i * math.acos(xs[K - j]))
                    for j in range(K + 1))
            coes.append(2.0 * c / (K + 1))
        if norm is None:
            norm = GF.degree_norm(graph, dtype=feature.dtype)
        tx0 = feature
        tx1 = _propagate(graph, feature, norm)
        out = coes[0] / 2 * tx0 + coes[1] * tx1
        for i in range(2, K + 1):
            tx2 = 2 * _propagate(graph, tx1, norm) - tx0
            out = out + coes[i] * tx2
            tx0, tx1 = tx1, tx2
        return out
