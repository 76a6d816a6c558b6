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
from ..ops.kernels.attention_kernels import fused_gat_attention
from ..ops.kernels.dedup_attention import dedup_gat_attention
from .functional import graph_op as GF

__all__ = ["GCNConv", "GATConv", "lecun_normal_"]

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


def _resolve_act(activation) -> Optional[Callable]:
    """A callable, or a name looked up in ``torch.nn.functional`` and then
    on ``torch`` (``"elu"`` lives only in the first)."""
    if activation is None or callable(activation):
        return activation
    fn = getattr(nn.functional, activation, None)
    return fn if fn is not None else getattr(torch, activation)


def _check_drop_mode(mode):
    if mode not in ("edge", "cell"):
        raise ValueError(
            f"attn_drop_mode must be 'edge' or 'cell', got {mode!r}")


def _dropout(x, rate: float, generator: torch.Generator):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    by 1 / (1 - rate); the mask comes from ``generator``."""
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


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
    (``ops/kernels/attention_kernels.py``).

    Dropout draws from the layer's own generator on its device
    (``self.generator``, seeded from ``generator`` at construction): the
    feature mask, and on each training forward one int32 seed for the
    attention's hash dropout (the counterpart of ``_attn_drop_seed``).
    ``attn_drop_mode="cell"`` keeps a multigraph under dropout on K7/K8,
    whose mask drops a cell's duplicate edges together (the same
    expectation as edge dropout).

    Where the reference leaves its fused kernels, this layer raises
    ``NotImplementedError``: training with attention dropout at ``3·H >
    128`` (its unfused ``send_uv`` path), and ``3·H > 128`` off the
    count-matrix route (its dot-mode kernels); neither is ported yet.
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
        self.linear = nn.Linear(input_size, num_heads * hidden_size)
        lecun_normal_(self.linear.weight, gen)
        nn.init.zeros_(self.linear.bias)
        # flax xavier_uniform on [H, Dh]: fan_in H, fan_out Dh, as torch's
        self.weight_src = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(num_heads, hidden_size), generator=gen))
        self.weight_dst = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(num_heads, hidden_size), generator=gen))
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(torch.randint(
            0, 2 ** 62, (1,), generator=gen)))
        self.to(device)

    def _route(self, graph, rate: float):
        """The count-matrix attention's work lists where the reference takes
        K7/K8 (``pgl_tpu/nn/conv.py:202-240``), None where it takes K9/K10;
        raises where it leaves the fused kernels."""
        H = self.num_heads
        if rate > 1e-15 and 3 * H > 128:
            raise NotImplementedError(
                f"GATConv with {H} heads trains with attention dropout on "
                "the reference's unfused path (send_uv, send_ue_recv; 3·H > "
                "128), which is not ported yet")
        dedup = graph._dedup_layouts
        if dedup is not None and not (rate > 0.0 and not dedup[0].simple
                                      and self.attn_drop_mode != "cell"):
            return graph._dedup_attn_aux()
        if 3 * H > 128:
            raise NotImplementedError(
                f"GATConv with {H} heads takes the reference's dot-mode "
                "attention (3·H > 128), which is not ported yet")
        return None

    def forward(self, graph, feature, training: bool = False):
        H, Dh = self.num_heads, self.hidden_size
        rate = float(self.attn_drop) if training else 0.0
        dedup = self._route(graph, rate)
        if training and self.feat_drop > 1e-15:
            feature = _dropout(feature, self.feat_drop, self.generator)
        feature = self.linear(feature)
        heads = feature.reshape(-1, H, Dh)
        attn_src = (heads * self.weight_src).sum(-1)
        attn_dst = (heads * self.weight_dst).sum(-1)
        seed = None
        if rate > 1e-15:
            seed = torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                                 generator=self.generator,
                                 device=self.generator.device)
        if dedup is not None:
            out = dedup_gat_attention(attn_dst, attn_src, feature, dedup,
                                      0.2, dvh=Dh, attn_drop=rate,
                                      drop_seed=seed)
        else:
            out = fused_gat_attention(attn_dst, attn_src, feature,
                                      *graph._attention_layouts(), 0.2,
                                      dvh=Dh, attn_drop=rate, drop_seed=seed)
        output = out.reshape(-1, H, Dh)
        if self.concat:
            output = output.reshape(-1, H * Dh)
        else:
            output = output.mean(dim=1)
        if self.activation is not None:
            output = self.activation(output)
        return output
