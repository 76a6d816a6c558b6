"""Graph Multiset Transformer pooling (port of ``pgl_tpu/nn/gmt_pool.py``):
``MAB`` (multi-head attention block), ``SAB`` (self attention), ``PMA``
(pooling by attention from learned seed queries) and the
``GraphMultisetTransformer`` that chains them into one vector a graph.

As in the reference, attention is a softmax over the keys, with the
padding keys of the dense batch masked by -1e9 (the upstream library
normalises over the queries; the reference documents the departure), and
a block's K and V both project its raw input. The products are plain
``torch`` matmuls, as the reference computes them outside any kernel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .. import resolve_device
from ..utils.transform import to_dense_batch
from .conv import GCNConv, _dense

__all__ = ["MAB", "SAB", "PMA", "GraphMultisetTransformer"]


def _gen(generator):
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


class MAB(nn.Module):
    """Multi-head attention block (``pgl_tpu/nn/gmt_pool.py:26-74``): queries
    ``proj_q(Q)`` attend over keys ``layer_k`` and values ``layer_v`` of
    ``K``, Denses of ``dim_K`` inputs, or, with ``conv`` given and a
    ``(graph, x)`` pair at the call, graph convolutions ``conv(dim_K,
    dim_V)`` of the node features packed by ``to_dense_batch`` (at most
    ``max_num_nodes`` a graph); then ``Q + attention``, optional layer norm
    (``ln0``, ``ln1``), and ``+ relu(proj_o(.))``."""

    def __init__(self, dim_Q: int, dim_K: int, dim_V: int, num_heads: int,
                 conv: Optional[Callable] = None, layer_norm: bool = False,
                 max_num_nodes: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = _gen(generator)
        self.dim_V = dim_V
        self.num_heads = num_heads
        self.max_num_nodes = max_num_nodes
        self.proj_q = _dense(dim_Q, dim_V, gen)
        if conv is not None:
            self.layer_k = conv(dim_K, dim_V, generator=gen, device=device)
            self.layer_v = conv(dim_K, dim_V, generator=gen, device=device)
        else:
            self.layer_k = _dense(dim_K, dim_V, gen)
            self.layer_v = _dense(dim_K, dim_V, gen)
        self.ln0 = nn.LayerNorm(dim_V, eps=1e-6) if layer_norm else None
        self.ln1 = nn.LayerNorm(dim_V, eps=1e-6) if layer_norm else None
        self.proj_o = _dense(dim_V, dim_V, gen)
        self.to(device)

    def forward(self, Q, K, graph=None, mask=None):
        """``mask`` [B, Lk] is True at the padding keys."""
        H = self.num_heads
        Q = self.proj_q(Q)
        if graph is not None:
            g, x = graph
            K, _ = to_dense_batch(self.layer_k(g, x), g,
                                  max_num_nodes=self.max_num_nodes)
            V, _ = to_dense_batch(self.layer_v(g, x), g,
                                  max_num_nodes=self.max_num_nodes)
        else:
            K, V = self.layer_k(K), self.layer_v(K)
        B, Lq, _ = Q.shape
        Lk, dh = K.shape[1], self.dim_V // H
        q = Q.reshape(B, Lq, H, dh).transpose(1, 2)
        k = K.reshape(B, Lk, H, dh).transpose(1, 2)
        v = V.reshape(B, Lk, H, dh).transpose(1, 2)
        score = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(self.dim_V)
        if mask is not None:
            score = score + torch.where(mask, -1e9, 0.0).to(
                score.dtype)[:, None, None, :]
        out = torch.einsum("bhqk,bhkd->bhqd", score.softmax(-1), v)
        output = Q + out.transpose(1, 2).reshape(B, Lq, self.dim_V)
        if self.ln0 is not None:
            output = self.ln0(output)
        output = output + torch.relu(self.proj_o(output))
        if self.ln1 is not None:
            output = self.ln1(output)
        return output


class SAB(nn.Module):
    """Self-attention block (``pgl_tpu/nn/gmt_pool.py:77-92``): ``mab`` on
    ``(x, x)``."""

    def __init__(self, input_dim: int, output_dim: int, num_heads: int,
                 conv: Optional[Callable] = None, layer_norm: bool = False,
                 max_num_nodes: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.mab = MAB(input_dim, input_dim, output_dim, num_heads, conv,
                       layer_norm, max_num_nodes, generator=generator,
                       device=device)

    def forward(self, x, graph=None, mask=None):
        return self.mab(x, x, graph, mask)


class PMA(nn.Module):
    """Pooling by attention (``pgl_tpu/nn/gmt_pool.py:95-113``):
    ``num_seeds`` learned queries ``Q_S`` [1, num_seeds, dim] (flax's
    kaiming-uniform draw) attend over ``x`` through ``mab``."""

    def __init__(self, dim: int, num_heads: int, num_seeds: int,
                 conv: Optional[Callable] = None, layer_norm: bool = False,
                 max_num_nodes: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen = _gen(generator)
        # variance_scaling(2, fan_in, uniform): fan_in is the seed axis
        bound = math.sqrt(6.0 / num_seeds)
        self.Q_S = nn.Parameter(torch.empty(1, num_seeds, dim).uniform_(
            -bound, bound, generator=gen))
        self.mab = MAB(dim, dim, dim, num_heads, conv, layer_norm,
                       max_num_nodes, generator=gen, device=device)
        self.to(resolve_device(device))

    def forward(self, x, graph=None, mask=None):
        Q = self.Q_S.expand(x.shape[0], -1, -1)
        return self.mab(Q, x, graph, mask)


_STAGES = ("GMPool_G", "GMPool_I", "SelfAtt")


class GraphMultisetTransformer(nn.Module):
    """GMT readout (``pgl_tpu/nn/gmt_pool.py:116-181``): ``lin1``, the node
    features packed ``num_nodes`` a graph, then ``pool_sequences``
    (default GMPool_G, SelfAtt, GMPool_I): GMPool_G a ``PMA`` whose keys are
    ``conv`` (default ``GCNConv``) over the graph, GMPool_I a ``PMA`` over
    the dense rows, SelfAtt a ``SAB``; the pools keep ``ceil(num_nodes ·
    ratio)``, then that times the ratio, ... seeds, the last one; then
    ``lin2``: ``[num_graph, output_dim]``. A sequence that ends in SelfAtt
    is rejected."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 conv: Optional[Callable] = None, num_nodes: int = 30,
                 pooling_ratio: float = 0.25,
                 pool_sequences: Optional[Sequence[str]] = None,
                 num_heads: int = 4, layer_norm: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = _gen(generator)
        seqs = list(pool_sequences or ["GMPool_G", "SelfAtt", "GMPool_I"])
        for name in seqs:
            if name not in _STAGES:
                raise ValueError(
                    "Elements in 'pool_sequences' should be one of "
                    "'GMPool_G', 'GMPool_I', or 'SelfAtt'")
        if seqs[-1] == "SelfAtt":
            raise ValueError(
                "'pool_sequences' must end in a GMPool stage: SelfAtt keeps "
                "one row per remaining seed, so the final single-vector "
                "squeeze would fail")
        self.seqs = seqs
        self.num_nodes = num_nodes
        conv = conv or GCNConv
        self.lin1 = _dense(input_dim, hidden_dim, gen)
        num_out = math.ceil(num_nodes * pooling_ratio)
        for i, name in enumerate(seqs):
            if i == len(seqs) - 1:
                num_out = 1
            if name == "SelfAtt":
                pool = SAB(hidden_dim, hidden_dim, num_heads, None,
                           layer_norm, generator=gen, device=device)
            else:
                graph_keys = name == "GMPool_G"
                pool = PMA(hidden_dim, num_heads, num_out,
                           conv if graph_keys else None, layer_norm,
                           num_nodes if graph_keys else None,
                           generator=gen, device=device)
                num_out = math.ceil(num_out * pooling_ratio)
            self.add_module(f"pool_{i}", pool)
        self.lin2 = _dense(hidden_dim, output_dim, gen)
        self.to(device)

    def forward(self, graph, x):
        x = self.lin1(x)
        batch_x, mask = to_dense_batch(x, graph, max_num_nodes=self.num_nodes)
        for i, name in enumerate(self.seqs):
            g = (graph, x) if name == "GMPool_G" else None
            batch_x = getattr(self, f"pool_{i}")(batch_x, g, mask)
            # a pool's rows are seeds, all valid; SelfAtt keeps the nodes
            if name != "SelfAtt":
                mask = None
        return self.lin2(batch_x.squeeze(1))
