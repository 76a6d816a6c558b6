"""Graph pooling layers (port of ``pgl_tpu/nn/pool.py``): the readouts
``GraphPool``, ``GraphNorm``, ``Set2Set`` and ``GlobalAttention``, and the
top-k node pooling ``SAGPool``.

``SAGPool`` keeps a dynamic node subset: by default it rebuilds the pooled
graph on the host, as the reference does; with ``static=True`` it keeps the
graph and zeroes the dropped nodes instead.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..ops.segment import (segment_softmax, segment_sum, segment_topk,
                           segment_topk_mask)
from .aggregation import lstm_cell
from .conv import GCNConv
from .functional import graph_op as GF

__all__ = ["GraphPool", "GraphNorm", "Set2Set", "GlobalAttention",
           "SAGPool"]


class GraphPool(nn.Module):
    """Pool node features per subgraph into ``[num_graph, dim]``
    (``pgl_tpu/nn/pool.py:25-31``)."""

    def __init__(self, pool_type: str = "sum"):
        super().__init__()
        self.pool_type = pool_type

    def forward(self, graph, feature):
        return GF.graph_pool(graph, feature, self.pool_type)


class GraphNorm(nn.Module):
    """Divide node features by the square root of their subgraph's node
    count (``pgl_tpu/nn/pool.py:34-40``)."""

    def forward(self, graph, feature):
        return GF.graph_norm(graph, feature)


class Set2Set(nn.Module):
    """Set2Set readout (``pgl_tpu/nn/pool.py:43-74``): ``n_iters`` rounds of
    an ``n_layers`` LSTM stack (``lstm_{i}``, carries from zeros) whose
    output queries each subgraph's nodes by a segment softmax; returns
    ``[num_graph, 2 * input_dim]``, the query and the attended sum."""

    def __init__(self, input_dim: int, n_iters: int, n_layers: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_dim = input_dim
        self.n_iters = n_iters
        self.n_layers = n_layers
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        for i in range(n_layers):
            self.add_module(f"lstm_{i}", lstm_cell(
                2 * input_dim if i == 0 else input_dim, input_dim, gen))
        self.to(resolve_device(device))

    def forward(self, graph, x):
        B, D = graph.num_graph, self.input_dim
        ids = torch.as_tensor(graph.graph_node_id, device=x.device)
        carries = [(x.new_zeros(B, D), x.new_zeros(B, D))
                   for _ in range(self.n_layers)]
        q_star = x.new_zeros(B, 2 * D)
        for _ in range(self.n_iters):
            h = q_star
            for i in range(self.n_layers):
                carries[i] = getattr(self, f"lstm_{i}")(h, carries[i])
                h = carries[i][0]
            e = (x * h.index_select(0, ids)).sum(-1, keepdim=True)
            a = segment_softmax(e, ids, B)
            q_star = torch.cat([h, segment_sum(a * x, ids, B)], dim=-1)
        return q_star


class GlobalAttention(nn.Module):
    """Gated attention readout (``pgl_tpu/nn/pool.py:77-97``): ``gate`` maps
    ``[N, d]`` to one score a node, softmaxed within each subgraph; the
    subgraph's output is the score-weighted sum of its nodes' features,
    passed first through ``feat_nn`` when given. ``gate`` and ``feat_nn``
    are modules."""

    def __init__(self, gate: Callable, feat_nn: Optional[Callable] = None):
        super().__init__()
        self.gate = gate
        self.feat_nn = feat_nn

    def forward(self, graph, x):
        ids = torch.as_tensor(graph.graph_node_id, device=x.device)
        gate_x = self.gate(x).reshape(-1, 1)
        if self.feat_nn is not None:
            x = self.feat_nn(x)
        gate_x = segment_softmax(gate_x, ids, graph.num_graph)
        return segment_sum(gate_x * x, ids, graph.num_graph)


class SAGPool(nn.Module):
    """Self-attention graph pooling (``pgl_tpu/nn/pool.py:100-170``): a GNN
    (``gnn``, default a ``GCNConv(input_dim, 1)`` named ``score_gnn``)
    scores each node; the score goes through ``nonlinearity`` (tanh), or
    with ``min_score`` a segment softmax; each subgraph keeps its
    ``ceil(ratio * n)`` best nodes (with ``min_score``, those scoring at
    least ``min(its max, min_score)``), scaled by their scores.

    * default: returns ``(x, batch, graph)``, the kept rows in subgraph
      order, their subgraph ids and the induced graph rebuilt on the host
      (``filter_adj``, ``graph_edge_id`` carried over), put on ``x``'s
      device when the input graph is a device graph;
    * ``static=True``: returns ``(x, keep, graph)``, every row (dropped
      ones zeroed), the bool keep mask and the same graph.
    """

    def __init__(self, input_dim: int, ratio: float = 0.5, gnn=None,
                 min_score: Optional[float] = None,
                 nonlinearity: Optional[Callable] = None,
                 static: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_dim = input_dim
        self.ratio = ratio
        self.min_score = min_score
        self.nonlinearity = nonlinearity
        self.static = static
        if gnn is None:
            self.score_gnn = GCNConv(input_dim, 1, generator=generator,
                                     device=device)
        else:
            self.gnn = gnn

    def forward(self, graph, x):
        from ..graph import Graph
        from ..utils.transform import filter_adj

        gnn = self.gnn if hasattr(self, "gnn") else self.score_gnn
        B = graph.num_graph
        batch = torch.as_tensor(graph.graph_node_id, device=x.device)
        score = gnn(graph, x).reshape(-1)
        if self.min_score is None:
            score = (self.nonlinearity or torch.tanh)(score)
        else:
            score = segment_softmax(score, batch, B)
        if self.static:
            keep = segment_topk_mask(score, batch, B, ratio=self.ratio,
                                     min_score=self.min_score)
            x = x * (score * keep.to(score.dtype)).reshape(-1, 1)
            return x, keep, graph
        out, rank = segment_topk(x, score, batch, B, ratio=self.ratio,
                                 min_score=self.min_score)
        x = out * score.index_select(0, rank).reshape(-1, 1)
        new_batch = batch.index_select(0, rank)
        edges, kept_edge_graph = filter_adj(
            np.asarray(graph.edges.cpu() if graph.is_tensor
                       else graph.edges),
            rank.cpu().numpy(), num_nodes=score.shape[0],
            edge_attr=np.asarray(torch.as_tensor(graph.graph_edge_id).cpu()))
        counts = np.bincount(new_batch.cpu().numpy(), minlength=B)
        ecounts = np.bincount(kept_edge_graph, minlength=B)
        pooled = Graph(edges, num_nodes=int(x.shape[0]),
                       node_feat={"attr": x.detach().cpu().numpy()},
                       _graph_node_index=np.concatenate(
                           [[0], np.cumsum(counts)]).astype(np.int32),
                       _graph_edge_index=np.concatenate(
                           [[0], np.cumsum(ecounts)]).astype(np.int32),
                       _num_graph=B)
        if graph.is_tensor:
            pooled = pooled.tensor(x.device)
        return x, new_batch, pooled
