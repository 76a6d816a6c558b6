"""Graph pooling layers (port of ``pgl_tpu/nn/pool.py``): the readouts
``GraphPool`` and ``GraphNorm``, which hold no parameters."""

from __future__ import annotations

from torch import nn

from .functional import graph_op as GF

__all__ = ["GraphPool", "GraphNorm"]


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
