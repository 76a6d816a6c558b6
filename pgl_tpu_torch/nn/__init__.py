"""Graph neural network layers (port of ``pgl_tpu/nn``)."""

from . import functional
from .conv import (
    GCNConv, GATConv, GATv2Conv, APPNP, GPRConv, GCNII, TransformerConv,
    GINConv, GraphSageConv, PinSageConv, RGCNConv, SGCConv, SSGCConv,
    NGCFConv, LightGCNConv, FAConv, BernProp, ChebProp,
)
from .pool import GraphPool, GraphNorm, Set2Set, GlobalAttention, SAGPool
from .gmt_pool import GraphMultisetTransformer
from .aggregation import LSTMAggregation

__all__ = [
    "functional",
    "GCNConv", "GATConv", "GATv2Conv", "APPNP", "GPRConv", "GCNII",
    "TransformerConv", "GINConv", "GraphSageConv", "PinSageConv", "RGCNConv",
    "SGCConv", "SSGCConv", "NGCFConv", "LightGCNConv", "FAConv",
    "BernProp", "ChebProp",
    "GraphPool", "GraphNorm", "Set2Set", "GlobalAttention", "SAGPool",
    "GraphMultisetTransformer", "LSTMAggregation",
]
