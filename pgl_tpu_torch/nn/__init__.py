from .conv import (FAConv, GATConv, GATv2Conv, GCNConv, PinSageConv,
                   TransformerConv)
from . import functional

__all__ = ["GCNConv", "GATConv", "GATv2Conv", "PinSageConv", "FAConv",
           "TransformerConv", "functional"]
