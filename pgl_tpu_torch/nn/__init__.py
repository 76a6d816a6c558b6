from .conv import GATConv, GCNConv, TransformerConv
from . import functional

__all__ = ["GCNConv", "GATConv", "TransformerConv", "functional"]
