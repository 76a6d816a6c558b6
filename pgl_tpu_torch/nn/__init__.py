from .conv import GATConv, GCNConv
from . import functional

__all__ = ["GCNConv", "GATConv", "functional"]
