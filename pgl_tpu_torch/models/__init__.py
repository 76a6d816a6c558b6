from .gnn import FAGCN, GAT, GATv2, GCN
from .unimp import UniMP

__all__ = ["GCN", "GAT", "GATv2", "FAGCN", "UniMP"]
