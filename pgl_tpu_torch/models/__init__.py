from .gnn import GAT, GCN
from .unimp import UniMP

__all__ = ["GCN", "GAT", "UniMP"]
