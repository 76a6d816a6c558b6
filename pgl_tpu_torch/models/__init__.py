from .gnn import GAT, GCN

__all__ = ["GCN", "GAT"]
