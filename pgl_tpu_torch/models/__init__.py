from .gnn import (GCN, GAT, GraphSage, GIN, DeepGCNII, APPNPModel, SGC,
                  SSGC, GATv2, GPRGNN, FAGCN, BernNet, ChebNetII)
from .unimp import UniMP

__all__ = ["GCN", "GAT", "GraphSage", "GIN", "DeepGCNII", "APPNPModel",
           "SGC", "SSGC", "GATv2", "GPRGNN", "FAGCN", "BernNet",
           "ChebNetII", "UniMP"]
