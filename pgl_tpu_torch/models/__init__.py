from .gnn import (GCN, GAT, GraphSage, GIN, DeepGCNII, APPNPModel, SGC,
                  SSGC, GATv2, GPRGNN, FAGCN, BernNet, ChebNetII, LSTMSage)
from .unimp import UniMP, RUniMP, label_propagation_smooth

__all__ = ["GCN", "GAT", "GraphSage", "GIN", "DeepGCNII", "APPNPModel",
           "SGC", "SSGC", "GATv2", "GPRGNN", "FAGCN", "BernNet",
           "ChebNetII", "LSTMSage", "UniMP", "RUniMP",
           "label_propagation_smooth"]
