from .gnn import (GCN, GAT, GraphSage, GIN, DeepGCNII, APPNPModel, SGC,
                  SSGC, GATv2, GPRGNN, FAGCN, BernNet, ChebNetII, LSTMSage)
from .unimp import UniMP, RUniMP, label_propagation_smooth
from .sampled_sage import BipartiteSAGE
from . import kg

__all__ = ["GCN", "GAT", "GraphSage", "GIN", "DeepGCNII", "APPNPModel",
           "SGC", "SSGC", "GATv2", "GPRGNN", "FAGCN", "BernNet",
           "ChebNetII", "LSTMSage", "UniMP", "RUniMP",
           "label_propagation_smooth", "BipartiteSAGE", "kg"]
