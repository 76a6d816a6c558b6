from .graph_op import degree_norm, edge_softmax

__all__ = ["degree_norm", "edge_softmax"]
