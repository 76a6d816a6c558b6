from .graph_op import degree_norm, graph_pool, graph_norm, edge_softmax

__all__ = ["degree_norm", "graph_pool", "graph_norm", "edge_softmax"]
