"""Functional graph operators (port of
``pgl_tpu/nn/functional/graph_op.py``)."""

from __future__ import annotations

import torch

from ...ops.segment import segment_count, segment_pool, segment_softmax

__all__ = ["degree_norm", "graph_pool", "graph_norm", "edge_softmax"]


def degree_norm(graph, mode: str = "indegree", dtype=torch.float32):
    """``clip(degree, 1)^-0.5`` as a ``[N, 1]`` column."""
    if mode == "indegree":
        degree = graph.indegree()
    elif mode == "outdegree":
        degree = graph.outdegree()
    else:
        raise ValueError(
            "The degree_norm mode should be in ['indegree', 'outdegree']. "
            f"But receive mode={mode}")
    # a host graph's degrees are numpy, as ``jnp.asarray`` takes them there
    degree = torch.as_tensor(degree).to(dtype)
    return degree.clamp(min=1.0).pow(-0.5).unsqueeze(-1)


def graph_pool(graph, feature, pool_type: str):
    """Pool node features per subgraph (``sum``, ``mean``, ``max`` or
    ``min``) into ``[num_graph, ...]`` (``pgl_tpu/nn/functional/
    graph_op.py:36-41``)."""
    return segment_pool(feature, graph.graph_node_id, pool_type,
                        num_segments=graph.num_graph)


def graph_norm(graph, feature):
    """Divide each node's features by the square root of its subgraph's
    node count (``pgl_tpu/nn/functional/graph_op.py:44-51``)."""
    ids = graph.graph_node_id
    counts = segment_count(ids, num_segments=graph.num_graph)
    norm = counts.to(feature.dtype).sqrt()
    return feature / norm[ids][:, None]


def edge_softmax(graph, logits, norm_by: str = "dst"):
    """Softmax of per-edge ``logits`` ([E] or [E, ...]) over each node's
    incoming (``norm_by="dst"``) or outgoing (``"src"``) edges, in the
    original edge order (``pgl_tpu/nn/functional/graph_op.py:54-66``). On a
    ``HaloGraph`` or ``ShardedGraph`` (which carry their own
    ``edge_softmax``) ``logits`` is the rank's ``[E_pad, ...]`` edge layout,
    normalised over incoming edges only, as in the reference."""
    if hasattr(graph, "edge_softmax"):
        if norm_by != "dst":
            raise NotImplementedError(
                "a partitioned graph's edge_softmax normalizes over "
                "incoming edges (each shard owns all in-edges of its dst "
                "rows); norm_by='src' would need a second exchange")
        return graph.edge_softmax(logits)
    if norm_by not in ("dst", "src"):
        raise ValueError(f"norm_by must be 'dst' or 'src', got {norm_by!r}")
    seg = graph.edges[:, 1 if norm_by == "dst" else 0].contiguous()
    return segment_softmax(logits, seg, num_segments=graph.num_nodes)
