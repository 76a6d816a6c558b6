"""Sampling: layered neighbour sampling, walks on the host and the device,
subgraph extraction (port of ``pgl_tpu/sampling``);
``metapath_randomwalk_dist`` walks through a distributed graph client."""

from .sage import (graphsage_sample, NeighborSampler,
                   HeteroNeighborSampler, sample_neighbors_padded,
                   make_padded_batch_fn, pack_padded_batch,
                   unpack_padded_batch, padded_batch_graph,
                   max_batch_words)
from .walk import (random_walk, node2vec_walk, node2vec_walk_plus,
                   walks_to_lists, metapath_randomwalk,
                   metapath_randomwalk_dist)
from .device_walk import DeviceWalker, skipgram_pairs
from .custom import (subgraph, graph_saint_node_sample,
                     graph_saint_random_walk_sample,
                     pinsage_sample, random_walk_with_restart)

__all__ = ["DeviceWalker", "skipgram_pairs", "graphsage_sample",
           "NeighborSampler", "HeteroNeighborSampler",
           "sample_neighbors_padded", "make_padded_batch_fn",
           "pack_padded_batch", "unpack_padded_batch", "padded_batch_graph",
           "max_batch_words",
           "graph_saint_node_sample", "graph_saint_random_walk_sample",
           "pinsage_sample", "random_walk_with_restart", "random_walk",
           "node2vec_walk", "node2vec_walk_plus", "walks_to_lists",
           "metapath_randomwalk", "metapath_randomwalk_dist", "subgraph"]
