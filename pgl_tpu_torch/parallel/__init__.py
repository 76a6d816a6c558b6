"""Multi-process parallelism on ``torch.distributed``, one rank a process
(port of ``pgl_tpu/parallel``): node-partitioned graphs with halo exchange
(``HaloGraph``, ``HaloHeterGraph``), edge-partitioned graphs
(``ShardedGraph``, the ``DistGPUGraph`` analog), row-sharded embedding
tables, and the multi-host bootstrap and loaders. A process group takes
the place of the reference's mesh axis; ``comm`` holds the collectives.
"""

from . import comm
from .dist_graph import ShardedGraph, shard_edges
from .halo_graph import HaloGraph, build_halo_partition
from .halo_heter import HaloHeterGraph
from .embedding import ShardedEmbedding
from . import multihost

__all__ = ["ShardedGraph", "shard_edges", "HaloGraph",
           "build_halo_partition", "HaloHeterGraph", "ShardedEmbedding",
           "multihost", "comm"]
