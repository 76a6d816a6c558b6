"""Multi-host helpers: bootstrap and host-sharded graph loading.

Port of ``pgl_tpu/parallel/multihost.py``. :func:`initialize` is
``comm.init`` (``torchrun`` sets the rendezvous), :func:`edge_mesh` the
world group, and :func:`sharded_graph_from_host_shards` builds a
``ShardedGraph`` in which each rank loads only its own edge shard (shard id
= rank); the pad length is agreed by an all-reduce of the ranks' maxima
(the reference left that to the caller, ``:75-96``).

Typical use, the same program on every rank::

    initialize()
    sg = sharded_graph_from_host_shards(
        lambda shard_id: np.load(f"edges_{shard_id}.npy"), num_nodes=N)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import comm
from .dist_graph import ShardedGraph

__all__ = ["initialize", "edge_mesh", "sharded_graph_from_host_shards",
           "shard_edge_values_from_host_shards"]


def initialize(**kwargs):
    """``comm.init(**kwargs)``: join the default process group (a no-op
    when one exists) and return it."""
    return comm.init(**kwargs)


def edge_mesh(axis: str = "edge"):
    """The group of every rank (the reference's 1-D mesh over every global
    device); ``axis`` is accepted for the reference's signature."""
    return comm.world(None)[0]


def sharded_graph_from_host_shards(
        load_shard: Callable[[int], np.ndarray], num_nodes: int, group=None,
        node_feat: Optional[Dict] = None, device=None) -> ShardedGraph:
    """A ShardedGraph where rank r loads only ``load_shard(r)`` (its ``[E_r,
    2]`` global-id edges): sorted by destination (stably), padded to the
    ranks' agreed length rounded up to 128. Node features are replicated
    (each rank passes the full arrays). ``perm_scope`` is "local": per-edge
    values go through :func:`shard_edge_values_from_host_shards`."""
    group, _, rank = comm.world(group)
    e = np.asarray(load_shard(rank)).reshape(-1, 2)
    order = np.argsort(e[:, 1], kind="stable")
    e = e[order]
    dev = comm.rank_device(device)
    longest = torch.tensor([max(len(e), 1)], dtype=torch.int64, device=dev)
    e_pad = int(comm.all_reduce_(longest, dist.ReduceOp.MAX, group)[0])
    e_pad = (e_pad + 127) // 128 * 128
    edges = np.zeros((e_pad, 2), np.int64)
    mask = np.zeros(e_pad, np.float32)
    perm = np.zeros(e_pad, np.int32)
    edges[:len(e)] = e
    mask[:len(e)] = 1.0
    perm[:len(e)] = order
    feats = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in (node_feat or {}).items()}
    return ShardedGraph(edges, mask, perm, num_nodes, group, dev,
                        node_feat=feats, perm_scope="local")


def shard_edge_values_from_host_shards(
        sg: ShardedGraph, load_values: Callable[[int], np.ndarray]):
    """This rank's per-edge values ``load_values(rank)`` (in the order its
    ``load_shard`` returned the edges) in the graph's ``[E_pad, ...]``
    destination-sorted layout, pads 0."""
    v = np.asarray(load_values(sg.rank))
    out = np.zeros((sg.e_pad,) + v.shape[1:], v.dtype)
    out[:sg.k] = v[sg._host_perm[:sg.k]]
    return torch.as_tensor(out, device=sg.device)
