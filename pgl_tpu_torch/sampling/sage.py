"""GraphSAGE layered neighbour sampling (port of ``pgl_tpu/sampling/sage.py``).

Host path: :func:`graphsage_sample`, the reference's numpy over the port's
C++ sampler, so a seed gives the reference's subgraphs; and the
minibatch collate :func:`make_padded_batch_fn`, which pads a sample into
fixed buckets (:func:`pack_padded_batch` puts it in one int32 buffer,
:func:`unpack_padded_batch` reads it back). With ``layouts=True`` the
collate also builds both K1 layouts of the padded graph on the host
(``segment_kernels.build_spmm_layout_host``) and appends them to the
buffer, so that :func:`padded_batch_graph` hands the step a device
``Graph`` whose SpMM needs no host work. A collate builds numpy arrays only:
a dataloader worker forked from a process that holds a CUDA context runs
it.

Device path: :class:`NeighborSampler` and :class:`HeteroNeighborSampler`
emit padded ``[B, k]`` neighbour blocks with masks (sampling with
replacement), drawing from a ``torch.Generator``; each is a public method
that draws, over an internal one (``_from_uniforms``) that takes the
draws as tensors. The draws' order: :func:`graphsage_sample` samples
``samples[-1]`` around the seeds first, :class:`NeighborSampler`
``samples[0]``.

The draws' arithmetic is the reference's: ``floor(u * deg)`` in float32,
with ``u < 1`` a float32 and ``deg`` converted to float32. It stays below
``deg`` for every degree below 2^31: the product rounds to at most
``fl(deg) - ulp(fl(deg))``, and ``fl(deg)`` is at most half an ulp above
``deg``. Where the reference's ``jnp.take`` reads past a table (a
zero-degree node at the end of ``sorted_v``, or an id that is such a
fill), its default fill mode gives ``INT32_MIN``; the port's gathers give
the same, so both packages' blocks are equal wherever the mask is 0 too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..graph import Graph
from ..native import graph_kernel as native
from ..ops.kernels.segment_kernels import (build_spmm_layout_host,
                                           pack_spmm_layout,
                                           packed_layout_words_max,
                                           unpack_spmm_layout)
from ..utils.edge_index import EdgeIndex

__all__ = ["graphsage_sample", "NeighborSampler",
           "HeteroNeighborSampler", "sample_neighbors_padded",
           "make_padded_batch_fn", "pack_padded_batch",
           "unpack_padded_batch", "padded_batch_graph", "max_batch_words"]

INT32_MIN = -2 ** 31


def _ordered_union(base: np.ndarray, new: np.ndarray):
    """Append unseen values of ``new`` (first-occurrence order) to ``base``.
    Returns (union, fresh)."""
    if new.size == 0:
        return base, new
    mask = ~np.isin(new, base)
    fresh = new[mask]
    if fresh.size:
        _, first = np.unique(fresh, return_index=True)
        fresh = fresh[np.sort(first)]
    return np.concatenate([base, fresh]), fresh


def graphsage_sample(graph, nodes, samples: Sequence[int],
                     ignore_edges=(), seed: int = 0):
    """Layered reverse neighbor sampling.

    Args:
      graph: numpy-mode Graph.
      nodes: seed node ids.
      samples: neighbors per layer, e.g. ``[25, 10]``.
      ignore_edges: iterable of (src, dst) pairs to skip (e.g. the linkage
        being predicted).

    Returns a list of ``num_layers`` tuples ``(subgraph, sample_index,
    node_index)`` where ``sample_index[i]`` is the parent-graph id of
    subgraph node ``i`` and ``node_index`` are the reindexed seed ids.
    Layer ``i``'s subgraph contains edges from sampling steps ``i..L-1``
    (reference accumulation order).
    """
    if graph.is_tensor:
        raise ValueError("You must call Graph.numpy() first.")
    seeds = np.asarray(nodes, dtype=np.int64)
    num_layers = len(samples)
    index = graph.adj_dst_index
    indptr = np.asarray(index.indptr)
    sorted_v = np.asarray(index.sorted_v)
    sorted_eid = np.asarray(index.sorted_eid)

    ignore = None
    if len(ignore_edges):
        # exact key: s * num_nodes + d (Python ints don't overflow) — a
        # fixed multiplier would collide once ids exceed it
        base = int(graph.num_nodes)
        ig = np.asarray(list(ignore_edges), dtype=np.int64)
        ignore = set(int(s) * base + int(d) for s, d in ig)

    all_nodes = seeds.copy()
    all_eids = np.zeros((0,), dtype=np.int64)
    all_edges = np.zeros((0, 2), dtype=np.int64)
    start_nodes = seeds
    snapshots = []  # (eids, edges) after each processed layer

    for layer_idx in reversed(range(num_layers)):
        if start_nodes.size:
            out_indptr, out_v, out_eid = native.sample_subset_with_eid(
                indptr, sorted_v, sorted_eid, start_nodes,
                samples[layer_idx], seed=seed + layer_idx)
            counts = np.diff(out_indptr)
            dst = np.repeat(start_nodes, counts)
            src = out_v
            eids = out_eid
            if ignore is not None and src.size:
                keep = np.fromiter(
                    ((int(s) * base + int(d)) not in ignore
                     for s, d in zip(src, dst)), dtype=bool, count=len(src))
                src, dst, eids = src[keep], dst[keep], eids[keep]
            # dedupe eids against everything collected so far
            if eids.size:
                mask = ~np.isin(eids, all_eids)
                fresh_e = eids[mask]
                if fresh_e.size:
                    _, first = np.unique(fresh_e, return_index=True)
                    order = np.sort(first)
                    all_eids = np.concatenate([all_eids, fresh_e[order]])
                    all_edges = np.concatenate(
                        [all_edges,
                         np.stack([src[mask][order], dst[mask][order]],
                                  axis=1)])
            all_nodes, fresh_nodes = _ordered_union(all_nodes, src)
            start_nodes = fresh_nodes
        snapshots.append((all_eids.copy(), all_edges.copy()))

    snapshots = snapshots[::-1]  # snapshots[i] for output layer i
    sample_index = all_nodes
    node_index = native.map_nodes(all_nodes, seeds)

    # every layer's edge list is a prefix of the full accumulated set
    # (all_eids/all_edges only ever append), so reindex and feature-slice
    # ONCE and hand each layer its prefix — the per-layer subgraph()
    # calls redid the map_nodes pass and the [num_sampled, D] feature
    # gathers num_layers times
    full_eids, full_edges = snapshots[0]
    if full_edges.size:
        sub_edges_full = native.map_nodes(
            all_nodes, full_edges.reshape(-1)).reshape(-1, 2)
    else:
        sub_edges_full = np.zeros((0, 2), dtype=np.int64)
    node_feat = {k: np.asarray(v)[all_nodes]
                 for k, v in graph.node_feat.items()}
    graph_list = []
    for i in range(num_layers):
        eids_i, _ = snapshots[i]
        k = len(eids_i)
        edge_feat = {key: np.asarray(v)[eids_i]
                     for key, v in graph.edge_feat.items()}
        sg = Graph(sub_edges_full[:k], num_nodes=len(all_nodes),
                   node_feat=node_feat, edge_feat=edge_feat)
        graph_list.append((sg, sample_index, node_index))
    return graph_list


def _take(table, idx):
    """``table[idx]`` with ``jnp.take``'s default rule: an index in ``[-n,
    0)`` counts from the end, one outside ``[-n, n)`` gives
    ``INT32_MIN``."""
    n = table.shape[0]
    ok = (idx >= -n) & (idx < n)
    if n == 0:
        return torch.full_like(idx, INT32_MIN)
    safe = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return torch.where(ok, table[safe].to(idx.dtype),
                       torch.full_like(idx, INT32_MIN))


def _offsets(degs, u):
    """``floor(u * max(deg, 1))`` in ``u``'s dtype, the offset of each draw
    in its row, int64: ``degs`` [B], ``u`` [B, k]."""
    return torch.floor(u * degs.clamp(min=1)[:, None].to(u.dtype)).to(
        torch.int64)


def _neighbors_from_uniforms(indptr, sorted_v, nodes, u):
    """The padded sample of ``nodes`` [B] given the uniforms ``u`` [B, k]:
    ``(neighbors [B, k], mask [B, k])``, int32 and bool."""
    nodes = nodes.to(torch.int64)
    starts = _take(indptr, nodes).to(torch.int64)
    degs = _take(indptr, nodes + 1).to(torch.int64) - starts
    offs = _offsets(degs, u)
    neigh = _take(sorted_v, starts[:, None] + offs).to(torch.int32)
    mask = (degs > 0)[:, None].expand(-1, u.shape[1])
    return neigh, mask


def sample_neighbors_padded(indptr, sorted_v, nodes, k: int,
                            generator: torch.Generator):
    """Uniform neighbour sampling with replacement from a CSC on the device
    (``indptr`` [N+1], ``sorted_v`` [E], int32): ``(neighbors [B, k],
    mask [B, k])`` for ``nodes`` [B], the uniforms drawn from
    ``generator``. A zero-degree node gets mask 0."""
    u = torch.rand((nodes.shape[0], k), generator=generator,
                   device=nodes.device)
    return _neighbors_from_uniforms(indptr, sorted_v, nodes, u)


def _device_csc(graph, device):
    if graph.num_edges >= 2 ** 31:
        raise ValueError(
            f"the device sampler stores indptr as int32; {graph.num_edges}"
            " edges would wrap — shard the graph first")
    idx = graph.adj_dst_index
    if idx.is_tensor:
        idx = idx.numpy()
    return (torch.as_tensor(np.asarray(idx.indptr, np.int32), device=device),
            torch.as_tensor(np.asarray(idx.sorted_v, np.int32),
                            device=device))


class NeighborSampler:
    """Device-side layered sampler producing padded neighbour blocks.

    For each layer size ``k`` (``samples[0]`` first) it emits ``(frontier,
    neighbors [B, k], mask [B, k])``; the next frontier is the flattened
    neighbour block. ``sample`` returns the blocks deepest first and the
    last frontier. The CSC goes to ``device`` (default: the CUDA card) as
    int32 once.
    """

    def __init__(self, graph, samples: Sequence[int], device=None):
        self.device = resolve_device(device)
        self.indptr, self.sorted_v = _device_csc(graph, self.device)
        self.samples = list(samples)

    def sample(self, nodes, generator: torch.Generator):
        """The blocks of ``nodes``, one ``torch.rand`` of ``[len(frontier),
        k]`` a layer from ``generator``."""
        n = torch.as_tensor(nodes).shape[0]
        uniforms = []
        for k in self.samples:
            uniforms.append(torch.rand((n, k), generator=generator,
                                       device=self.device))
            n *= k
        return self._from_uniforms(nodes, uniforms)

    def _from_uniforms(self, nodes, uniforms):
        """:meth:`sample` given its draws, a ``[B_l, k_l]`` tensor a layer."""
        layers = []
        frontier = torch.as_tensor(nodes, device=self.device)
        for k, u in zip(self.samples, uniforms):
            neigh, mask = _neighbors_from_uniforms(
                self.indptr, self.sorted_v, frontier, u)
            layers.append((frontier, neigh, mask))
            frontier = neigh.reshape(-1)
        return layers[::-1], frontier


class HeteroNeighborSampler:
    """Per-edge-type padded device sampler over a ``HeterGraph``: each layer
    samples ``k`` neighbours for every edge type in ``etypes`` (all by
    default); the next frontier is the old one followed by every type's
    flattened block."""

    def __init__(self, hetergraph, samples: Sequence[int],
                 etypes: Optional[Sequence[str]] = None, device=None):
        self.device = resolve_device(device)
        self.etypes = list(etypes or hetergraph.edge_types)
        self.samples = list(samples)
        self._csc = {etype: _device_csc(hetergraph[etype], self.device)
                     for etype in self.etypes}

    def sample(self, nodes, generator: torch.Generator):
        """The blocks of ``nodes``: one ``torch.rand`` of ``[len(frontier),
        k]`` an edge type a layer, in ``etypes`` order, from
        ``generator``."""
        n = torch.as_tensor(nodes).shape[0]
        uniforms = []
        for k in self.samples:
            uniforms.append([torch.rand((n, k), generator=generator,
                                        device=self.device)
                             for _ in self.etypes])
            n *= 1 + k * len(self.etypes)
        return self._from_uniforms(nodes, uniforms)

    def _from_uniforms(self, nodes, uniforms):
        """:meth:`sample` given its draws: a list a layer of one ``[B_l,
        k_l]`` tensor an edge type."""
        layers = []
        frontier = torch.as_tensor(nodes, device=self.device)
        for k, draws in zip(self.samples, uniforms):
            per_etype = {}
            nexts = [frontier.to(torch.int32)]
            for etype, u in zip(self.etypes, draws):
                indptr, sorted_v = self._csc[etype]
                neigh, mask = _neighbors_from_uniforms(indptr, sorted_v,
                                                       frontier, u)
                per_etype[etype] = (neigh, mask)
                nexts.append(neigh.reshape(-1))
            layers.append((frontier, per_etype))
            frontier = torch.cat(nexts)
        return layers[::-1], frontier


def make_padded_batch_fn(graph, samples, n_bucket: int, e_bucket: int,
                         pack: bool = False, layouts: bool = False):
    """Dataloader ``collate_fn`` for host-sampled minibatch training:
    GraphSAGE-sample the batch's (node, label) items, then pad the subgraph
    into fixed-size CSC arrays.

    Row ``n_bucket - 1`` is reserved as the pad sentinel: the ``e_bucket -
    ne`` pad edges are self loops on it and ``smask`` zeroes it, so a batch
    must have ``ns < n_bucket`` nodes.

    Returns ``(edges, deg, su, sv, se, indptr, sidx, smask, y, mask)``, the
    reference's tuple; with ``pack`` the one int32 buffer of
    :func:`pack_padded_batch`. With ``layouts`` (which needs ``pack``) the
    buffer goes on with the padded graph's K1 layouts, CSC then CSR
    (``segment_kernels.pack_spmm_layout``), built here on the host; read
    it with :func:`padded_batch_graph`. Numpy only: a forked worker runs
    it.
    """
    if layouts and not pack:
        raise ValueError("layouts=True rides in the packed buffer: pass "
                         "pack=True")

    def batch_fn(items):
        nodes = np.asarray([n for n, _ in items])
        labels = np.asarray([lb for _, lb in items])
        sub, sample_index, node_index = graphsage_sample(
            graph, nodes, samples)[0]
        ns, ne = sub.num_nodes, sub.num_edges
        if ns >= n_bucket or ne > e_bucket:
            raise RuntimeError(
                f"bucket too small: {ns}/{n_bucket} nodes (last row is "
                f"the pad sentinel: need ns < n_bucket), "
                f"{ne}/{e_bucket} edges")
        idx = sub.adj_dst_index                  # host C++ CSC build
        su = np.full(e_bucket, n_bucket - 1, np.int32)
        su[:ne] = np.asarray(idx.sorted_u)       # stays sorted (pad=max)
        sv = np.full(e_bucket, n_bucket - 1, np.int32)
        sv[:ne] = np.asarray(idx.sorted_v)
        se = np.arange(e_bucket, dtype=np.int32)
        deg = np.zeros(n_bucket, np.int32)
        deg[:ns] = np.asarray(idx.degree)
        deg[n_bucket - 1] += e_bucket - ne       # pads -> sentinel row
        indptr = np.full(n_bucket + 1, ne, np.int64)
        indptr[:ns + 1] = np.asarray(idx.indptr)
        indptr[n_bucket] = e_bucket
        sidx = np.zeros(n_bucket, np.int32)
        sidx[:ns] = sample_index
        smask = np.zeros((n_bucket, 1), np.float32)
        smask[:ns] = 1.0
        y = np.zeros(n_bucket, np.int32)
        mask = np.zeros(n_bucket, np.float32)
        y[node_index] = labels
        mask[node_index] = 1.0
        edges = np.stack([sv, su], axis=1)
        return edges, deg, su, sv, se, indptr, sidx, smask, y, mask

    def batch_fn_packed(items):
        edges, deg, su, sv, se, indptr, sidx, smask, y, mask = \
            batch_fn(items)
        ns = int(smask.sum())
        buf = pack_padded_batch(ns, su, sv, deg, indptr, sidx, y, mask)
        if not layouts:
            return buf
        # the layouts start 16-byte aligned (pack_spmm_layout)
        pad = np.zeros(_layouts_offset(n_bucket, e_bucket) - len(buf),
                       np.int32)
        return np.concatenate([buf, pad, *(pack_spmm_layout(lay) for lay in
                                           padded_layouts(su, sv, indptr,
                                                          n_bucket))])

    return batch_fn_packed if pack else batch_fn


def padded_layouts(su, sv, indptr, n_bucket: int):
    """The K1 layouts (CSC, CSR) of a padded batch graph, on the host: the
    CSC over the padded ``indptr`` gathering the sources ``sv`` (edge ids:
    the padded order), the CSR over the edges grouped by source by the
    native counting sort."""
    su = np.asarray(su, np.int64)
    sv = np.asarray(sv, np.int64)
    csc = build_spmm_layout_host(indptr, sv, n_bucket, kind="csc",
                                 edge_id=np.arange(len(sv)))
    _, dst, eid, rptr = native.build_index(sv, su, n_bucket)
    csr = build_spmm_layout_host(rptr, dst, n_bucket, kind="csr",
                                 edge_id=eid)
    return csc, csr


def pack_padded_batch(ns, su, sv, deg, indptr, sidx, y, mask):
    """Pack one padded batch into one int32 buffer, so a batch reaches the
    device in one copy: ``[ns, su, sv, deg, indptr, sidx, y, mask]``. The
    arrays that follow from these (``se``, ``edges``, ``smask``) are
    rebuilt by :func:`unpack_padded_batch`."""
    return np.concatenate([
        np.asarray([ns], np.int32),
        su.astype(np.int32), sv.astype(np.int32),
        deg.astype(np.int32), indptr.astype(np.int32),
        sidx.astype(np.int32), y.astype(np.int32),
        mask.astype(np.int32)])


def unpack_padded_batch(buf, n_bucket: int, e_bucket: int):
    """Inverse of :func:`pack_padded_batch` on a 1-D int32 tensor (on any
    device): the unpacked tuple, int32 but ``indptr`` (int64) and
    ``smask``, ``mask`` (float32); every array but those three a view of
    ``buf``."""
    n, e = n_bucket, e_bucket
    o = 1
    ns = buf[0]
    su = buf[o:o + e]; o += e
    sv = buf[o:o + e]; o += e
    deg = buf[o:o + n]; o += n
    indptr = buf[o:o + n + 1].to(torch.int64); o += n + 1
    sidx = buf[o:o + n]; o += n
    y = buf[o:o + n]; o += n
    mask = buf[o:o + n].to(torch.float32)
    se = torch.arange(e, dtype=torch.int32, device=buf.device)
    edges = torch.stack([sv, su], dim=1)
    smask = (torch.arange(n, device=buf.device) < ns)[:, None].to(
        torch.float32)
    return edges, deg, su, sv, se, indptr, sidx, smask, y, mask


def _layouts_offset(n_bucket: int, e_bucket: int) -> int:
    """Where a ``layouts=True`` buffer's layouts start: past the packed
    batch (``2 + 2 e + 5 n`` words), rounded up to 16 bytes."""
    return -(-(2 + 2 * e_bucket + 5 * n_bucket) // 4) * 4


def max_batch_words(n_bucket: int, e_bucket: int) -> int:
    """The most int32 words a ``layouts=True`` collate returns for these
    buckets (its layouts' work lists vary from batch to batch): the size
    of one host or device buffer that takes every batch."""
    return (_layouts_offset(n_bucket, e_bucket)
            + 2 * packed_layout_words_max(n_bucket, e_bucket))


def padded_batch_graph(buf, n_bucket: int, e_bucket: int, host=None):
    """The device batch of a ``layouts=True`` collate's buffer ``buf`` (a
    1-D int32 tensor on the device the step runs on; ``host``, its host
    copy, from which the layouts' headers are read, default ``buf``, and
    needed when ``buf`` is off the CPU):
    ``(graph, sidx, smask, y, mask)``. ``graph`` has ``n_bucket`` nodes,
    its CSC index on the device (degrees for ``mean``), and both K1
    layouts: its SpMM and its gradient launch K1 and build nothing."""
    edges, deg, su, sv, se, indptr, sidx, smask, y, mask = \
        unpack_padded_batch(buf, n_bucket, e_bucket)
    o = _layouts_offset(n_bucket, e_bucket)
    csc, o = unpack_spmm_layout(buf, "csc", o, host)
    csr, o = unpack_spmm_layout(buf, "csr", o, host)
    if o != buf.shape[0]:
        raise ValueError(f"buffer of {buf.shape[0]} words holds "
                         f"{o} of a batch and its layouts")
    i64 = torch.int64
    graph = Graph(edges.to(i64), num_nodes=n_bucket,
                  adj_dst_index=EdgeIndex(deg.to(i64), su.to(i64),
                                          sv.to(i64), se.to(i64), indptr),
                  _spmm_layouts=(csc, csr))
    return graph, sidx, smask, y, mask
