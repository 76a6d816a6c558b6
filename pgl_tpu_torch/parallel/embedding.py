"""Row-sharded embedding tables, one block of rows a rank.

Port of ``pgl_tpu/parallel/embedding.py``. Rank r owns rows ``[r·B,
(r+1)·B)`` (``B`` the padded row count over the ranks), equal bit for bit
to the reference's draw (``np.random.default_rng(seed).uniform``, drawn
in chunks up to the end of this rank's block, so no rank holds the whole
table). :meth:`ShardedEmbedding.lookup` sends each id to its owner and its
row back by two all-to-alls and is differentiable;
:meth:`ShardedEmbedding.apply_sparse_grad` sends the gradient rows to their
owners, which sum the rows of one id in a fixed order (K1 over a layout of
the received ids) and take an SGD step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.kernels.segment_kernels import _spmm_one, build_spmm_layout
from ..utils.edge_index import EdgeIndex
from . import comm

__all__ = ["ShardedEmbedding"]

_CHUNK_ROWS = 1 << 16


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, ids, emb):
        rows, route = emb._route_lookup(block, ids)
        ctx.emb, ctx.route = emb, route
        return rows

    @staticmethod
    def backward(ctx, g):
        local, grad = ctx.emb._route_grad(ctx.route, g)
        return ctx.emb._sum_rows(local, grad), None, None


class ShardedEmbedding:
    """Row-sharded embedding table.

    Args:
      num_embeddings / embedding_dim: table shape (rows padded up to a
        multiple of the group's size).
      group / device: placement (default: the world, this rank's card).
      scale: uniform init range (default ``1 / √embedding_dim``).
    """

    def __init__(self, num_embeddings: int, embedding_dim: int, group=None,
                 scale: Optional[float] = None, seed: int = 0,
                 dtype=np.float32, device=None):
        self.group, size, self.rank = comm.world(group)
        self.device = comm.rank_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        padded = (num_embeddings + size - 1) // size * size
        self.block_rows = padded // size
        scale = scale if scale is not None else 1.0 / np.sqrt(embedding_dim)
        self.table = torch.nn.Parameter(torch.as_tensor(
            _draw_block(seed, scale, padded, embedding_dim, dtype,
                        self.rank * self.block_rows,
                        (self.rank + 1) * self.block_rows),
            device=self.device))

    # -- routing ----------------------------------------------------------------

    def _route(self, ids):
        """Send each of this rank's ``ids`` to its owner: ``(order, send,
        recv, local)``, ``order`` sorting ``ids`` by owner, ``send`` /
        ``recv`` the counts to and from each rank, ``local`` the block rows
        this rank was asked for."""
        _, size, _ = comm.world(self.group)
        owner = torch.div(ids, self.block_rows, rounding_mode="floor")
        order = torch.argsort(owner, stable=True)
        send = torch.bincount(owner, minlength=size)
        recv = comm.all_to_all(send.reshape(-1, 1), self.group).reshape(-1)
        asked = comm.all_to_all_v(ids[order].reshape(-1, 1), send.tolist(),
                                  recv.tolist(), self.group).reshape(-1)
        return order, send, recv, asked - self.rank * self.block_rows

    def _route_lookup(self, block, ids):
        """(rows ``[len(ids), D]`` of ``ids``, the routing kept for the
        gradient)."""
        route = self._route(ids.reshape(-1).to(torch.int64))
        order, send, recv, local = route
        rows = comm.all_to_all_v(block.detach().index_select(0, local),
                                 recv.tolist(), send.tolist(), self.group)
        out = torch.empty_like(rows)
        out[order] = rows
        return out, route

    def _route_grad(self, route, g):
        """Rows ``g`` (one for each routed id) sent back to their owner:
        (local rows, their gradients) on this rank."""
        order, send, recv, local = route
        grad = comm.all_to_all_v(g.contiguous()[order], send.tolist(),
                                 recv.tolist(), self.group)
        return local, grad

    def _sum_rows(self, local, grad):
        """``[B, D]``: the gradient rows of each local row summed in a fixed
        order (K1 over a layout of ``local``)."""
        idx = EdgeIndex.from_edges(local.cpu().numpy(),
                                   np.arange(local.shape[0]),
                                   self.block_rows)
        lay = build_spmm_layout(idx.indptr, idx.sorted_v, self.block_rows,
                                kind="embedding", device=grad.device)
        return _spmm_one(grad.contiguous(), lay)

    # -- the reference's surface ---------------------------------------------

    def lookup(self, ids):
        """Rows of ``ids`` (any global ids, this rank's own), differentiable
        in ``table`` (this rank's block): every rank calls it together."""
        shape = tuple(ids.shape)
        rows = _Lookup.apply(self.table, torch.as_tensor(
            ids, device=self.device), self)
        return rows.reshape(shape + (self.embedding_dim,))

    def apply_sparse_grad(self, ids, grad, lr: float):
        """SGD step ``table[ids] -= lr · grad`` with each rank's ``(ids,
        grad)``: the rows go to their owners and are summed per id in a
        fixed order first. Every rank calls it together."""
        ids = torch.as_tensor(ids, device=self.device).reshape(-1).to(
            torch.int64)
        grad = torch.as_tensor(grad, device=self.device).reshape(
            ids.shape[0], self.embedding_dim)
        local, rows = self._route_grad(self._route(ids), grad)
        with torch.no_grad():
            self.table -= lr * self._sum_rows(local, rows.to(
                self.table.dtype))

    def as_params(self):
        """This rank's block, for an optimizer."""
        return self.table

    def set_params(self, table):
        """Replace this rank's block."""
        with torch.no_grad():
            self.table.copy_(torch.as_tensor(table))


def _draw_block(seed, scale, rows, dim, dtype, lo, hi):
    """Rows ``[lo, hi)`` of ``default_rng(seed).uniform(-scale, scale,
    (rows, dim)).astype(dtype)``: the draw runs in chunks of rows up to
    ``hi`` (the generator's stream is the same whatever the chunks)."""
    rng = np.random.default_rng(seed)
    out = np.empty((hi - lo, dim), dtype)
    at = 0
    while at < hi:
        n = min(_CHUNK_ROWS, hi - at)
        chunk = rng.uniform(-scale, scale, (n, dim)).astype(dtype)
        a, b = max(at, lo), at + n
        if b > a:
            out[a - lo:b - lo] = chunk[a - at:]
        at += n
    return out
