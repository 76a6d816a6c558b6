"""CSR/CSC edge index — the sorted-adjacency container behind every Graph.

Port of ``pgl_tpu/utils/edge_index.py``: the same fields (``degree,
sorted_u, sorted_v, sorted_eid, indptr``) built by the same counting sort
(the port's copy of the C++ host kernel, ``pgl_tpu_torch/native``), so the
arrays equal the reference's; the ragged neighbour views; and ``dump`` /
``load`` in the reference's directory of ``.npy`` files, so either package
reads what the other wrote.

The device form holds int64 tensors, the index type PyTorch's gather and
scatter operators take; the kernel layouts keep their own int32 copies
(``ops/kernels/segment_kernels.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..native import graph_kernel as _native

__all__ = ["EdgeIndex"]

_ID_DTYPE = np.int32


class EdgeIndex:
    """Sorted adjacency: each node ``u``'s neighbors ``v`` are contiguous.

    Attributes (numpy arrays or torch tensors depending on mode):
      degree:      [N]   neighbor count per u
      sorted_u:    [E]   edge source (sorted ascending)
      sorted_v:    [E]   edge destination, grouped by u
      sorted_eid:  [E]   original edge id of each sorted position
      indptr:      [N+1] CSR row pointer
      segment_ids: [E]   == sorted_u (alias kept for clarity at reduce sites)
    """

    def __init__(self, degree, sorted_u, sorted_v, sorted_eid, indptr):
        self.degree = degree
        self.sorted_u = sorted_u
        self.sorted_v = sorted_v
        self.sorted_eid = sorted_eid
        self.indptr = indptr

    @classmethod
    def from_edges(cls, u, v, num_nodes: int) -> "EdgeIndex":
        """Host build by the native O(E + N) counting sort on ``u``."""
        u = np.asarray(u)
        v = np.asarray(v)
        if u.size:
            lo, hi = int(u.min()), int(u.max())
            if lo < 0 or hi >= num_nodes:
                raise ValueError(
                    f"edge source ids in [{lo}, {hi}] out of range for "
                    f"num_nodes={num_nodes}")
        if u.shape[0] >= 2 ** 31 or num_nodes >= 2 ** 31:
            raise ValueError(
                f"int32 id layout: {u.shape[0]} edges / {num_nodes} nodes "
                "would wrap — shard the graph first")
        degree, sorted_v, sorted_eid, indptr = _native.build_index(
            u, v, num_nodes)
        degree = degree.astype(_ID_DTYPE)
        sorted_v = sorted_v.astype(_ID_DTYPE)
        sorted_eid = sorted_eid.astype(_ID_DTYPE)
        sorted_u = np.repeat(np.arange(num_nodes, dtype=_ID_DTYPE), degree)
        return cls(degree, sorted_u, sorted_v, sorted_eid, indptr)

    @classmethod
    def from_edges_device(cls, u, v, num_nodes: int) -> "EdgeIndex":
        """Device build (on ``u``'s device) by a stable ``torch.sort`` of
        ``u``, a ``bincount`` for the degrees and a ``cumsum`` for
        ``indptr``: int64 tensors, the device form. The same arrays as
        :meth:`from_edges` (ids outside ``[0, num_nodes)`` are not
        counted, as the reference's segment sum drops them)."""
        u = torch.as_tensor(u).to(torch.int64)
        v = torch.as_tensor(v, device=u.device).to(torch.int64)
        sorted_u, order = torch.sort(u, stable=True)
        degree = torch.bincount(u, minlength=num_nodes)[:num_nodes]
        indptr = torch.cat([degree.new_zeros(1), torch.cumsum(degree, 0)])
        return cls(degree, sorted_u, v[order], order, indptr)

    def view_v(self, u=None):
        """Ragged neighbour view: a list of each node's ``sorted_v`` slice
        (all nodes, or those of ``u``)."""
        return self._view(self.sorted_v, u)

    def view_eid(self, u=None):
        """Ragged edge-id view: a list of each node's ``sorted_eid`` slice."""
        return self._view(self.sorted_eid, u)

    def _view(self, values, u):
        indptr, values = np.asarray(self.indptr), np.asarray(values)
        nodes = range(len(indptr) - 1) if u is None else \
            np.asarray(u).reshape(-1)
        return [values[indptr[i]:indptr[i + 1]] for i in nodes]

    def triples(self):
        """(sorted_u, sorted_v, sorted_eid)."""
        return self.sorted_u, self.sorted_v, self.sorted_eid

    def _fields(self):
        return (self.degree, self.sorted_u, self.sorted_v, self.sorted_eid,
                self.indptr)

    @property
    def segment_ids(self):
        return self.sorted_u

    @property
    def is_tensor(self) -> bool:
        return isinstance(self.sorted_v, torch.Tensor)

    def tensor(self, device) -> "EdgeIndex":
        """Device copy as int64 tensors on ``device``."""
        if self.is_tensor:
            return EdgeIndex(*(x.to(device) for x in self._fields()))
        # a copy: the host arrays may be a read-only memory map (``load``)
        return EdgeIndex(*(torch.as_tensor(np.array(x, dtype=np.int64),
                                           device=device)
                           for x in self._fields()))

    def numpy(self) -> "EdgeIndex":
        """Host copy with the reference's dtypes (int32 ids, int64 indptr)."""
        if not self.is_tensor:
            return self
        *ids, indptr = (x.cpu().numpy() for x in self._fields())
        return EdgeIndex(*(x.astype(_ID_DTYPE) for x in ids),
                         indptr.astype(np.int64))

    _FILES = ("degree", "sorted_u", "sorted_v", "sorted_eid", "indptr")

    def dump(self, path):
        """Save the five arrays (host dtypes) as ``<name>.npy`` under
        ``path``, the reference's format."""
        os.makedirs(path, exist_ok=True)
        for name, x in zip(self._FILES, self.numpy()._fields()):
            np.save(os.path.join(path, f"{name}.npy"), np.asarray(x))

    @classmethod
    def load(cls, path, mmap_mode: Optional[str] = "r") -> "EdgeIndex":
        """Load a dumped index, memory-mapped unless ``mmap_mode`` is
        None."""
        return cls(*(np.load(os.path.join(path, f"{name}.npy"),
                             mmap_mode=mmap_mode) for name in cls._FILES))

    def __repr__(self):
        mode = "tensor" if self.is_tensor else "numpy"
        return (f"EdgeIndex(num_nodes={len(self.degree)}, "
                f"num_edges={len(self.sorted_v)}, mode={mode})")
