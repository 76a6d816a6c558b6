"""Host-resident feature SpMM: the out-of-core path, PGL's UVA graphs on a
card that holds only a chunk.

Port of ``pgl_tpu/ops/pallas/streaming.py`` (``StreamedSpMM``). The
reference (``Graph.tensor(uva=True)``, ``pgl/graph.py:227-247``) lets the
GPU read a host table through unified addressing; this keeps the table a
host numpy array or memmap and runs the SpMM destination range by
destination range, staging only the source rows each chunk reads.

* **Build, once, on the host.** For each chunk of ``chunk_rows``
  destination rows (rounded to the dedup block ``NB``, as the reference
  does): the chunk's distinct sources (``np.unique`` with the inverse)
  relabel its edges, and K1's layout over (chunk rows x distinct rows) is
  built by ``build_spmm_layout_host`` and packed, 16-byte aligned, into one
  int32 array by ``pack_spmm_layout``. Under ``dispatch.DEDUP`` (read
  here) the chunk takes the dedup layout and K6 instead, the reference's
  route: the rows staged are ``feature[uv]`` and the layout's ``uv``
  becomes the positions ``0..len(uv)-1`` (made on the device), since the
  CUDA K6 gathers ``x[uv[...]]`` itself.
* **Each call, double-buffered.** A :class:`~pgl_tpu_torch.utils.
  stream_pool.StreamPool` of two workers gathers chunk *i+1*'s rows and
  sends them and its layout words while chunk *i*'s kernel runs; finished
  rows come back through pinned buffers into ``out[r0:r1]``. Peak device
  memory is about two chunks' staged rows, outputs and layouts, never
  ``[N, D]``; any D. Host in, host out, no autograd, as the reference.
  The chunks' builds run on the host's threads (up to 8), as a chunk's
  gather does; ``build_s`` keeps the build's seconds.

Both routes pack a chunk's layout with ``segment_kernels.pack_words``
(the K1 layout through ``pack_spmm_layout``).

Each chunk launches one K1 (``segment_kernels``, counted under layout kind
``"streamed"``) or one K6 (``dedup_kernels``, ``("dedup", "streamed",
D)``); on a CPU device the wrappers run their plain versions.
"""

from __future__ import annotations

import concurrent.futures as _fut
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ... import resolve_device
from .. import dispatch
from . import dedup_kernels as dk
from . import segment_kernels as sk
from ...utils.stream_pool import GATHER_THREADS, StreamPool

__all__ = ["StreamedSpMM", "KIND"]

# the layout kind the streamed chunks' launches are counted under
KIND = "streamed"

# the dedup layout's scalars and arrays a chunk sends, in order (``uv`` is
# made on the device; ``eid`` and ``edge_id`` are not read by K6)
_DEDUP_SCALARS = ("num_edges", "simple", "max_count", "num_partials")
_DEDUP_ARRAYS = ("pairs", "dst", "urow", "groups", "split_blocks",
                 "split_ptr")


@dataclass(frozen=True)
class _Chunk:
    r0: int
    r1: int
    rows: np.ndarray      # [U] host rows to stage, int64
    words: np.ndarray     # the packed layout, int32
    partials: int         # the kernel's partial rows (K6: blocks)


def _build_chunk(indptr, sorted_v, r0, r1, dedup) -> _Chunk:
    e0, e1 = int(indptr[r0]), int(indptr[r1])
    sub_indptr = indptr[r0:r1 + 1] - e0
    if dedup:
        lay = dk.build_dedup_layout(sub_indptr, sorted_v[e0:e1], r1 - r0,
                                    kind=KIND, device="cpu")
        words = sk.pack_words(
            [getattr(lay, name) for name in _DEDUP_SCALARS],
            [getattr(lay, name).numpy() for name in _DEDUP_ARRAYS])
        return _Chunk(r0, r1, lay.uv.numpy().astype(np.int64), words,
                      lay.num_partials)
    rows, inv = np.unique(sorted_v[e0:e1], return_inverse=True)
    lay = sk.build_spmm_layout_host(sub_indptr, inv.reshape(-1), r1 - r0,
                                    kind=KIND)
    return _Chunk(r0, r1, rows, sk.pack_spmm_layout(lay), lay.item_partials)


class StreamedSpMM:
    """``out[d] = Σ_{(s, d) in E} feature[s]`` with a host-resident table.

    Args:
      indptr / sorted_v: the graph's destination-sorted (CSC) index, numpy
        (``graph.adj_dst_index``).
      num_segments: node count.
      chunk_rows: destination rows a chunk (rounded down to a multiple of
        the dedup block, at least one block); the device holds about two
        chunks' distinct source rows.
      device: the card (default; raises without one) or ``"cpu"``.
    """

    def __init__(self, indptr, sorted_v, num_segments: int,
                 chunk_rows: int = 1 << 18, device=None):
        self.device = resolve_device(device)
        indptr = np.asarray(indptr, dtype=np.int64)
        sorted_v = np.asarray(sorted_v, dtype=np.int64)
        self.num_segments = int(num_segments)
        self.dedup = bool(dispatch.DEDUP)
        self.chunk_rows = max(dk.NB, (int(chunk_rows) // dk.NB) * dk.NB)
        self.max_index = int(sorted_v.max()) if len(sorted_v) else -1
        starts = range(0, self.num_segments, self.chunk_rows)
        t0 = time.perf_counter()
        with _fut.ThreadPoolExecutor(GATHER_THREADS) as pool:
            self.chunks = list(pool.map(
                lambda r0: _build_chunk(
                    indptr, sorted_v, r0,
                    min(r0 + self.chunk_rows, self.num_segments),
                    self.dedup), starts))
        self.build_s = time.perf_counter() - t0

    @property
    def staged_rows(self) -> int:
        """Host rows a call sends to the device, all chunks."""
        return sum(len(c.rows) for c in self.chunks)

    def chunk_bytes(self, D: int, itemsize: int = 4):
        """Device bytes of each chunk at width ``D``: its staged rows, its
        layout words, its output rows and its kernel's partial rows."""
        out = []
        for c in self.chunks:
            if self.dedup:
                rows_out = -(-(c.r1 - c.r0) // dk.NB) * dk.NB
                partial = c.partials * dk.NB
                uv = 4 * len(c.rows)
            else:
                rows_out, partial, uv = c.r1 - c.r0, c.partials, 0
            out.append(itemsize * D * (len(c.rows) + rows_out + partial)
                       + 4 * c.words.size + uv)
        return out

    def _layout(self, c: _Chunk, words: torch.Tensor, positions):
        """The chunk's layout over ``words``, its packed words on the
        device (``positions``: ``0..`` on the device, the dedup ``uv``)."""
        if not self.dedup:
            return sk.unpack_spmm_layout(words, KIND, host=c.words)[0]
        scalars, arrays, _ = sk.unpack_words(
            words, len(_DEDUP_SCALARS), len(_DEDUP_ARRAYS), host=c.words)
        fields = dict(zip(_DEDUP_SCALARS, scalars),
                      **dict(zip(_DEDUP_ARRAYS, arrays)))
        for name in ("pairs", "groups"):
            fields[name] = fields[name].view(-1, 4)
        fields["simple"] = bool(fields["simple"])
        return dk.DedupLayout(
            kind=KIND, num_segments=c.r1 - c.r0, max_index=len(c.rows) - 1,
            uv=positions[:len(c.rows)], eid=positions[:0], **fields)

    def __call__(self, feature_host: np.ndarray,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
        """The SpMM of ``feature_host`` (numpy or memmap ``[N', D]``, N' >
        every source id; float32 on the card). Returns host ``[N, D]``
        (``out`` when given)."""
        if feature_host.ndim != 2 or feature_host.shape[0] <= self.max_index:
            raise ValueError(f"a host table of shape {feature_host.shape}; "
                             f"the graph reads row {self.max_index}")
        N, D = self.num_segments, feature_host.shape[1]
        if out is None:
            out = np.empty((N, D), feature_host.dtype)
        pool = StreamPool(2, self.device)
        positions = None
        if self.dedup:
            positions = torch.arange(
                max([len(c.rows) for c in self.chunks] + [1]),
                dtype=torch.int32, device=self.device)

        def stage(c):
            return (pool.async_pull(feature_host, c.rows),
                    pool.async_pull(c.words))

        try:
            nxt = stage(self.chunks[0]) if self.chunks else None
            for i, c in enumerate(self.chunks):
                rows, words = (f.result() for f in nxt)
                if i + 1 < len(self.chunks):
                    nxt = stage(self.chunks[i + 1])     # overlaps the kernel
                lay = self._layout(c, words, positions)
                res = (dk._apply_one(rows, lay) if self.dedup
                       else sk._spmm_one(rows, lay))
                pool.async_push(out, slice(c.r0, c.r1), res)
            pool.synchronize()
        finally:
            pool.close()
        return out
