"""Out-of-core graph ingestion: edge files → on-disk Graph directory with
bounded working memory.

The port's own copy of ``pgl_tpu/apps/ingest.py``; it writes the directory
format both packages read.

The reference's tiered engine ingests shard-by-shard
(``apps/PGLBox/src/graph.py:107-141``, ``sharding_tool/graph_sharding.py``);
this is the same capability as one external counting sort:

  pass 1  stream the files in fixed-size chunks, counting per-node in/out
          degrees (the only O(N) state) and the edge total;
  pass 2  stream again, appending ``edges.npy`` sequentially and
          scatter-writing both CSR index files (``sorted_v``/``sorted_eid``
          per side) through ``np.memmap`` — every array larger than O(N)
          lives on disk from the moment it is produced.

Peak *allocated* memory is O(N + chunk); the edge-proportional arrays are
only ever memory-mapped (the OS page cache is the RAM tier, exactly the
PGLBox SSD→CPU tiering story). The output directory is a standard
:meth:`pgl_tpu_torch.Graph.dump` layout, so ``Graph.load(path, mmap_mode='r')``
and every walk kernel work on it directly.

numpy-only on purpose (no torch call): ingestion runs in data-prep
processes that need no device.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Union

import numpy as np

__all__ = ["build_graph_external", "text_edge_chunks"]

_ID = np.int32


def text_edge_chunks(files: Union[str, Sequence[str]],
                     chunk_bytes: int = 16 * 1024 * 1024):
    """Yield ``[k, 2] int64`` edge chunks from ``src<sep>dst`` text files
    (whitespace/tab separated) reading at most ``chunk_bytes`` at a time."""
    if isinstance(files, str):
        files = [files]
    for path in files:
        with open(path, "rb") as f:
            tail = b""
            while True:
                buf = f.read(chunk_bytes)
                if not buf:
                    if tail.strip():
                        yield _parse(tail)
                    break
                buf = tail + buf
                cut = buf.rfind(b"\n")
                if cut < 0:
                    tail = buf
                    continue
                tail = buf[cut + 1:]
                chunk = buf[:cut]
                if chunk.strip():
                    yield _parse(chunk)


def _parse(raw: bytes) -> np.ndarray:
    vals = np.array(raw.split(), dtype=np.int64)
    if vals.size % 2:
        raise ValueError("edge file lines must hold exactly 2 ids")
    return vals.reshape(-1, 2)


def _scatter_csr(mm_v, mm_eid, cursor, key, val, eid):
    """Place one chunk's edges into the CSR memmaps at their final sorted
    positions (stable within the chunk, chunks arrive in order → globally
    stable like the single-shot counting sort)."""
    order = np.argsort(key, kind="stable")
    ks = key[order]
    runs = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    lens = np.diff(np.concatenate([runs, [len(ks)]]))
    rank = np.arange(len(ks)) - np.repeat(runs, lens)
    pos = cursor[ks] + rank
    mm_v[pos] = val[order]
    mm_eid[pos] = eid[order]
    cursor[ks[runs]] += lens


def build_graph_external(files: Union[str, Sequence[str]], work_dir: str,
                         num_nodes: Optional[int] = None,
                         symmetry: bool = True,
                         chunk_bytes: int = 16 * 1024 * 1024) -> str:
    """Build ``work_dir`` (a ``Graph.dump`` directory with both adjacency
    indexes) from edge text files without materializing the edge set in
    memory. Returns ``work_dir``.
    """
    os.makedirs(work_dir, exist_ok=True)

    # ---- pass 1: degrees + totals --------------------------------------
    n = int(num_nodes) if num_nodes else 0
    deg_out = np.zeros(max(n, 1), np.int64)
    deg_in = np.zeros(max(n, 1), np.int64)
    E = 0

    def grow(arr, need):
        if need <= len(arr):
            return arr
        out = np.zeros(max(need, 2 * len(arr)), np.int64)
        out[:len(arr)] = arr
        return out

    for chunk in text_edge_chunks(files, chunk_bytes):
        hi = int(chunk.max()) + 1 if chunk.size else 0
        if num_nodes is None:
            n = max(n, hi)
            deg_out = grow(deg_out, n)
            deg_in = grow(deg_in, n)
        elif hi > n:
            raise ValueError(f"node id {hi - 1} >= num_nodes {n}")
        src, dst = chunk[:, 0], chunk[:, 1]
        deg_out[:n] += np.bincount(src, minlength=n)[:n] if n else 0
        deg_in[:n] += np.bincount(dst, minlength=n)[:n] if n else 0
        if symmetry:
            deg_out[:n] += np.bincount(dst, minlength=n)[:n] if n else 0
            deg_in[:n] += np.bincount(src, minlength=n)[:n] if n else 0
        E += len(chunk) * (2 if symmetry else 1)

    if E >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(
            f"int32 id layout: {E} edges / {n} nodes would wrap — shard "
            "the input (graph_sharding) before ingesting")
    deg_out, deg_in = deg_out[:n], deg_in[:n]
    indptr_src = np.zeros(n + 1, np.int64)
    np.cumsum(deg_out, out=indptr_src[1:])
    indptr_dst = np.zeros(n + 1, np.int64)
    np.cumsum(deg_in, out=indptr_dst[1:])

    # ---- output files (memmapped from the start) -----------------------
    from numpy.lib.format import open_memmap
    mm_edges = open_memmap(os.path.join(work_dir, "edges.npy"), mode="w+",
                           dtype=_ID, shape=(E, 2))
    sides = {}
    for name, deg, indptr in (("adj_src", deg_out, indptr_src),
                              ("adj_dst", deg_in, indptr_dst)):
        d = os.path.join(work_dir, name)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "degree.npy"), deg.astype(_ID))
        np.save(os.path.join(d, "indptr.npy"), indptr)
        sides[name] = (
            open_memmap(os.path.join(d, "sorted_v.npy"), mode="w+",
                        dtype=_ID, shape=(E,)),
            open_memmap(os.path.join(d, "sorted_eid.npy"), mode="w+",
                        dtype=_ID, shape=(E,)),
            indptr[:-1].copy(),
        )
        # sorted_u = repeat(arange, degree), written sequentially per node
        # range so no O(E) temp exists
        mm_u = open_memmap(os.path.join(d, "sorted_u.npy"), mode="w+",
                           dtype=_ID, shape=(E,))
        step = max(1, (1 << 20) // 8)
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            seg = np.repeat(np.arange(lo, hi, dtype=_ID),
                            deg[lo:hi])
            mm_u[indptr[lo]:indptr[hi]] = seg
        mm_u.flush()
        del mm_u

    # ---- pass 2: write edges + scatter both CSRs -----------------------
    eid0 = 0
    for chunk in text_edge_chunks(files, chunk_bytes):
        src, dst = chunk[:, 0], chunk[:, 1]
        if symmetry:
            src = np.concatenate([src, chunk[:, 1]])
            dst = np.concatenate([dst, chunk[:, 0]])
        k = len(src)
        eids = np.arange(eid0, eid0 + k, dtype=np.int64)
        mm_edges[eid0:eid0 + k, 0] = src
        mm_edges[eid0:eid0 + k, 1] = dst
        v_s, e_s, cur_s = sides["adj_src"]
        _scatter_csr(v_s, e_s, cur_s, src, dst, eids)
        v_d, e_d, cur_d = sides["adj_dst"]
        _scatter_csr(v_d, e_d, cur_d, dst, src, eids)
        eid0 += k
    assert eid0 == E, (eid0, E)
    mm_edges.flush()
    for v_mm, e_mm, _ in sides.values():
        v_mm.flush()
        e_mm.flush()

    with open(os.path.join(work_dir, "meta.json"), "w") as f:
        json.dump({"num_nodes": n, "num_graph": 1}, f)
    for sub in ("node_feat", "edge_feat"):
        os.makedirs(os.path.join(work_dir, sub), exist_ok=True)
    return work_dir
