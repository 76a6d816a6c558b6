"""PGLBox-analog: out-of-core pass-based training for graphs and embedding
tables larger than device memory.

Port of ``pgl_tpu/apps/pglbox.py``, itself of the reference's
``apps/PGLBox``: the tiered graph store ``GraphGpuWrapper``
(``src/graph.py:27-140``, SSD→CPU→GPU tiers) becomes :class:`DistGraph`
(CSR npy files on disk, the OS page cache as the host-RAM tier, and only
per-pass walk and pair batches on the device); the pass-based GPU
parameter server ``PSGPU`` (``src/embedding.py:22-57``, ``begin_pass`` /
``end_pass`` / ``dump_to_mem``) becomes :class:`DistEmbedding` (an
mmap-backed table on disk from which ``begin_pass`` stages the pass's
working set on the device and ``end_pass`` writes the trained rows back);
and the yaml-driven trainer (``src/cluster_train_and_infer.py:52-149``)
becomes :class:`PGLBoxTrainer`.

Walks come from the device walker over the card-resident CSR, or from the
C++ host kernel straight over the memory-mapped CSR; the device trains a
fixed-capacity ``[capacity, dim]`` working-set table with
``torch.optim.Adam`` (optax's ``adam`` in the JAX version: the same update,
eps added to the bias-corrected root), and in-batch shuffled negatives
replace sampled negatives (the reference's ``shuffle_batch`` trick,
``src/models/gnn_model.py:158-161``). Where the JAX version asks for a
TPU backend (the device walks, the resident table), this one asks for a
CUDA device; the same environment variables override both.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from ..graph import Graph
from ..native.graph_kernel import skip_gram_gen_pair
from ..sampling import random_walk
from ..utils.logger import log
from ..utils.shared_embedding import SharedEmbedding
from .common import _inbatch_skipgram_loss

__all__ = ["DistGraph", "DistEmbedding", "PGLBoxTrainer"]


class DistGraph:
    """Disk-tiered graph store (reference ``GraphGpuWrapper`` analog).

    The CSR lives in npy files opened with ``mmap_mode='r'``: cold pages
    stay on disk (the reference's SSD tier), hot pages live in the OS page
    cache (the CPU tier), and the host walk kernel reads straight through
    the mapping. ``device`` (default: the card; raises without one unless
    ``"cpu"``) is where the device walks run.
    """

    def __init__(self, path: str, device=None):
        self.path = path
        self.device = resolve_device(device)
        self.graph = Graph.load(path, mmap_mode="r")
        self._walker = None

    @classmethod
    def from_graph(cls, graph: Graph, work_dir: str,
                   device=None) -> "DistGraph":
        """Dump a host graph to ``work_dir`` and reopen it memory-mapped."""
        g = graph.numpy()
        # build both CSRs before dumping so the reopened graph walks
        # directly over the on-disk index instead of rebuilding it in RAM
        g.adj_src_index, g.adj_dst_index
        g.dump(work_dir)
        return cls(work_dir, device)

    @classmethod
    def from_edge_file(cls, files: Union[str, Sequence[str]], work_dir: str,
                       symmetry: bool = True,
                       num_nodes: Optional[int] = None,
                       chunk_bytes: int = 16 * 1024 * 1024,
                       device=None) -> "DistGraph":
        """Build from ``src<TAB>dst`` text files (the reference's
        ``load_edge_file`` ingestion, ``src/graph.py:107-127``), streamed
        twice into memmapped CSR shards (:mod:`.ingest`) with O(num_nodes +
        chunk) working memory. ``symmetry=True`` adds reverse edges, the
        reference's default for undirected graphs."""
        from .ingest import build_graph_external
        build_graph_external(files, work_dir, num_nodes=num_nodes,
                             symmetry=symmetry, chunk_bytes=chunk_bytes)
        return cls(work_dir, device)

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    def _device_walker(self):
        if self._walker is None:
            from ..sampling import DeviceWalker
            self._walker = DeviceWalker(self.graph, device=self.device)
        return self._walker

    def _use_device_walks(self) -> bool:
        """Device walks when the device is a card and the CSR fits its
        budget (the reference generates walks on the GPU inside its engine,
        ``apps/PGLBox/src/graph.py:84-106``). Override with
        PGL_TPU_PGLBOX_DEVICE_WALKS=0/1; the budget is
        PGL_TPU_PGLBOX_WALK_HBM_MB (default 4096)."""
        flag = os.environ.get("PGL_TPU_PGLBOX_DEVICE_WALKS")
        if flag is not None:
            return flag == "1"
        budget = int(os.environ.get("PGL_TPU_PGLBOX_WALK_HBM_MB", 4096))
        return (self.device.type == "cuda"
                and self.num_edges * 4 <= budget * (1 << 20))

    def walk_pass(self, nodes, walk_len: int, seed: int = 0) -> np.ndarray:
        """Walks for one pass: on the device (a generator seeded ``seed``)
        when the CSR fits there, else over the mmap'd CSR with the host
        C++ kernel."""
        if self._use_device_walks():
            w = self._device_walker()
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return w.random_walk(np.asarray(nodes, np.int64), walk_len,
                                 gen).cpu().numpy()
        return random_walk(self.graph, nodes, walk_len, seed=seed)

    def node_batch_iter(self, batch_size: int, seed: int = 0):
        return self.graph.node_batch_iter(batch_size, seed=seed)


class DistEmbedding:
    """Pass-based sparse embedding table (reference ``PSGPU`` analog).

    The full ``[num_embeddings, dim]`` table is an mmap-backed
    :class:`SharedEmbedding` on disk. :meth:`begin_pass` stages the unique
    ids touched by a pass into a fixed-capacity device tensor;
    :meth:`end_pass` writes the trained rows back to the backing store —
    the ``begin_pass``/``end_pass`` contract of
    ``apps/PGLBox/src/embedding.py:33-57``.

    **Device-resident tier** (the reference keeps tables GPU-resident,
    ``PSGPU``, and spills beyond): when ``device`` is a card and the table
    fits its budget (``PGL_TPU_PGLBOX_EMB_HBM_MB``, default 6144), the whole
    table is uploaded once and every ``begin_pass``/``end_pass`` becomes a
    device gather and scatter. ``PGL_TPU_PGLBOX_EMB_RESIDENT=0/1``
    overrides the choice. The mmap file stays the persistent store,
    refreshed on :meth:`flush_to_store` / :meth:`dump_to_mem`.
    """

    def __init__(self, num_embeddings: int, embedding_dim: int, path: str,
                 capacity: int, lr: float = 0.1, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.table = SharedEmbedding(num_embeddings, embedding_dim, path,
                                     lr=lr, init_scale=0.1, seed=seed)
        self.capacity = int(capacity)
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = embedding_dim
        self._ids: Optional[np.ndarray] = None
        self._dev_table = None
        budget_mb = int(os.environ.get("PGL_TPU_PGLBOX_EMB_HBM_MB", 6144))
        force = os.environ.get("PGL_TPU_PGLBOX_EMB_RESIDENT")
        if force is not None:           # explicit override (tests/tuning)
            self._resident = force == "1"
        else:
            self._resident = (
                self.device.type == "cuda"
                and num_embeddings * embedding_dim * 4
                <= budget_mb * (1 << 20))

    def begin_pass(self, ids: Iterable[int]) -> torch.Tensor:
        """Stage the pass working set; returns the device table
        ``[capacity, dim]`` (padded past the working set: zeros from the
        mmap tier, row 0 in the resident tier; pad rows are never trained
        nor written back).

        Ids beyond ``capacity`` are dropped most-rare-first; use
        :meth:`local_ids` afterwards to remap (dropped ids map to -1).
        """
        if self._ids is not None:
            raise RuntimeError("begin_pass called twice without end_pass")
        ids = np.asarray(ids, dtype=np.int64).ravel()
        uniq, counts = np.unique(ids, return_counts=True)
        if len(uniq) > self.capacity:
            keep = np.sort(np.argsort(counts)[::-1][:self.capacity])
            log.warning("pass working set %d > capacity %d: dropping %d "
                        "rarest ids", len(uniq), self.capacity,
                        len(uniq) - self.capacity)
            uniq = uniq[keep]
        self._ids = uniq
        if self._resident:
            if self._dev_table is None:           # one-time upload
                self._dev_table = torch.as_tensor(
                    np.array(self.table.weight, np.float32)).to(self.device)
            ids_pad = np.zeros(self.capacity, np.int64)
            ids_pad[:len(uniq)] = uniq
            return self._dev_table.index_select(
                0, torch.as_tensor(ids_pad).to(self.device))
        padded = np.zeros((self.capacity, self.embedding_dim), np.float32)
        padded[:len(uniq)] = self.table.pull(uniq)
        return torch.as_tensor(padded).to(self.device)

    def local_ids(self, global_ids) -> np.ndarray:
        """Map global node ids to working-set rows (-1 when not staged)."""
        g = np.asarray(global_ids, dtype=np.int64)
        if self._ids is None:
            raise RuntimeError("local_ids outside a begin_pass/end_pass")
        if len(self._ids) == 0:
            return np.full(g.shape, -1, dtype=np.int64)
        pos = np.searchsorted(self._ids, g).clip(0, len(self._ids) - 1)
        hit = self._ids[pos] == g
        return np.where(hit, pos, -1)

    def end_pass(self, device_table: torch.Tensor) -> None:
        """Write the trained working-set rows back to the backing store:
        a device scatter of the ``len(ids)`` real rows in the resident tier
        (the JAX version scatters every slot, its pads to an out-of-bounds
        row that JAX drops; a CUDA ``index_copy_`` there would assert), an
        mmap write otherwise."""
        if self._ids is None:
            raise RuntimeError("end_pass without begin_pass")
        n = len(self._ids)
        rows = device_table.detach()[:n]
        if self._resident:
            self._dev_table.index_copy_(
                0, torch.as_tensor(self._ids).to(self.device), rows)
        else:
            self.table.weight[self._ids] = rows.cpu().numpy()
            self.table.flush()
        self._ids = None

    def flush_to_store(self) -> None:
        """Persist the resident device table to the mmap backing store."""
        if self._resident and self._dev_table is not None:
            self.table.weight[:] = self._dev_table.cpu().numpy()
            self.table.flush()

    def dump_to_mem(self) -> np.ndarray:
        """Full table as a host array (reference ``dump_to_mem``)."""
        if self._resident and self._dev_table is not None:
            return self._dev_table.cpu().numpy()
        return np.asarray(self.table.weight)


class PGLBoxTrainer:
    """Config-driven unsupervised trainer over the two tiers above
    (reference ``cluster_train_and_infer.py`` assembly).

    Config keys (PGLBox yaml names where they exist): ``emb_size``,
    ``walk_len``, ``win_size``, ``neg_num``, ``batch_pairs``,
    ``pass_nodes`` (node batch per pass), ``epochs``, ``lr``,
    ``pass_capacity`` (working-set rows staged to the device per pass;
    defaults to ``pass_nodes * walk_len`` rounded up to a multiple of
    1024). Each pass trains its table with a fresh Adam, as the JAX
    version's ``opt.init`` a pass; the negatives' permutations come from
    one generator on the device, seeded ``seed + 7``.
    """

    def __init__(self, graph: DistGraph, embed_path: str,
                 config: Optional[Dict] = None, seed: int = 0, device=None):
        cfg = dict(emb_size=64, walk_len=20, win_size=5, neg_num=5,
                   batch_pairs=4096, pass_nodes=1024, epochs=1, lr=0.05,
                   pass_capacity=None)
        cfg.update(config or {})
        self.cfg = cfg
        self.graph = graph
        self.device = resolve_device(device)
        cap = cfg["pass_capacity"] or -(-cfg["pass_nodes"] *
                                        cfg["walk_len"] // 1024) * 1024
        self.embedding = DistEmbedding(graph.num_nodes, cfg["emb_size"],
                                       embed_path, capacity=cap,
                                       lr=cfg["lr"], seed=seed,
                                       device=self.device)
        self._seed = seed
        self.timings = {"begin_pass": 0.0, "end_pass": 0.0, "walk": 0.0,
                        "steps": 0.0}

    def _draw(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """A step's negative permutation of ``n``."""
        return torch.randperm(n, generator=generator, device=self.device)

    def _train_pass(self, pass_id: int, nodes: np.ndarray,
                    generator: torch.Generator) -> float:
        cfg, t = self.cfg, self.timings
        s = self._seed * 9973 + pass_id * 131
        t0 = time.perf_counter()
        walks = self.graph.walk_pass(nodes, cfg["walk_len"], seed=s)
        src, dst = skip_gram_gen_pair(walks, cfg["win_size"], seed=s)
        t1 = time.perf_counter()
        table = torch.nn.Parameter(
            self.embedding.begin_pass(np.concatenate([src, dst])))
        src_l = self.embedding.local_ids(src)
        dst_l = self.embedding.local_ids(dst)
        keep = (src_l >= 0) & (dst_l >= 0)
        src_l, dst_l = src_l[keep], dst_l[keep]
        t2 = time.perf_counter()
        opt = torch.optim.Adam([table], lr=cfg["lr"])
        B, neg = cfg["batch_pairs"], cfg["neg_num"]
        total, steps = 0.0, 0
        for lo in range(0, max(len(src_l), 1), B):
            bs, bd = src_l[lo:lo + B], dst_l[lo:lo + B]
            valid = np.ones(len(bs), np.float32)
            if len(bs) < B:  # fixed shapes: zero-pad the tail batch
                pad = B - len(bs)
                bs, bd = np.pad(bs, (0, pad)), np.pad(bd, (0, pad))
                valid = np.pad(valid, (0, pad))
            bs, bd, valid = (torch.as_tensor(a).to(self.device)
                             for a in (bs, bd, valid))
            loss = _inbatch_skipgram_loss(table[bs], table[bd],
                                          self._draw(generator, B * neg),
                                          neg, valid, neg_reduce="sum")
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            total += float(loss.detach())
            steps += 1
        t3 = time.perf_counter()
        self.embedding.end_pass(table)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t4 = time.perf_counter()
        t["walk"] += t1 - t0
        t["begin_pass"] += t2 - t1
        t["steps"] += t3 - t2
        t["end_pass"] += t4 - t3
        return total / max(steps, 1)

    def train(self, log_every: int = 0) -> float:
        """Pass-based training over the whole node set; returns the last
        pass's mean loss. Every pass stages its working set, trains, and
        writes back — peak device memory is ``capacity * emb_size`` floats
        (and the table in the resident tier) however large the graph is.
        ``self.timings`` accumulates seconds of walks and pairs,
        ``begin_pass``, the steps and ``end_pass``."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(self._seed + 7)
        last = 0.0
        pass_id = 0
        for epoch in range(cfg["epochs"]):
            for nodes in self.graph.node_batch_iter(
                    cfg["pass_nodes"], seed=self._seed + epoch):
                last = self._train_pass(pass_id, nodes, gen)
                if log_every and pass_id % log_every == 0:
                    log.info("pass %d: loss %.4f", pass_id, last)
                pass_id += 1
            # persist the resident tier once per epoch (the mmap tier
            # flushes every pass): the on-disk table is the documented
            # persistence contract
            self.embedding.flush_to_store()
        return last

    def embeddings(self) -> np.ndarray:
        return self.embedding.dump_to_mem()

    def infer(self, out_dir: str, batch_nodes: int = 0) -> int:
        """Inference pass: stream every node's trained embedding to
        sharded ``part-XXXXX.npz`` files (``ids`` + ``emb`` arrays) — the
        analog of the reference's infer mode
        (``cluster_train_and_infer.py``, infer section). Reads the
        mmap-backed table slice by slice; peak RAM is one shard.

        Returns the number of shards written."""
        os.makedirs(out_dir, exist_ok=True)
        B = batch_nodes or max(self.cfg["pass_nodes"] * 16, 1 << 16)
        self.embedding.flush_to_store()      # resident tier → mmap
        table = self.embedding.table.weight  # mmap-backed [N, emb_size]
        n = self.graph.num_nodes
        shards = 0
        for lo in range(0, n, B):
            hi = min(lo + B, n)
            np.savez(os.path.join(out_dir, f"part-{shards:05d}.npz"),
                     ids=np.arange(lo, hi, dtype=np.int64),
                     emb=np.asarray(table[lo:hi]))
            shards += 1
        return shards
