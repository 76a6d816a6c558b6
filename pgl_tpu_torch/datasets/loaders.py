"""Dataset loaders (port of ``pgl_tpu/datasets/loaders.py``).

The reference's on-disk formats and attribute contract (``.graph``,
``.y``, ``.num_classes``, ``.train/val/test_index``), read from local files
through an explicit ``data_path``: nothing is downloaded. One departure:
``data_path`` is required, where the reference falls back to
:func:`get_default_data_dir` (and ``OgbnArxivDataset`` to the ``ogb``
package's download); the port raises instead, so a loader reads only the
directory it is given.
"""

from __future__ import annotations

import io
import os
import pickle
import sys
from typing import Optional

import numpy as np

from ..graph import Graph

__all__ = ["CitationDataset", "CoraDataset", "BlogCatalogDataset",
           "ArXivDataset", "RedditDataset", "OgbnArxivDataset",
           "get_default_data_dir"]


def get_default_data_dir(name: str) -> str:
    """``$PGL_TPU_DATA_ROOT/<name>`` (default ``~/.pgl_tpu/data/<name>``)."""
    root = os.environ.get("PGL_TPU_DATA_ROOT",
                          os.path.expanduser("~/.pgl_tpu/data"))
    return os.path.join(root, name)


def _data_path(data_path, name):
    if data_path is None:
        raise ValueError(
            f"{name} reads local files only: pass data_path, the directory "
            "that holds them (nothing is downloaded)")
    return data_path


def _require(path, files, hint):
    missing = [f for f in files if not os.path.exists(os.path.join(path, f))]
    if missing:
        raise FileNotFoundError(
            f"dataset files missing under {path}: {missing}. {hint}")


def _dedup_edges(all_edges):
    return np.unique(np.asarray(all_edges, dtype=np.int64), axis=0)


def _pickle_load(f):
    if sys.version_info > (3, 0):
        return pickle.load(f, encoding="latin1")
    return pickle.load(f)


class CitationDataset:
    """Planetoid pickle format (``ind.<name>.{x,y,tx,ty,allx,ally,graph}`` +
    ``ind.<name>.test.index``) for pubmed/citeseer
    (reference ``pgl/dataset.py:62-161``)."""

    def __init__(self, name: str, symmetry_edges: bool = True,
                 self_loop: bool = True, data_path: Optional[str] = None):
        self.name = name
        self.path = _data_path(data_path, "CitationDataset")
        self.symmetry_edges = symmetry_edges
        self.self_loop = self_loop
        self._load_data()

    def _load_data(self):
        names = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
        _require(self.path, [f"ind.{self.name}.{n}" for n in names],
                 "Planetoid files (github.com/kimiyoung/planetoid)")
        objects = []
        for n in names:
            with open(os.path.join(self.path, f"ind.{self.name}.{n}"),
                      "rb") as f:
                objects.append(_pickle_load(f))
        x, y, tx, ty, allx, ally, graph_dict = objects
        with open(os.path.join(self.path,
                               f"ind.{self.name}.test.index")) as f:
            test_idx_reorder = np.array([int(line.strip()) for line in f],
                                        dtype=np.int64)
        test_idx_range = np.sort(test_idx_reorder)

        allx = np.asarray(allx.todense())
        tx = np.asarray(tx.todense())
        if self.name == "citeseer":
            # isolated test nodes: place tx rows at their real positions
            full = range(int(test_idx_reorder.min()),
                         int(test_idx_reorder.max()) + 1)
            tx_ext = np.zeros((len(full), x.shape[1]), dtype="float32")
            tx_ext[test_idx_range - test_idx_range.min()] = tx
            tx = tx_ext
            ty_ext = np.zeros((len(full), y.shape[1]), dtype="float32")
            ty_ext[test_idx_range - test_idx_range.min()] = ty
            ty = ty_ext

        features = np.vstack([allx, tx])
        features[test_idx_reorder] = features[test_idx_range]
        features = features / (features.sum(-1, keepdims=True) + 1e-15)
        features = features.astype("float32")

        onehot = np.vstack([ally, ty])
        onehot[test_idx_reorder] = onehot[test_idx_range]
        labels = onehot.argmax(1)

        num_nodes = features.shape[0]
        all_edges = []
        for u, nbrs in graph_dict.items():
            for v in nbrs:
                all_edges.append((u, v))
                if self.symmetry_edges:
                    all_edges.append((v, u))
        if self.self_loop:
            all_edges.extend((i, i) for i in range(num_nodes))
        edges = _dedup_edges(all_edges)

        self.graph = Graph(edges, num_nodes=num_nodes,
                           node_feat={"words": features})
        self.y = labels.astype("int64")
        self.num_classes = onehot.shape[1]
        self.train_index = np.arange(len(y), dtype="int32")
        self.val_index = np.arange(len(y), len(y) + 500, dtype="int32")
        self.test_index = test_idx_range.astype("int32")


class CoraDataset:
    """``cora.content`` / ``cora.cites`` format
    (reference ``pgl/dataset.py:164-245``)."""

    def __init__(self, symmetry_edges: bool = True, self_loop: bool = True,
                 data_path: Optional[str] = None):
        self.path = _data_path(data_path, "CoraDataset")
        self.symmetry_edges = symmetry_edges
        self.self_loop = self_loop
        self._load_data()

    def _load_data(self):
        _require(self.path, ["cora.content", "cora.cites"],
                 "LINQS cora archive")
        feats, paper_ids, y, y_dict = [], [], [], {}
        with open(os.path.join(self.path, "cora.content")) as f:
            for line in f:
                parts = line.strip().split()
                paper_ids.append(int(parts[0]))
                cls = parts[-1]
                y_dict.setdefault(cls, len(y_dict))
                row = np.array([int(v) for v in parts[1:-1]],
                               dtype="float32")
                feats.append(row / (row.sum() + 1e-15))
                y.append(y_dict[cls])
        paper2vid = {pid: i for i, pid in enumerate(paper_ids)}
        num_nodes = len(paper_ids)
        all_edges = []
        with open(os.path.join(self.path, "cora.cites")) as f:
            for line in f:
                u, v = (paper2vid[int(t)] for t in line.split())
                all_edges.append((u, v))
                if self.symmetry_edges:
                    all_edges.append((v, u))
        if self.self_loop:
            all_edges.extend((i, i) for i in range(num_nodes))
        self.graph = Graph(_dedup_edges(all_edges), num_nodes=num_nodes,
                           node_feat={"words": np.asarray(feats,
                                                          dtype="float32")})
        perm = np.arange(num_nodes)
        self.train_index = perm[:140]
        self.val_index = perm[200:500]
        self.test_index = perm[500:1500]
        self.y = np.asarray(y, dtype="int64")
        self.num_classes = len(y_dict)


class BlogCatalogDataset:
    """``nodes.csv`` / ``edges.csv`` / ``group-edges.csv`` format
    (reference ``pgl/dataset.py:249-317``)."""

    def __init__(self, symmetry_edges: bool = True, self_loop: bool = False,
                 data_path: Optional[str] = None, seed: Optional[int] = None):
        self.path = _data_path(data_path, "BlogCatalogDataset")
        self.num_groups = 39
        self.symmetry_edges = symmetry_edges
        self.self_loop = self_loop
        self._seed = seed
        self._load_data()

    def _load_data(self):
        _require(self.path, ["nodes.csv", "edges.csv", "group-edges.csv"],
                 "BlogCatalog3 archive")
        with io.open(os.path.join(self.path, "nodes.csv")) as f:
            num_nodes = len(f.readlines())
        node_feature = np.zeros((num_nodes, self.num_groups))
        with io.open(os.path.join(self.path, "group-edges.csv")) as f:
            for line in f:
                nid, gid = (int(t) - 1 for t in line.strip().split(","))
                node_feature[nid][gid] = 1
        all_edges = []
        with io.open(os.path.join(self.path, "edges.csv")) as f:
            for line in f:
                u, v = (int(t) - 1 for t in line.strip().split(","))
                all_edges.append((u, v))
                if self.symmetry_edges:
                    all_edges.append((v, u))
        if self.self_loop:
            all_edges.extend((i, i) for i in range(num_nodes))
        self.graph = Graph(_dedup_edges(all_edges), num_nodes=num_nodes,
                           node_feat={"group_id": node_feature})
        perm = np.arange(num_nodes)
        np.random.default_rng(self._seed).shuffle(perm)
        train_num = num_nodes // 2
        self.train_index = perm[:train_num]
        self.test_index = perm[train_num:]


class ArXivDataset:
    """``arxiv.txt`` whitespace edge list (reference
    ``pgl/dataset.py:320-383``)."""

    def __init__(self, np_random_seed: int = 123,
                 data_path: Optional[str] = None):
        self.path = _data_path(data_path, "ArXivDataset")
        self.np_random_seed = np_random_seed
        self._load_data()

    def _load_data(self):
        """Reference contract (``pgl/dataset.py:338-383``): raw ids are
        remapped to a dense 0..N-1 space in first-seen order, undirected
        edges are deduped, half become held-out ``pos_edges``, an equal
        count of non-edges become ``neg_edges``, and the remaining half
        (symmetrized) form ``graph`` — the link-prediction split."""
        _require(self.path, ["arxiv.txt"], "SNAP ca-AstroPh style edge list")
        rng = np.random.default_rng(self.np_random_seed)
        raw = np.loadtxt(os.path.join(self.path, "arxiv.txt"),
                         dtype=np.int64, comments="#", ndmin=2)
        # dense remap in first-seen order (SNAP ids are sparse: ~133k max
        # id for ~18k real nodes — unmapped they inflate every
        # node-indexed array)
        uniq, inv = np.unique(raw.reshape(-1), return_inverse=True)
        order = np.argsort(np.unique(raw.reshape(-1),
                                     return_index=True)[1])
        rank = np.empty(len(uniq), np.int64)
        rank[order] = np.arange(len(uniq))
        edges = rank[inv].reshape(-1, 2)
        num_nodes = len(uniq)
        self.node2id = {int(u): int(r) for u, r in zip(uniq, rank)}

        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        keep = lo != hi
        bi = np.unique(np.stack([lo[keep], hi[keep]], 1), axis=0)
        bi = bi[rng.permutation(len(bi))]
        bi_set = set(map(tuple, bi.tolist()))
        half = len(bi) // 2
        self.pos_edges = [tuple(e) for e in bi[:half].tolist()]
        neg = []
        while len(neg) < half:
            cand = rng.integers(0, num_nodes, (len(bi), 2))
            for u, v in cand:
                u, v = int(u), int(v)
                if u != v and (u, v) not in bi_set \
                        and (v, u) not in bi_set:
                    neg.append((u, v))
                    if len(neg) == half:
                        break
        self.neg_edges = neg
        rest = bi[half:]
        all_edges = np.concatenate([rest, rest[:, ::-1]])
        self.graph = Graph(all_edges, num_nodes=num_nodes)


class RedditDataset:
    """``reddit.npz`` + ``reddit_adj.npz`` (scipy CSR) format
    (reference ``pgl/dataset.py:386-473``)."""

    def __init__(self, normalize: bool = True, symmetry: bool = True,
                 data_path: Optional[str] = None):
        self.path = _data_path(data_path, "RedditDataset")
        _require(self.path, ["reddit.npz", "reddit_adj.npz"],
                 "the FastGCN authors list mirrors")
        self._load_data(normalize, symmetry)

    def _load_data(self, normalize, symmetry):
        import scipy.sparse as sp

        data = np.load(os.path.join(self.path, "reddit.npz"))
        adj = sp.load_npz(os.path.join(self.path, "reddit_adj.npz"))
        if symmetry:
            adj = adj + adj.T
        adj = adj.tocoo()
        feature = data["feats"].astype("float32")
        if normalize:
            mu = feature[data["train_index"]].mean(0)
            sd = feature[data["train_index"]].std(0) + 1e-9
            feature = (feature - mu) / sd
        self.graph = Graph(np.stack([adj.row, adj.col], axis=1),
                           num_nodes=feature.shape[0])
        self.feature = feature
        self.train_index = data["train_index"]
        self.val_index = data["val_index"]
        self.test_index = data["test_index"]
        self.train_label = data["y_train"]
        self.val_label = data["y_val"]
        self.test_label = data["y_test"]
        self.num_classes = 41


class OgbnArxivDataset:
    """ogbn-arxiv from the extracted OGB directory ``data_path``
    (``raw/{edge,node-feat,node-label,num-node-list}.csv[.gz]`` and
    ``split/time/{train,valid,test}.csv[.gz]``), parsed directly; the
    reference's other path, the ``ogb`` package's download, is not
    ported."""

    def __init__(self, data_path: Optional[str] = None):
        self._load_raw(_data_path(data_path, "OgbnArxivDataset"))

    @staticmethod
    def _csv(path, dtype):
        """Load OGB's headerless csv / csv.gz (np handles .gz natively)."""
        for p in (path, path + ".gz"):
            if os.path.exists(p):
                arr = np.loadtxt(p, delimiter=",", dtype=dtype, ndmin=2)
                return arr
        raise FileNotFoundError(
            f"{path}[.gz] not found — expected the OGB extracted layout "
            "(ogbn_arxiv/raw + ogbn_arxiv/split/time)")

    def _load_raw(self, path):
        raw = os.path.join(path, "raw")
        num_nodes = int(self._csv(
            os.path.join(raw, "num-node-list.csv"), np.int64)[0, 0])
        edges = self._csv(os.path.join(raw, "edge.csv"), np.int64)
        self.feature = self._csv(
            os.path.join(raw, "node-feat.csv"), np.float32)
        label = self._csv(
            os.path.join(raw, "node-label.csv"), np.int64)
        split_dir = os.path.join(path, "split", "time")
        self.graph = Graph(edges, num_nodes=num_nodes)
        self.y = label
        self.num_classes = int(label.max()) + 1
        self.train_index = self._csv(
            os.path.join(split_dir, "train.csv"), np.int64).reshape(-1)
        self.val_index = self._csv(
            os.path.join(split_dir, "valid.csv"), np.int64).reshape(-1)
        self.test_index = self._csv(
            os.path.join(split_dir, "test.csv"), np.int64).reshape(-1)
