"""Port parity for the data pipeline and the datasets on the CPU against
``pgl_tpu``: the ``Dataloader`` (each case of the reference's
``tests/test_dataloader.py``; synchronous batches equal to the reference's
for a seed; workers that refuse a tensor off the CPU), ``mp_reader``
(merged readers, a dead worker detected), ``HadoopDataset`` (through a
fake ``hadoop`` the test writes), the loaders (each case of
``tests/test_datasets.py``, on files the tests write, their graphs and
splits equal to the reference's; ``data_path`` required) and the
synthetic generators (equal to the reference's for a seed).

Every test that starts worker processes drains them in a thread it joins
with a timeout of its own: a hung worker fails the test, it does not hang
the run.
"""

import os
import pickle
import stat
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pgl_tpu.datasets as jdatasets
import pgl_tpu.utils.data as jdata
from pgl_tpu.utils.mp_reader import multiprocess_reader as j_reader
import pgl_tpu_torch.datasets as datasets
from pgl_tpu_torch.datasets import (BlogCatalogDataset, CitationDataset,
                                    CoraDataset, RedditDataset,
                                    community_graph, powerlaw_graph)
from pgl_tpu_torch.utils.data import (Dataloader, Dataset, HadoopDataset,
                                      Sampler, StreamDataset)
from pgl_tpu_torch.utils.mp_reader import (check_host, merge_worker_queue,
                                           multiprocess_reader)

# one intra-op thread: the test files run in parallel worker processes
torch.set_num_threads(1)

JOIN_S = 60


def drain(iterable, timeout=JOIN_S):
    """``list(iterable)`` in a thread joined with ``timeout``: returns the
    items, or re-raises what the iteration raised; a hang fails."""
    out = {}

    def run():
        try:
            out["items"] = list(iterable)
        except BaseException as e:      # re-raised below
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"workers did not finish in {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["items"]


class ToyDataset(Dataset):
    def __init__(self, n=20):
        self.data = list(range(n))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class ToyStream(StreamDataset):
    def __init__(self, n=20):
        self.n = n

    def __iter__(self):
        yield from self._shard_iter(range(self.n))


# -- Dataloader ---------------------------------------------------------------

@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_map_dataloader(num_workers, shuffle):
    loader = Dataloader(ToyDataset(20), batch_size=3, shuffle=shuffle,
                        num_workers=num_workers, seed=0)
    batches = drain(loader)
    assert sorted(x for b in batches for x in b) == list(range(20))
    assert len(loader) == 7
    if num_workers == 0:      # the reference's batches, in its order
        assert batches == list(jdata.Dataloader(
            _JToy(20), batch_size=3, shuffle=shuffle, num_workers=0, seed=0))


class _JToy(jdata.Dataset):
    def __init__(self, n):
        self.data = list(range(n))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_stream_dataloader(num_workers):
    loader = Dataloader(ToyStream(21), batch_size=4,
                        num_workers=num_workers)
    assert sorted(x for b in drain(loader) for x in b) == list(range(21))


def test_drop_last():
    batches = list(Dataloader(ToyDataset(10), batch_size=3, drop_last=True))
    assert all(len(b) == 3 for b in batches) and len(batches) == 3


def test_collate_fn():
    batches = list(Dataloader(ToyDataset(6), batch_size=2,
                              collate_fn=lambda xs: np.asarray(xs) * 10))
    np.testing.assert_array_equal(batches[0], [0, 10])


def test_worker_error_propagates():
    class Bad(Dataset):
        def __getitem__(self, idx):
            raise ValueError("boom")

        def __len__(self):
            return 4

    with pytest.raises(RuntimeError, match="boom"):
        drain(Dataloader(Bad(), batch_size=2, num_workers=2))


def test_numpy_payloads_cross_process():
    class NpStream(StreamDataset):
        def __iter__(self):
            for i in self._shard_iter(range(8)):
                yield {"x": np.full((3, 2), i), "i": i}

    items = drain(Dataloader(NpStream(), batch_size=2, num_workers=2))
    assert len(items) == 4


def test_shuffled_sampler_equals_reference():
    """The index batches for a seed are the reference's (numpy's
    shuffle)."""
    for seed in (0, 7):
        got = list(Sampler(ToyDataset(23), 4, shuffle=True, seed=seed))
        assert got == list(jdata.Sampler(_JToy(23), 4, shuffle=True,
                                         seed=seed))


def test_sync_graphsage_batches_equal_reference():
    """The ``Dataloader`` in sync mode over ``make_padded_batch_fn``, shuffled
    by a seed: every packed batch equals the reference's."""
    import pgl_tpu.sampling as jsampling
    from pgl_tpu.datasets import community_graph as j_cg
    from pgl_tpu_torch.sampling import make_padded_batch_fn
    jg, y = j_cg(num_nodes=600, num_classes=4, feat_dim=4, avg_degree=6,
                 seed=3)
    tg, _ = community_graph(num_nodes=600, num_classes=4, feat_dim=4,
                            avg_degree=6, seed=3)

    class Items(Dataset):
        def __getitem__(self, i):
            return i, y[i]

        def __len__(self):
            return 200

    class JItems(jdata.Dataset):
        __getitem__ = Items.__getitem__
        __len__ = Items.__len__

    kw = dict(batch_size=64, shuffle=True, seed=5)
    got = list(Dataloader(Items(), collate_fn=make_padded_batch_fn(
        tg, (4, 3), 1 << 10, 1 << 12, pack=True), **kw))
    want = list(jdata.Dataloader(JItems(), collate_fn=jsampling.
                                 make_padded_batch_fn(jg, (4, 3), 1 << 10,
                                                      1 << 12, pack=True),
                                 **kw))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_workers_run_the_layout_collate():
    """Two forked workers run the minibatch collate with the K1 layouts
    (numpy only) and give the batches the synchronous loader gives."""
    from pgl_tpu_torch.sampling import make_padded_batch_fn
    tg, y = community_graph(num_nodes=600, num_classes=4, feat_dim=4,
                            avg_degree=6, seed=3)
    tg.adj_dst_index            # built once, before the fork

    class Items(Dataset):
        def __getitem__(self, i):
            return i, y[i]

        def __len__(self):
            return 96

    fn = make_padded_batch_fn(tg, (4, 3), 1 << 10, 1 << 12, pack=True,
                              layouts=True)
    sync = list(Dataloader(Items(), batch_size=32, collate_fn=fn))
    par = drain(Dataloader(Items(), batch_size=32, collate_fn=fn,
                           num_workers=2))
    key = lambda a: a.tobytes()     # noqa: E731
    assert sorted(map(key, par)) == sorted(map(key, sync))


@pytest.mark.parametrize("where", ["item", "batch"])
def test_worker_refuses_a_device_tensor(where):
    """A worker handed a tensor off the CPU (a ``meta`` tensor here, a
    CUDA one on the card) raises a clear error, in what it reads and in
    what its collate makes, instead of touching the parent's device."""
    class Held(Dataset):
        def __getitem__(self, i):
            return torch.empty(2, device="meta") if where == "item" else i

        def __len__(self):
            return 4

    collate = (lambda xs: {"x": [torch.empty(3, device="meta")]}) \
        if where == "batch" else None
    with pytest.raises(RuntimeError, match="tensor on meta"):
        drain(Dataloader(Held(), batch_size=2, num_workers=2,
                         collate_fn=collate))
    assert check_host({"a": [np.zeros(2), torch.zeros(2)]}) is not None


# -- mp_reader ----------------------------------------------------------------

def _reader(lo, hi):
    def reader():
        for i in range(lo, hi):
            yield {"x": np.full((2,), i)}
    return reader


def test_mp_reader():
    items = drain(multiprocess_reader([_reader(0, 5), _reader(5, 9)]))
    assert sorted(int(d["x"][0]) for d in items) == list(range(9))
    want = list(j_reader([_reader(0, 5), _reader(5, 9)]))
    assert sorted(int(d["x"][0]) for d in want) == list(range(9))


def test_merge_detects_a_dead_worker():
    """A worker killed before its sentinel (here: it ends its own process
    with ``os._exit``, as an OOM kill would) is reported, not waited for."""
    def dies():
        yield {"x": 1}
        os._exit(3)

    with pytest.raises(RuntimeError, match="died abnormally"):
        drain(multiprocess_reader([dies, _reader(0, 3)]))


def test_merge_worker_queue_ends_on_sentinels():
    """A worker that exited cleanly after its sentinel ends the merge
    without an error; every process is joined."""
    import multiprocessing as mp
    from pgl_tpu_torch.utils.mp_reader import _Sentinel
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    procs = [ctx.Process(target=lambda: None)]
    procs[0].start()
    procs[0].join(JOIN_S)
    q.put({"x": 1})
    q.put(_Sentinel())
    assert drain(merge_worker_queue(q, procs, poll_s=0.1)) == [{"x": 1}]
    assert not procs[0].is_alive()


# -- HadoopDataset ------------------------------------------------------------

def _fake_hadoop(tmp_path, lines, rc=0):
    data = tmp_path / "part-0"
    data.write_bytes(b"".join(lines))
    exe = tmp_path / "hadoop"
    exe.write_text(f"#!/bin/sh\n# usage: hadoop fs -cat PATH\n"
                   f"cat \"$3\"\nexit {rc}\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(exe), str(data)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_hadoop_dataset_streams_lines(tmp_path, num_workers):
    """``hadoop fs -cat`` through a fake client the test writes; the lines
    shard across workers and all arrive once."""
    lines = [f"line {i}\n".encode() for i in range(11)]
    exe, path = _fake_hadoop(tmp_path, lines)
    ds = HadoopDataset(path, hadoop_bin=exe)
    got = drain(Dataloader(ds, batch_size=3, num_workers=num_workers))
    assert sorted(x for b in got for x in b) == sorted(lines)
    ref = list(jdata.HadoopDataset(path, hadoop_bin=exe))
    assert ref == lines


def test_hadoop_dataset_errors(tmp_path):
    exe, path = _fake_hadoop(tmp_path, [b"a\n"], rc=2)
    with pytest.raises(RuntimeError, match="exited with code 2"):
        list(HadoopDataset(path, hadoop_bin=exe))
    with pytest.raises(RuntimeError, match="not found"):
        list(HadoopDataset(path, hadoop_bin=str(tmp_path / "nohadoop")))


# -- loaders on files the tests write -----------------------------------------

def same_graph(got, want):
    assert got.num_nodes == want.num_nodes
    np.testing.assert_array_equal(np.asarray(got.edges),
                                  np.asarray(want.edges))
    for k in set(got.node_feat) | set(want.node_feat):
        np.testing.assert_array_equal(np.asarray(got.node_feat[k]),
                                      np.asarray(want.node_feat[k]))


def same_attrs(got, want, names):
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(got, n)),
                                      np.asarray(getattr(want, n)),
                                      err_msg=n)


def test_cora_format(tmp_path):
    d = tmp_path / "cora"
    d.mkdir()
    ids = [101, 202, 303, 404, 505]
    classes = ["AI", "DB", "AI", "DB", "AI"]
    with open(d / "cora.content", "w") as f:
        for i, (pid, c) in enumerate(zip(ids, classes)):
            feats = " ".join(str((i + j) % 2) for j in range(3))
            f.write(f"{pid} {feats} {c}\n")
    with open(d / "cora.cites", "w") as f:
        f.write("101 202\n202 303\n404 505\n")
    ds = CoraDataset(data_path=str(d))
    assert ds.graph.num_nodes == 5 and ds.num_classes == 2
    assert ds.y.shape == (5,)
    edges = set(map(tuple, np.asarray(ds.graph.edges).tolist()))
    assert (0, 1) in edges and (1, 0) in edges and (0, 0) in edges
    ref = jdatasets.CoraDataset(data_path=str(d))
    same_graph(ds.graph, ref.graph)
    same_attrs(ds, ref, ("y", "train_index", "val_index", "test_index"))


def test_citation_planetoid_format(tmp_path):
    d = tmp_path / "pubmed"
    d.mkdir()
    n_train, n_test, n_all, dim, ncls = 4, 3, 7, 5, 3
    rng = np.random.default_rng(0)
    objs = {"x": sp.csr_matrix(rng.random((n_train, dim)).astype("float32")),
            "allx": sp.csr_matrix(rng.random((n_all, dim)).astype("float32")),
            "tx": sp.csr_matrix(rng.random((n_test, dim)).astype("float32")),
            "y": np.eye(ncls)[rng.integers(0, ncls, n_train)],
            "ally": np.eye(ncls)[rng.integers(0, ncls, n_all)],
            "ty": np.eye(ncls)[rng.integers(0, ncls, n_test)],
            "graph": {i: [(i + 1) % (n_all + n_test)]
                      for i in range(n_all + n_test)}}
    for name, obj in objs.items():
        with open(d / f"ind.pubmed.{name}", "wb") as f:
            pickle.dump(obj, f)
    (d / "ind.pubmed.test.index").write_text("8\n7\n9\n")
    ds = CitationDataset("pubmed", data_path=str(d))
    assert ds.graph.num_nodes == 10 and ds.num_classes == ncls
    assert len(ds.test_index) == 3
    ref = jdatasets.CitationDataset("pubmed", data_path=str(d))
    same_graph(ds.graph, ref.graph)
    same_attrs(ds, ref, ("y", "train_index", "val_index", "test_index"))


def test_blogcatalog_format(tmp_path):
    d = tmp_path / "bc"
    d.mkdir()
    (d / "nodes.csv").write_text("1\n2\n3\n4\n")
    (d / "edges.csv").write_text("1,2\n2,3\n3,4\n")
    (d / "group-edges.csv").write_text("1,1\n2,2\n3,1\n4,3\n")
    ds = BlogCatalogDataset(data_path=str(d), seed=0)
    assert ds.graph.num_nodes == 4
    assert ds.graph.node_feat["group_id"].shape == (4, 39)
    assert len(ds.train_index) + len(ds.test_index) == 4
    ref = jdatasets.BlogCatalogDataset(data_path=str(d), seed=0)
    same_graph(ds.graph, ref.graph)
    same_attrs(ds, ref, ("train_index", "test_index"))


def test_reddit_format(tmp_path):
    d = tmp_path / "reddit"
    d.mkdir()
    n, dim = 12, 6
    rng = np.random.default_rng(0)
    sp.save_npz(d / "reddit_adj.npz", sp.random(n, n, density=0.3,
                                                format="csr",
                                                random_state=1))
    np.savez(d / "reddit.npz",
             feats=rng.random((n, dim)).astype("float32"),
             y_train=rng.integers(0, 41, 6), y_val=rng.integers(0, 41, 3),
             y_test=rng.integers(0, 41, 3), train_index=np.arange(6),
             val_index=np.arange(6, 9), test_index=np.arange(9, 12))
    ds = RedditDataset(data_path=str(d))
    assert ds.graph.num_nodes == 12 and ds.feature.shape == (12, 6)
    assert ds.num_classes == 41
    ref = jdatasets.RedditDataset(data_path=str(d))
    same_graph(ds.graph, ref.graph)
    same_attrs(ds, ref, ("feature", "train_index", "train_label"))


def test_missing_files_helpful_error(tmp_path):
    with pytest.raises(FileNotFoundError, match="cora.content"):
        CoraDataset(data_path=str(tmp_path))


@pytest.mark.parametrize("loader", ["CoraDataset", "BlogCatalogDataset",
                                    "ArXivDataset", "RedditDataset",
                                    "OgbnArxivDataset"])
def test_loaders_need_a_data_path(loader):
    """A departure: without ``data_path`` a loader raises (the reference
    reads ``get_default_data_dir`` under the home directory, or downloads
    ogbn-arxiv through ``ogb``); nothing is read from elsewhere."""
    with pytest.raises(ValueError, match="pass data_path"):
        getattr(datasets, loader)()
    with pytest.raises(ValueError, match="pass data_path"):
        CitationDataset("pubmed")


def test_ogbn_arxiv_raw_layout(tmp_path):
    """The extracted OGB layout, gzipped csv files the test writes."""
    import gzip
    raw, split = tmp_path / "raw", tmp_path / "split" / "time"
    raw.mkdir()
    split.mkdir(parents=True)
    rng = np.random.default_rng(2)

    def put(path, rows, fmt):
        with gzip.open(str(path) + ".gz", "wt") as f:
            for r in np.atleast_2d(rows):
                f.write(",".join(fmt % v for v in np.atleast_1d(r)) + "\n")

    put(raw / "num-node-list.csv", [[9]], "%d")
    put(raw / "edge.csv", rng.integers(0, 9, (20, 2)), "%d")
    put(raw / "node-feat.csv", rng.random((9, 3)), "%.6f")
    put(raw / "node-label.csv", rng.integers(0, 4, (9, 1)), "%d")
    for name, idx in (("train", [0, 1, 2, 3]), ("valid", [4, 5]),
                      ("test", [6, 7, 8])):
        put(split / f"{name}.csv", np.asarray(idx)[:, None], "%d")
    ds = datasets.OgbnArxivDataset(data_path=str(tmp_path))
    ref = jdatasets.OgbnArxivDataset(data_path=str(tmp_path))
    same_graph(ds.graph, ref.graph)
    same_attrs(ds, ref, ("feature", "y", "train_index", "val_index",
                         "test_index", "num_classes"))


def test_arxiv_link_prediction_contract(tmp_path):
    rng = np.random.default_rng(0)
    ids = rng.choice(100000, 30, replace=False)
    pairs = {(int(ids[i]), int(ids[j])) for i in range(30)
             for j in range(30) if i < j and rng.random() < 0.3}
    d = tmp_path / "arxiv"
    d.mkdir()
    with open(d / "arxiv.txt", "w") as f:
        f.write("# comment line\n")
        for u, v in sorted(pairs):
            f.write(f"{u}\t{v}\n")
    ds = datasets.ArXivDataset(data_path=str(d))
    n_bi = len(pairs)
    assert ds.graph.num_nodes == 30
    assert len(ds.pos_edges) == len(ds.neg_edges) == n_bi // 2
    assert ds.graph.num_edges == 2 * (n_bi - n_bi // 2)
    bi = {(min(a, b), max(a, b))
          for a, b in np.asarray(ds.graph.edges).tolist()} | {
          (min(a, b), max(a, b)) for a, b in ds.pos_edges}
    for u, v in ds.neg_edges:
        assert (min(u, v), max(u, v)) not in bi
    ref = jdatasets.ArXivDataset(data_path=str(d))
    same_graph(ds.graph, ref.graph)
    assert ds.pos_edges == ref.pos_edges and ds.neg_edges == ref.neg_edges


# -- synthetic generators -----------------------------------------------------

def test_synthetic_generators():
    g, labels = community_graph(200, 4, 8, seed=0)
    assert g.num_nodes == 200 and labels.shape == (200,)
    g = powerlaw_graph(500, avg_degree=6, feat_dim=4)
    assert g.num_edges == 3000
    assert int(g.indegree().max()) > 50


@pytest.mark.parametrize("name,kw", [
    ("random_graph", dict(num_nodes=50, num_edges=300, feat_dim=3,
                          weighted=True, seed=1)),
    ("citation_shaped_graph", dict(name="citeseer", seed=2)),
    ("cora_shaped_graph", dict(seed=0)),
    ("blogcatalog_shaped_graph", dict(num_nodes=300, seed=3))])
def test_generators_equal_reference(name, kw):
    got = getattr(datasets, name)(**kw)
    want = getattr(jdatasets, name)(**kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    same_graph(got[0], want[0])
    for k in got[0].edge_feat:
        np.testing.assert_array_equal(got[0].edge_feat[k],
                                      want[0].edge_feat[k])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert set(datasets.__all__) == set(jdatasets.__all__)
