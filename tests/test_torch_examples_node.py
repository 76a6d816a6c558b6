"""End-to-end CPU runs of the node-level scripts of ``examples_torch/``
(``PGL_TPU_PLATFORM=cpu``, in this process through ``main(argv)``, torch
on one thread):

* at the argv of the reference's ``tests/test_examples.py`` (citation GCN,
  deploy, link prediction, LightGCN, NGCF, node2vec, clustering, the
  device-sampled GraphSAGE, and the halo-sharded citation GCN, here on 2
  gloo ranks), clearing the same assertion;
* the four commands that ``docs/ACCURACY.md`` pins
  (``tests/test_example_commands.py``) on the same format-true fixtures,
  clearing the same accuracy floors;
* ``unimp``, ``ogb`` without ``--full-scale``, ``rgcn``, ``gnn_autoscale``
  and the host-sampled GraphSAGE at a tiny argv: each prints its metric
  field and ends with a finite loss;
* and with ``--data-path`` a loader's error propagates.

A script whose Dataloader forks a worker runs in a thread joined with a
timeout (``bounded``).

The graph-level and embedding scripts are in
``tests/test_torch_examples_graph.py``.
"""

import gzip
import pickle
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_examples_common import bounded, finite_loss, run  # noqa: F401

torch.set_num_threads(1)


def test_citation_gcn(run):
    out, res = run("citation_benchmark/train.py", "--model", "GCN",
                   "--epochs", "30")
    assert "test acc" in out
    finite_loss(res)


def test_deploy_roundtrip(run):
    """The reference asserts a tiny served-vs-direct error (an exponent
    e-0x or e-1x in the line); the port's served logits are the direct
    ones bit for bit (0.00e+00), so the error is read and bounded."""
    out, res = run("deploy/export_and_serve.py", "--epochs", "30")
    assert "served: acc" in out
    err = float(re.search(r"max \|served-direct\| = (\S+)\)", out)[1])
    assert err <= 1e-5, out


def test_link_prediction(run):
    out, res = run("link_prediction/train.py", "--epochs", "40")
    assert "AUC" in out
    finite_loss(res)


def test_lightgcn(run):
    out, res = run("lightgcn/train.py", "--epochs", "20")
    assert "recall@20" in out
    finite_loss(res)


def test_ngcf(run):
    out, res = run("ngcf/train.py", "--epochs", "30")
    assert "recall@20" in out
    finite_loss(res)


def test_node2vec(run):
    out, res = run("node2vec/train.py", "--epochs", "1",
                   "--steps-per-epoch", "80")
    assert "probe acc" in out
    finite_loss(res)


def test_clustering(run):
    out, res = run("clustering/train.py", "--steps", "150")
    assert "NMI" in out
    finite_loss(res)


def test_graphsage_device_sampler(run):
    out, res = run("graphsage/train.py", "--device-sampler", "--epochs",
                   "4", "--samples", "10", "10")
    assert "device-sampled" in out and "test acc" in out
    finite_loss(res)


def test_citation_multi_chip(run):
    """Two gloo ranks, each a process of the script."""
    out, res = run("citation_benchmark/multi_chip_train.py", "--epochs",
                   "60", "--nprocs", "2")
    assert "halo-sharded GCN" in out
    acc = float(out.rsplit("test acc ", 1)[1].split()[0])
    assert acc > 0.7, out
    finite_loss(res)


# -- the pinned commands (tests/test_example_commands.py) ---------------------

def _community(n, ncls, deg, seed, p_intra=0.9):
    """Edges + labels with planted communities (learnable by any GNN)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, ncls, n)
    by_cls = [np.flatnonzero(y == c) for c in range(ncls)]
    src = rng.integers(0, n, n * deg)
    dst = np.empty_like(src)
    intra = rng.random(n * deg) < p_intra
    for i, s in enumerate(src):
        pool = by_cls[y[s]] if intra[i] else np.arange(n)
        dst[i] = pool[rng.integers(0, len(pool))]
    return np.stack([src, dst], 1), y


def _words(y, ncls, dim, seed, p_on=0.6, p_off=0.05):
    """Binary bag-of-words with a per-class block signal."""
    rng = np.random.default_rng(seed)
    n = len(y)
    block = dim // ncls
    w = (rng.random((n, dim)) < p_off).astype(np.int64)
    for c in range(ncls):
        rows = y == c
        w[np.ix_(rows, np.arange(c * block, (c + 1) * block))] = (
            rng.random((rows.sum(), block)) < p_on).astype(np.int64)
    return w


def _acc(out, pattern=r"test acc:?\s+([0-9.]+)"):
    m = re.findall(pattern, out)
    assert m, out
    return float(m[-1])


def test_citation_command_cora_format(run, tmp_path):
    n, ncls, dim = 700, 3, 30
    edges, y = _community(n, ncls, 4, seed=0)
    w = _words(y, ncls, dim, seed=1)
    names = ["AI", "DB", "ML"]
    d = tmp_path / "cora"
    d.mkdir()
    with open(d / "cora.content", "w") as f:
        for i in range(n):
            f.write(f"{1000 + i} " + " ".join(map(str, w[i]))
                    + f" {names[y[i]]}\n")
    with open(d / "cora.cites", "w") as f:
        for u, v in edges:
            f.write(f"{1000 + u} {1000 + v}\n")
    out, _ = run("citation_benchmark/train.py", "--model", "GCN",
                 "--dataset", "cora", "--data-path", str(d), "--epochs",
                 "120")
    assert _acc(out) > 0.75, out


def test_citation_command_planetoid_format(run, tmp_path):
    n_all, n_test, ncls, dim = 700, 120, 3, 30
    n = n_all + n_test
    edges, y = _community(n, ncls, 4, seed=2)
    feats = _words(y, ncls, dim, seed=3).astype(np.float32)
    onehot = np.eye(ncls, dtype=np.float32)[y]
    graph = {i: [] for i in range(n)}
    for u, v in edges:
        graph[int(u)].append(int(v))
    n_train = 80
    test_order = np.random.default_rng(4).permutation(n_test)
    d = tmp_path / "pubmed"
    d.mkdir()
    for name, obj in [
            ("x", sp.csr_matrix(feats[:n_train])), ("y", onehot[:n_train]),
            ("tx", sp.csr_matrix(feats[n_all + test_order])),
            ("ty", onehot[n_all + test_order]),
            ("allx", sp.csr_matrix(feats[:n_all])),
            ("ally", onehot[:n_all]), ("graph", graph)]:
        with open(d / f"ind.pubmed.{name}", "wb") as f:
            pickle.dump(obj, f)
    with open(d / "ind.pubmed.test.index", "w") as f:
        for i in test_order:
            f.write(f"{n_all + i}\n")
    out, _ = run("citation_benchmark/train.py", "--model", "GCN",
                 "--dataset", "pubmed", "--data-path", str(d), "--epochs",
                 "120")
    assert _acc(out) > 0.75, out


def test_graphsage_command_reddit_format(run, tmp_path):
    """One Dataloader worker process (``bounded``)."""
    n, ncls, dim = 600, 3, 32
    edges, y = _community(n, ncls, 8, seed=5)
    rng = np.random.default_rng(6)
    feats = np.eye(ncls, dtype=np.float32)[y] @ np.abs(
        rng.normal(1.0, 0.2, (ncls, dim))).astype(np.float32)
    feats += rng.normal(0, 0.3, feats.shape).astype(np.float32)
    adj = sp.csr_matrix(
        (np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(n, n))
    d = tmp_path / "reddit"
    d.mkdir()
    sp.save_npz(d / "reddit_adj.npz", adj)
    perm = rng.permutation(n)
    tr, va, te = perm[:400], perm[400:500], perm[500:]
    np.savez(d / "reddit.npz", feats=feats, y_train=y[tr], y_val=y[va],
             y_test=y[te], train_index=tr, val_index=va, test_index=te)
    out, _ = bounded(run, "graphsage/train.py", "--data-path", str(d),
                     "--epochs", "3", "--batch-size", "64", "--samples",
                     "10", "5", "--num-workers", "1")
    assert _acc(out) > 0.7, out


def test_unimp_command_ogb_arxiv_format(run, tmp_path):
    n, ncls, dim = 500, 3, 24
    edges, y = _community(n, ncls, 5, seed=7)
    rng = np.random.default_rng(8)
    feats = np.eye(ncls, dtype=np.float32)[y] @ np.abs(
        rng.normal(1.0, 0.2, (ncls, dim))).astype(np.float32)
    feats += rng.normal(0, 0.3, feats.shape).astype(np.float32)
    d = tmp_path / "ogbn_arxiv"
    raw, split = d / "raw", d / "split" / "time"
    raw.mkdir(parents=True)
    split.mkdir(parents=True)

    def gz(path, arr, fmt):
        with gzip.open(path, "wt") as f:
            for row in np.atleast_2d(arr):
                f.write(",".join(fmt % v for v in np.atleast_1d(row)) + "\n")

    gz(raw / "edge.csv.gz", edges, "%d")
    gz(raw / "node-feat.csv.gz", feats, "%.6f")
    gz(raw / "node-label.csv.gz", y.reshape(-1, 1), "%d")
    gz(raw / "num-node-list.csv.gz", np.array([[n]]), "%d")
    perm = rng.permutation(n)
    gz(split / "train.csv.gz", perm[:300].reshape(-1, 1), "%d")
    gz(split / "valid.csv.gz", perm[300:400].reshape(-1, 1), "%d")
    gz(split / "test.csv.gz", perm[400:].reshape(-1, 1), "%d")
    out, _ = run("unimp/train.py", "--data-path", str(d), "--epochs", "60",
                 "--hidden", "32")
    assert _acc(out) > 0.75, out


def test_data_path_errors_propagate(run, tmp_path):
    """With ``--data-path`` a loader error ends the run: no silent
    synthetic fallback (the reference's ``examples/ogb/train.py:33-46``
    swallows any exception)."""
    with pytest.raises(FileNotFoundError):
        run("ogb/train.py", "--data-path", str(tmp_path), "--epochs", "1")
    with pytest.raises(FileNotFoundError):
        run("citation_benchmark/train.py", "--data-path", str(tmp_path),
            "--epochs", "1")


# -- tiny runs of the scripts neither reference test covers -------------------

@pytest.mark.parametrize("rel,argv,field", [
    ("unimp/train.py", ("--epochs", "5", "--hidden", "16"), "test acc"),
    ("ogb/train.py", ("--epochs", "2", "--hidden", "16"), "test acc"),
    ("ogb/train.py", ("--epochs", "1", "--hidden", "16", "--model",
                      "UniMP"), "test acc"),
    ("rgcn/train.py", ("--epochs", "10",), "test acc"),
    ("gnn_autoscale/train.py", ("--epochs", "2",), "acc"),
])
def test_tiny(run, rel, argv, field):
    out, res = run(rel, *argv)
    assert field in out
    finite_loss(res)


def test_tiny_graphsage_host_sampler(run):
    """A Dataloader worker sampling on the host (``bounded``)."""
    out, res = bounded(run, "graphsage/train.py", "--epochs", "1",
                       "--samples", "5", "5", "--num-workers", "1")
    assert "test acc" in out
    finite_loss(res)
