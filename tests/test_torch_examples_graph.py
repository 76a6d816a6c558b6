"""End-to-end CPU runs of the graph-level, heterogeneous and embedding
scripts of ``examples_torch/`` (``PGL_TPU_PLATFORM=cpu``, in this process
through ``main(argv)``, torch on one thread; a script whose Dataloader
forks a worker in a thread joined with a timeout):

* at the argv of the reference's ``tests/test_examples.py`` (GIN, SAGPool,
  the sum readout, R-UniMP), clearing the same assertion;
* R-UniMP over a ``HaloHeterGraph`` on 2 gloo ranks and the distributed
  DeepWalk with 2 trainer processes, each a process of its script;
* ``deepwalk``, ``metapath2vec`` and ``kg`` at a tiny argv: each prints its
  metric field and ends with a finite loss. ``kg`` trains on a 300-entity
  instance of its synthetic task (``synthetic_triples`` at its defaults
  draws a 2000 x 2000 x 16 distance array a relation), the builder
  patched in the script's module.
"""

import math

import torch

from torch_examples_common import bounded, finite_loss, port, run  # noqa: F401

torch.set_num_threads(1)


def test_gin_graph_classification(run):
    out, res = run("gin/train.py", "--epochs", "3", "--num-graphs", "128")
    assert "test acc" in out
    finite_loss(res)


def test_sag_pool(run):
    out, res = run("sag_pool/train.py", "--epochs", "3", "--num-graphs",
                   "64")
    assert "test acc" in out
    finite_loss(res)


def test_global_pool(run):
    out, res = run("global_pool/train.py", "--pool_type", "sum", "--epochs",
                   "3", "--num-graphs", "64")
    assert "test acc" in out
    finite_loss(res)


def test_r_unimp(run):
    out, res = run("r_unimp/train.py", "--epochs", "2", "--batch-size",
                   "96")
    assert "val acc" in out
    finite_loss(res)


def test_r_unimp_multi_chip(run):
    """Two gloo ranks over a HaloHeterGraph, each a process of the
    script."""
    out, res = run("r_unimp/train.py", "--multi-chip", "--epochs", "1",
                   "--nprocs", "2")
    assert "multi-chip full-graph val acc" in out
    assert "after post-smoothing: val acc" in out
    finite_loss(res)


def test_distributed_deepwalk(run):
    """Two trainer processes against two shard servers (threads of the
    launcher)."""
    out, res = run("deepwalk/train_distributed_cpu.py", "--trainers", "2",
                   "--shards", "2", "--epochs", "1", "--nodes", "600")
    assert out.count("done, final loss") == 2
    assert "MacroF1" in out
    assert all(math.isfinite(v) for v in res["trainer_losses"])


def test_tiny_deepwalk(run):
    """One Dataloader worker (``bounded``)."""
    out, res = bounded(run, "deepwalk/train.py", "--epochs", "1",
                       "--num-workers", "1", "--embed-dim", "16")
    assert "1-NN label agreement" in out
    finite_loss(res)


def test_tiny_metapath2vec(run):
    out, res = run("metapath2vec/train.py", "--epochs", "1", "--embed-dim",
                   "16")
    assert "1-NN community agreement" in out
    finite_loss(res)


def test_tiny_kg(run, monkeypatch):
    module = port("kg/train.py")
    full = module.synthetic_triples
    monkeypatch.setattr(module, "synthetic_triples",
                        lambda: full(num_ents=300, num_rels=4, per_rel=200))
    out, res = run("kg/train.py", "--steps", "20", "--embed-dim", "16",
                   "--batch-size", "128", "--neg-num", "8", "--score",
                   "rotate")
    assert "mrr=" in out and "hits@10=" in out
    finite_loss(res)
