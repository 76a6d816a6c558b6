"""Port parity for the asynchronous parameter server
(``pgl_tpu_torch.distributed.ps``): the PS cases of the reference's
``tests/test_dist_trainer.py`` on the port's servers, both packages'
tables through the same pull and push sequence (equal bit for bit: the
same numpy draw and server-side adagrad), and the reference's multi-process
deepwalk run as the port's: 2 shard-server processes and 2 Graph4Rec
trainer processes (``tests/torch_ps_procs.py``), whose table must move
and whose losses must fall. The reference's MacroF1 probe and the whole
run are ported as ``examples_torch/deepwalk/train_distributed_cpu.py``:
``tests/test_torch_examples_parity.py`` holds the probe to the reference's
and ``tests/test_torch_examples_graph.py`` runs the script.
"""

import tempfile

import numpy as np
import pytest
import torch

from pgl_tpu.distributed import ps as jps
from pgl_tpu_torch.distributed.ps import (EmbeddingShardService, PSEmbedding,
                                          start_shard_server)

import torch_ps_procs as procs

torch.set_num_threads(1)


def test_ps_embedding_roundtrip_and_adagrad():
    """Single-shard service semantics: pull/push/dump with server-side
    adagrad, duplicate rows accumulating."""
    srv = start_shard_server(0, 1)
    try:
        ps = PSEmbedding([f"127.0.0.1:{srv.port}"], "t", 10, 4, lr=0.5,
                         seed=3, async_push=False)
        w0 = ps.pull([2, 7])
        g = np.ones((3, 4), np.float32)
        ps.push([2, 2, 7], g)          # row 2 gets two grads
        w1 = ps.pull([2, 7])
        assert not np.allclose(w0, w1)
        full = ps.dump()
        assert full.shape == (10, 4)
        np.testing.assert_allclose(full[[2, 7]], w1, rtol=1e-6)
        ps.close()
    finally:
        srv.stop()


def test_ps_sharding_covers_all_rows():
    srvs = [start_shard_server(s, 3) for s in range(3)]
    try:
        addrs = [f"127.0.0.1:{s.port}" for s in srvs]
        ps = PSEmbedding(addrs, "emb", 101, 8, seed=1, async_push=False)
        ids = np.arange(101)
        rows = ps.pull(ids)
        full = ps.dump()
        np.testing.assert_allclose(rows, full[ids])
        # distinct shards hold distinct rows: push to one row only
        # changes that row
        before = ps.pull(ids)
        ps.push([50], np.ones((1, 8), np.float32))
        after = ps.pull(ids)
        changed = np.where(np.any(before != after, axis=1))[0]
        assert list(changed) == [50]
        ps.close()
    finally:
        for s in srvs:
            s.stop()


@pytest.mark.parametrize("async_push", [False, True])
def test_ps_tables_equal_reference(async_push):
    """Both packages' 3-shard tables through the same create, pull and
    push sequence: the initial rows, every pull and the final tables equal
    bit for bit (asynchronous pushes flushed before each read)."""
    mine = [start_shard_server(s, 3) for s in range(3)]
    theirs = [jps.start_shard_server(s, 3) for s in range(3)]
    try:
        tables = [
            cls([f"127.0.0.1:{s.port}" for s in srvs], "emb", 97, 6,
                lr=0.1, init_scale=0.2, seed=4, async_push=async_push)
            for cls, srvs in ((PSEmbedding, mine),
                              (jps.PSEmbedding, theirs))]
        np.testing.assert_array_equal(tables[0].dump(), tables[1].dump())
        rng = np.random.default_rng(0)
        for _ in range(6):
            ids = rng.integers(0, 97, 40)
            grads = rng.normal(size=(40, 6)).astype(np.float32)
            for t in tables:
                t.push(ids, grads)
                t.flush()
            np.testing.assert_array_equal(tables[0].pull(ids),
                                          tables[1].pull(ids))
        np.testing.assert_array_equal(tables[0].dump(), tables[1].dump())
        for t in tables:
            t.close()
    finally:
        for s in mine + theirs:
            s.stop()


def test_ps_rejects_shape_mismatch():
    svc = EmbeddingShardService(0, 1)
    svc.create_table("x", 10, 4)
    with pytest.raises(ValueError):
        svc.create_table("x", 10, 8)


def test_ps_rejects_lr_mismatch():
    svc = EmbeddingShardService(0, 1)
    svc.create_table("x", 10, 4, lr=0.1)
    with pytest.raises(ValueError):
        svc.create_table("x", 10, 4, lr=0.5)
    # lr=None attaches without asserting a value
    assert svc.create_table("x", 10, 4) is False


def test_two_shard_two_trainer_graph4rec():
    """2 shard-server processes and 2 trainer processes train the
    ``deepwalk`` preset asynchronously: each trainer's loss falls over its
    epochs, and both tables moved from their initial rows."""
    from pgl_tpu_torch.datasets import blogcatalog_shaped_graph
    n = blogcatalog_shaped_graph(**procs.GRAPH)[0].num_nodes
    lr = procs.trainer_config()["lr"]
    shards, addrs = procs.start_shards(2)
    try:
        # create the tables first (the trainers attach), keeping their rows
        tables = {name: PSEmbedding(addrs, name, n, procs.DIM, lr=lr,
                                    init_scale=scale, seed=seed)
                  for name, scale, seed in (("emb", 0.1, 0), ("ctx", 1e-4,
                                                              1))}
        before = {k: t.dump() for k, t in tables.items()}
        with tempfile.TemporaryDirectory() as tmp:
            losses = procs.run_trainers(2, addrs, tmp)
        for rank, ls in enumerate(losses):
            assert len(ls) == procs.EPOCHS and np.all(np.isfinite(ls))
            assert ls[-1] < ls[0], (rank, ls)
        for name, t in tables.items():
            after = t.dump()
            moved = np.any(after != before[name], axis=1).mean()
            assert moved > 0.9, (name, moved)
            t.close()
    finally:
        procs.stop(shards)
