"""Port parity for the out-of-core SpMM (``pgl_tpu_torch.ops.kernels.
streaming.StreamedSpMM``, ``Graph.streamed_send_u_recv``) and the stream
pool (``pgl_tpu_torch.utils.stream_pool.StreamPool``) on the CPU, against
``pgl_tpu``'s on the reference's own cases (``tests/test_pallas_kernels.py
::test_streamed_spmm_host_features``, ``tests/test_graph.py::
test_streamed_send_u_recv_host_features``; the reference's dedup kernel in
interpret mode): five chunks with a hub straddling them, isolated
destinations, a memmap table, on both routes (K1, and K6 under
``dispatch.DEDUP``), at rtol and atol 1e-4.
"""

import os

import numpy as np
import pytest
import torch

import pgl_tpu
from pgl_tpu.ops.pallas.streaming import StreamedSpMM as JStreamedSpMM
from pgl_tpu_torch import Graph
from pgl_tpu_torch.ops import dispatch
from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
from pgl_tpu_torch.ops.kernels import segment_kernels as sk
from pgl_tpu_torch.ops.kernels.streaming import StreamedSpMM
from pgl_tpu_torch.utils import stream_pool
from pgl_tpu_torch.utils.stream_pool import StreamPool

# one intra-op thread: the test files run in parallel worker processes
torch.set_num_threads(1)

ROUTES = [False, True]
ROUTE_IDS = ["k1", "dedup"]


@pytest.fixture
def route(request, monkeypatch):
    monkeypatch.setattr(dispatch, "DEDUP", request.param)
    return request.param


def hub_case():
    """The reference's case: 2,200 nodes, 15,000 edges, a third of them from
    16 hub sources, D = 128, as a CSC index and a float32 table."""
    N, E, D = 2200, 15000, 128
    rng = np.random.default_rng(3)
    src = np.concatenate([rng.integers(0, 16, E // 3),
                          rng.integers(0, N, E - E // 3)])
    dst = rng.integers(0, N, E)
    order = np.argsort(dst, kind="stable")
    deg = np.bincount(dst, minlength=N)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    feat = rng.normal(size=(N, D)).astype(np.float32)
    return N, src, dst, indptr, src[order], feat


@pytest.fixture(scope="module")
def hub_reference():
    N, src, dst, indptr, sorted_v, feat = hub_case()
    sp = JStreamedSpMM(indptr, sorted_v, N, chunk_rows=512, interpret=True)
    assert len(sp.chunks) == 5
    return sp(feat)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS, indirect=True)
def test_streamed_spmm_matches_reference(route, hub_reference, tmp_path):
    N, src, dst, indptr, sorted_v, feat = hub_case()
    sp = StreamedSpMM(indptr, sorted_v, N, chunk_rows=512, device="cpu")
    assert len(sp.chunks) == 5 and sp.dedup == route
    out = sp(feat)
    np.testing.assert_allclose(out, hub_reference, rtol=1e-4, atol=1e-4)
    want = np.zeros((N, feat.shape[1]))
    np.add.at(want, dst, feat[src].astype(np.float64))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    # a memory-mapped table (the table-larger-than-the-card posture)
    p = os.path.join(tmp_path, "feat.npy")
    np.save(p, feat)
    np.testing.assert_array_equal(sp(np.load(p, mmap_mode="r")), out)
    # into a given output
    given = np.full_like(out, np.nan)
    assert sp(feat, out=given) is given
    np.testing.assert_array_equal(given, out)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS, indirect=True)
def test_streamed_chunks_stage_what_they_read(route):
    """Each chunk stages the rows its edges read: the distinct sources on
    K1's route, the layout's ``uv`` (the reference's staging) under DEDUP;
    every chunk's layout words (both routes packed by ``sk.pack_words``,
    each array 16-byte aligned) unpack to the chunk's layout."""
    N, src, dst, indptr, sorted_v, feat = hub_case()
    sp = StreamedSpMM(indptr, sorted_v, N, chunk_rows=512, device="cpu")
    assert [(c.r0, c.r1) for c in sp.chunks] == [
        (0, 512), (512, 1024), (1024, 1536), (1536, 2048), (2048, 2200)]
    for c in sp.chunks:
        read = sorted_v[indptr[c.r0]:indptr[c.r1]]
        if route:
            assert set(read) <= set(c.rows.tolist())
            # the dedup words unpack (sk.unpack_words) to the chunk's layout
            lay = sp._layout(c, torch.as_tensor(c.words),
                             torch.arange(len(c.rows), dtype=torch.int32))
            want = dk.build_dedup_layout(
                indptr[c.r0:c.r1 + 1] - indptr[c.r0], read, c.r1 - c.r0,
                kind="streamed", device="cpu")
            for name in ("num_edges", "simple", "max_count", "num_partials"):
                assert getattr(lay, name) == getattr(want, name)
            for name in ("pairs", "dst", "urow", "groups", "split_blocks",
                         "split_ptr"):
                assert torch.equal(getattr(lay, name).long(),
                                   getattr(want, name).long())
            np.testing.assert_array_equal(want.uv.numpy(), c.rows)
            assert sk.unpack_words(c.words, 4, 6)[2] == c.words.size
        else:
            np.testing.assert_array_equal(c.rows, np.unique(read))
            lay, end = sk.unpack_spmm_layout(torch.as_tensor(c.words),
                                             "streamed")
            assert end == c.words.size
            assert lay.num_rows == c.r1 - c.r0 and lay.max_index == \
                len(c.rows) - 1
    assert sp.staged_rows == sum(len(c.rows) for c in sp.chunks)
    assert all(b > 0 for b in sp.chunk_bytes(128))


def test_streamed_rounds_chunks_to_the_block():
    N, src, dst, indptr, sorted_v, feat = hub_case()
    assert StreamedSpMM(indptr, sorted_v, N, chunk_rows=700,
                        device="cpu").chunk_rows == 512
    assert StreamedSpMM(indptr, sorted_v, N, chunk_rows=1,
                        device="cpu").chunk_rows == 256
    with pytest.raises(ValueError, match="reads row"):
        StreamedSpMM(indptr, sorted_v, N, device="cpu")(feat[:100])


def isolated_case():
    """The reference's ``streamed_send_u_recv`` case: 1,300 nodes, 9,000
    edges, the last 300 nodes receive none."""
    rng = np.random.default_rng(9)
    N, E, D = 1300, 9000, 128
    edges = rng.integers(0, N, (E, 2))
    edges[:, 1] = rng.integers(0, N - 300, E)
    feat = rng.normal(size=(N, D)).astype(np.float32)
    return N, edges, feat


@pytest.fixture(scope="module")
def isolated_reference():
    N, edges, feat = isolated_case()
    g = pgl_tpu.Graph(edges, num_nodes=N)
    return {op: g.streamed_send_u_recv(feat, op, chunk_rows=512,
                                       interpret=True)
            for op in ("sum", "mean")}


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS, indirect=True)
def test_streamed_send_u_recv_matches_reference(route, isolated_reference):
    N, edges, feat = isolated_case()
    g = Graph(edges, num_nodes=N)
    for op in ("sum", "mean"):
        out = g.streamed_send_u_recv(feat, op, chunk_rows=512, device="cpu")
        np.testing.assert_allclose(out, isolated_reference[op], rtol=1e-4,
                                   atol=1e-4)
    assert (out[N - 300:] == 0).all()      # mean: isolated rows stay zero
    # the device path of the port agrees too
    gt = g.tensor("cpu")
    np.testing.assert_allclose(
        g.streamed_send_u_recv(feat, "sum", chunk_rows=512, device="cpu"),
        gt.send_recv(torch.as_tensor(feat), "sum").numpy(), rtol=1e-4,
        atol=1e-4)


def test_streamed_send_u_recv_keeps_one_layout_set(monkeypatch):
    N, edges, feat = isolated_case()
    g = Graph(edges, num_nodes=N)
    g.streamed_send_u_recv(feat, chunk_rows=512, device="cpu")
    kept = g._streamed[1]
    g.streamed_send_u_recv(feat, "mean", chunk_rows=512, device="cpu")
    assert g._streamed[1] is kept                  # same key: reused
    g.streamed_send_u_recv(feat, chunk_rows=256, device="cpu")
    assert g._streamed[1] is not kept and len(g._streamed[1].chunks) == 6
    monkeypatch.setattr(dispatch, "DEDUP", True)
    g.streamed_send_u_recv(feat, chunk_rows=256, device="cpu")
    assert g._streamed[1].dedup and g._streamed[0] == (256, "cpu", True)
    # a tensor graph streams through its host copy
    out = g.tensor("cpu").streamed_send_u_recv(feat, chunk_rows=512,
                                               device="cpu")
    assert out.shape == (N, 128)
    with pytest.raises(NotImplementedError):
        g.streamed_send_u_recv(feat, "max", device="cpu")


def test_streamed_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    N, edges, feat = isolated_case()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Graph(edges, num_nodes=N).streamed_send_u_recv(feat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamPool(2)


# -- the stream pool -------------------------------------------------------

def test_stream_pool_roundtrip():
    """The reference's ``test_stream_pool``: a pull gives the rows, a push
    writes them, on the CPU's plain copies; tensors, slices, whole arrays
    and ``submit`` too."""
    pool = StreamPool(pool_size=2, device="cpu")
    host = np.arange(50, dtype=np.float32).reshape(10, 5)
    rows = pool.async_pull(host, [2, 4]).result()
    assert isinstance(rows, torch.Tensor)
    np.testing.assert_array_equal(rows.numpy(), host[[2, 4]])
    pool.async_push(host, [0], torch.full((1, 5), -1.0))
    pool.async_push(host, slice(8, 10), np.full((2, 5), -2.0))
    pool.synchronize()
    np.testing.assert_array_equal(host[0], -1.0)
    np.testing.assert_array_equal(host[8:], -2.0)
    whole = pool.async_pull(host).result()
    np.testing.assert_array_equal(whole.numpy(), host)
    # a pulled tensor is its own copy: the staging buffer is reused
    first = pool.async_pull(host, [1]).result()
    for _ in range(3):
        pool.async_pull(host, [3]).result()
    np.testing.assert_array_equal(first.numpy(), host[[1]])
    assert pool.submit(lambda a, b: a + b, 2, 3).result() == 5
    with pytest.raises(IndexError):
        pool.async_pull(host, [10])
    pool.close()


def test_stream_pool_splits_a_large_gather(monkeypatch):
    """A pull of more than ``GATHER_BLOCK`` rows a thread is gathered by
    the process's ``GATHER_THREADS`` gather threads into one buffer; the
    rows come out in order. The split follows the row count alone: the
    pool takes no thread option."""
    monkeypatch.setattr(stream_pool, "GATHER_THREADS", 4)
    used, real = [], stream_pool._gather_executor
    monkeypatch.setattr(stream_pool, "_gather_executor",
                        lambda: used.append(1) or real())
    host = np.random.default_rng(5).normal(size=(40000, 3)).astype(
        np.float32)
    index = np.random.default_rng(6).integers(0, 40000, 70000)
    pool = StreamPool(1, device="cpu")
    assert min(4, len(index) // stream_pool.GATHER_BLOCK) == 4
    np.testing.assert_array_equal(
        pool.async_pull(host, index).result().numpy(), host[index])
    assert used == [1]
    np.testing.assert_array_equal(
        pool.async_pull(host, index[:1000]).result().numpy(),
        host[index[:1000]])
    assert used == [1]                     # a small gather stays whole
    pool.close()


def test_stream_pool_raises_what_a_worker_raised():
    pool = StreamPool(1, device="cpu")

    def boom():
        raise ValueError("worker failed")

    pool.submit(boom)
    with pytest.raises(ValueError, match="worker failed"):
        pool.synchronize()
    pool.close()


def test_stream_pool_never_falls_back_to_pageable_memory():
    """A staging buffer for a card is pinned; where pinning fails (here:
    no card) it raises instead of staging in pageable memory."""
    st = stream_pool._Staging(torch.device("cpu"))
    st.cuda = True
    if torch.cuda.is_available():
        _, t, _ = st.take((4, 4), np.float32)
        assert t.is_pinned()
    else:
        with pytest.raises(RuntimeError):
            st.take((4, 4), np.float32)


def test_stream_pool_history_rows_never_torn():
    """The reference's ``test_history_async_roundtrip``: pushes and pulls
    through the pool land as the blocking path does, and the history's lock
    keeps every read of a row whole."""
    from pgl_tpu_torch.apps.gnn_autoscale import History
    pool = StreamPool(2, device="cpu")
    h = History(64, 8, device="cpu")
    vals = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    idx = np.arange(16) * 3 % 64
    h.async_push(idx, vals, pool)
    pool.synchronize()
    np.testing.assert_array_equal(h.async_pull(idx, pool).result().numpy(),
                                  vals)
    np.testing.assert_array_equal(h.pull(idx).numpy(), vals)
    row = np.arange(1)
    # row 0 still holds vals[0], whose values differ: make it whole first,
    # so a pull that overtakes the loop's first push reads a whole row
    h.async_push(row, torch.full((1, 8), -1.0), pool)
    pool.synchronize()
    for k in range(50):
        pushed = h.async_push(row, torch.full((1, 8), float(k)), pool)
        got = h.async_pull(row, pool).result().numpy()[0]
        assert (got == got[0]).all(), got
        # the pool orders no two pushes (two workers): the next push waits
        # for this one, so the last to land is the last pushed
        pushed.result()
    pool.synchronize()
    assert (h.emb[0] == 49.0).all()
    pool.close()
