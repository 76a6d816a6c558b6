"""Port parity for the SpMM kernel module (``pgl_tpu_torch/ops/kernels``).

On the CPU the port runs the kernel's plain PyTorch version; it is held
against the Pallas kernels in interpret mode, ``sorted_segment_sum`` and
``spmm`` (K1) and ``_blocked_spmm_fused`` (K2), forward and gradient, on the
same numpy inputs. Tolerance rtol 1e-5, atol 1e-3: float32 sums taken in
another order (the one-hot MXU product against ``index_add_`` over sources
sorted within each row). A hub row here sums 1000 terms of magnitude ~1, and
two orders of such a sum differ by ~1e-4 rms; one edge dropped or counted
twice would be off by ~1. The CUDA kernel itself is held against its
plain version in ``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack: there this file skips, and the gpu tests still collect
pytest.importorskip("flax")

import pgl_tpu
from pgl_tpu.nn.functional import edge_softmax as j_edge_softmax
from pgl_tpu.ops.pallas import segment_kernels as jsk
from pgl_tpu.ops.segment import segment_softmax as j_segment_softmax
import pgl_tpu_torch
from pgl_tpu_torch.nn.functional import edge_softmax
from pgl_tpu_torch.ops.kernels import segment_kernels as tsk
from pgl_tpu_torch.ops.segment import segment_softmax
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3
NB, ET = 128, 256    # the interpret-mode tile sizes of test_pallas_kernels


def make_segments(N, E, D, seed=0, hub=False):
    """Sorted segment ids (optionally one hub of E/2 edges and many empty
    segments), messages and indptr, as in tests/test_pallas_kernels.py."""
    rng = np.random.default_rng(seed)
    if hub:
        seg = np.sort(np.concatenate([
            np.zeros(E // 2, np.int32),
            rng.integers(N // 2, N, E - E // 2).astype(np.int32)]))
    else:
        seg = np.sort(rng.integers(0, N, E)).astype(np.int32)
    msgs = rng.normal(size=(E, D)).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=N))])
    return msgs, seg, indptr.astype(np.int32)


def make_graph(N, E, D, seed=0, hub=False):
    """Edges (dst skewed like make_segments, src uniform), features, the
    CSC/CSR indexes and a cotangent."""
    rng = np.random.default_rng(seed)
    _, dst, _ = make_segments(N, E, 1, seed, hub)
    src = rng.integers(0, N, E)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(N, D)).astype(np.float32)
    return (EdgeIndex.from_edges(dst, src, N),
            EdgeIndex.from_edges(src, dst, N), x, w)


SEG_CASES = [
    (100, 1000, 128, False),
    (1000, 5000, 16, False),
    (64, 2000, 128, True),      # hub segment + empty segments
    (64, 2000, 16, True),
    (300, 77, 128, False),      # fewer edges than a tile
]


@pytest.mark.parametrize("N,E,D,hub", SEG_CASES)
def test_sorted_segment_sum_matches_pallas(N, E, D, hub):
    msgs, seg, indptr = make_segments(N, E, D, hub=hub)
    w = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)

    def loss(m):
        return (jsk.sorted_segment_sum(m, jnp.asarray(seg),
                                       jnp.asarray(indptr), N, NB, ET, True)
                * w).sum()

    want = jsk.sorted_segment_sum(jnp.asarray(msgs), jnp.asarray(seg),
                                  jnp.asarray(indptr), N, NB, ET, True)
    want_grad = jax.grad(loss)(jnp.asarray(msgs))

    m = torch.tensor(msgs, requires_grad=True)
    out = tsk.sorted_segment_sum(m, torch.as_tensor(seg), indptr, N)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want_grad),
                               rtol=RTOL, atol=ATOL)


def test_sorted_segment_sum_rejects_mismatched_ids():
    msgs, seg, indptr = make_segments(20, 100, 4)
    with pytest.raises(ValueError, match="seg_ids"):
        tsk.sorted_segment_sum(torch.as_tensor(msgs),
                               torch.as_tensor(seg[::-1].copy()), indptr, 20)


def _pallas_layouts(csc, csr, N):
    return tuple(jsk.build_blocked_layout(idx.indptr, idx.sorted_v, N, NB, ET)
                 for idx in (csc, csr))


def _port_layouts(csc, csr, N):
    return tuple(tsk.build_spmm_layout(idx.indptr, idx.sorted_v, N, kind=k,
                                       device="cpu")
                 for k, idx in (("csc", csc), ("csr", csr)))


@pytest.mark.parametrize("N,E,D,hub", [
    (100, 1000, 128, False),
    (64, 2000, 128, True),
    (64, 2000, 16, True),
    (300, 77, 16, False),
])
def test_spmm_matches_pallas(N, E, D, hub):
    csc, csr, x, w = make_graph(N, E, D, hub=hub)
    jcsc, jcsr = _pallas_layouts(csc, csr, N)

    def loss(f):
        return (jsk.spmm(f, jcsc, jcsr, NB, ET, True) * w).sum()

    want = jsk.spmm(jnp.asarray(x), jcsc, jcsr, NB, ET, True)
    want_grad = jax.grad(loss)(jnp.asarray(x))

    f = torch.tensor(x, requires_grad=True)
    out = tsk.spmm(f, *_port_layouts(csc, csr, N))
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_grad),
                               rtol=RTOL, atol=ATOL)


def test_spmm_matches_pallas_fused_gather():
    """K2: the fused-gather Pallas kernel has K1's contract; the port's one
    kernel covers both."""
    N, E, D = 64, 700, 128
    csc, csr, x, _ = make_graph(N, E, D, seed=2, hub=True)
    jcsc, _ = _pallas_layouts(csc, csr, N)
    want = jsk._blocked_spmm_fused(jnp.asarray(x), jcsc.padded_v,
                                   jcsc.padded_ids, jcsc.tile_starts,
                                   jcsc.tile_ends, N, NB, ET, True)
    out = tsk.spmm(torch.as_tensor(x), *_port_layouts(csc, csr, N))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("deg", [
    [2 * tsk.ET + 3, 0, 3, 0, 1, 0, 4],    # a row of three pieces
    [tsk.ET, tsk.ET + 1, 0, 1, 0],         # one full piece; just over one
    [0, 5, 0, 7],                          # no row split
], ids=["three_pieces", "piece_edges", "no_split"])
def test_layout_covers_every_edge_once(deg):
    """``cut_rows`` (the pieces of the attention and dedup work lists, and
    at its own lengths of K1's) cuts every row into pieces of at most
    ``ET`` edges in order, an empty row one empty piece, split rows owning
    contiguous partial slots; the layout's work list (``items``) and
    ``seg_ids`` cover every edge once."""
    et = tsk.ET
    deg = np.array(deg)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    E = int(indptr[-1])
    pieces, split_rows, split_ptr = tsk.cut_rows(indptr, et)
    row, begin, end, slot = pieces.T
    covered = np.concatenate([np.arange(b, e) for b, e in zip(begin, end)])
    np.testing.assert_array_equal(np.sort(covered), np.arange(E))
    assert len(covered) == E
    np.testing.assert_array_equal(begin >= indptr[row], True)
    np.testing.assert_array_equal(end <= indptr[row + 1], True)
    np.testing.assert_array_equal(end - begin <= et, True)
    n_pc = np.maximum(1, -(-deg // et))
    np.testing.assert_array_equal(np.bincount(row, minlength=len(deg)), n_pc)
    empty = np.flatnonzero(deg == 0)
    np.testing.assert_array_equal(begin[np.isin(row, empty)],
                                  end[np.isin(row, empty)])
    # split rows own contiguous partial slots in piece order; others store
    split = np.flatnonzero(n_pc > 1)
    np.testing.assert_array_equal(split_rows, split)
    for i, r in enumerate(split):
        np.testing.assert_array_equal(slot[row == r],
                                      np.arange(split_ptr[i],
                                                split_ptr[i + 1]))
    assert (slot[~np.isin(row, split)] == -1).all()
    assert split_ptr[-1] == (slot >= 0).sum()
    lay = tsk.build_spmm_layout(indptr, np.arange(E)[::-1], len(deg),
                                device="cpu")
    items = lay.items.numpy()
    covered = np.concatenate([np.arange(b, e) for _, b, e, _ in items])
    np.testing.assert_array_equal(np.sort(covered), np.arange(E))
    np.testing.assert_array_equal(lay.seg_ids.numpy(),
                                  np.repeat(np.arange(len(deg)), deg))


def test_layout_rejects_bad_indptr():
    with pytest.raises(ValueError, match="indptr"):
        tsk.build_spmm_layout(np.array([0, 2, 5]), np.arange(4), 2,
                              device="cpu")


def test_plain_version_runs_for_cpu_tensors_only():
    csc, csr, x, _ = make_graph(30, 200, 8)
    layouts = _port_layouts(csc, csr, 30)
    tsk.reset_launches()
    tsk.spmm(torch.as_tensor(x), *layouts)
    assert tsk.LAUNCHES == 0
    with pytest.raises(ValueError, match="device"):
        tsk.spmm(torch.as_tensor(x, device="meta"), *layouts)



def test_segment_softmax_of_an_all_neg_inf_segment_is_zero():
    """A segment whose logits are all -inf gives zeros, as the reference's
    shift of a non-finite max to 0 does (``pgl_tpu/ops/segment.py:117-
    122``), and the other segments their softmax; no NaN."""
    data = np.array([-np.inf, -np.inf, 1.0, 2.0], np.float32)
    ids = np.array([0, 0, 1, 1])
    want = np.asarray(j_segment_softmax(jnp.asarray(data), jnp.asarray(ids),
                                        2))
    got = segment_softmax(torch.as_tensor(data), torch.as_tensor(ids), 2)
    assert not torch.isnan(got).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_edge_softmax_on_a_masked_destination_matches_reference():
    """``edge_softmax`` on a 3-node graph where every edge into node 2 is
    masked to -inf (``where(mask, x, -inf)``, the usual masked logits):
    zeros there, and a finite gradient w.r.t. ``x`` equal to the
    reference's ``jax.grad``, forward at rtol 1e-6 and backward at atol
    1e-6 (float32, one exp and one division apart)."""
    edges = np.array([[0, 1], [2, 1], [0, 2], [1, 2], [1, 0]])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 2)).astype(np.float32)
    w = rng.normal(size=(5, 2)).astype(np.float32)
    mask = (edges[:, 1] != 2)[:, None]

    jg = pgl_tpu.Graph(edges, num_nodes=3).tensor()

    def j_loss(a):
        logits = jnp.where(mask, a, -jnp.inf)
        alpha = j_edge_softmax(jg, logits)
        return (alpha * w).sum(), alpha

    (_, j_alpha), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(x))

    tg = pgl_tpu_torch.Graph(edges, num_nodes=3).tensor("cpu")
    a = torch.tensor(x, requires_grad=True)
    alpha = edge_softmax(tg, torch.where(torch.as_tensor(mask), a,
                                         torch.tensor(-np.inf)))
    (alpha * torch.as_tensor(w)).sum().backward()
    assert not torch.isnan(alpha).any() and torch.isfinite(a.grad).all()
    assert (alpha[2:4] == 0).all()
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(j_alpha),
                               rtol=1e-6)
    assert np.isfinite(np.asarray(j_grad)).all()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(j_grad), atol=1e-6)
