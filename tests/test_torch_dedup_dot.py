"""Parity of the port's count-matrix dot attention (K7/K8 in dot mode,
``dedup_dot_attention`` of ``pgl_tpu_torch/ops/kernels/dedup_attention.py``)
with ``pgl_tpu``'s ``dedup_dot_attention`` run in interpret mode, on the
CPU, each on its own dedup layout of the same numpy edges: the forward and
its ``lse``, the gradients (through the fold over ``build_uniq_reduce``), the
cell dropout, and scores wider than one 128-lane tile. ``TransformerConv``
and ``UniMP`` on a dedup-layout graph are held against the reference in
``tests/test_torch_transformer.py``; the CUDA kernels against the plain
versions in ``tests/test_torch_kernels_gpu.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack: there this file skips
pytest.importorskip("flax")

from pgl_tpu.ops.pallas import dedup_kernels as jdk
from pgl_tpu.ops.pallas.dedup_attention import (
    _dedup_attn_fwd_call, build_uniq_reduce as j_uniq_reduce,
    dedup_dot_attention as j_dedup_dot)
from pgl_tpu_torch.ops.kernels import dedup_attention as da
from pgl_tpu_torch.ops.kernels import dedup_kernels as tdk
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

# The first torch.exp of a process on the CPU can differ from every later
# one by up to ~6e-5 (see tests/test_torch_dedup_attention.py): take it here.
torch.exp(torch.zeros(1 << 16))


def _edges(kind):
    """(edges [E, 2] as (src, dst), N) of a small graph of one kind, at the
    size of the reference's own test (tests/test_dedup_attention.py:170)."""
    rng = np.random.default_rng({"hub": 3, "dups": 4, "empty": 5,
                                 "simple": 6, "multi": 7}[kind])
    N, E = 700, 5000
    if kind == "empty":                 # every edge into nodes 0..199
        return np.stack([rng.integers(0, N, E),
                         rng.integers(0, 200, E)], 1), N
    if kind == "simple":                # no (dst, src) pair twice
        pairs = rng.choice(N * N, E, replace=False)
        return np.stack([pairs % N, pairs // N], 1), N
    e = rng.integers(0, N, (E, 2))
    if kind == "hub":                   # hub destination 0, hub source 1
        e[:E // 3, 1] = 0
        e[E // 3:E // 2, 0] = 1
    else:                               # "dups" and "multi": a multigraph
        e[-600:] = e[:600]
    return e, N


def _case(kind, H, dsh, dvh, scale=1.0):
    """Both packages' layouts of one graph and numpy q, k [N, H·dsh], v and
    a target [N, H·dvh]."""
    edges, N = _edges(kind)
    idx = EdgeIndex.from_edges(edges[:, 1], edges[:, 0], N)
    ref = jdk.build_dedup_layout(idx.indptr, idx.sorted_v, N,
                                 debug_rows=True)
    lay = tdk.build_dedup_layout(idx.indptr, idx.sorted_v, N, device="cpu")
    rng = np.random.default_rng(H * 1000 + dsh * 10 + dvh)
    q, k = (rng.normal(size=(N, H * dsh)).astype(np.float32)
            * np.float32(scale) for _ in range(2))
    v, tgt = (rng.normal(size=(N, H * dvh)).astype(np.float32)
              for _ in range(2))
    return N, ref, lay, q, k, v, tgt


def _pad_lanes(v):
    """v with its columns padded to a multiple of 128, as the reference's
    kernels take it."""
    width = -(-v.shape[1] // 128) * 128
    return jnp.zeros((v.shape[0], width)).at[:, :v.shape[1]].set(v)


def _reference(ref, N, H, dsh, dvh, q, k, v, tgt, rate, seed):
    """The reference's out, lse [N, H] and gradients of sum((out - tgt)^2)
    (interpret mode)."""
    red = j_uniq_reduce(ref, N)
    seed_j = None if seed is None else jnp.int32(seed)
    C = H * dvh
    out, lse = _dedup_attn_fwd_call(
        jnp.asarray(q), jnp.asarray(k), _pad_lanes(v), ref, H, dvh, dsh,
        False, 0.0, 256, 1024, 128, True, rate, seed_j)
    n_pad = lse.shape[0] // H
    lse = np.asarray(lse).reshape(n_pad // 256, H, 256).transpose(
        0, 2, 1).reshape(n_pad, H)[:N]

    def loss(a, b, c):
        o = j_dedup_dot(a, b, c, ref, red, H, dsh, dvh, 0.0, 256, 1024, True,
                        rate, seed_j)
        return ((o[:, :C] - tgt) ** 2).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), _pad_lanes(v))
    return (np.asarray(out)[:, :C], lse,
            [np.asarray(gr)[:, :w] for gr, w in zip(grads, (H * dsh, H * dsh,
                                                             C))])


def _port(lay, N, H, dsh, dvh, q, k, v, tgt, rate, seed):
    att = da.build_dedup_attention(lay, N)
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = da.dedup_dot_attention(*t, att, H, dsh, dvh, 0.0, rate, seed)
    ((out - torch.as_tensor(tgt)) ** 2).sum().backward()
    _, lse = da.dedup_dot_reference(*(x.detach() for x in t), lay, dsh, dvh,
                                    0.0, rate, seed)
    return out.detach().numpy(), lse.numpy(), [x.grad.numpy() for x in t]


# the reference's own tolerances (tests/test_dedup_attention.py:170-237):
# forward rtol 1e-4, atol 1e-4; gradients rtol 2e-3, atol 3e-4
FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=2e-3, atol=3e-4)


def _assert_matches(got, want):
    (out, lse, grads), (out_j, lse_j, grads_j) = got, want
    np.testing.assert_allclose(out, out_j, err_msg="out", **FWD)
    np.testing.assert_allclose(lse, lse_j, err_msg="lse", **FWD)
    for g, w, name in zip(grads, grads_j, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD)


@pytest.mark.parametrize("kind,H,dsh,dvh,scale", [
    ("hub", 4, 8, 8, 1.0), ("dups", 2, 16, 8, 0.5), ("empty", 1, 8, 16, 1.0),
    ("hub", 4, 64, 8, 0.2)])
def test_forward_lse_and_gradients_match_reference(kind, H, dsh, dvh, scale):
    """A hub destination and a hub source (the hub block has several
    windows), a multigraph with dsh != dvh, empty rows (zeros in out and
    lse), and scores 256 columns wide (H·dsh > 128, the reference's
    wide-score case)."""
    N, ref, lay, *ins = _case(kind, H, dsh, dvh, scale)
    got = _port(lay, N, H, dsh, dvh, *ins, 0.0, None)
    _assert_matches(got, _reference(ref, N, H, dsh, dvh, *ins, 0.0, None))
    if kind == "empty":
        assert (got[0][200:] == 0).all() and (got[1][200:] == 0).all()
    if kind == "hub":
        assert int(np.bincount(lay.pairs[:, 0].numpy())[0]) > 1
    if kind == "dups":
        assert not lay.simple


@pytest.mark.parametrize("kind", ["simple", "multi"])
def test_cell_dropout_matches_reference(kind):
    """Rate 0.3 at one seed: the plain version drops the cells the
    reference's in-kernel mask drops, on a simple graph (cell dropout is
    edge dropout there) and on a multigraph in cell mode (a cell's
    duplicates drop together); outputs and gradients."""
    H, dsh, dvh = 2, 8, 8
    N, ref, lay, *ins = _case(kind, H, dsh, dvh)
    assert lay.simple == (kind == "simple")
    _assert_matches(_port(lay, N, H, dsh, dvh, *ins, 0.3, -1234567),
                    _reference(ref, N, H, dsh, dvh, *ins, 0.3, -1234567))


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_backward_is_autograd_of_plain_forward(rate):
    """``dedup_dot_attention``'s backward (the plain K8, then the fold over
    ``red``) against torch autograd of the plain forward, in float64, at
    dsh != dvh with a leaky relu."""
    H, dsh, dvh = 3, 4, 5
    N, _, lay, q, k, v, g = _case("multi", H, dsh, dvh)
    att = da.build_dedup_attention(lay, N)
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
         for x in (q, k, v)]
    g = torch.as_tensor(g, dtype=torch.float64)
    out, _ = da.dedup_dot_reference(*t, lay, dsh, dvh, 0.2, rate, -77)
    want = torch.autograd.grad(out, t, g)
    got = torch.autograd.grad(
        da.dedup_dot_attention(*t, att, H, dsh, dvh, 0.2, rate, -77), t, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_counts_or_none_give_the_same_bits():
    """A layout with K4's counts and one without give the same outputs and
    gradients."""
    H, dsh, dvh = 2, 16, 8
    N, _, lay, *ins = _case("dups", H, dsh, dvh)
    with_counts = tdk.materialize_counts(lay)
    assert with_counts.counts is not None
    runs = [_port(lay_, N, H, dsh, dvh, *ins, 0.3, 99)
            for lay_ in (with_counts, dataclasses.replace(lay, counts=None))]
    flat = [np.concatenate([r[0].ravel(), r[1].ravel()]
                           + [g.ravel() for g in r[2]]) for r in runs]
    np.testing.assert_array_equal(flat[0], flat[1])


def test_plain_path_launches_nothing_and_checks_shapes():
    N, _, lay, q, k, v, _ = _case("empty", 2, 4, 3)
    att = da.build_dedup_attention(lay, N)
    da.reset_launches()
    out = da.dedup_dot_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                 att, 2)
    assert out.shape == (N, 6) and not da.LAUNCHES_BY_SHAPE
    with pytest.raises(ValueError, match="are not"):
        da.dedup_dot_attention(torch.zeros(N, 8), torch.zeros(N, 6),
                               torch.zeros(N, 8), att, 2)
    with pytest.raises(ValueError, match="device"):
        da.dedup_dot_attention(*(torch.zeros(N, 8, device="meta")
                                 for _ in range(3)), att, 2)
