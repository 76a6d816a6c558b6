"""Port parity for the dedup SDDMM (``pgl_tpu_torch/ops/kernels/
sddmm_kernels.py``, ``Graph.sddmm_csc``) against ``pgl_tpu`` on the CPU.

The slot layout equals the reference's array for array. The plain version
(what the CPU path runs) equals the reference's ``sddmm_xla_slots`` bit for
bit: one IEEE float32 operation a value on the same gathered inputs. It is
within 1e-6 relative of the Pallas kernel in interpret mode, whose bf16
hi/mid/lo split of the gathered rows costs it about 2^-26 relative. The
gradients sum in another order than the reference's ``segment_sum``: they
are held at 1e-5 relative to the 2-norm of the terms each element sums (and
at least 1). The CUDA kernel is held against the plain version in
``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

import pgl_tpu
from pgl_tpu.ops.pallas import dedup_kernels as jdk
from pgl_tpu.ops.pallas import sddmm_kernels as jsk
from pgl_tpu_torch import Graph
from pgl_tpu_torch.ops.kernels import dedup_kernels as tdk
from pgl_tpu_torch.ops.kernels import sddmm_kernels as tsk
from pgl_tpu_torch.ops.kernels import segment_kernels as sk
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

OPS = ("add", "sub", "mul", "div")


def graph_edges(kind, seed=0):
    """(src, dst, N): a uniform graph, a skewed one with a hub destination
    (node 5, a third of the edges, several 128-source windows) and repeated
    pairs, one whose upper half has no edge at all, or none."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        N, E = 200, 1500
        return rng.integers(0, N, E), rng.integers(0, N, E), N
    if kind == "skewed":
        N, E = 700, 3000
        dst = rng.integers(0, N, E)
        src = rng.integers(0, N, E)
        dst[:E // 3] = 5
        src[E // 3:E // 3 + 200] = src[:200]
        dst[E // 3:E // 3 + 200] = dst[:200]
        return src, dst, N
    if kind == "isolated":
        N, E = 600, 900
        return rng.integers(0, N // 2, E), rng.integers(0, N // 3, E), N
    return np.zeros(0, np.int64), np.zeros(0, np.int64), 50


def layouts(kind, seed=0):
    src, dst, N = graph_edges(kind, seed)
    idx = EdgeIndex.from_edges(dst, src, N)
    return (jsk.build_sddmm_layout(idx.indptr, idx.sorted_v, N),
            tsk.build_sddmm_layout(idx.indptr, idx.sorted_v, N,
                                   device="cpu"), N)


def features(N, D, seed, shift=3.0):
    """``src`` and ``dst`` [N, D] float32; ``dst`` kept away from 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = rng.normal(size=(N, D)).astype(np.float32)
    return x, y + np.float32(shift) * np.sign(y)


def bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "isolated", "empty"])
def test_layout_matches_reference(kind):
    want, got, N = layouts(kind)
    if want is None:
        assert got is None and kind == "empty"
        return
    S = want.slots
    assert got.slots == S and got.num_edges == want.num_edges
    np.testing.assert_array_equal(got.uv, np.asarray(want.uv))
    np.testing.assert_array_equal(got.slot_src.numpy(),
                                  np.asarray(want.slot_src))
    np.testing.assert_array_equal(
        got.slot_dst.numpy(), np.asarray(want.slot_ids).reshape(-1)[:S])
    np.testing.assert_array_equal(got.eid.numpy(), want.eid)
    # the backward's K1 layouts hold every real slot once, by its endpoint
    real = np.flatnonzero(want.eid >= 0)
    for lay, ids in ((got.by_src, got.slot_src), (got.by_dst, got.slot_dst)):
        assert lay.num_edges == len(real) and lay.num_rows == N
        idx = lay.indices.numpy()
        np.testing.assert_array_equal(np.sort(idx), real)
        np.testing.assert_array_equal(ids.numpy()[idx], lay.seg_ids.numpy())


@pytest.mark.parametrize("nb,w", [(None, None), (128, 128)])
def test_layout_prefix_matches_reference(nb, w):
    """The default prefix is the SpMM's (``nb = NB = 256``, ``w = W``);
    the SDDMM's takes 128 and 128."""
    src, dst, N = graph_edges("skewed")
    idx = EdgeIndex.from_edges(dst, src, N)
    if nb is None:
        got = tdk._LayoutPrefix(idx.indptr, idx.sorted_v, N)
        want = jdk._LayoutPrefix(idx.indptr, idx.sorted_v, N, tdk.NB, tdk.W)
        assert tdk.NB == 256 and tdk.W == 128
    else:
        got = tdk._LayoutPrefix(idx.indptr, idx.sorted_v, N, nb=nb, w=w)
        want = jdk._LayoutPrefix(idx.indptr, idx.sorted_v, N, nb, w)
    assert got.P == want.P
    for f in ("uv", "order", "starts", "ends", "pair_wb", "pair_blk",
              "grow_o", "dst_o", "src_o"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("D", [1, 16, 128])
def test_plain_version_matches_reference_bit_for_bit(op, D):
    want_l, got_l, N = layouts("skewed", seed=1)
    x, y = features(N, D, seed=D)
    want = jsk.sddmm_xla_slots(jnp.asarray(x), jnp.asarray(y), want_l, op)
    got = tsk.sddmm_reference(torch.tensor(x), torch.tensor(y), got_l, op)
    assert got.dtype == torch.float32 and got.shape == (want_l.slots, D)
    np.testing.assert_array_equal(bits(got), bits(want))
    # sddmm_dedup's CPU path is the plain version
    np.testing.assert_array_equal(
        bits(tsk.sddmm_dedup(torch.tensor(x), torch.tensor(y), got_l, op)),
        bits(want))


def test_division_by_zero_keeps_inf_and_nan_on_real_edges():
    want_l, got_l, N = layouts("uniform")
    x, y = features(N, 4, seed=2)
    x[::3] = 0.0
    y[::2] = 0.0
    want = jsk.sddmm_xla_slots(jnp.asarray(x), jnp.asarray(y), want_l, "div")
    got = tsk.sddmm_reference(torch.tensor(x), torch.tensor(y), got_l, "div")
    np.testing.assert_array_equal(bits(got), bits(want))
    real = got_l.eid >= 0
    assert torch.isinf(got[real]).any() and torch.isnan(got[real]).any()
    assert (got[~real] == 0).all()


def test_matches_pallas_kernel_in_interpret_mode():
    """Forward within 1e-6 relative, and the reference's custom_vjp
    gradient (``jax.grad`` through ``sddmm_dedup``) at the module's rule,
    for mul and div on a tiny graph (interpret mode is slow)."""
    rng = np.random.default_rng(7)
    N, E, D = 40, 150, 128
    idx = EdgeIndex.from_edges(rng.integers(0, N, E), rng.integers(0, N, E),
                               N)
    # one 128-slot tile a step: the kernel body traces in less time
    want_l = jsk.build_sddmm_layout(idx.indptr, idx.sorted_v, N, et=128)
    got_l = tsk.build_sddmm_layout(idx.indptr, idx.sorted_v, N, device="cpu")
    x, y = features(N, D, seed=8)
    cot = rng.normal(size=(want_l.slots, D)).astype(np.float32)
    for op in ("mul", "div"):
        want, vjp = jax.vjp(lambda a, b: jsk.sddmm_dedup(a, b, want_l, op,
                                                         True),
                            jnp.asarray(x), jnp.asarray(y))
        xt = torch.tensor(x, requires_grad=True)
        yt = torch.tensor(y, requires_grad=True)
        got = tsk.sddmm_dedup(xt, yt, got_l, op)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        got.backward(torch.tensor(cot))
        check_grads(op, (xt.grad, yt.grad), vjp(jnp.asarray(cot)), x, y,
                    cot, got_l)


def term_scale(op, x, y, g, lay):
    """The 2-norm of the terms each gradient element sums (float64)."""
    x, y, g = (torch.tensor(a, dtype=torch.float64) for a in (x, y, g))
    xs = x.index_select(0, lay.slot_src)
    xd = y.index_select(0, lay.slot_dst.clamp(max=lay.num_segments - 1))
    gs, gd = {"add": (g, g), "sub": (g, g), "mul": (g * xd, g * xs),
              "div": (g / xd, g * xs / (xd * xd))}[op]
    return tuple(sk.spmm_reference(t * t, b).sqrt().numpy()
                 for t, b in ((gs, lay.by_src), (gd, lay.by_dst)))


def check_grads(op, got, want, x, y, g, lay):
    for a, b, scale in zip(got, want, term_scale(op, x, y, g, lay)):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b)
        bound = 1e-5 * np.maximum(np.maximum(np.abs(b), scale), 1.0)
        assert (err <= bound).all(), f"{op}: max |err| {err.max():.3e}"


@pytest.mark.parametrize("op", OPS)
def test_gradients_match_reference(op):
    """The port's backward (K1 over by_src/by_dst; its plain version here)
    against the reference's custom_vjp backward ``_sddmm_bwd``, what
    ``jax.grad`` through ``sddmm_dedup`` runs."""
    want_l, got_l, N = layouts("skewed", seed=2)
    x, y = features(N, 16, seed=3)
    g = np.random.default_rng(4).normal(
        size=(want_l.slots, 16)).astype(np.float32)
    want = jsk._sddmm_bwd(op, False, (jnp.asarray(x), jnp.asarray(y),
                                      want_l), jnp.asarray(g))[:2]
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    sk.reset_launches()
    tsk.sddmm_dedup(xt, yt, got_l, op).backward(torch.tensor(g))
    check_grads(op, (xt.grad, yt.grad), want, x, y, g, got_l)
    # the CPU path runs K1's plain version, which counts no launch
    assert sk.LAUNCHES == 0


@pytest.mark.parametrize("side", ["src", "dst"])
@pytest.mark.parametrize("op", OPS)
def test_one_sided_gradient_equals_the_two_sided_one(op, side):
    """With one input needing a gradient, the backward gathers and saves
    only what that side reads, and gives the same bits."""
    _, lay, N = layouts("skewed", seed=2)
    x, y = features(N, 16, seed=3)
    g = torch.tensor(np.random.default_rng(4).normal(
        size=(lay.slots, 16)).astype(np.float32))
    both = [torch.tensor(a, requires_grad=True) for a in (x, y)]
    tsk.sddmm_dedup(*both, lay, op).backward(g)
    k = 0 if side == "src" else 1
    one = [torch.tensor(a, requires_grad=i == k) for i, a in enumerate((x, y))]
    tsk.sddmm_dedup(*one, lay, op).backward(g)
    assert torch.equal(one[k].grad, both[k].grad)
    assert one[1 - k].grad is None


@pytest.mark.parametrize("op", ["add", "div"])
def test_graph_sddmm_csc_matches_reference(op):
    src, dst, N = graph_edges("skewed", seed=5)
    edges = np.stack([src, dst], axis=1)
    x, y = features(N, 8, seed=6)
    jg = pgl_tpu.Graph(edges, num_nodes=N).tensor()
    g = Graph(edges, num_nodes=N).tensor("cpu")
    want = jg.sddmm_csc(jnp.asarray(x), jnp.asarray(y), op)
    got = g.sddmm_csc(torch.tensor(x), torch.tensor(y), op)
    np.testing.assert_array_equal(bits(got), bits(want))
    lay = g.sddmm_layout()
    assert g.sddmm_layout() is lay           # built once
    np.testing.assert_array_equal(lay.eid.numpy(), jg.sddmm_layout().eid)
    again = g.sddmm_csc(torch.tensor(x), torch.tensor(y), op, layout=lay)
    np.testing.assert_array_equal(bits(again), bits(want))
    # real slots map back to send_uv's rows through eid and the CSC eid
    real = lay.eid >= 0
    edge = g.adj_dst_index.sorted_eid[lay.eid[real]]
    uv = g.send_uv(torch.tensor(x), torch.tensor(y), op)
    assert torch.equal(got[real], uv[edge])


def test_graph_sddmm_csc_needs_a_tensor_graph_and_handles_no_edges():
    g = Graph(np.zeros((0, 2), np.int64), num_nodes=4)
    with pytest.raises(ValueError, match="You must call Graph.tensor"):
        g.sddmm_csc(torch.zeros(4, 3), torch.zeros(4, 3))
    gt = g.tensor("cpu")
    assert gt.sddmm_layout() is None
    out = gt.sddmm_csc(torch.zeros(4, 3), torch.zeros(4, 3))
    assert out.shape == (0, 3) and out.dtype == torch.float32


def test_sddmm_dedup_rejects_what_the_kernel_does_not_take():
    _, lay, N = layouts("uniform")
    x = torch.zeros(N, 4)
    with pytest.raises(TypeError, match="float32"):
        tsk.sddmm_dedup(x.double(), x.double(), lay)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        tsk.sddmm_dedup(x[:, None], x[:, None], lay)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        tsk.sddmm_dedup(x[1:], x[1:], lay)
    with pytest.raises(ValueError, match="op must be"):
        tsk.sddmm_dedup(x, x, lay, "max")
