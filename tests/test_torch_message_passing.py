"""Port parity for edge-weighted message passing: ``Graph.send_ue_recv``,
``Graph.send_uv`` and ``edge_softmax`` of ``pgl_tpu_torch`` (and the
functions of ``pgl_tpu_torch.ops.message_passing``) against
``pgl_tpu.ops.message_passing`` and ``pgl_tpu.nn.functional.edge_softmax``
on the CPU, on the same numpy inputs, outputs and gradients.

On the CPU the port's ``send_ue_recv`` runs K1w's plain version for mul and
add with sum on a scalar or per-head edge feature, and gathers, combines
and reduces otherwise; the reference's CPU path is always the latter. Both
compute the same function: rtol and atol 1e-5 on outputs, 1e-4 on
gradients (float32 sums in another order; the graph's hub row sums 120
terms of magnitude ~1, one edge dropped would be off by ~1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

from pgl_tpu import Graph as JGraph
from pgl_tpu.nn.functional import edge_softmax as j_edge_softmax
from pgl_tpu.ops import message_passing as jmp
from pgl_tpu_torch import Graph
from pgl_tpu_torch.nn.functional import edge_softmax
from pgl_tpu_torch.ops import message_passing as tmp

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

N, E, HUB = 60, 500, 120
OPS = ["add", "sub", "mul", "div"]
REDUCES = ["sum", "mean", "max", "min"]
# (feature shape, edge feature shape): scalar [E] and [E, 1], per head
# [E, H] on [N, D] (H = D here: the reference's segment path broadcasts
# only H in (1, D)), and [E, H] / [E, H, 1] on [N, H, Dh]
SHAPES = [((N, 6), (E,)), ((N, 6), (E, 1)), ((N, 6), (E, 6)),
          ((N, 3, 2), (E, 3)), ((N, 3, 2), (E, 3, 1))]


def _edges(seed=0):
    """Random edges, a hub destination (node 5, ``HUB`` in-edges) and
    nodes with no in-edge (the last ten receive none)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N - 10, E)
    dst[:HUB] = 5
    return np.stack([rng.integers(0, N, E), dst], axis=1)


def _graphs(edges):
    return (JGraph(edges, num_nodes=N).tensor(),
            Graph(edges, num_nodes=N).tensor("cpu"))


def _edge_values(shape, op, rng):
    """Edge features away from 0 for div (so the quotients stay bounded)."""
    w = rng.normal(size=shape).astype(np.float32)
    if op == "div":
        w = np.sign(w) * (0.5 + np.abs(w))
    return w


def _check(got, want, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("reduce_op", REDUCES)
def test_send_ue_recv_matches_reference(op, reduce_op):
    edges = _edges()
    gj, gt = _graphs(edges)
    rng = np.random.default_rng(OPS.index(op) * 4 + REDUCES.index(reduce_op))
    for fshape, wshape in SHAPES:
        x = rng.normal(size=fshape).astype(np.float32)
        w = _edge_values(wshape, op, rng)
        want = np.asarray(jmp.send_ue_recv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(edges[:, 0]),
            jnp.asarray(edges[:, 1]), N, op, reduce_op))
        cot = rng.normal(size=want.shape).astype(np.float32)
        gx, gw = jax.grad(lambda a, b: (gj.send_ue_recv(
            a, b, op, reduce_op) * cot).sum(), (0, 1))(
                jnp.asarray(x), jnp.asarray(w))
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        out = gt.send_ue_recv(xt, wt, op, reduce_op)
        (out * torch.as_tensor(cot)).sum().backward()
        tag = f"{fshape} {wshape}"
        _check(out, want, msg=tag)
        _check(xt.grad, gx, 1e-4, 1e-4, tag)
        _check(wt.grad, gw, 1e-4, 1e-4, tag)
        assert (out[N - 10:] == 0).all(), tag    # no in-edge: zeros
        # the module function on the original edge order
        _check(tmp.send_ue_recv(torch.tensor(x), torch.tensor(w),
                                torch.as_tensor(edges[:, 0]),
                                torch.as_tensor(edges[:, 1]), N, op,
                                reduce_op), want, msg=tag)


@pytest.mark.parametrize("op", OPS)
def test_send_uv_matches_reference(op):
    edges = _edges(1)
    gj, gt = _graphs(edges)
    rng = np.random.default_rng(10 + OPS.index(op))
    for shape in [(N, 4), (N, 3, 2), (N, 1)]:
        a = rng.normal(size=shape).astype(np.float32)
        b = _edge_values(shape, op, rng)
        want = gj.send_uv(jnp.asarray(a), jnp.asarray(b), op)
        cot = rng.normal(size=want.shape).astype(np.float32)
        ga, gb = jax.grad(lambda p, q: (gj.send_uv(p, q, op) * cot).sum(),
                          (0, 1))(jnp.asarray(a), jnp.asarray(b))
        at = torch.tensor(a, requires_grad=True)
        bt = torch.tensor(b, requires_grad=True)
        out = gt.send_uv(at, bt, op)
        (out * torch.as_tensor(cot)).sum().backward()
        _check(out, want, msg=str(shape))
        _check(at.grad, ga, 1e-4, 1e-4, str(shape))
        _check(bt.grad, gb, 1e-4, 1e-4, str(shape))
        np.testing.assert_allclose(
            tmp.send_uv(torch.tensor(a), torch.tensor(b),
                        torch.as_tensor(edges[:, 0]),
                        torch.as_tensor(edges[:, 1]), op).numpy(),
            np.asarray(jmp.send_uv(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(edges[:, 0]),
                                   jnp.asarray(edges[:, 1]), op)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("norm_by", ["dst", "src"])
@pytest.mark.parametrize("shape", [(E,), (E, 4), (E, 2, 3)])
def test_edge_softmax_matches_reference(norm_by, shape):
    edges = _edges(2)
    gj, gt = _graphs(edges)
    rng = np.random.default_rng(len(shape))
    logits = (3 * rng.normal(size=shape)).astype(np.float32)
    want = j_edge_softmax(gj, jnp.asarray(logits), norm_by)
    cot = rng.normal(size=shape).astype(np.float32)
    gl = jax.grad(lambda z: (j_edge_softmax(gj, z, norm_by) * cot).sum())(
        jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    out = edge_softmax(gt, lt, norm_by)
    (out * torch.as_tensor(cot)).sum().backward()
    _check(out, want)
    _check(lt.grad, gl, 1e-4, 1e-5)
    # probabilities sum to 1 over each node's edges
    seg = edges[:, 1 if norm_by == "dst" else 0]
    sums = np.zeros((N,) + shape[1:])
    np.add.at(sums, seg, out.detach().numpy())
    has = np.bincount(seg, minlength=N) > 0
    np.testing.assert_allclose(sums[has], 1.0, rtol=1e-5)


def test_edge_softmax_rejects_other_norms():
    gt = Graph(_edges(), num_nodes=N).tensor("cpu")
    with pytest.raises(ValueError, match="norm_by"):
        edge_softmax(gt, torch.zeros(E), "both")


@pytest.mark.parametrize("op", ["mul", "add"])
def test_empty_graph_gives_zeros(op):
    """No edge: every reduction is zeros, the kernel route included, and
    the gradients are zeros of the inputs' shapes."""
    gt = Graph(np.zeros((0, 2), np.int64), num_nodes=7).tensor("cpu")
    x = torch.randn(7, 4, requires_grad=True)
    w = torch.zeros(0, 1, requires_grad=True)
    out = gt.send_ue_recv(x, w, op, "sum")
    assert out.shape == (7, 4) and (out == 0).all()
    out.sum().backward()
    assert (x.grad == 0).all() and w.grad.shape == (0, 1)
    for reduce_op in REDUCES:
        assert (gt.send_ue_recv(x, w, "sub", reduce_op) == 0).all()
    assert gt.send_uv(x, x).shape == (0, 4)
    assert edge_softmax(gt, torch.zeros(0, 2)).shape == (0, 2)


def test_send_ue_recv_rejects_unknown_ops():
    gt = Graph(_edges(), num_nodes=N).tensor("cpu")
    x, w = torch.randn(N, 2), torch.randn(E)
    with pytest.raises(ValueError, match="message_op"):
        gt.send_ue_recv(x, w, "pow")
    with pytest.raises(ValueError, match="message_op"):
        gt.send_uv(x, x, "pow")
    with pytest.raises(ValueError, match="pool"):
        gt.send_ue_recv(x, w, "mul", "prod")


def test_send_ue_recv_needs_a_tensor_graph():
    with pytest.raises(ValueError, match="tensor"):
        Graph(_edges(), num_nodes=N).send_ue_recv(torch.randn(N, 2),
                                                  torch.randn(E))
