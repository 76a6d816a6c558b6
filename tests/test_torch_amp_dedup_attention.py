"""Port parity for mixed precision on the count-matrix attention: the bf16
plain versions of K7 and K8 (``pgl_tpu_torch/ops/kernels/
dedup_attention.py``), additive and dot, against ``pgl_tpu``'s
``dedup_gat_attention`` and ``dedup_dot_attention`` in interpret mode on
the same bf16 inputs, forward and gradients; and GAT and UniMP trained
under ``utils.amp`` on a graph with dedup layouts against the reference's
amp training.

The port's bf16 contract (the CUDA kernels', which these plain versions
compute): tables loaded as bf16 and widened to float32, every score, exp,
sum and product in float32, ``lse`` and ``delta`` float32, and each output
rounded once to bf16. The reference keeps the same contract here: it
widens the tables, ``g`` and ``delta`` to float32 before its kernels, sums
its pair-slot rows and their fold in float32 and rounds each output once
(``pgl_tpu/ops/pallas/dedup_attention.py:483``, ``:508-512``,
``:612-625``, ``:713-724``). So each output is held against float64 of the
same bf16 values by ``tests/test_torch_amp_attention.py``'s rule, except
that the mean and the root mean square take a slack at the elements where
the two bf16 results differ, and nowhere else: one bf16 ulp of the larger
of the two (``_no_worse_once``). Both round a float32 value once, summed
in another order, so they differ only where that rounding falls on either
side of a bf16 boundary, by one ulp; which side is either's luck, as the
rule says of its largest error. (A gradient whose float64 value is 0, as
d a_dst of a row of one cell, where ``delta`` is formed from the bf16
``out`` in both packages, is a few ulps of its terms in both, and the two
results fall one ulp apart there.) The contract itself is held
exactly: each bf16 output is the float32 computation on the same values
rounded once. The graph has a hub destination, a hub source, empty rows,
repeated (dst, src) pairs (cells of several edges) and shuffled edges
(``tests/test_torch_amp_attention.py:_edges``); the cell dropout is keyed
alike in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

from pgl_tpu.ops.pallas import dedup_kernels as jdk  # noqa: E402
from pgl_tpu.ops.pallas.dedup_attention import (  # noqa: E402
    build_uniq_reduce as j_uniq_reduce, dedup_dot_attention as j_dedup_dot,
    dedup_gat_attention as j_dedup_gat)
from pgl_tpu_torch.ops import dispatch  # noqa: E402
from pgl_tpu_torch.ops.kernels import attention_kernels as ak  # noqa
from pgl_tpu_torch.ops.kernels import dedup_attention as da  # noqa: E402
from pgl_tpu_torch.ops.kernels import dedup_kernels as tdk  # noqa: E402
from pgl_tpu_torch.utils.edge_index import EdgeIndex  # noqa: E402
from test_torch_amp_attention import (BF, N, _amp_both, _bf16,  # noqa: E402
                                      _edges, _errors, _exact_run,
                                      _models, _pad_lanes, _port_run)

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

# The first torch.exp of a process on the CPU can differ from every later
# one by up to ~6e-5 (see tests/test_torch_dedup_attention.py): take it here.
torch.exp(torch.zeros(1 << 16))


def _layouts(seed):
    """The reference's CSC dedup layout and its fold, and the port's
    count-matrix work lists, of one graph."""
    edges = _edges(seed)
    idx = EdgeIndex.from_edges(edges[:, 1], edges[:, 0], N)
    ref = jdk.build_dedup_layout(idx.indptr, idx.sorted_v, N,
                                 debug_rows=True)
    lay = tdk.build_dedup_layout(idx.indptr, idx.sorted_v, N, device="cpu")
    assert not lay.simple
    return ref, j_uniq_reduce(ref, N), da.build_dedup_attention(lay, N)


def _no_worse_once(name, port, ref, exact):
    """``_no_worse`` of two results that each round a float32 value once
    (the module's note): the port's mean and root mean square error no
    larger than the reference's plus one bf16 ulp (at most 2^-7 of the
    larger magnitude) at each element where the two differ, its largest no
    larger than the reference's plus 2^-8 of the largest |exact|."""
    e_port, e_ref = _errors(port, ref, exact)
    port, ref = np.asarray(port), np.asarray(ref)
    exact = np.abs(np.asarray(exact, np.float64))
    luck = np.where(port != ref, 2.0 ** -7 * np.maximum(np.abs(port),
                                                        np.abs(ref)), 0.0)
    assert e_port.mean() <= (e_ref + luck).mean(), (name, e_port.mean(),
                                                    e_ref.mean())
    assert (e_port ** 2).mean() <= ((e_ref + luck) ** 2).mean(), name
    assert e_port.max() <= e_ref.max() + 2.0 ** -8 * exact.max(), (
        name, e_port.max(), e_ref.max())


def _compare(fn, jfn, tables, cot, widths):
    """``fn`` (the port) and ``jfn`` (the reference, its v lane-padded) on
    the bf16 ``tables`` with the loss ``sum(out · cot)``: out and each
    gradient held by ``_no_worse_once`` against float64 of the same
    values."""
    C = cot.shape[1]

    def loss_j(a, b, c):
        out = jfn(a, b, c)
        return (out[:, :C].astype(jnp.float32) * cot).sum(), out

    a, b, v = tables
    (_, out_j), grads_j = jax.value_and_grad(loss_j, (0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        _pad_lanes(v, -(-C // 128) * 128))
    assert out_j.dtype == jnp.bfloat16
    ref = [np.asarray(out_j[:, :C].astype(jnp.float32))] + [
        np.asarray(gr.astype(jnp.float32))[:, :w]
        for gr, w in zip(grads_j, widths)]
    out, grads = _port_run(fn, tables, cot)
    out64, grads64 = _exact_run(fn, tables, cot)
    for name, p, r, x in zip(("out", "d0", "d1", "dv"), [out] + grads, ref,
                             [out64] + grads64):
        _no_worse_once(name, p, r, x)
    return out


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("H,dvh", [(8, 8), (1, 16)])
def test_bf16_dedup_additive_no_worse_than_pallas(H, dvh, rate):
    """K7 (out) and K8 (d a_dst, d a_src, dv) on bf16 tables: the port's
    bf16 plain versions and the reference's ``dedup_gat_attention`` in
    interpret mode (its backward through the fold of ``build_uniq_reduce``),
    each against float64 of the same bf16 values (``_no_worse_once``)."""
    ref, red, att = _layouts(7)
    rng = np.random.default_rng(H * 100 + dvh)
    a_dst, a_src = (_bf16(rng.normal(size=(N, H))) for _ in range(2))
    v = _bf16(rng.normal(size=(N, H * dvh)))
    cot = _bf16(rng.normal(size=(N, H * dvh)))
    seed = 12345 if rate else None
    seed_j = None if seed is None else jnp.int32(seed)

    def jfn(a, b, c):
        return j_dedup_gat(a, b, c, ref, red, H, dvh, 0.2, 256, 1024, True,
                           rate, seed_j)

    def fn(a, b, c):
        return da.dedup_gat_attention(a, b, c, att, 0.2, dvh, rate, seed)

    out = _compare(fn, jfn, (a_dst, a_src, v), cot, (H, H, H * dvh))
    assert (out[1:N // 2] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_bf16_dedup_dot_no_worse_than_pallas(rate):
    """The dot-mode K7 and K8 (dq, dk, dv) at (H, dsh, dvh) = (2, 16, 16)
    on bf16 tables: the port's bf16 plain versions and the reference's
    ``dedup_dot_attention`` in interpret mode, each against float64 of the
    same bf16 values (``_no_worse_once``)."""
    H, dsh, dvh = 2, 16, 16
    ref, red, att = _layouts(9)
    rng = np.random.default_rng(3)
    q, k = (_bf16(rng.normal(size=(N, H * dsh)) * dsh ** -0.25)
            for _ in range(2))
    v = _bf16(rng.normal(size=(N, H * dvh)))
    cot = _bf16(rng.normal(size=(N, H * dvh)))
    seed = 12345 if rate else None
    seed_j = None if seed is None else jnp.int32(seed)

    def jfn(a, b, c):
        return j_dedup_dot(a, b, c, ref, red, H, dsh, dvh, 0.0, 256, 1024,
                           True, rate, seed_j)

    def fn(a, b, c):
        return da.dedup_dot_attention(a, b, c, att, H, dsh, dvh, 0.0, rate,
                                      seed)

    _compare(fn, jfn, (q, k, v), cot, (H * dsh, H * dsh, H * dvh))


@pytest.mark.parametrize("dot", [False, True])
def test_bf16_plain_dedup_attention_rounds_once(dot):
    """On bf16 tables the plain K7 returns bf16 ``out`` and float32
    ``lse``, and K8 returns bf16 gradients: each exactly the float32 plain
    version on the same values (the backward on the bf16 run's out, lse
    and float32 delta) rounded once; at rate 0.3, additive (8, 8) and dot
    (2, 16, 16)."""
    _, _, att = _layouts(5)
    lay = att.layout
    rng = np.random.default_rng(0)
    H, dsh, dvh = (2, 16, 16) if dot else (8, 1, 8)
    t = [torch.tensor(_bf16(rng.normal(size=(N, w))))
         for w in (H * dsh, H * dsh, H * dvh, H * dvh)]
    b = [x.to(BF) for x in t]
    if dot:
        args = (dsh, dvh, 0.0, 0.3, 77)
        fwd, bwd = da.dedup_dot_reference, da.dedup_dot_bwd_reference
    else:
        args = (0.2, dvh, 0.3, 77)
        fwd, bwd = da.dedup_attention_reference, da.dedup_bwd_reference
    out, lse = fwd(*b[:3], lay, *args)
    out32, lse32 = fwd(*t[:3], lay, *args)
    assert out.dtype == BF and lse.dtype == torch.float32
    assert torch.equal(lse, lse32) and torch.equal(out, out32.to(BF))
    delta = ak._delta(b[3], out, H, dvh)
    assert delta.dtype == torch.float32
    for x, y in zip(bwd(*b, lse, delta, lay, *args),
                    bwd(*t, lse, delta, lay, *args)):
        assert x.dtype == BF and torch.equal(x, y.to(BF))


# -- GAT and UniMP under utils.amp on the count-matrix route -----------------

@pytest.mark.parametrize("name", ["GAT", "UniMP"])
def test_amp_training_on_the_dedup_route(monkeypatch, name):
    """GAT (the additive K7/K8) and UniMP (the dot K7/K8 in its attention
    layers; labels fed through a mask, training, dropout 0) under
    ``utils.amp`` on a graph with dedup layouts, from the reference's flax
    parameters: the losses follow the reference's amp training for 10
    steps at rtol 2e-2 (``tests/test_torch_amp_attention.py``'s
    ``_amp_both``), fall, and the masters stay float32; the port runs the
    bf16 plain versions of K7 and K8."""
    monkeypatch.setattr(dispatch, "DEDUP", True)
    monkeypatch.setattr(dispatch, "DEDUP_MIN_EDGES", 0)
    plain = "dedup_dot_reference" if name == "UniMP" \
        else "dedup_attention_reference"
    calls = []
    real = getattr(da, plain)

    def counted(*args, **kw):
        calls.append(args[2].dtype)
        return real(*args, **kw)

    monkeypatch.setattr(da, plain, counted)
    make, jcls, tcls, extra, kw = _models()[name]
    model = make(lambda *a, **k: tcls(*a, device="cpu", **k))
    want, got, model = _amp_both(make(jcls), model, extra, kw)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0], got
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert calls and set(calls) == {BF}
