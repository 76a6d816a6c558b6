"""Port parity for mixed precision on the dedup SpMM: the bf16 plain
versions of K5, K6 and the weighted K6 (``pgl_tpu_torch/ops/kernels/
dedup_kernels.py``) against ``pgl_tpu``'s Pallas kernels in interpret mode
on the same bf16 inputs, forward and gradients; K11, which neither package
runs on bf16; the GCN and FAGCN trained under ``utils.amp`` on the dedup
route against the reference's amp training; and a bf16 GCN and GAT on a
graph with dedup layouts exported.

The port's bf16 contract (the CUDA kernels', which these plain versions
compute): tables loaded as bf16 and widened to float32, every product and
sum in float32, and each output rounded once to bf16. The reference rounds
more often: it adds each (block, window) pair's product into its bf16
output block (``pgl_tpu/ops/pallas/dedup_kernels.py:548-551``,
``:648-650``), so it rounds once a pair. So each output is held against
float64 of the same bf16 values, and the port's error must be no larger
than the reference's: its mean and its root mean square over the elements
no larger, and its largest no larger than the reference's largest plus half
a bf16 ulp of the largest value (2^-8 of it), the one rounding both make
last (``tests/test_torch_amp_attention.py``'s rule, ``_no_worse``). The
contract itself is held exactly: each bf16 output is the float32
computation on the same values rounded once. The graph has a hub
destination whose block spans three windows, a hub source, empty rows and
shuffled edges (``tests/test_torch_amp_attention.py:_edges``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

from chip_smoke import dispatch_settings  # noqa: E402
from pgl_tpu.models import FAGCN as JFAGCN  # noqa: E402
from pgl_tpu.models import GCN as JGCN  # noqa: E402
from pgl_tpu.ops.pallas import dedup_kernels as jdk  # noqa: E402
from pgl_tpu.ops.pallas import sddmm_kernels as jsdk  # noqa: E402
from pgl_tpu_torch import Graph  # noqa: E402
from pgl_tpu_torch.models import FAGCN, GAT, GCN  # noqa: E402
from pgl_tpu_torch.ops import dispatch  # noqa: E402
from pgl_tpu_torch.ops.kernels import dedup_kernels as tdk  # noqa: E402
from pgl_tpu_torch.ops.kernels import sddmm_kernels as tsdk  # noqa: E402
from pgl_tpu_torch.ops.kernels import segment_kernels as tsk  # noqa: E402
from pgl_tpu_torch.utils.edge_index import EdgeIndex  # noqa: E402
from pgl_tpu_torch.utils.export import (Predictor, export_model,  # noqa
                                        op_calls)
from test_torch_amp_attention import (BF, N, _amp_both, _bf16,  # noqa: E402
                                      _edges, _exact_run, _f32_run,
                                      _no_worse, _port_run)

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

D = 16


def _dedup_case(seed):
    """Both packages' dedup layouts of ``_edges(seed)`` (no gates; the
    port's with edge ids), the port's K1 CSR layout and the two indexes."""
    edges = _edges(seed)
    idxs = (EdgeIndex.from_edges(edges[:, 1], edges[:, 0], N),
            EdgeIndex.from_edges(edges[:, 0], edges[:, 1], N))
    jlays = tuple(jdk.build_dedup_layout(i.indptr, i.sorted_v, N)
                  for i in idxs)
    tlays = tuple(tdk.build_dedup_layout(i.indptr, i.sorted_v, N, kind=k,
                                         device="cpu", edge_id=i.sorted_eid)
                  for k, i in zip(("csc", "csr"), idxs))
    csr = tsk.build_spmm_layout(idxs[1].indptr, idxs[1].sorted_v, N,
                                kind="csr", device="cpu",
                                edge_id=idxs[1].sorted_eid)
    return jlays, tlays, csr, idxs


def _held(names, got, ref, exact, f32):
    """Each bf16 output no worse than the reference's (``_no_worse``) and
    equal to the float32 computation rounded once."""
    for name, p, r, e, f in zip(names, [got[0]] + got[1],
                                ref, [exact[0]] + exact[1],
                                [f32[0]] + f32[1]):
        _no_worse(name, p, r, e)
        assert np.array_equal(p, _bf16(f)), name


@pytest.mark.parametrize("cached", [False, True], ids=["K6", "K5"])
def test_bf16_dedup_spmm_no_worse_than_pallas(cached):
    """K6 (counts rebuilt) and K5 (K4's counts cached) on bf16 tables, the
    forward over the CSC dedup layout and dx over the CSR one: the port's
    bf16 plain version and the reference's ``spmm_dedup`` in interpret
    mode, each against float64 of the same bf16 values (``_held``)."""
    (jcsc, jcsr), (csc, csr), _, _ = _dedup_case(11)
    # a block of several windows (several pairs)
    assert csc.num_pairs > int(csc.pairs[:, 0].max()) + 1
    if cached:
        jcsc, jcsr = (jdk.materialize_counts(lay, interpret=True)
                      for lay in (jcsc, jcsr))
        csc, csr = (tdk.materialize_counts(lay) for lay in (csc, csr))
        assert csc.counts is not None and csr.counts is not None
    rng = np.random.default_rng(3)
    x, cot = (_bf16(rng.normal(size=(N, D))) for _ in range(2))

    def loss(a):
        out = jdk.spmm_dedup(a, jcsc, jcsr, interpret=True)
        return (out.astype(jnp.float32) * cot).sum(), out

    (_, out_j), gx = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x, jnp.bfloat16))
    assert out_j.dtype == jnp.bfloat16 and gx.dtype == jnp.bfloat16
    ref = [np.asarray(t.astype(jnp.float32)) for t in (out_j, gx)]

    def fn(a):
        return tdk.spmm_dedup(a, csc, csr)

    _held(("out", "dx"), _port_run(fn, (x,), cot), ref,
          _exact_run(fn, (x,), cot), _f32_run(fn, (x,), cot))


def test_bf16_weighted_dedup_spmm_no_worse_than_pallas():
    """The weighted K6 on bf16 tables and weights: forward, dx (the
    weighted K6 over CSR) and dw (K1w's pass): the port's bf16 plain
    versions and the reference's ``spmm_dedup_weighted`` in interpret mode
    (its bf16 weights in each layout's dedup order, zero-padded as
    ``pgl_tpu/graph.py:389-399`` pads them), each against float64 of the
    same bf16 values (``_held``)."""
    (jcsc, jcsr), (csc, csr), csr_k1, idxs = _dedup_case(12)
    E = csc.num_edges
    rng = np.random.default_rng(4)
    x, cot = (_bf16(rng.normal(size=(N, D))) for _ in range(2))
    w = _bf16(rng.normal(size=E))

    def in_dedup_order(jlay, idx):
        out = np.zeros(jlay.padded_v.shape[0], np.float32)
        out[:E] = w[idx.sorted_eid][np.asarray(jlay.eid)]
        return jnp.asarray(out, jnp.bfloat16)

    w_csc, w_csr = (in_dedup_order(lay, i) for lay, i in zip((jcsc, jcsr),
                                                            idxs))

    def loss(a, wc):
        out = jdk.spmm_dedup_weighted(a, wc, w_csr, jcsc, jcsr,
                                      interpret=True)
        return (out.astype(jnp.float32) * cot).sum(), out

    (_, out_j), (gx, gw_d) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(x, jnp.bfloat16), w_csc)
    assert out_j.dtype == jnp.bfloat16 and gw_d.dtype == jnp.bfloat16
    gw = np.zeros(E, np.float32)
    gw[idxs[0].sorted_eid[np.asarray(jcsc.eid)]] = np.asarray(
        gw_d.astype(jnp.float32))[:E]
    ref = [np.asarray(t.astype(jnp.float32)) for t in (out_j, gx)] + [gw]

    def fn(a, b):
        return tdk.spmm_dedup_weighted(a, b, csc, csr, csr_k1)

    _held(("out", "dx", "dw"), _port_run(fn, (x, w), cot), ref,
          _exact_run(fn, (x, w), cot), _f32_run(fn, (x, w), cot))


def test_k11_takes_float32_only():
    """K11 has no bf16 form in either package: the reference's
    ``sddmm_dedup`` on bf16 raises ``TypeError`` in interpret mode (its
    kernel copies the rows into float32 scratch,
    ``pgl_tpu/ops/pallas/sddmm_kernels.py:397-398``), and the port's
    ``sddmm_dedup`` raises ``TypeError`` on bf16, as ``use_sddmm_kernel``
    does on the card; float32 runs in both."""
    edges = _edges(13)
    idx = EdgeIndex.from_edges(edges[:, 1], edges[:, 0], N)
    jlay = jsdk.build_sddmm_layout(idx.indptr, idx.sorted_v, N, et=128)
    tlay = tsdk.build_sddmm_layout(idx.indptr, idx.sorted_v, N,
                                   device="cpu")
    x = _bf16(np.random.default_rng(5).normal(size=(N, 8)))
    xj = jnp.asarray(x, jnp.bfloat16)
    with pytest.raises(TypeError):
        jsdk.sddmm_dedup(xj, xj, jlay, "mul", interpret=True)
    xt = torch.as_tensor(x).to(BF)
    with pytest.raises(TypeError):
        tsdk.sddmm_dedup(xt, xt, tlay, "mul")
    got = tsdk.sddmm_dedup(xt.float(), xt.float(), tlay, "mul")
    want = jsdk.sddmm_dedup(xj.astype(jnp.float32), xj.astype(jnp.float32),
                            jlay, "mul", interpret=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32


# -- the GCN and FAGCN under utils.amp on the dedup route ---------------------

@pytest.fixture
def dedup_route(monkeypatch):
    """``DEDUP`` on, with the band opened so that the small graph takes the
    dedup route (``tests/test_torch_dedup_kernels.py``'s ``dedup_small``),
    and a count of the dedup apply's plain-version calls."""
    monkeypatch.setattr(dispatch, "DEDUP", True)
    monkeypatch.setattr(dispatch, "DEDUP_MIN_EDGES", 0)
    calls = []
    real = tdk._apply_plain

    def counted(*args, **kw):
        calls.append(kw.get("w", args[2] if len(args) > 2 else None)
                     is not None)
        return real(*args, **kw)

    monkeypatch.setattr(tdk, "_apply_plain", counted)
    return calls


@pytest.mark.parametrize("name", ["GCN", "FAGCN"])
def test_amp_training_on_the_dedup_route(dedup_route, name):
    """The GCN (K5: the small graph's counts are cached) and FAGCN (the
    weighted K6, dw by K1w's pass), dropout 0, under ``utils.amp`` on the
    dedup route, from the reference's flax parameters: the losses follow
    the reference's amp training for 10 steps at rtol 2e-2
    (``tests/test_torch_amp_attention.py``'s ``_amp_both``), fall, and the
    masters stay float32. On the CPU the port runs the bf16 plain versions
    of K5 and the weighted K6; the reference its own route in bf16."""
    if name == "GCN":
        kw = dict(num_layers=3, hidden_size=24, dropout=0.0)
        jmodel, model = JGCN(16, 3, **kw), GCN(16, 3, device="cpu", **kw)
    else:
        kw = dict(hidden_size=16, num_layer=3, eps=0.2, dropout=0.0)
        jmodel, model = JFAGCN(16, 3, **kw), FAGCN(16, 3, device="cpu", **kw)
    want, got, model = _amp_both(jmodel, model)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0], got
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # K5 for the GCN's sums, the weighted K6 for FAGCN's
    assert dedup_route and any(dedup_route) == (name == "FAGCN")


def test_bf16_dedup_models_export(tmp_path):
    """A bf16 GCN (K5) and GAT (K7) on a graph with dedup layouts exported
    by ``utils.export``: the program calls the dedup ops, and the served
    logits are bf16 and equal the eager model's bit for bit."""
    rng = np.random.default_rng(6)
    with dispatch_settings(DEDUP=True, DEDUP_MIN_EDGES=0):
        g = Graph(_edges(14), num_nodes=N).tensor("cpu")
    assert g._dedup_layouts is not None
    x = torch.as_tensor(_bf16(rng.normal(size=(N, 16)))).to(BF)
    cases = ((GCN(16, 3, device="cpu"), {"spmm_dedup": 2}),
             (GAT(16, 3, num_heads=8, hidden_size=8, device="cpu"),
              {"dedup_gat_attention": 2}))
    for i, (model, ops) in enumerate(cases):
        model = model.to(BF).eval()
        path = str(tmp_path / f"model{i}.pt2")
        program = export_model(lambda x: model(g, x), [x], path)
        assert op_calls(program) == ops
        with torch.no_grad():
            eager = model(g, x)
        out = Predictor(path).run(x)
        assert eager.dtype == BF and out.dtype == BF
        assert torch.equal(out, eager)
