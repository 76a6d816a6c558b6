"""Port parity for bf16: K1's bf16 contract on the CPU and
``pgl_tpu_torch/utils/amp.py`` against ``pgl_tpu/utils/amp.py``.

K1's plain version on a bf16 table (the CUDA kernel's contract) sums in
float32 and rounds each row once; the reference's Pallas K1 (interpret
mode, its test tile sizes) rounds its running sum to bf16 once an edge
tile. The two agree to two bf16 ulps of ``max(1, |sum|)`` (``sum`` the
float64 sum of the same bf16 terms; an ulp of v is ``2^(floor(log2 v) -
7)``, so two are 2^-7 to 2^-6 of it) on every row whose edges lie in one
tile. On a row over several tiles the reference rounds its partial sums,
whose size the terms' 2-norm gives, so there the ulps are of ``max(1,
|sum|, ||terms||_2)``: at ``|sum|`` alone a hub row of 350 edges summing
to about 3 differs by 0.0625, the reference's rounding of a partial sum
near 19, and a hub of 1,000 edges (four tiles, seven roundings) is off by
1.7 ulps of its sum. The port's error against ``sum`` is no larger than the
reference's. The reference's two amp trainings run on the port from the
carried parameters: the losses follow the reference's step for step to
2e-2 relative over the first 10 steps (bf16 activations, sums rounded at
other places), the end criteria are the reference's, and the masters stay
float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")
import optax

from pgl_tpu import Graph as JGraph
from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.models import GCN as JGCN
from pgl_tpu.ops.pallas import segment_kernels as jsk
from pgl_tpu.utils import amp as jamp
from pgl_tpu_torch import Graph
from pgl_tpu_torch.models import GCN
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.ops.kernels import segment_kernels as tsk
from pgl_tpu_torch.utils import amp
from pgl_tpu_torch.utils.convert import flax_to_state_dict
from pgl_tpu_torch.utils.edge_index import EdgeIndex

torch.set_num_threads(1)

NB, ET = 128, 256    # the interpret-mode tile sizes of test_pallas_kernels


def _two_ulps(scale):
    """Two bf16 ulps of ``scale`` (>= 1): ``2 · 2^(floor(log2 v) - 7)``."""
    return 2.0 ** (np.floor(np.log2(scale)) - 6)


def _scale(x64, layout, indptr):
    """``(sum, scale)`` per element: ``max(1, |sum|)``, and on a row whose
    edges span more than one of the reference's ET-edge tiles also the
    terms' 2-norm."""
    exact = tsk.spmm_reference(x64, layout).numpy()
    terms = tsk.spmm_reference(x64 * x64, layout).sqrt().numpy()
    start, end = np.asarray(indptr[:-1]), np.asarray(indptr[1:])
    tiles = np.where(end > start, (end - 1) // ET - start // ET + 1, 0)
    scale = np.maximum(1.0, np.abs(exact))
    return exact, np.where((tiles > 1)[:, None],
                           np.maximum(scale, terms), scale)


def _graph(N, E, D, seed, hub):
    """Edges (a hub destination of half of them with ``hub``), a bf16
    feature table and its CSC/CSR indexes."""
    rng = np.random.default_rng(seed)
    dst = (np.concatenate([np.zeros(E // 2, np.int64),
                           rng.integers(N // 2, N, E - E // 2)])
           if hub else rng.integers(0, N, E))
    src = rng.integers(0, N, E)
    x = rng.normal(size=(N, D)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return (EdgeIndex.from_edges(dst, src, N),
            EdgeIndex.from_edges(src, dst, N), x)


@pytest.mark.parametrize("N,E,D,hub", [
    (300, 77, 16, False),      # fewer edges than a tile
    (100, 200, 128, False),
    (64, 700, 16, True),       # a hub of 350 edges: two tiles
    (64, 2000, 128, True),     # a hub of 1000 edges: four tiles
])
def test_bf16_spmm_matches_pallas(N, E, D, hub):
    csc, csr, x = _graph(N, E, D, seed=N + E, hub=hub)
    jlays = [jsk.build_blocked_layout(i.indptr, i.sorted_v, N, NB, ET)
             for i in (csc, csr)]
    want = np.asarray(jsk.spmm(jnp.asarray(x, jnp.bfloat16), *jlays, NB, ET,
                               True).astype(jnp.float32))
    lays = [tsk.build_spmm_layout(i.indptr, i.sorted_v, N, kind=k,
                                  device="cpu")
            for k, i in (("csc", csc), ("csr", csr))]
    xb = torch.tensor(x).to(torch.bfloat16)
    got = tsk.spmm(xb, *lays)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    exact, scale = _scale(torch.as_tensor(x, dtype=torch.float64), lays[0],
                          csc.indptr)
    assert (np.abs(got - want) <= _two_ulps(scale)).all()
    err_port = np.abs(got - exact)
    err_ref = np.abs(want - exact)
    assert err_port.max() <= err_ref.max()
    assert err_port.mean() <= err_ref.mean()
    # the row is rounded once: the float32 sum's nearest bf16
    f32 = tsk.spmm_reference(torch.as_tensor(x), lays[0])
    assert torch.equal(torch.as_tensor(got), f32.to(torch.bfloat16).float())


def test_bf16_spmm_gradient_matches_pallas():
    """The backward (K1 over CSR) of a bf16 SpMM: bf16 cotangent in, bf16
    gradient out, within the same two ulps of the reference's."""
    N, E, D = 64, 700, 16
    csc, csr, x = _graph(N, E, D, seed=3, hub=True)
    w = np.asarray(jnp.asarray(np.random.default_rng(4).normal(
        size=(N, D)), jnp.bfloat16).astype(jnp.float32))
    jlays = [jsk.build_blocked_layout(i.indptr, i.sorted_v, N, NB, ET)
             for i in (csc, csr)]
    wb = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jax.grad(lambda f: (jsk.spmm(f, *jlays, NB, ET, True)
                                          * wb).astype(jnp.float32).sum())(
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    lays = [tsk.build_spmm_layout(i.indptr, i.sorted_v, N, kind=k,
                                  device="cpu")
            for k, i in (("csc", csc), ("csr", csr))]
    xb = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    (tsk.spmm(xb, *lays) * torch.as_tensor(w).to(torch.bfloat16)).float(
    ).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    exact, scale = _scale(torch.as_tensor(w, dtype=torch.float64), lays[1],
                          csr.indptr)
    got = xb.grad.float().numpy()
    assert (np.abs(got - want) <= _two_ulps(scale)).all()
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


def test_casts_and_state_dicts():
    """``to_bf16``/``to_f32`` on tensors, nested containers and a state
    dict: floating leaves cast, integers and bools and non-tensors kept,
    the container types kept."""
    model = GCN(4, 2, dropout=0.0, device="cpu")
    tree = {"w": torch.ones(2), "ids": torch.arange(3), "ok": torch.ones(
        1, dtype=torch.bool), "list": [torch.zeros(2, dtype=torch.float64),
                                       3], "sd": model.state_dict()}
    half = amp.to_bf16(tree)
    assert half["w"].dtype == torch.bfloat16
    assert half["ids"].dtype == torch.int64 and half["ok"].dtype == torch.bool
    assert half["list"][0].dtype == torch.bfloat16 and half["list"][1] == 3
    assert type(half["sd"]) is type(model.state_dict())
    assert all(v.dtype == torch.bfloat16 for v in half["sd"].values())
    back = amp.to_f32(half)
    assert back["w"].dtype == torch.float32 and back["ids"].dtype == \
        torch.int64
    assert amp.to_bf16(torch.ones(2)).dtype == torch.bfloat16


def _train_both(jg, labels, model_kw, cast_x, steps=60, lr=1e-2):
    """The reference's amp recipe (``bf16_params_policy`` over
    ``value_and_grad``, optax Adam) and the port's (``bf16_params_policy``
    over ``functional_call``, torch Adam) from the same parameters: both
    loss trajectories and the port's model and masters."""
    gt = jg.tensor()
    xj = gt.node_feat["h"]
    yj = jnp.asarray(labels)
    jmodel = JGCN(dropout=0.0, **model_kw)
    params = jmodel.init(jax.random.key(0), gt, xj)
    opt = optax.adam(lr)
    ost = opt.init(params)

    def loss_fn(p):
        x = jamp.to_bf16(xj) if cast_x else xj
        logits = jmodel.apply(p, gt, x).astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yj).mean()

    grad_fn = jamp.bf16_params_policy(jax.value_and_grad(loss_fn))

    @jax.jit
    def step(params, ost):
        loss, grads = grad_fn(params)
        updates, ost = opt.update(grads, ost)
        return optax.apply_updates(params, updates), ost, loss

    want = []
    for _ in range(steps):
        params, ost, loss = step(params, ost)
        want.append(float(loss))

    g = Graph(np.asarray(jg.edges), num_nodes=jg.num_nodes,
              node_feat={"h": np.asarray(jg.node_feat["h"])}).tensor("cpu")
    model = GCN(dropout=0.0, device="cpu", **model_kw)
    model.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), gt, xj)),
        "cpu"))
    masters = dict(model.named_parameters())
    topt = torch.optim.Adam(model.parameters(), lr=lr)
    x = g.node_feat["h"]
    y = torch.as_tensor(np.asarray(labels))

    def tloss(p):
        logits = torch.func.functional_call(
            model, p, (g, amp.to_bf16(x) if cast_x else x))
        return ce(logits.float(), y).mean()

    policy = amp.bf16_params_policy(tloss)
    got = []
    for _ in range(steps):
        topt.zero_grad(set_to_none=True)
        loss, grads = policy(masters)
        assert all(v.dtype == torch.float32 for v in grads.values())
        topt.step()
        got.append(float(loss))
    return np.asarray(want), np.asarray(got), model, g, x, y


def test_amp_bf16_training_converges():
    """``tests/test_utils.py:107-143`` on the port."""
    jg, y = j_community_graph(num_nodes=200, num_classes=3, feat_dim=16,
                              avg_degree=6, seed=0)
    want, got, model, *_ = _train_both(
        jg, y, dict(input_size=16, num_class=3, hidden_size=16), True)
    np.testing.assert_allclose(got[:10], want[:10], rtol=2e-2)
    assert got[-1] < 0.5 * got[0], (got[0], got[-1])
    assert model.gcn_0.linear.weight.dtype == torch.float32


def test_bf16_mixed_precision_training():
    """``tests/test_utils.py:204-250`` on the port: bf16 params and
    activations in the loss, float32 masters; the loss falls over 3x, the
    masters stay float32, and the float32 model's accuracy passes 0.9."""
    jg, labels = j_community_graph(num_nodes=200, num_classes=2, feat_dim=8,
                                   avg_degree=10, seed=1)
    want, got, model, g, x, y = _train_both(
        jg, np.asarray(labels), dict(input_size=8, num_class=2, num_layers=2,
                                     hidden_size=16), True)
    np.testing.assert_allclose(got[:10], want[:10], rtol=2e-2)
    assert got[0] / got[-1] > 3, (got[0], got[-1])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        acc = float((model(g, x).argmax(-1) == y).float().mean())
    assert acc > 0.9, acc
