"""Port parity for mixed precision on the attention path: the bf16 plain
versions of K9, K10-dq and K10-dkv (additive and dot) and of K1w against
``pgl_tpu``'s Pallas kernels in interpret mode on the same bf16 inputs, and
GAT, UniMP, FAGCN and GATv2 trained under ``utils.amp`` against the
reference's amp training.

The port's bf16 contract (the CUDA kernels', which these plain versions
compute): tables loaded as bf16 and widened to float32, every score, exp,
sum and product in float32, ``lse`` and ``delta`` float32, and each output
rounded once to bf16. The reference rounds more often: K9 rounds p to bf16
before p·v, its CSR pass rounds ``lse`` and ``delta`` to bf16, its
``delta`` is a bf16 product, and K1w forms each message ``x·w`` in bf16
and rounds its running sum once an edge tile. So each kernel's output is
held against float64 of the same bf16 values, and the port's error must be
no larger than the reference's: its mean and its root mean square over the
elements no larger, and its largest no larger than the reference's largest
plus half a bf16 ulp of the largest value (2^-8 of it), the one rounding
both make last, whose direction at the worst element is either's luck.
The contract itself is held exactly: each bf16 output is the float32
computation on the same values rounded once. The graph has a hub
destination split over several pieces, a hub source, empty rows and
shuffled edges (``tests/test_torch_attention_kernels.py:_edges``).
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
from pgl_tpu.models import FAGCN as JFAGCN
from pgl_tpu.models import GAT as JGAT
from pgl_tpu.models import GATv2 as JGATv2
from pgl_tpu.models import UniMP as JUniMP
from pgl_tpu.ops import softmax_cross_entropy_integer as j_ce
from pgl_tpu.ops.pallas import segment_kernels as jsk
from pgl_tpu.ops.pallas.attention_kernels import (
    fused_gat_attention as j_gat, fused_graph_attention as j_dot)
from pgl_tpu.ops.pallas.segment_kernels import build_blocked_layout
from pgl_tpu.utils import amp as jamp
from pgl_tpu_torch import Graph
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import FAGCN, GAT, GATv2, UniMP
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.ops.kernels import attention_kernels as ak
from pgl_tpu_torch.ops.kernels import segment_kernels as tsk
from pgl_tpu_torch.utils import amp
from pgl_tpu_torch.utils.convert import flax_to_state_dict
from pgl_tpu_torch.utils.edge_index import EdgeIndex

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

N = 300
NB, ET = 128, 256    # the interpret-mode tile sizes of test_pallas_kernels
BF = torch.bfloat16


def _edges(seed, E=3000):
    """A hub destination (node 0, 700 edges: split over pieces of
    ``ak.ET`` and over the reference's ET-edge tiles), a hub source (node
    5, 600 out-edges), empty rows 1..149, and the edges in shuffled order
    (so CSC and CSR positions differ from edge ids)."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(700, np.int64),
                          rng.integers(N // 2, N, E - 700)])
    src = rng.integers(0, N, E)
    src[rng.choice(E, 600, replace=False)] = 5
    return np.stack([src, dst], axis=1)[rng.permutation(E)]


def _bf16(x):
    """float32 numpy rounded to bf16 values (still float32)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _layouts(seed):
    """The port's CPU graph and the reference's layouts (``nb=128``,
    ``et=256``, and ``perm``) of one graph."""
    edges = _edges(seed)
    port = Graph(edges, num_nodes=N).tensor("cpu")
    gj = JGraph(edges, num_nodes=N)
    di, si = gj.adj_dst_index, gj.adj_src_index
    ref = (build_blocked_layout(np.asarray(di.indptr),
                                np.asarray(di.sorted_v), N, NB, ET),
           build_blocked_layout(np.asarray(si.indptr),
                                np.asarray(si.sorted_v), N, NB, ET),
           gj.tensor()._spmm_layouts[2])
    return port, ref


def _errors(port, ref, exact):
    """(|port - exact|, |ref - exact|) as float64 numpy."""
    exact = np.asarray(exact, np.float64)
    return (np.abs(np.asarray(port, np.float64) - exact),
            np.abs(np.asarray(ref, np.float64) - exact))


def _no_worse(name, port, ref, exact):
    """The port's error against ``exact`` no larger than the reference's:
    mean and root mean square, and the largest up to half a bf16 ulp of
    the largest |exact| (the module's note)."""
    e_port, e_ref = _errors(port, ref, exact)
    assert e_port.mean() <= e_ref.mean(), (name, e_port.mean(),
                                           e_ref.mean())
    assert (e_port ** 2).mean() <= (e_ref ** 2).mean(), name
    assert e_port.max() <= e_ref.max() + 2.0 ** -8 * np.abs(exact).max(), (
        name, e_port.max(), e_ref.max())


def _pad_lanes(v, width):
    """``v`` (bf16 values) zero-padded to ``width`` lanes, as bf16."""
    out = np.zeros((v.shape[0], width), np.float32)
    out[:, :v.shape[1]] = v
    return jnp.asarray(out, jnp.bfloat16)


def _port_run(fn, tables, cot):
    """``fn`` on bf16 CPU tensors of ``tables`` and its gradients of
    ``sum(out · cot)``: (out, grads) as float32 numpy, the out and every
    gradient checked to be bf16."""
    t = [torch.tensor(x).to(BF).requires_grad_() for x in tables]
    out = fn(*t)
    assert out.dtype == BF
    (out.float() * torch.as_tensor(cot)).sum().backward()
    assert all(x.grad.dtype == BF for x in t)
    return out.detach().float().numpy(), [x.grad.float().numpy() for x in t]


def _f32_run(fn, tables, cot):
    """``fn`` in float32 on the same values and its gradients of ``sum(out
    · cot)``, as float32 numpy."""
    t = [torch.tensor(x, requires_grad=True) for x in tables]
    out = fn(*t)
    (out * torch.as_tensor(cot)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in t]


def _exact_run(fn, tables, cot):
    """``fn`` in float64 on the same values and its gradients (the plain
    backward, itself autograd of the plain forward at 1e-10:
    tests/test_torch_attention_kernels.py)."""
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
         for x in tables]
    out = fn(*t)
    (out * torch.as_tensor(cot, dtype=torch.float64)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in t]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("H,dvh", [(8, 8), (1, 16)])
def test_bf16_additive_attention_no_worse_than_pallas(H, dvh, rate):
    """K9 (out) and K10 (d a_dst, d a_src, dv) on bf16 tables: the port's
    bf16 plain versions and the reference's ``fused_gat_attention`` in
    interpret mode (its flash backward through ``(csr, perm)``), each
    against float64 of the same bf16 values: the port's error is no
    larger (``_no_worse``)."""
    port, (csc, csr, perm) = _layouts(7)
    rng = np.random.default_rng(H * 100 + dvh)
    a_dst, a_src = (_bf16(rng.normal(size=(N, H))) for _ in range(2))
    v = _bf16(rng.normal(size=(N, H * dvh)))
    cot = _bf16(rng.normal(size=(N, H * dvh)))
    seed = 12345 if rate else None
    lays = port._attention_layouts()

    def loss_j(a, b, c):
        out = j_gat(a, b, c, csc, (csr, perm), 0.2, NB, ET, True, dvh, rate,
                    None if seed is None else jnp.int32(seed))
        return (out[:, :H * dvh].astype(jnp.float32) * cot).sum(), out

    tables_j = (jnp.asarray(a_dst, jnp.bfloat16),
                jnp.asarray(a_src, jnp.bfloat16), _pad_lanes(v, 128))
    (_, out_j), grads_j = jax.value_and_grad(loss_j, (0, 1, 2),
                                             has_aux=True)(*tables_j)
    assert out_j.dtype == jnp.bfloat16
    ref = [np.asarray(out_j[:, :H * dvh].astype(jnp.float32))] + [
        np.asarray(gr.astype(jnp.float32))[:, :w]
        for gr, w in zip(grads_j, (H, H, H * dvh))]

    def fn(a, b, c):
        return ak.fused_gat_attention(a, b, c, *lays, 0.2, dvh, rate, seed)

    out, grads = _port_run(fn, (a_dst, a_src, v), cot)
    out64, grads64 = _exact_run(fn, (a_dst, a_src, v), cot)
    for name, p, r, x in zip(("out", "d a_dst", "d a_src", "dv"),
                             [out] + grads, ref, [out64] + grads64):
        _no_worse(name, p, r, x)
    assert (out[1:N // 2] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shape", [(2, 64, 64), (8, 16, 16)])
def test_bf16_dot_attention_no_worse_than_pallas(shape, rate):
    """The dot-mode K9 and K10 (dq, dk, dv) at (H, dsh, dvh) = (2, 64, 64)
    and (8, 16, 16) on bf16 tables: the port's bf16 plain versions and the
    reference's ``fused_graph_attention`` in interpret mode, each against
    float64 of the same bf16 values: the port's error is no larger
    (``_no_worse``)."""
    H, dsh, dvh = shape
    port, (csc, csr, perm) = _layouts(9)
    rng = np.random.default_rng(3)
    q, k = (_bf16(rng.normal(size=(N, H * dsh)) * dsh ** -0.25)
            for _ in range(2))
    v = _bf16(rng.normal(size=(N, H * dvh)))
    cot = _bf16(rng.normal(size=(N, H * dvh)))
    seed = 12345 if rate else None
    lays = port._attention_layouts()

    def loss_j(a, b, c):
        out = j_dot(a, b, c, csc, (csr, perm), H, 0.0, NB, ET, True, dsh,
                    dvh, rate, None if seed is None else jnp.int32(seed))
        return (out.astype(jnp.float32) * cot).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, (0, 1, 2),
                                             has_aux=True)(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    assert out_j.dtype == jnp.bfloat16
    ref = [np.asarray(t.astype(jnp.float32)) for t in (out_j, *grads_j)]

    def fn(a, b, c):
        return ak.fused_graph_attention(a, b, c, *lays, H, 0.0, dsh, dvh,
                                        rate, seed)

    out, grads = _port_run(fn, (q, k, v), cot)
    out64, grads64 = _exact_run(fn, (q, k, v), cot)
    for name, p, r, x in zip(("out", "dq", "dk", "dv"), [out] + grads, ref,
                             [out64] + grads64):
        _no_worse(name, p, r, x)


@pytest.mark.parametrize("dot", [False, True])
def test_bf16_plain_attention_rounds_once(dot):
    """On bf16 tables the plain K9 returns bf16 ``out`` and float32
    ``lse``, ``delta`` is float32, and K10-dq and K10-dkv return bf16: each
    exactly the float32 plain version on the same values (the backward on
    the bf16 run's out, lse and delta) rounded once; at rate 0.3, additive
    (8, 8) and dot (2, 16, 16)."""
    port, _ = _layouts(5)
    csc, csr = port._attention_layouts()
    rng = np.random.default_rng(0)
    H, dsh, dvh = (2, 16, 16) if dot else (8, 1, 8)
    t = [torch.tensor(_bf16(rng.normal(size=(N, w))))
         for w in (H * dsh, H * dsh, H * dvh, H * dvh)]
    b = [x.to(BF) for x in t]
    if dot:
        args = (dsh, dvh, 0.0, 0.3, 77)
        fwd, dq, dkv = (ak.dot_attention_reference, ak.dot_dq_reference,
                        ak.dot_dkv_reference)
    else:
        args = (0.2, dvh, 0.3, 77)
        fwd, dq, dkv = (ak.gat_attention_reference, ak.gat_dq_reference,
                        ak.gat_dkv_reference)
    out, lse = fwd(*b[:3], csc, *args)
    out32, lse32 = fwd(*t[:3], csc, *args)
    assert out.dtype == BF and lse.dtype == torch.float32
    assert torch.equal(lse, lse32) and torch.equal(out, out32.to(BF))
    delta = ak._delta(b[3], out, H, dvh)
    assert delta.dtype == torch.float32
    got = [dq(*b, lse, delta, csc, *args), *dkv(*b, lse, delta, csr, *args)]
    want = [dq(*t, lse, delta, csc, *args), *dkv(*t, lse, delta, csr, *args)]
    for x, y in zip(got, want):
        assert x.dtype == BF and torch.equal(x, y.to(BF))


@pytest.mark.parametrize("msg_op", ["mul", "add"])
@pytest.mark.parametrize("D,H", [(64, 1), (64, 8), (16, 1)])
def test_bf16_k1w_no_worse_than_pallas(msg_op, D, H):
    """K1w's forward, dx and dw on bf16 tables (FAGCN's (64, 1), GATv2's
    (64, 8) and (16, 1)): the port's bf16 plain versions (float32
    messages and sums, each output rounded once) and the reference's
    ``spmm_weighted`` in interpret mode (bf16 messages, a rounding an edge
    tile), each against float64 of the same bf16 values: the port's error
    is no larger (``_no_worse``); and each bf16 output equals the float32
    plain version on the same values rounded once, exactly."""
    E = 3000
    rng = np.random.default_rng(D + H)
    dst = rng.integers(0, N - N // 8, E)
    src = rng.integers(0, N, E)
    dst[:E // 3] = 3
    src[E // 3:E // 2] = 9
    perm = rng.permutation(E)
    src, dst = src[perm], dst[perm]
    csc_i, csr_i = (EdgeIndex.from_edges(a, b, N)
                    for a, b in ((dst, src), (src, dst)))
    lays = tuple(tsk.build_spmm_layout(i.indptr, i.sorted_v, N, kind=k,
                                       device="cpu", edge_id=i.sorted_eid)
                 for k, i in (("csc", csc_i), ("csr", csr_i)))
    jcsc, jcsr = (jsk.build_blocked_layout(i.indptr, i.sorted_v, N, NB, ET)
                  for i in (csc_i, csr_i))
    x = _bf16(rng.normal(size=(N, D)))
    w = _bf16(rng.normal(size=(E, H)))
    cot = _bf16(rng.normal(size=(N, D)))

    def padded(lay, idx):
        out = np.zeros((len(np.asarray(lay.padded_v)), H), np.float32)
        out[:E] = w[idx.sorted_eid]
        return jnp.asarray(out, jnp.bfloat16)

    w_csr = padded(jcsr, csr_i)

    def loss(a, wc):
        out = jsk.spmm_weighted(a, wc, w_csr, jcsc, jcsr, NB, ET, True,
                                msg_op)
        return (out.astype(jnp.float32) * cot).sum(), out

    (_, out_j), (gx, gw_csc) = jax.value_and_grad(loss, (0, 1),
                                                  has_aux=True)(
        jnp.asarray(x, jnp.bfloat16), padded(jcsc, csc_i))
    assert out_j.dtype == jnp.bfloat16
    gw = np.zeros((E, H), np.float32)
    gw[csc_i.sorted_eid] = np.asarray(gw_csc.astype(jnp.float32))[:E]
    ref = [np.asarray(out_j.astype(jnp.float32)),
           np.asarray(gx.astype(jnp.float32)), gw]

    def fn(a, b):
        return tsk.spmm_weighted(a, b, *lays, msg_op)

    got = _port_run(fn, (x, w), cot)
    exact = _exact_run(fn, (x, w), cot)
    f32 = _f32_run(fn, (x, w), cot)
    for name, p, r, e, f in zip(("out", "dx", "dw"), [got[0]] + got[1], ref,
                                [exact[0]] + exact[1], [f32[0]] + f32[1]):
        _no_worse(name, p, r, e)
        assert np.array_equal(p, np.asarray(jnp.asarray(f, jnp.bfloat16)
                                            .astype(jnp.float32))), name


# -- the four models under utils.amp ------------------------------------------

def _graphs():
    g, labels = j_community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    tg, _ = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                            avg_degree=8, seed=5)
    return g.tensor(), np.asarray(labels), tg.tensor("cpu")


def _amp_both(jmodel, model, extra=(), kw=None, steps=10, lr=1e-2):
    """The reference's amp recipe (``bf16_params_policy`` over
    ``value_and_grad``, optax Adam, under ``jax.jit``) and the port's
    (``bf16_params_policy`` over ``functional_call``, torch Adam) from the
    same flax parameters carried by ``utils.convert``, bf16 features and
    ``extra`` arguments (numpy) after them: both loss trajectories and the
    port's model."""
    kw = kw or {}
    gj, labels, gt = _graphs()
    xj = gj.node_feat["h"]
    jextra = tuple(jnp.asarray(a) for a in extra)
    params = jax.jit(lambda key: jmodel.init(key, gj, xj, *jextra, **kw))(
        jax.random.key(0))
    opt = optax.adam(lr)
    yj = jnp.asarray(labels)

    def loss_fn(p):
        logits = jmodel.apply(p, gj, jamp.to_bf16(xj), *jextra, **kw)
        return j_ce(logits.astype(jnp.float32), yj).mean()

    grad_fn = jamp.bf16_params_policy(jax.value_and_grad(loss_fn))

    @jax.jit
    def step(params, ost):
        loss, grads = grad_fn(params)
        updates, ost = opt.update(grads, ost)
        return optax.apply_updates(params, updates), ost, loss

    want, p, ost = [], params, opt.init(params)
    for _ in range(steps):
        p, ost, loss = step(p, ost)
        want.append(float(loss))

    model.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params), "cpu"), strict=True)
    masters = dict(model.named_parameters())
    topt = torch.optim.Adam(model.parameters(), lr=lr)
    x = amp.to_bf16(gt.node_feat["h"])
    textra = tuple(torch.as_tensor(a) for a in extra)
    y = torch.as_tensor(labels).long()
    policy = amp.bf16_params_policy(lambda q: ce(
        torch.func.functional_call(model, q, (gt, x, *textra), kw).float(),
        y).mean())
    got = []
    for _ in range(steps):
        topt.zero_grad(set_to_none=True)
        loss, grads = policy(masters)
        assert all(v.dtype == torch.float32 for v in grads.values())
        topt.step()
        got.append(float(loss))
    return np.asarray(want), np.asarray(got), model


def _models():
    rng = np.random.default_rng(2)
    label, mask = rng.integers(0, 3, 300), rng.random(300) < 0.5
    return {
        "GAT": (lambda m: m(16, 3, num_heads=8, hidden_size=8, feat_drop=0.0,
                            attn_drop=0.0), JGAT, GAT, (), {}),
        "GATv2": (lambda m: m(16, 3, num_heads=8, hidden_size=8,
                              feat_drop=0.0, attn_drop=0.0), JGATv2, GATv2,
                  (), {}),
        "FAGCN": (lambda m: m(16, 3, hidden_size=16, num_layer=3, eps=0.2,
                              dropout=0.0), JFAGCN, FAGCN, (), {}),
        "UniMP": (lambda m: m(16, 3, num_layers=3, hidden_size=8,
                              num_heads=2, dropout=0.0), JUniMP, UniMP,
                  (label, mask), {"training": True})}


@pytest.mark.parametrize("name", ["GAT", "GATv2", "FAGCN", "UniMP"])
def test_amp_training_follows_the_reference(name):
    """GAT, GATv2 and FAGCN (training, dropout 0) and UniMP (labels fed
    through a mask, training, dropout 0) under ``utils.amp``, from the
    reference's flax parameters: the losses follow the reference's amp
    training for 10 steps at rtol 2e-2 (bf16 activations rounded at other
    places, ``tests/test_torch_amp.py``'s tolerance), fall, and the
    masters stay float32. On the CPU the port runs the bf16 plain versions
    of K9/K10 (GAT, UniMP) and K1w (FAGCN, GATv2); the reference its
    unfused edge-space path in bf16."""
    make, jcls, tcls, extra, kw = _models()[name]
    model = make(lambda *a, **k: tcls(*a, device="cpu", **k))
    want, got, model = _amp_both(make(jcls), model, extra, kw)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0], got
    assert all(p.dtype == torch.float32 for p in model.parameters())
