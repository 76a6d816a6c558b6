"""Parity of the port's per-edge GAT attention (K9/K10,
``pgl_tpu_torch/ops/kernels/attention_kernels.py``) with ``pgl_tpu``'s
``fused_gat_attention`` run in interpret mode, on the CPU: the dropout hash
bit for bit, the forward and its ``lse``, and the gradients of the flash
backward; and the plain backward functions against autograd of the plain
forward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack: there this file skips
pytest.importorskip("flax")

from pgl_tpu import Graph as JGraph
from pgl_tpu.ops.pallas.attention_kernels import (
    _drop_keep, _fused_attention_fwd, fused_gat_attention as j_fused)
from pgl_tpu.ops.pallas.segment_kernels import build_blocked_layout
from pgl_tpu_torch import Graph
from pgl_tpu_torch.ops.kernels import attention_kernels as ak

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

N = 300


def _edges(seed, E=3000):
    """A hub destination (node 0, 700 edges: split over pieces of
    ``ak.ET``), a hub source (node 5, 600 out-edges), empty rows 1..149,
    and the edges in shuffled order (so CSC and CSR positions differ from
    edge ids)."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(700, np.int64),
                          rng.integers(N // 2, N, E - 700)])
    src = rng.integers(0, N, E)
    src[rng.choice(E, 600, replace=False)] = 5
    return np.stack([src, dst], axis=1)[rng.permutation(E)]


def _case(seed, H, dvh):
    """The port's layouts and the reference's (``build_blocked_layout``
    with nb=128, et=256, and the reference graph's ``perm``) of one graph,
    and numpy inputs from ``seed``."""
    edges = _edges(seed)
    port = Graph(edges, num_nodes=N).tensor("cpu")
    gj = JGraph(edges, num_nodes=N)
    di, si = gj.adj_dst_index, gj.adj_src_index
    ref = (build_blocked_layout(np.asarray(di.indptr),
                                np.asarray(di.sorted_v), N, 128, 256),
           build_blocked_layout(np.asarray(si.indptr),
                                np.asarray(si.sorted_v), N, 128, 256),
           gj.tensor()._spmm_layouts[2])
    rng = np.random.default_rng(seed + 1)
    a_dst, a_src = (rng.normal(size=(N, H)).astype(np.float32)
                    for _ in range(2))
    v = rng.normal(size=(N, H * dvh)).astype(np.float32)
    return port, ref, a_dst, a_src, v


def _pad128(v):
    DV = max(128, -(-v.shape[1] // 128) * 128)
    return jnp.zeros((v.shape[0], DV)).at[:, :v.shape[1]].set(v)


@pytest.mark.parametrize("rate", [0.1, 0.4, 0.6, 0.9])
def test_drop_keep_is_the_reference_hash(rate):
    """2^20 positions, half of them just below 2^31; heads 0..41; a
    negative and a positive seed."""
    half = np.arange(2 ** 19, dtype=np.int64)
    idx = np.concatenate([half, 2 ** 31 - 1 - half]).astype(np.int32)
    jidx, tidx = jnp.asarray(idx), torch.as_tensor(idx)
    for seed in (-123456789, 2 ** 31 - 7):
        for h in range(42):
            want = np.asarray(_drop_keep(jidx, jnp.int32(seed), h, rate))
            got = ak.drop_keep(tidx, seed, h, rate).numpy()
            assert np.array_equal(got, want), (seed, h)
    assert 0.0 < got.mean() < 1.0


def test_layouts_carry_the_reference_positions():
    port, (csc, csr, perm), *_ = _case(3, 1, 1)
    lc, lr = port._attention_layouts()
    E = port.num_edges
    assert lc.eidx is None and lr.kind == "csr"
    np.testing.assert_array_equal(lc.indices.numpy(),
                                  np.asarray(csc.padded_v)[:E])
    np.testing.assert_array_equal(lr.indices.numpy(),
                                  np.asarray(csr.padded_v)[:E])
    np.testing.assert_array_equal(lr.eidx.numpy(), np.asarray(perm))
    assert lc.split_rows.tolist() == [0]                # the hub destination
    assert lr.split_rows.tolist() == [5]                # the hub source


FWD_CASES = [(8, 8, 0.2, 0.0), (1, 16, 0.0, 0.0), (4, 32, 0.2, 0.4),
             (8, 8, 0.0, 0.4)]


@pytest.mark.parametrize("H,dvh,leaky,rate", FWD_CASES)
def test_forward_and_lse_match_reference(H, dvh, leaky, rate):
    """rtol 1e-4, atol 1e-5 (tests/test_pallas_kernels.py:430-431)."""
    port, (csc, _, _), a_dst, a_src, v = _case(7, H, dvh)
    seed = 12345
    out_j, lse_j, _ = _fused_attention_fwd(
        jnp.asarray(np.pad(a_dst, ((0, 0), (0, 128 - H)))),
        jnp.asarray(np.pad(a_src, ((0, 0), (0, 128 - H)))), _pad128(v),
        csc.padded_v, csc.padded_ids, csc.tile_starts, csc.tile_ends, N, H,
        leaky, 128, 256, True, dsh=1, dvh=dvh, additive=True,
        drop_rate=rate, drop_seed=jnp.int32(seed) if rate else None)
    csc_t, csr_t = port._attention_layouts()
    t = [torch.as_tensor(x) for x in (a_dst, a_src, v)]
    out = ak.fused_gat_attention(*t, csc_t, csr_t, leaky, dvh, rate,
                                 seed if rate else None)
    _, lse = ak.gat_attention_reference(*t, csc_t, leaky, dvh, rate,
                                        seed if rate else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j)[:, :H * dvh],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-4,
                               atol=1e-5)
    assert (out[1:N // 2] == 0).all() and (lse[1:N // 2] == 0).all()


@pytest.mark.parametrize("H,dvh,leaky,rate", [(8, 8, 0.2, 0.0),
                                              (1, 16, 0.0, 0.0),
                                              (8, 8, 0.2, 0.4)])
def test_gradients_match_reference_flash_backward(H, dvh, leaky, rate):
    """Gradients of sum((out - tgt)^2) against JAX's analytic backward
    (``bwd_aux=(csr, perm)``) at rtol 2e-3, atol 2e-4
    (tests/test_pallas_kernels.py:457-459)."""
    port, (csc, csr, perm), a_dst, a_src, v = _case(9, H, dvh)
    tgt = np.random.default_rng(11).normal(size=(N, H * dvh)).astype(
        np.float32)
    seed = 12345 if rate else None

    def loss_j(a_dst, a_src, v):
        out = j_fused(a_dst, a_src, v, csc, (csr, perm), leaky, 128, 256,
                      True, dvh, rate, None if seed is None
                      else jnp.int32(seed))
        return ((out[:, :H * dvh] - tgt) ** 2).sum()

    want = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(a_dst), jnp.asarray(a_src), _pad128(v))
    t = [torch.tensor(x, requires_grad=True) for x in (a_dst, a_src, v)]
    out = ak.fused_gat_attention(*t, *port._attention_layouts(), leaky, dvh,
                                 rate, seed)
    ((out - torch.as_tensor(tgt)) ** 2).sum().backward()
    for got, w, name in zip(t, want, ("a_dst", "a_src", "v")):
        np.testing.assert_allclose(got.grad.numpy(),
                                   np.asarray(w)[:, :got.shape[1]],
                                   rtol=2e-3, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_plain_backward_is_autograd_of_plain_forward(rate):
    """K10's plain versions (edge space, the CSR pass through ``eidx``)
    against torch autograd of the plain forward, in float64 at 1e-10."""
    H, dvh = 3, 5
    port, _, a_dst, a_src, v = _case(5, H, dvh)
    csc, csr = port._attention_layouts()
    t = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
         for x in (a_dst, a_src, v)]
    g = torch.randn(N, H * dvh, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    out, lse = ak.gat_attention_reference(*t, csc, 0.2, dvh, rate, -77)
    want = torch.autograd.grad(out, t, g)
    delta = (g.reshape(N, H, dvh) * out.detach().reshape(N, H, dvh)).sum(-1)
    ins = [x.detach() for x in t] + [g, lse.detach(), delta]
    da_dst = ak.gat_dq_reference(*ins, csc, 0.2, dvh, rate, -77)
    da_src, dv = ak.gat_dkv_reference(*ins, csr, 0.2, dvh, rate, -77)
    for got, w in zip((da_dst, da_src, dv), want):
        torch.testing.assert_close(got, w, rtol=1e-10, atol=1e-10)


def test_fused_gat_attention_rejects_mismatched_shapes():
    port, *_ = _case(3, 1, 1)
    lays = port._attention_layouts()
    a = torch.zeros(N, 2)
    with pytest.raises(ValueError, match="not \\[N, H\\]"):
        ak.fused_gat_attention(a, torch.zeros(N, 3), torch.zeros(N, 8),
                               *lays)
    with pytest.raises(ValueError, match="not \\[N, H\\]"):
        ak.fused_gat_attention(a, a, torch.zeros(N, 8), *lays, dvh=3)
