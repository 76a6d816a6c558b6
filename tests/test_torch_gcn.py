"""Port parity for the main path: the GCN of ``pgl_tpu_torch`` against
``pgl_tpu``'s on the CPU, with flax-initialised parameters carried over by
``pgl_tpu_torch.utils.convert``; the 20-step ``gcn`` loss golden; and the
package's freedom from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference needs flax, which a machine that runs only the port (the
# card's) may lack: there this file skips, and the gpu tests still collect
pytest.importorskip("flax")

from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.models import GCN as JGCN
from pgl_tpu.nn import GCNConv as JGCNConv
from pgl_tpu.ops import softmax_cross_entropy_integer as j_ce
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import GCN
from pgl_tpu_torch.nn import GCNConv
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes,
# and these sums are small
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS_FILE = os.path.join(REPO, "tests", "test_trajectory_goldens_data.npz")
GOLDEN_RTOL = 2e-3          # tests/test_trajectory_goldens.py:30


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_gcn_logits_and_grads_match_reference():
    """3-layer GCN 16 -> 24 -> 24 -> 3. Logits at rtol/atol 1e-5, parameter
    gradients at rtol 1e-4, atol 1e-5 (float32; sums in another order)."""
    g, labels = j_community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    gj = g.tensor()
    jmodel = JGCN(input_size=16, num_class=3, num_layers=3, hidden_size=24,
                  dropout=0.0)
    params = jmodel.init(jax.random.key(0), gj, gj.node_feat["h"])

    def loss(p):
        logits = jmodel.apply(p, gj, gj.node_feat["h"])
        return j_ce(logits, jnp.asarray(labels)).mean(), logits

    (_, want_logits), want_grads = jax.value_and_grad(loss, has_aux=True)(
        params)

    tg, tlabels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    gt = tg.tensor("cpu")
    model = GCN(16, 3, num_layers=3, hidden_size=24, dropout=0.0,
                device="cpu")
    model.load_state_dict(flax_to_state_dict(_numpy_tree(params), "cpu"))
    logits = model(gt, gt.node_feat["h"])
    ce(logits, torch.as_tensor(tlabels)).mean().backward()

    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    want = flax_to_state_dict(_numpy_tree(want_grads), "cpu")
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_gcn_on_a_float64_feature_graph_matches_reference():
    """A graph built from float64 numpy features: ``tensor()`` gives
    float32, as the reference's ``jnp.asarray`` does in 32-bit mode, so
    ``GCN(4, 2)`` runs and its logits equal the reference's (rtol/atol
    1e-5, float32 sums in another order); integer features stay int64, the
    port's departure (the reference gives int32)."""
    import pgl_tpu
    import pgl_tpu_torch

    edges = np.array([[0, 1], [1, 2], [2, 0], [0, 2]])
    feat = np.random.default_rng(0).normal(size=(3, 4))
    ids = np.arange(3)
    jg = pgl_tpu.Graph(edges, num_nodes=3,
                       node_feat={"h": feat, "id": ids}).tensor()
    jmodel = JGCN(input_size=4, num_class=2, dropout=0.0)
    params = jmodel.init(jax.random.key(0), jg, jg.node_feat["h"])
    want = jmodel.apply(params, jg, jg.node_feat["h"])

    tg = pgl_tpu_torch.Graph(edges, num_nodes=3,
                             node_feat={"h": feat, "id": ids}).tensor("cpu")
    assert tg.node_feat["h"].dtype == torch.float32
    assert jg.node_feat["h"].dtype == jnp.float32
    assert tg.node_feat["id"].dtype == torch.int64
    model = GCN(4, 2, dropout=0.0, device="cpu")
    model.load_state_dict(flax_to_state_dict(_numpy_tree(params), "cpu"))
    got = model(tg, tg.node_feat["h"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_gcn_trajectory_matches_golden():
    """The ``gcn`` trajectory of tests/test_trajectory_goldens.py: two
    GCNConv layers initialised by flax from the same keys, then 20 steps of
    torch Adam at lr 1e-2."""
    g, labels = j_community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    gj = g.tensor()
    jlayers = [JGCNConv(16, 24, activation="relu"), JGCNConv(24, 3)]
    key, h, params = jax.random.key(0), gj.node_feat["h"], []
    for layer in jlayers:
        key, sub = jax.random.split(key)
        p = layer.init(sub, gj, h)
        h = layer.apply(p, gj, h)
        params.append(p)

    layers = torch.nn.ModuleList([
        GCNConv(16, 24, activation="relu", device="cpu"),
        GCNConv(24, 3, device="cpu")])
    for layer, p in zip(layers, params):
        layer.load_state_dict(flax_to_state_dict(_numpy_tree(p), "cpu"))
    tg, tlabels = community_graph(num_nodes=300, num_classes=3, feat_dim=16,
                                  avg_degree=8, seed=5)
    gt = tg.tensor("cpu")
    y = torch.as_tensor(tlabels)
    opt = torch.optim.Adam(layers.parameters(), lr=1e-2)
    losses = []
    for _ in range(20):
        h = gt.node_feat["h"]
        for layer in layers:
            h = layer(gt, h)
        loss = ce(h, y).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, np.load(GOLDENS_FILE)["gcn"],
                               rtol=GOLDEN_RTOL)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(50, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 50).astype(np.int32)
    np.testing.assert_allclose(
        ce(torch.as_tensor(logits), torch.as_tensor(labels)).numpy(),
        np.asarray(j_ce(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)


def test_cross_entropy_with_a_label_outside_the_classes():
    """A label outside ``[0, C)`` selects no logit, as the reference's
    one-hot mask (``pgl_tpu/ops/losses.py:28-32``): its loss is the row's
    log-sum-exp, and its gradient the row's softmax."""
    logits = np.array([[1, 2, 3], [0, 0, 1]], np.float32)
    labels = np.array([2, -1], np.int32)
    want = np.asarray(j_ce(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(want, [0.4076059, 1.5514448], rtol=1e-6)
    x = torch.as_tensor(logits).requires_grad_()
    got = ce(x, torch.as_tensor(labels))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    got.sum().backward()
    np.testing.assert_allclose(
        x.grad.numpy(), np.asarray(jax.grad(lambda v: j_ce(
            v, jnp.asarray(labels)).sum())(jnp.asarray(logits))),
        rtol=1e-6, atol=1e-7)


def test_degree_norm_on_a_host_graph():
    """``degree_norm`` on a graph that was not ``tensor()``ed takes its
    numpy degrees, as the reference's ``jnp.asarray`` does
    (``pgl_tpu/nn/functional/graph_op.py:30``)."""
    import pgl_tpu
    import pgl_tpu_torch
    from pgl_tpu.nn.functional import degree_norm as j_degree_norm
    from pgl_tpu_torch.nn.functional import degree_norm

    edges = np.array([[0, 1], [2, 1]])
    got = degree_norm(pgl_tpu_torch.Graph(edges, num_nodes=3))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), [[1.0], [0.70710677], [1.0]],
                               rtol=1e-7)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_degree_norm(pgl_tpu.Graph(edges,
                                                            num_nodes=3))),
        rtol=1e-7)


def test_init_follows_flax_defaults():
    """lecun-normal kernel (truncated at ±2 std, variance 1/fan_in), zero
    bias, reproducible from the generator's seed."""
    conv = GCNConv(400, 300, generator=torch.Generator().manual_seed(3),
                   device="cpu")
    w = conv.linear.weight.detach()
    assert w.shape == (300, 400)
    assert abs(float(w.var()) * 400 - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * (1 / 400) ** 0.5 / 0.87962566103423978
    assert (conv.bias == 0).all()
    again = GCNConv(400, 300, generator=torch.Generator().manual_seed(3),
                    device="cpu")
    assert torch.equal(again.linear.weight, conv.linear.weight)


def test_convert_transposes_dense_kernels():
    tree = {"params": {"gcn_0": {"linear": {"kernel": np.ones((4, 3))},
                                 "bias": np.zeros(3)}}}
    sd = flax_to_state_dict(tree, "cpu")
    assert set(sd) == {"gcn_0.linear.weight", "gcn_0.bias"}
    assert sd["gcn_0.linear.weight"].shape == (3, 4)


def test_import_leaves_jax_out():
    code = ("import sys, pgl_tpu_torch, pgl_tpu_torch.models, "
            "pgl_tpu_torch.datasets, pgl_tpu_torch.utils.convert, "
            "pgl_tpu_torch.ops.kernels.segment_kernels, "
            "pgl_tpu_torch.ops.kernels.dedup_kernels, "
            "pgl_tpu_torch.ops.kernels.attention_kernels, "
            "pgl_tpu_torch.ops.kernels.dedup_attention, "
            "pgl_tpu_torch.ops.kernels.sddmm_kernels, "
            "pgl_tpu_torch.message, pgl_tpu_torch.math, "
            "pgl_tpu_torch.native, pgl_tpu_torch.native.graph_kernel, "
            "pgl_tpu_torch.ops.dispatch, pgl_tpu_torch.sampling, "
            "pgl_tpu_torch.sampling.device_walk, pgl_tpu_torch.partition, "
            "pgl_tpu_torch.utils.data, pgl_tpu_torch.utils.mp_reader, "
            "pgl_tpu_torch.models.sampled_sage, "
            "pgl_tpu_torch.datasets.loaders, "
            "pgl_tpu_torch.ops.kernels.streaming, "
            "pgl_tpu_torch.utils.stream_pool, "
            "pgl_tpu_torch.utils.shared_embedding, "
            "pgl_tpu_torch.utils.logger, pgl_tpu_torch.apps, "
            "pgl_tpu_torch.apps.common, pgl_tpu_torch.apps.gnn_autoscale, "
            "pgl_tpu_torch.apps.ingest, pgl_tpu_torch.apps.pglbox, "
            "pgl_tpu_torch.apps.unsupervised, chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'pgl_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
