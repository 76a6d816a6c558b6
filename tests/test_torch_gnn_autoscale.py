"""Port parity for GNNAutoScale (``pgl_tpu_torch.apps.gnn_autoscale``) on
the CPU against ``pgl_tpu``'s: ``partition_batches`` gives the reference's
batches (nodes, batch sizes, subgraph edges) for METIS and random parts;
``ScalableGNN`` over ``GCNConv`` layers with the reference's parameters
carried across (``utils/convert.py``) gives the reference's batch outputs,
fresh rows and one step's gradients to 1e-5, and its full-graph inference;
an empty part runs to a ``(0, C)`` output, as the reference's does; the
``iter_batches`` halos equal the blocking ``pull_halo``. A stock
``GCNConv`` normalises a batch by the subgraph's degrees, as the
reference's; the full graph's norm (``FULL_NORM``) is the port's own.

The mapping: the reference's ``ScalableGNN(n, layer_fns=[lambda p, sg, x:
conv.apply(p, sg, x), ...], hidden_dims)`` with ``forward_batch(params_list,
batch, x, halo)`` is the port's ``ScalableGNN(n, layers=[conv, ...],
hidden_dims, device=...)`` with ``forward_batch(batch, x, halo)``: each
``torch.nn.Module`` holds its parameters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

optax = pytest.importorskip("optax")

from pgl_tpu.apps import gnn_autoscale as jgas
from pgl_tpu.datasets import community_graph as j_community_graph
from pgl_tpu.nn import GCNConv as JGCNConv
from pgl_tpu_torch import Graph
from pgl_tpu_torch.apps.gnn_autoscale import (FULL_NORM, History,
                                              ScalableGNN, partition_batches)
from pgl_tpu_torch.nn import GCNConv
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.utils.convert import flax_to_state_dict

# one intra-op thread: the test files run in parallel worker processes
torch.set_num_threads(1)


def graphs(num_nodes=240, seed=2):
    """The reference's community graph and the port's Graph of its edges
    and features."""
    jg, labels = j_community_graph(num_nodes=num_nodes, num_classes=3,
                                   feat_dim=12, avg_degree=8, seed=seed)
    feat = np.asarray(jg.node_feat["h"], np.float32)
    g = Graph(np.asarray(jg.edges), num_nodes=num_nodes,
              node_feat={"h": feat})
    return jg, g, feat, np.asarray(labels)


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for b, r in zip(got, want):
        np.testing.assert_array_equal(b["nodes"], r["nodes"])
        assert b["batch_size"] == r["batch_size"]
        np.testing.assert_array_equal(np.asarray(b["subgraph"].edges),
                                      np.asarray(r["subgraph"].edges))
        assert b["subgraph"].num_nodes == r["subgraph"].num_nodes


@pytest.mark.parametrize("method,parts", [("metis", 3), ("random", 4)])
def test_partition_batches_match_reference(method, parts):
    jg, g, _, _ = graphs()
    got = partition_batches(g, parts, method=method, seed=0)
    assert_same_batches(got, jgas.partition_batches(jg, parts,
                                                    method=method, seed=0))
    covered = np.concatenate([b["nodes"][:b["batch_size"]] for b in got])
    assert sorted(covered.tolist()) == list(range(g.num_nodes))
    assert sum(b["subgraph"].num_edges for b in got) == g.num_edges
    # a partition made earlier gives the same batches
    from pgl_tpu_torch.partition import metis_partition, random_partition
    made = (metis_partition if method == "metis" else random_partition)(
        g, parts, 0)
    assert_same_batches(partition_batches(g, parts, parts=made), got)


def test_history_roundtrip():
    h = History(10, 4, device="cpu")
    h.push([2, 5], torch.ones(2, 4))
    np.testing.assert_array_equal(h.pull([2, 3, 5]).numpy(),
                                  [[1] * 4, [0] * 4, [1] * 4])
    h.reset()
    assert (h.emb == 0).all()


def models(jg, batch, feat):
    """The reference's two GCN layers initialised on the batch, the port's
    with the same weights."""
    l1, l2 = JGCNConv(12, 16, activation="relu"), JGCNConv(16, 3)
    gt0 = batch["subgraph"].tensor()
    x0 = jnp.asarray(feat[batch["nodes"]])
    p1 = l1.init(jax.random.key(0), gt0, x0)
    p2 = l2.init(jax.random.key(1), gt0, l1.apply(p1, gt0, x0))
    c1 = GCNConv(12, 16, activation="relu", device="cpu")
    c2 = GCNConv(16, 3, device="cpu")
    for conv, p in ((c1, p1), (c2, p2)):
        conv.load_state_dict(flax_to_state_dict(
            jax.tree.map(np.asarray, p), "cpu"))
    return (l1, l2), (p1, p2), (c1, c2)


def test_forward_batch_and_gradients_match_reference():
    jg, g, feat, labels = graphs()
    jbatches = jgas.partition_batches(jg, 3, method="metis", seed=0)
    batches = partition_batches(g, 3, method="metis", seed=0)
    (l1, l2), params, convs = models(jg, jbatches[0], feat)
    jgnn = jgas.ScalableGNN(240, [lambda p, sg, x: l1.apply(p, sg, x),
                                  lambda p, sg, x: l2.apply(p, sg, x)], [16])
    gnn = ScalableGNN(240, list(convs), [16], device="cpu")
    hist = np.random.default_rng(2).normal(size=(240, 16)).astype(np.float32)
    jgnn.histories[0].emb[:] = hist
    gnn.histories[0].emb[:] = hist

    def jloss(params, batch, x, halo, yb):
        out, fresh = jgnn.forward_batch(params, batch, x, halo)
        return optax.softmax_cross_entropy_with_integer_labels(
            out, yb).mean(), (out, fresh)

    for jb, b in list(zip(jbatches, batches))[:2]:
        bs = b["batch_size"]
        yb = labels[b["nodes"][:bs]]
        # under jit: one compile, where eager flax compiles every operator
        (jl, (jout, jfresh)), jgrads = jax.jit(jax.value_and_grad(
            lambda p, x, h, y: jloss(p, jb, x, h, y), has_aux=True))(
                params, jnp.asarray(feat[jb["nodes"]]), jgnn.pull_halo(jb),
                jnp.asarray(yb))
        out, fresh = gnn.forward_batch(b, torch.as_tensor(feat[b["nodes"]]),
                                       gnn.pull_halo(b))
        loss = ce(out, torch.as_tensor(yb).long()).mean()
        for c in convs:
            c.zero_grad()
        loss.backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(fresh[0].detach().numpy(),
                                   np.asarray(jfresh[0]), rtol=1e-5,
                                   atol=1e-5)
        assert abs(float(loss.detach()) - float(jl)) < 1e-5
        for c, jgr in zip(convs, jgrads):
            want = flax_to_state_dict(jax.tree.map(np.asarray, jgr), "cpu")
            for name, p in c.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(),
                                           want[name].numpy(), rtol=1e-5,
                                           atol=1e-5)
        # the fresh rows go back into the histories alike
        jgnn.push_fresh(jb, jfresh)
        gnn.push_fresh(b, fresh)
        np.testing.assert_allclose(gnn.histories[0].emb,
                                   jgnn.histories[0].emb, rtol=1e-5,
                                   atol=1e-5)
    # each batch's subgraph went to the device once and was kept
    assert len(gnn._graphs) == 2
    assert gnn.batch_graph(batches[0]) is gnn.batch_graph(batches[0])
    np.testing.assert_allclose(
        gnn.inference_full(g, feat).numpy(),
        np.asarray(jgnn.inference_full(params, jg, jg.node_feat["h"])),
        rtol=1e-5, atol=1e-5)
    gnn.pool.close()


def test_batch_norm_is_the_subgraphs_unless_the_full_graphs_is_passed():
    """A reference behaviour: a stock ``GCNConv`` in ``forward_batch``
    normalises by the subgraph's own in-degrees, as the reference's does, so
    a halo node (no in-edge in the subgraph) sends its messages out
    unnormalised; the first layer's fresh rows equal the reference conv on
    the subgraph and differ from the full graph's layer. Each batch also
    carries the full graph's ``deg^-1/2`` of its nodes (``FULL_NORM``):
    passed as ``norm=``, the fresh rows equal the full-graph layer's rows
    of the batch (GAS's GCN)."""
    jg, g, feat, _ = graphs()
    jbatches = jgas.partition_batches(jg, 3, method="metis", seed=0)
    batches = partition_batches(g, 3, method="metis", seed=0)
    (l1, _), params, convs = models(jg, jbatches[0], feat)
    deg = np.bincount(np.asarray(g.edges)[:, 1], minlength=g.num_nodes)
    stock = ScalableGNN(240, list(convs), [16], device="cpu")
    normed = ScalableGNN(240, [
        lambda sg, x, c=c: c(sg, x, norm=sg.node_feat.get(FULL_NORM))
        for c in convs], [16], device="cpu")
    with torch.no_grad():
        full = convs[0](g.tensor("cpu"), torch.as_tensor(feat)).numpy()
        for jb, b in zip(jbatches, batches):
            n, bs = b["nodes"], b["batch_size"]
            np.testing.assert_array_equal(
                b["subgraph"].node_feat[FULL_NORM],
                (np.maximum(deg[n], 1).astype(np.float32) ** -0.5)[:, None])
            x = torch.as_tensor(feat[n])
            _, fresh = stock.forward_batch(b, x, stock.pull_halo(b))
            want = l1.apply(params[0], jb["subgraph"].tensor(),
                            jnp.asarray(feat[n]))[:bs]
            np.testing.assert_allclose(fresh[0].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
            assert not np.allclose(fresh[0].numpy(), full[n[:bs]],
                                   rtol=1e-3, atol=1e-3)
            _, fresh = normed.forward_batch(b, x, normed.pull_halo(b))
            np.testing.assert_allclose(fresh[0].numpy(), full[n[:bs]],
                                       rtol=1e-5, atol=1e-5)
    for gnn in (stock, normed):
        gnn.pool.close()


def test_empty_part_runs_to_an_empty_output():
    """A part of no nodes (METIS can leave one empty): the reference runs
    it to ``(0, C)``; the port does too, with no halo and no fresh
    rows."""
    jg, g, feat, _ = graphs(num_nodes=30, seed=3)
    jbatches = jgas.partition_batches(jg, 40, method="random", seed=0)
    batches = partition_batches(g, 40, method="random", seed=0)
    assert_same_batches(batches, jbatches)
    empty = [i for i, b in enumerate(batches) if b["batch_size"] == 0]
    assert empty
    i = empty[0]
    assert batches[i]["subgraph"].node_feat[FULL_NORM].shape == (0, 1)
    (l1, l2), params, convs = models(jg, jbatches[i], feat)
    jgnn = jgas.ScalableGNN(30, [lambda p, sg, x: l1.apply(p, sg, x),
                                 lambda p, sg, x: l2.apply(p, sg, x)], [16])
    jout, _ = jgnn.forward_batch(params, jbatches[i],
                                 jnp.asarray(feat[jbatches[i]["nodes"]]),
                                 jgnn.pull_halo(jbatches[i]))
    gnn = ScalableGNN(30, list(convs), [16], device="cpu")
    out, fresh = gnn.forward_batch(batches[i],
                                   torch.as_tensor(feat[batches[i]["nodes"]]),
                                   gnn.pull_halo(batches[i]))
    assert tuple(out.shape) == tuple(jout.shape) == (0, 3)
    assert tuple(fresh[0].shape) == (0, 16)
    gnn.push_fresh_async(batches[i], fresh)
    gnn.pool.close()


def test_iter_batches_overlap_and_equivalence():
    """The reference's test: batch k+1's halo pull is issued before batch k
    is consumed, and the yielded halos equal the blocking ``pull_halo``."""
    _, g, _, _ = graphs(num_nodes=200, seed=1)
    batches = partition_batches(g, 4, method="metis", seed=0)
    gnn = ScalableGNN(200, [lambda sg, x: x, lambda sg, x: x], [5],
                      device="cpu")
    gnn.histories[0].emb[:] = np.random.default_rng(2).normal(
        size=gnn.histories[0].emb.shape).astype(np.float32)
    issued = []
    orig = gnn.prefetch_halo

    def recording_prefetch(batch):
        issued.append(batch["nodes"][0])
        return orig(batch)

    gnn.prefetch_halo = recording_prefetch
    seen = []
    for i, (b, halo) in enumerate(gnn.iter_batches(batches)):
        if i + 1 < len(batches):
            assert len(issued) >= i + 2, (i, len(issued))
        seen.append((b, halo))
    assert len(seen) == len(batches)
    for b, halo in seen:
        for a, r in zip(halo, gnn.pull_halo(b)):
            np.testing.assert_array_equal(a.numpy(), r.numpy())
    gnn.pool.close()


def test_async_training_falls():
    """Training through ``iter_batches`` and ``push_fresh_async`` (the
    reference's ``test_gas_async_training_converges`` loop, 15 epochs):
    finite losses that fall, then full-graph inference of the right
    shape."""
    _, g, feat, labels = graphs()
    batches = partition_batches(g, 3, method="metis", seed=0)
    convs = [GCNConv(12, 16, activation="relu", device="cpu"),
             GCNConv(16, 3, device="cpu")]
    gnn = ScalableGNN(240, convs, [16], device="cpu")
    opt = torch.optim.Adam([p for c in convs for p in c.parameters()],
                           lr=1e-2)
    epochs = []
    for _ in range(15):
        total = 0.0
        for b, halo in gnn.iter_batches(batches):
            out, fresh = gnn.forward_batch(
                b, torch.as_tensor(feat[b["nodes"]]), halo)
            loss = ce(out, torch.as_tensor(
                labels[b["nodes"][:b["batch_size"]]]).long()).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            gnn.push_fresh_async(b, fresh)
            total += float(loss.detach())
        gnn.pool.synchronize()
        epochs.append(total)
    assert np.isfinite(epochs).all() and epochs[-1] < 0.7 * epochs[0]
    assert gnn.inference_full(g, feat).shape == (240, 3)
    gnn.pool.close()


def test_scalable_gnn_checks_its_widths():
    with pytest.raises(ValueError, match="hidden dims"):
        ScalableGNN(10, [lambda sg, x: x] * 3, [4], device="cpu")
