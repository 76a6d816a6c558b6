"""Parity of the in-script modules of ``examples_torch/`` with those of
``examples/`` on the CPU: ``Encoder`` (link prediction), ``NGCF``,
``GINWithReadout`` with each readout, ``SAGPoolNet`` (its plan equal too),
``RGCN``, ``HaloGCN``, ``HaloGAT`` and ``HaloUniMP``, with the reference's
flax parameters carried over by each script's ``load_reference_params``:
the outputs within 1e-5 of their largest magnitude, and the parameter
gradients of ``Σ out · W`` (W fixed) as ``close_grads`` holds them. The
halo modules run on a world of one rank against the reference on a
one-device mesh.
"""

import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

from pgl_tpu_torch.parallel import comm
from torch_examples_common import close, close_grads, numpy_tree, port, ref

torch.set_num_threads(1)


# -- in-script modules --------------------------------------------------------

def _graphs(n=90, d=16, seed=1):
    """The reference's and the port's small community graph with self
    loops (undirected), on the CPU."""
    from pgl_tpu.datasets import community_graph as j_community_graph
    from pgl_tpu.utils.transform import (add_self_loops as j_loops,
                                         to_undirected as j_undirected)
    from pgl_tpu_torch.datasets import community_graph
    from pgl_tpu_torch.utils.transform import add_self_loops, to_undirected
    jg, y = j_community_graph(num_nodes=n, num_classes=3, feat_dim=d,
                              avg_degree=5, seed=seed)
    tg, _ = community_graph(num_nodes=n, num_classes=3, feat_dim=d,
                            avg_degree=5, seed=seed)
    return j_loops(j_undirected(jg)), add_self_loops(to_undirected(tg)), y


def _module_parity(jmodel, tmodule, jargs, targs, load, weight_shape=None):
    """Init the flax model, carry its parameters over with ``load``, and
    hold the outputs and the gradients of ``Σ out · W`` (W fixed) equal."""
    params = jax.jit(jmodel.init)(jax.random.key(0), *jargs)
    load(tmodule, numpy_tree(params))
    out_shape = jax.eval_shape(lambda p: jmodel.apply(p, *jargs),
                               params).shape
    W = np.random.default_rng(9).normal(size=out_shape).astype(np.float32)

    def loss(p):
        out = jmodel.apply(p, *jargs)
        return (out * W).sum(), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    got = tmodule(*targs)
    close(got, want)
    (got * torch.as_tensor(W)).sum().backward()
    close_grads(tmodule, grads)


def test_encoder_module():
    p = port("link_prediction/train.py")
    jg, tg, _ = _graphs()
    jg, tg = jg.tensor(), tg.tensor("cpu")
    _module_parity(ref("link_prediction/train.py").Encoder(hidden=8),
                   p.Encoder(16, hidden=8, device="cpu"),
                   (jg, jg.node_feat["h"]), (tg, tg.node_feat["h"]),
                   p.load_reference_params)


def test_ngcf_module():
    p = port("ngcf/train.py")
    jg, tg, _ = _graphs(d=8)
    jg, tg = jg.tensor(), tg.tensor("cpu")
    _module_parity(ref("ngcf/train.py").NGCF(dim=8, num_layers=2),
                   p.NGCF(8, num_layers=2, device="cpu"),
                   (jg, jg.node_feat["h"]), (tg, tg.node_feat["h"]),
                   p.load_reference_params)


@pytest.mark.parametrize("pool", ["sum", "mean", "max", "GlobalAttention",
                                  "Set2Set", "GMT"])
def test_gin_with_readout(pool):
    r, p = ref("global_pool/train.py"), port("global_pool/train.py")
    (jb, _), = r.make_batches(12, 12, seed=5)
    (tb, _), = p.make_batches(12, 12, seed=5)
    jb, tb = jb.tensor(), tb.tensor("cpu")
    # noisy features: the motifs' constant ones tie every max
    x = np.asarray(jb.node_feat["h"]) + np.random.default_rng(3).normal(
        size=jb.node_feat["h"].shape).astype(np.float32)
    _module_parity(
        r.GINWithReadout(input_size=8, num_class=3, pool_type=pool,
                         hidden_size=8),
        p.GINWithReadout(8, 3, pool, hidden_size=8, device="cpu"),
        (jb, jnp.asarray(x)), (tb, torch.as_tensor(x)),
        p.load_reference_params)


def test_rgcn_module():
    r, p = ref("rgcn/train.py"), port("rgcn/train.py")
    hj, _ = r.synthetic_relational(num_nodes=80)
    ht, _ = p.synthetic_relational(num_nodes=80)
    etypes = tuple(sorted(hj.edge_types))
    hj, ht = hj.tensor(), ht.tensor("cpu")
    _module_parity(r.RGCN(etypes=etypes, num_class=4, hidden=8),
                   p.RGCN(16, etypes, num_class=4, hidden=8, device="cpu"),
                   (hj, hj[etypes[0]].node_feat["h"]),
                   (ht, ht[etypes[0]].node_feat["h"]),
                   p.load_reference_params)


def test_sag_pool_module():
    """The plan (kept nodes and pooled graph) equal to the reference's, and
    the forward at the plan with its gradients through ``h[rank] *
    score[rank]``."""
    r, p = ref("sag_pool/train.py"), port("sag_pool/train.py")
    (jb, _), = r.make_batches(10, 10, 4)
    (tb, _), = p.make_batches(10, 10, 4, "cpu")
    jx = jb.node_feat["h"] + jnp.asarray(np.random.default_rng(3).normal(
        size=jb.node_feat["h"].shape), jnp.float32)
    tx = torch.as_tensor(np.asarray(jx))
    jmodel = r.SAGPoolNet(input_size=8, hidden=8, num_class=2)
    tmodel = p.SAGPoolNet(8, 8, 2, device="cpu")
    params = jmodel.init(jax.random.key(0), jb, jx,
                         np.arange(jb.num_nodes), jb)
    p.load_reference_params(tmodel, numpy_tree(params))
    jrank, jpooled = jmodel.apply(params, jb, jx, method=r.SAGPoolNet.plan)
    trank, tpooled = tmodel.plan(tb, tx)
    np.testing.assert_array_equal(trank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(tpooled.edges.numpy(),
                                  np.asarray(jpooled.edges))
    np.testing.assert_array_equal(tpooled.graph_node_id.numpy(),
                                  np.asarray(jpooled.graph_node_id))
    _module_parity(jmodel, tmodel, (jb, jx, jrank, jpooled),
                   (tb, tx, trank, tpooled), lambda m, t: None)


@pytest.fixture
def world_of_one():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_ = s.getsockname()[1]
    comm.init(backend="gloo", init_method=f"tcp://127.0.0.1:{port_}",
              world_size=1, rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", ["HaloGCN", "HaloGAT", "HaloUniMP"])
def test_halo_modules(world_of_one, name):
    """A world of one rank against the reference on a one-device mesh:
    outputs unsharded to the global order, and the gradients of ``Σ out ·
    W`` (W zero on the pad rows)."""
    from jax.sharding import Mesh
    from pgl_tpu.parallel import HaloGraph as JHaloGraph
    from pgl_tpu_torch.parallel import HaloGraph
    rel = "citation_benchmark/multi_chip_train.py"
    r, p = ref(rel), port(rel)
    jg, tg, _ = _graphs(n=70, d=12)
    mesh = Mesh(np.array(jax.devices()[:1]), ("node",))
    jh = JHaloGraph.from_graph(jg, mesh, partition="range")
    th = HaloGraph.from_graph(tg, partition="range", device="cpu")
    jx, tx = jh.node_feat["h"], th.node_feat["h"]
    jmodel = getattr(r, name)(hidden=4, num_class=3)
    tmodel = getattr(p, name)(12, 4, 3, device="cpu")
    params = jax.jit(jmodel.init)(jax.random.key(0), jh, jx)
    p.load_reference_params(tmodel, numpy_tree(params))
    W = np.random.default_rng(9).normal(size=(70, 3)).astype(np.float32)
    jW = jnp.asarray(jh.shard_node_values(W)) * \
        jnp.asarray(jh.shard_node_values(np.ones(70, np.float32)))[..., None]

    def loss(p_):
        out = jmodel.apply(p_, jh, jx)
        return (out * jW).sum(), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    got = tmodel(th, tx)
    close(th.unshard_node_values(got.detach()), jh.unshard_node_values(want))
    (got * th.shard_node_values(W)).sum().backward()
    close_grads(tmodel, grads)
