"""Port parity for ``HaloHeterGraph``: per-relation halo partitions over one
shared node assignment, on 4 gloo ranks on the CPU; mirrors
``tests/test_halo_heter.py`` case by case, and
``label_propagation_smooth`` on a HaloGraph (``pgl_tpu/models/unimp.py``).

The ranks run once for the whole file (``torch_parallel_ranks.py``, suite
"heter") while the reference runs here on a mesh of 4 host devices
(``pgl_tpu.parallel``, under ``jax.jit``). The partition (METIS on the
union of the relations, then one HaloGraph a relation) equals the
reference's array for array; ``RGCNConv``, ``RUniMP`` (output and
parameter gradients, summed over the ranks) and the smoothing equal the
reference's on its ``HaloHeterGraph``, flax parameters carried as state
dicts.

Tolerance: host index arrays exactly; float32 outputs at rtol 1e-5 and
atol 1e-5; gradients at rtol 1e-4, atol 1e-5.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

pytest.importorskip("flax")

import pgl_tpu
import pgl_tpu.nn as jnn
from pgl_tpu.models import RUniMP as JRUniMP
from pgl_tpu.models import label_propagation_smooth as j_smooth
from pgl_tpu.parallel import HaloHeterGraph as JHaloHeterGraph
from pgl_tpu_torch.utils.convert import flax_to_state_dict

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

S = 4
RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-4

N, D = 41, 8
ETYPES = ["cites", "writes"]
rng = np.random.default_rng(5)
EDGES = {"cites": rng.integers(0, N, (60, 2)),
         "writes": rng.integers(0, N, (45, 2))}
FEAT = rng.normal(size=(N, D)).astype(np.float32)
LAB = rng.integers(0, 3, N)
MSK = rng.random(N) < 0.5
C = 3
GOLD = np.eye(C, dtype=np.float32)[LAB]
PROBS = GOLD * 0.4 + rng.random((N, C)).astype(np.float32)
PROBS /= PROBS.sum(-1, keepdims=True)
TRAIN = (rng.random(N) < 0.3).astype(np.float32)


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=ATOL)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models():
    return {"rgcn": jnn.RGCNConv(in_dim=D, out_dim=6, etypes=ETYPES,
                                 num_bases=2),
            "runimp": JRUniMP(input_size=D, num_class=C, etypes=ETYPES,
                              num_layers=2, hidden_size=4, num_heads=2,
                              dropout=0.0)}


@pytest.fixture(scope="module")
def runs():
    """(port results, reference): the reference on a mesh of 4, computed
    while the ranks run."""
    with tempfile.TemporaryDirectory() as tmp:
        hg = pgl_tpu.HeterGraph(EDGES, num_nodes=N, node_feat={"h": FEAT})
        hgt = hg.tensor()
        x = hgt.node_feat["h"]
        jy, jm = jnp.asarray(LAB), jnp.asarray(MSK)
        models = _models()
        # the reference under jax.jit: eager flax takes seconds a call here
        params = {"rgcn": jax.jit(models["rgcn"].init)(jax.random.key(0),
                                                       hgt, x),
                  "runimp": jax.jit(models["runimp"].init)(
                      jax.random.key(1), hgt, x, jy, jm)}
        inputs = dict(N=N, D=D, FEAT=FEAT, LAB=LAB, MSK=MSK, PROBS=PROBS,
                      GOLD=GOLD, TRAIN=TRAIN,
                      **{f"EDGES_{t}": e for t, e in EDGES.items()})
        for name, p in params.items():
            sd = flax_to_state_dict(_numpy_tree(p), "cpu")
            inputs.update({f"sd/{name}/{k}": v.numpy()
                           for k, v in sd.items()})
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        procs = ranks.start("heter", S, tmp)
        try:
            ref = _reference(hg, models, params)
        finally:
            port = ranks.finish(procs, tmp)
        yield port, ref


def _reference(hg, models, params):
    """The reference on a mesh of 4 (``pgl_tpu.parallel``), one program
    under ``jax.jit``: RGCN, R-UniMP's output and parameter gradients (over
    the real rows), and the smoothing on the ``cites`` relation."""
    hhg = JHaloHeterGraph.from_heter_graph(
        hg, Mesh(np.array(jax.devices()[:S]), ("node",)))
    x = hhg.shard_node_values(FEAT)
    lab = hhg.shard_node_values(LAB).astype(jnp.int32)
    msk = hhg.shard_node_values(MSK.astype(np.float32)) > 0.5
    mask = jnp.asarray(hhg["cites"]._host_node_mask)
    cites = hhg["cites"]
    probs, gold, train = (cites.shard_node_values(t)
                          for t in (PROBS, GOLD, TRAIN))

    @jax.jit
    def run(hhg, x, lab, msk, probs, gold, train):
        def loss(p):
            out = models["runimp"].apply(p, hhg, x, lab, msk)
            return ((out ** 2) * mask[..., None]).sum(), out

        (_, runimp), grads = jax.value_and_grad(loss, has_aux=True)(
            params["runimp"])
        return (models["rgcn"].apply(params["rgcn"], hhg, x), runimp, grads,
                j_smooth(hhg["cites"], probs, gold, train))

    rgcn, runimp, grads, smooth = run(hhg, x, lab, msk, probs, gold, train)
    U = hhg.unshard_node_values
    return {"hhg": hhg, "rgcn": U(rgcn), "runimp": U(runimp),
            "runimp_grad": flax_to_state_dict(_numpy_tree(grads), "cpu"),
            "smooth": U(smooth)}


@pytest.mark.parametrize("etype", ETYPES)
def test_partition_equals_reference(runs, etype):
    """One METIS assignment of the union: each relation's host layout is
    the reference's, array for array."""
    port, ref = runs
    sub = ref["hhg"][etype]
    want = dict(node_perm=sub._host_node_perm, node_mask=sub._host_node_mask,
                send_idx=sub.send_idx, local_edges=sub.local_edges,
                local_mask=sub._host_lmask, remote_edges=sub.remote_edges,
                remote_mask=sub._host_rmask)
    for k, v in want.items():
        np.testing.assert_array_equal(port[f"built_{etype}_{k}"],
                                      np.asarray(v), err_msg=k)


def test_shared_node_layout(runs):
    """Features shard once and round-trip; the relations' node layouts
    are one."""
    port, _ = runs
    np.testing.assert_array_equal(port["round_x"], FEAT)
    np.testing.assert_array_equal(port["built_cites_node_perm"],
                                  port["built_writes_node_perm"])


def test_rgcn(runs):
    port, ref = runs
    close(port["rgcn_out"], ref["rgcn"])


def test_runimp_output_and_gradients(runs):
    """Relation-wise UniMP (dot attention a relation, the label embedding,
    the last layer's mean heads) on the hetero halo: output, and the
    parameter gradients summed over the ranks."""
    port, ref = runs
    close(port["runimp_out"], ref["runimp"])
    got = {k[len("runimp_grad/"):]: port[k] for k in port
           if k.startswith("runimp_grad/")}
    want = ref["runimp_grad"]
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k].numpy(), GRAD_RTOL)


def test_label_propagation_on_halo(runs):
    """``label_propagation_smooth`` runs on a HaloGraph unchanged, as the
    reference's does on its own."""
    port, ref = runs
    close(port["smooth"], ref["smooth"])


def test_save_load_round_trip(runs):
    """A saved hetero partition reloads without re-partitioning; RGCN on
    it equals the freshly built graph's."""
    port, _ = runs
    halo, fresh = port["load_halo_size"]
    assert halo == fresh
    close(port["load_rgcn"], port["fresh_rgcn"])
