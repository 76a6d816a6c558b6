"""Export and serving of every model the port trains
(``pgl_tpu_torch/utils/export.py``) against ``pgl_tpu``'s on the CPU.

Each model is built small from the reference's flax parameters (carried by
``pgl_tpu_torch.utils.convert``) and exported: GAT (K9 additive),
``UniMP`` (K9 dot), ``FAGCN`` and ``GATv2`` (K1w), ``Graph.sddmm_csc``
(K11), and on a graph with dedup layouts the GCN with and without counts
(K5, K6), ``FAGCN`` (the weighted K6), GAT and ``TransformerConv`` (K7 in
both modes). The program holds one node of the kernel's custom op for each
forward kernel call; ``Predictor``'s output equals the eager port's bit for
bit and the reference's served output (``pgl_tpu.utils.export``) at the
model's parity tolerance (logits rtol/atol 1e-5, as
``tests/test_torch_gat.py``; the SDDMM bit for bit, as
``tests/test_torch_sddmm.py``). ``torch.library.opcheck`` holds each new
op's fake implementation to its CPU one, float32 and (K1w, K9, K5/K6 and
the weighted K6, K7) bf16, the collectives in a gloo world of one. Two gloo ranks export the halo GCN and
the ``ShardedGraph`` GCN, and two fresh rank processes serve them
(``tests/torch_parallel_ranks.py``'s ``export`` and ``serve`` suites).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")

import torch_parallel_ranks as ranks  # noqa: E402
from chip_smoke import dispatch_settings  # noqa: E402
from pgl_tpu.datasets import community_graph as j_community_graph  # noqa
from pgl_tpu.models import FAGCN as JFAGCN  # noqa: E402
from pgl_tpu.models import GAT as JGAT  # noqa: E402
from pgl_tpu.models import GATv2 as JGATv2  # noqa: E402
from pgl_tpu.models import GCN as JGCN  # noqa: E402
from pgl_tpu.models import UniMP as JUniMP  # noqa: E402
from pgl_tpu.nn import TransformerConv as JTransformerConv  # noqa: E402
from pgl_tpu.utils.export import Predictor as JPredictor  # noqa: E402
from pgl_tpu.utils.export import export_model as j_export_model  # noqa
from pgl_tpu_torch import Graph  # noqa: E402
from pgl_tpu_torch.datasets import community_graph  # noqa: E402
from pgl_tpu_torch.models import FAGCN, GAT, GATv2, GCN, UniMP  # noqa
from pgl_tpu_torch.nn import TransformerConv  # noqa: E402
from pgl_tpu_torch.ops.kernels import attention_kernels as ak  # noqa
from pgl_tpu_torch.ops.kernels import dedup_attention as da  # noqa: E402
from pgl_tpu_torch.ops.kernels import dedup_kernels as dk  # noqa: E402
from pgl_tpu_torch.ops.kernels import sddmm_kernels as sdk  # noqa: E402
from pgl_tpu_torch.ops.kernels import segment_kernels as sk  # noqa: E402
from pgl_tpu_torch.parallel import comm  # noqa: E402
from pgl_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402
from pgl_tpu_torch.utils.export import (Predictor, export_model,  # noqa
                                        op_calls)

# one intra-op thread: the test files run in parallel worker processes
torch.set_num_threads(1)

# the first torch.exp of a process on the CPU can differ from later ones
# (tests/test_torch_gat.py): take it before any comparison
torch.exp(torch.zeros(1 << 16))

N, C, F = 300, 3, 16
LABEL_SEED = 2


def _graphs(dedup=False, counts=True):
    """The reference's and the port's small graph; ``dedup`` builds the
    port's with dedup layouts (with their counts unless ``counts`` is
    False)."""
    g, _ = j_community_graph(num_nodes=N, num_classes=C, feat_dim=F,
                             avg_degree=8, seed=5)
    tg, _ = community_graph(num_nodes=N, num_classes=C, feat_dim=F,
                            avg_degree=8, seed=5)
    budget = {} if counts else {"COUNTS_BUDGET_BYTES": 0}
    with dispatch_settings(DEDUP=dedup, DEDUP_MIN_EDGES=0, **budget):
        gt = tg.tensor("cpu")
    assert (gt._dedup_layouts is not None) == dedup
    if dedup:
        assert (gt._dedup_layouts[0].counts is not None) == counts
    return g.tensor(), gt


def _unimp_labels():
    rng = np.random.default_rng(LABEL_SEED)
    return rng.integers(0, C, N), rng.random(N) < 0.5


def _unimp():
    label, mask = _unimp_labels()
    kw = dict(num_layers=3, hidden_size=8, num_heads=2)
    return (JUniMP(F, C, **kw), UniMP(F, C, device="cpu", **kw),
            (jnp.asarray(label), jnp.asarray(mask)),
            (torch.as_tensor(label), torch.as_tensor(mask)))


# name: (the reference's and the port's model and extra arguments, the
# graph's dedup layouts (None: none; True / False: with or without
# counts), the ops the program calls: one a forward kernel call)
CASES = {
    "gat": (lambda: (JGAT(F, C, num_heads=8, hidden_size=8),
                     GAT(F, C, num_heads=8, hidden_size=8, device="cpu"),
                     (), ()), None, {"gat_attention": 2}),
    "unimp": (_unimp, None, {"dot_attention": 2}),
    "fagcn": (lambda: (JFAGCN(F, C, hidden_size=16, num_layer=3),
                       FAGCN(F, C, hidden_size=16, num_layer=3,
                             device="cpu"), (), ()), None,
              {"spmm_weighted": 3}),
    "gatv2": (lambda: (JGATv2(F, C, num_heads=8, hidden_size=4),
                       GATv2(F, C, num_heads=8, hidden_size=4,
                             device="cpu"), (), ()), None,
              {"spmm_weighted": 2}),
    "gcn_dedup": (lambda: (JGCN(F, C), GCN(F, C, device="cpu"), (), ()),
                  True, {"spmm_dedup": 2}),
    "gcn_dedup_no_counts": (lambda: (JGCN(F, C), GCN(F, C, device="cpu"),
                                     (), ()), False, {"spmm_dedup": 2}),
    "fagcn_dedup": (lambda: (JFAGCN(F, C, hidden_size=16, num_layer=3),
                             FAGCN(F, C, hidden_size=16, num_layer=3,
                                   device="cpu"), (), ()), True,
                    {"spmm_dedup": 3}),
    "gat_dedup": (lambda: (JGAT(F, C, num_heads=8, hidden_size=8),
                           GAT(F, C, num_heads=8, hidden_size=8,
                               device="cpu"), (), ()), True,
                  {"dedup_gat_attention": 2}),
    "transformer_dedup": (lambda: (JTransformerConv(F, 4, num_heads=3),
                                   TransformerConv(F, 4, num_heads=3,
                                                   device="cpu"), (), ()),
                          True, {"dedup_dot_attention": 1}),
}


def _served_reference(tmp, jmodel, jg, jargs):
    """The reference's model exported and served (``pgl_tpu.utils.
    export``), and its flax parameters."""
    x = jg.node_feat["h"]
    params = jmodel.init(jax.random.key(0), jg, x, *jargs)
    path = os.path.join(tmp, "ref.bin")
    j_export_model(lambda x: jmodel.apply(params, jg, x, *jargs), [x], path)
    return np.asarray(JPredictor(path).run(x)), params


@pytest.mark.parametrize("case", sorted(CASES))
def test_exported_model_serves_the_eager_bits(case, tmp_path):
    make, dedup, ops = CASES[case]
    jmodel, model, jargs, args = make()
    jg, g = _graphs(dedup is not None, counts=dedup is not False)
    want, params = _served_reference(str(tmp_path), jmodel, jg, jargs)
    model.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params), "cpu"), strict=True)
    x = g.node_feat["h"]
    path = str(tmp_path / "model.pt2")
    program = export_model(lambda x: model(g, x, *args), [x], path)
    assert op_calls(program) == ops
    with torch.no_grad():
        eager = model(g, x, *args)
    out = Predictor(path).run(x)
    assert torch.equal(out, eager)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_exported_sddmm_serves_the_eager_bits(tmp_path):
    """``sddmm_csc(x, x, "mul")``: K11's op once, the slots bit for bit
    against the eager port and the reference's served program."""
    jg, g = _graphs()
    path = str(tmp_path / "ref.bin")
    j_export_model(lambda x: jg.sddmm_csc(x, x, "mul"),
                   [jg.node_feat["h"]], path)
    want = np.asarray(JPredictor(path).run(jg.node_feat["h"]))
    x = g.node_feat["h"]
    path = str(tmp_path / "sddmm.pt2")
    program = export_model(lambda x: g.sddmm_csc(x, x, "mul"), [x], path)
    assert op_calls(program) == {"sddmm": 1}
    out = Predictor(path).run(x)
    assert torch.equal(out, g.sddmm_csc(x, x, "mul"))
    np.testing.assert_array_equal(out.numpy(), want)


def test_eager_calls_take_no_op(monkeypatch):
    """An eager forward launches (or runs the plain version) directly: no
    wrapper reaches its custom op outside a trace."""
    def refuse(*args, **kwargs):
        raise AssertionError("an eager call reached a custom op")

    for module, name in ((sk, "_spmm_weighted_op"), (ak, "_gat_op"),
                         (ak, "_dot_op"), (dk, "_apply_op"),
                         (da, "_gat_op"), (da, "_dot_op"),
                         (sdk, "_sddmm_op"), (sk, "_spmm_op")):
        monkeypatch.setattr(module, name, refuse)
    for case in ("gat", "unimp", "fagcn", "gat_dedup",
                 "transformer_dedup", "gcn_dedup"):
        make, dedup, _ = CASES[case]
        _, model, _, args = make()
        _, g = _graphs(dedup is not None, counts=dedup is not False)
        with torch.no_grad():
            model(g, g.node_feat["h"], *args)
    _, g = _graphs()
    g.sddmm_csc(g.node_feat["h"], g.node_feat["h"], "mul")


# -- opcheck ------------------------------------------------------------------

def _small_graph(dedup=False, counts=True):
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 40, (240, 2))
    budget = {} if counts else {"COUNTS_BUDGET_BYTES": 0}
    with dispatch_settings(DEDUP=dedup, DEDUP_MIN_EDGES=0, **budget):
        return Graph(edges, num_nodes=40).tensor("cpu")


def _table(rows, cols, dtype, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        size=(rows, cols)).astype(np.float32)).to(dtype)


def _op_cases():
    """``(name, op, args)`` of each new op at the small graph's shapes."""
    f32, bf16 = torch.float32, torch.bfloat16
    g = _small_graph()
    csc, _ = g._spmm_layouts
    out = []
    for dtype in (f32, bf16):
        tag = str(dtype).replace("torch.", "")
        for op, H in (("mul", 1), ("add", 4)):
            x, w = _table(40, 8, dtype, 1), _table(g.num_edges, H, dtype, 2)
            out.append((f"spmm_weighted-{op}-{tag}", sk._spmm_weighted_op, (
                x, w, [getattr(csc, n) for n in sk._W_TENSORS],
                [getattr(csc, n) for n in sk._SCALARS], csc.kind, op)))
        lay, _ = g._attention_layouts()
        H, dvh, dsh = 2, 4, 3
        seed = torch.tensor([7], dtype=torch.int32)
        for rate in (0.0, 0.5):
            out.append((f"gat_attention-{rate}-{tag}", ak._gat_op, (
                _table(40, H, dtype, 3), _table(40, H, dtype, 4),
                _table(40, H * dvh, dtype, 5), *ak._op_args(lay), 0.2, dvh,
                rate, seed)))
            out.append((f"dot_attention-{rate}-{tag}", ak._dot_op, (
                _table(40, H * dsh, dtype, 3), _table(40, H * dsh, dtype, 4),
                _table(40, H * dvh, dtype, 5), *ak._op_args(lay), 0.0, dsh,
                dvh, rate, seed)))
    lay = g.sddmm_layout()
    for op in ("mul", "div"):
        out.append((f"sddmm-{op}", sdk._sddmm_op, (
            _table(40, 8, f32, 1), _table(40, 8, f32, 2), lay.slot_src,
            lay.slot_dst, lay.num_segments, op)))
    # the dedup ops on float32 and (named with the dtype) bf16 tables
    for dtype, tag in ((f32, ""), (bf16, "-bfloat16")):
        for counts in (True, False):
            gd = _small_graph(True, counts)
            csc_d = gd._dedup_layouts[0]
            tensors = [getattr(csc_d, n) for n in dk._OP_TENSORS]
            ints = [getattr(csc_d, n) for n in dk._OP_INTS]
            x = _table(40, 8, dtype, 1)
            out.append((f"spmm_dedup-counts_{counts}{tag}", dk._apply_op, (
                x, tensors, ints, csc_d.counts, None, None, csc_d.kind)))
        out.append((f"spmm_dedup-weighted{tag}", dk._apply_op, (
            x, tensors, ints, None, csc_d.edge_id,
            _table(gd.num_edges, 1, dtype, 6).reshape(-1), csc_d.kind)))
        att = gd._dedup_attn_aux()
        seed = torch.tensor([7], dtype=torch.int32)
        for rate in (0.0, 0.5):
            out.append((f"dedup_gat_attention-{rate}{tag}", da._gat_op, (
                _table(40, 2, dtype, 3), _table(40, 2, dtype, 4),
                _table(40, 8, dtype, 5), *da._op_args(att), 0.2, 4, rate,
                seed)))
            out.append((f"dedup_dot_attention-{rate}{tag}", da._dot_op, (
                _table(40, 6, dtype, 3), _table(40, 6, dtype, 4),
                _table(40, 8, dtype, 5), *da._op_args(att), 0.0, 3, 4,
                rate, seed)))
    return out


OP_CASES = _op_cases()


@pytest.mark.parametrize("name", [c[0] for c in OP_CASES])
def test_opcheck(name):
    """The op's schema, fake implementation (shapes, dtypes, strides) and
    registration against its CPU implementation."""
    _, op, args = next(c for c in OP_CASES if c[0] == name)
    torch.library.opcheck(op, args)


@pytest.fixture
def world_of_one():
    comm.init(backend="gloo", init_method=f"tcp://127.0.0.1:"
              f"{ranks.free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("op", ["all_to_all", "sum", "max", "min"])
def test_opcheck_collectives(world_of_one, op):
    x = _table(8, 3, torch.float32, 1)
    if op == "all_to_all":
        torch.library.opcheck(comm._all_to_all_op, (x, 1))
    else:
        torch.library.opcheck(comm._all_reduce_op, (x, op, 1))


def test_collective_program_needs_its_world(world_of_one, tmp_path):
    """A program with collectives records its world: ``Predictor`` serves
    it in a world of that size on the exporting rank, and raises without a
    process group; the op raises in a world of another size."""
    from pgl_tpu_torch.parallel import HaloGraph
    from pgl_tpu_torch.nn import GCNConv
    rng = np.random.default_rng(0)
    g = Graph(rng.integers(0, 32, (100, 2)), num_nodes=32,
              node_feat={"h": rng.normal(size=(32, 8)).astype(np.float32)})
    hg = HaloGraph.from_graph(g, device="cpu")
    layer = GCNConv(8, 4, device="cpu")
    x = hg.node_feat["h"]
    path = str(tmp_path / "halo.pt2")
    program = export_model(lambda x: layer(hg, x), (x,), path)
    assert op_calls(program) == {"spmm": 2, "all_to_all": 1}
    pred = Predictor(path)
    assert pred.world == {"world_size": 1, "rank": 0}
    with torch.no_grad():
        assert torch.equal(pred.run(x), layer(hg, x))
    with pytest.raises(RuntimeError, match="world of 2 ranks runs in one "
                       "of 1"):
        comm._all_to_all_op(x, 2)
    sub = torch.distributed.new_group([0])
    with pytest.raises(NotImplementedError, match="other than the world"):
        export_model(lambda x: comm.all_reduce_sum(x, sub), (x,),
                     str(tmp_path / "sub.pt2"))
    torch.distributed.destroy_process_group()
    with pytest.raises(RuntimeError, match="join one first"):
        Predictor(path)
    comm.init(backend="gloo", init_method=f"tcp://127.0.0.1:"
              f"{ranks.free_port()}", world_size=1, rank=0)


# -- two ranks: export, then serve in fresh processes -------------------------

RANK_N, RANK_F = 120, 8


def _rank_inputs(tmp):
    """The graph, features and the reference GCN's carried parameters."""
    rng = np.random.default_rng(11)
    edges = rng.integers(0, RANK_N, (900, 2))
    feat = rng.normal(size=(RANK_N, RANK_F)).astype(np.float32)
    jg = __import__("pgl_tpu").Graph(edges, num_nodes=RANK_N,
                                     node_feat={"h": feat}).tensor()
    jmodel = JGCN(RANK_F, C, hidden_size=16)
    params = jmodel.init(jax.random.key(0), jg, jg.node_feat["h"])
    sd = flax_to_state_dict(jax.tree.map(np.asarray, params), "cpu")
    np.savez(os.path.join(tmp, "inputs.npz"), N=RANK_N, EDGES=edges,
             FEAT=feat, **{f"sd/gcn/{k}": v.numpy() for k, v in sd.items()})
    return np.asarray(jmodel.apply(params, jg, jg.node_feat["h"]))


@pytest.fixture(scope="module")
def served_ranks():
    """Two gloo ranks export the halo GCN and the ``ShardedGraph`` GCN,
    then two fresh ranks serve the artifacts; the reference's logits."""
    with tempfile.TemporaryDirectory() as tmp:
        want = _rank_inputs(tmp)
        exported = ranks.finish(ranks.start("export", 2, tmp), tmp)
        served = ranks.finish(ranks.start("serve", 2, tmp), tmp)
        yield exported, served, want


@pytest.mark.parametrize("model", ["halo_gcn", "sharded_gcn"])
def test_two_ranks_serve_their_exports(served_ranks, model):
    """Each rank's served output equals its eager one bit for bit, and the
    unsharded eager output the reference's at 1e-5; each program calls K1
    and its collectives as ops; a rank refuses the other rank's
    artifact."""
    exported, served, want = served_ranks
    ops = {"halo_gcn": {"spmm": 4, "all_to_all": 2},
           "sharded_gcn": {"spmm": 2, "all_reduce": 2}}[model]
    for r in range(2):
        assert dict(zip(exported[f"{model}_op_names_{r}"],
                        exported[f"{model}_op_calls_{r}"])) == ops
        np.testing.assert_array_equal(served[f"{model}_served_{r}"],
                                      exported[f"{model}_eager_{r}"])
        assert served[f"{model}_refused_{r}"]
    np.testing.assert_allclose(exported[f"{model}_out"], want, rtol=1e-5,
                               atol=1e-5)
