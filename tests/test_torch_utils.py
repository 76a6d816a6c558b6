"""Port parity for the utilities (``pgl_tpu_torch/utils/``: ``checkpoint``,
``export``, ``profiler``, ``platform``) against ``tests/test_utils.py``'s
cases for ``pgl_tpu/utils/``.

Checkpoints and exported programs are exact: a restored state and a served
program give the same bits as the tensors and the eager model they came
from. A resumed training run's losses equal the uninterrupted run's bit
for bit. Where the reference checkpoints a mesh-sharded array, the port
saves one rank's shard on its device (a world of one, gloo, in this
process); where it exports a halo-sharded function with its collectives,
the port's rank exports its own shard's program, the halo exchange an op.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("flax")
import optax

from pgl_tpu.models import GCN as JGCN
from pgl_tpu.utils.checkpoint import CheckpointManager as JManager
from pgl_tpu.utils.export import Predictor as JPredictor
from pgl_tpu.utils.export import export_model as j_export_model
from pgl_tpu_torch import Graph
from pgl_tpu_torch.models import GCN
from pgl_tpu_torch.ops import softmax_cross_entropy_integer as ce
from pgl_tpu_torch.ops.kernels import segment_kernels as sk
from pgl_tpu_torch.utils import platform
from pgl_tpu_torch.utils.checkpoint import (CheckpointManager, load_pytree,
                                            save_pytree)
from pgl_tpu_torch.utils.convert import flax_to_state_dict
from pgl_tpu_torch.utils.export import Predictor, export_model, load_model
from pgl_tpu_torch.utils.logger import log
from pgl_tpu_torch.utils.profiler import StageTimer, annotate, trace

torch.set_num_threads(1)


def _small_graph(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 20, (60, 2)),
            rng.normal(size=(20, 8)).astype(np.float32))


@pytest.fixture
def world_of_one():
    import torch_parallel_ranks as ranks
    from pgl_tpu_torch.parallel import comm
    comm.init(backend="gloo", init_method=f"tcp://127.0.0.1:"
              f"{ranks.free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


# -- checkpoint ---------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """``tests/test_utils.py:81-104`` on both packages: one-shot save and
    load, then three steps kept two (step 1 dropped), the latest restored;
    the port's restore equals the reference's."""
    params = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3),
              "b": np.ones(3, np.float32)}
    jmgr = JManager(str(tmp_path / "ref"), max_to_keep=2)
    mgr = CheckpointManager(str(tmp_path / "mgr"), max_to_keep=2)
    for step in (1, 2, 3):
        jmgr.save(step, {"params": jax.tree.map(
            lambda x: jnp.asarray(x) * step, params), "step": step})
        mgr.save(step, {"params": {k: torch.as_tensor(v) * step
                                   for k, v in params.items()},
                        "step": step})
    assert mgr.latest_step() == jmgr.latest_step() == 3
    assert mgr.all_steps() == sorted(jmgr.all_steps()) == [2, 3]
    assert sorted(os.listdir(tmp_path / "mgr")) == ["2", "3"]
    want, got = jmgr.restore(), mgr.restore()
    jmgr.close()
    mgr.close()
    assert int(got["step"]) == int(want["step"]) == 3
    for k in params:
        np.testing.assert_array_equal(got["params"][k].numpy(),
                                      np.asarray(want["params"][k]))
    np.testing.assert_array_equal(mgr.restore(step=2)["params"]["b"].numpy(),
                                  2 * np.ones(3))

    tree = {"t": torch.arange(6.0).reshape(2, 3), "np": np.arange(4),
            "list": [1.5, torch.ones(2, dtype=torch.bfloat16)], "n": None}
    save_pytree(str(tmp_path / "one"), tree)
    save_pytree(str(tmp_path / "one"), tree)          # overwrites
    back = load_pytree(str(tmp_path / "one"))
    assert torch.equal(back["t"], tree["t"]) and back["n"] is None
    assert isinstance(back["np"], np.ndarray)
    np.testing.assert_array_equal(back["np"], tree["np"])
    assert back["list"][0] == 1.5 and back["list"][1].dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_checkpoint_restore_with_target(tmp_path):
    """With a target, each tensor comes back in the target's dtype (and on
    its device) and each numpy array in the target's dtype; without one,
    tensors come back on the CPU as saved."""
    state = {"w": torch.arange(4.0), "ids": np.arange(3, dtype=np.int64)}
    save_pytree(str(tmp_path / "ck"), state)
    target = {"w": torch.zeros(4, dtype=torch.float64),
              "ids": np.zeros(3, np.int32)}
    got = load_pytree(str(tmp_path / "ck"), target)
    assert got["w"].dtype == torch.float64 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"], torch.arange(4.0, dtype=torch.float64))
    assert got["ids"].dtype == np.int32
    assert load_pytree(str(tmp_path / "ck"))["w"].dtype == torch.float32


def test_checkpoint_resumes_training_bit_for_bit(tmp_path):
    """A GCN with Adam: 3 steps, a checkpoint of the model's and the
    optimizer's state dicts, a fresh model and optimizer restored from it,
    3 more steps: the losses equal 6 uninterrupted steps' bit for bit."""
    edges, feat = _small_graph()
    g = Graph(edges, num_nodes=20, node_feat={"h": feat}).tensor("cpu")
    y = torch.as_tensor(np.random.default_rng(1).integers(0, 3, 20))

    def trainer():
        model = GCN(8, 3, hidden_size=8, dropout=0.0, device="cpu")
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)

        def step():
            opt.zero_grad()
            loss = ce(model(g, g.node_feat["h"]), y).mean()
            loss.backward()
            opt.step()
            return float(loss)
        return model, opt, step

    _, _, step = trainer()
    want = [step() for _ in range(6)]
    model, opt, step = trainer()
    got = [step() for _ in range(3)]
    mgr = CheckpointManager(str(tmp_path / "mgr"), max_to_keep=2)
    mgr.save(3, {"model": model.state_dict(), "opt": opt.state_dict()})
    model, opt, step = trainer()
    state = mgr.restore(target={"model": model.state_dict()})
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["opt"])
    got += [step() for _ in range(3)]
    assert got == want


def test_checkpoint_sharded_halo_state(tmp_path, world_of_one):
    """``tests/test_utils.py:146-168``: the reference restores a
    mesh-sharded array with its sharding; the port's rank saves its own
    shard (a ``HaloGraph``'s ``[N_pad, D]`` feature rows) and restores it
    onto the shard's device and dtype from a target."""
    from pgl_tpu_torch.parallel import HaloGraph
    edges, feat = _small_graph()
    hg = HaloGraph.from_graph(Graph(edges, num_nodes=20,
                                    node_feat={"h": feat}), device="cpu")
    x = hg.node_feat["h"]
    save_pytree(str(tmp_path / "ck"), {"params": {"w": x},
                                       "step": torch.tensor(7)})
    target = {"params": {"w": torch.zeros_like(x)}, "step": torch.tensor(0)}
    got = load_pytree(str(tmp_path / "ck"), target)
    assert torch.equal(got["params"]["w"], x)
    assert int(got["step"]) == 7
    assert got["params"]["w"].device == x.device


# -- export -------------------------------------------------------------------

def test_export_roundtrip(tmp_path):
    """``tests/test_utils.py:31-55`` on both packages from the same
    parameters: the port's program, loaded back, equals its eager model bit
    for bit, and the reference's served logits at 1e-5; the graph's K1
    calls are the custom op, with the layouts as constants."""
    edges, feat = _small_graph()
    jg = __import__("pgl_tpu").Graph(edges, num_nodes=20,
                                     node_feat={"h": feat}).tensor()
    jmodel = JGCN(input_size=8, num_class=3, hidden_size=8, dropout=0.0)
    params = jmodel.init(jax.random.key(0), jg, jg.node_feat["h"])
    jpath = str(tmp_path / "ref.bin")
    j_export_model(lambda x: jmodel.apply(params, jg, x),
                   [jg.node_feat["h"]], jpath)
    want = np.asarray(JPredictor(jpath).run(jg.node_feat["h"]))

    g = Graph(edges, num_nodes=20, node_feat={"h": feat}).tensor("cpu")
    model = GCN(8, 3, hidden_size=8, dropout=0.0, device="cpu")
    model.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params), "cpu"))
    x = g.node_feat["h"]
    path = str(tmp_path / "model.pt2")
    program = export_model(lambda x: model(g, x), [x], path)
    assert os.path.getsize(path) > 0
    calls = [n for n in program.graph.nodes
             if n.op == "call_function" and "pgl_tpu_torch" in str(n.target)]
    assert len(calls) == 2                     # one K1 a layer
    with torch.no_grad():
        eager = model(g, x)
    sk.reset_launches()
    out = Predictor(path).run(x)
    assert torch.equal(out, eager)
    assert torch.equal(load_model(path).module()(x), eager)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    assert sk.LAUNCHES == 0                    # the CPU runs no kernel


def test_export_halo_sharded_inference(tmp_path, world_of_one):
    """``tests/test_utils.py:171-201`` on both packages from the same
    parameters: a halo-sharded GCN layer exports with its halo exchange
    (the op ``pgl_tpu_torch::all_to_all``) and K1's calls, and serves
    through ``Predictor``; the served output equals the eager layer's bit
    for bit, and unsharded the reference's served output at its rtol 1e-5,
    atol 1e-6. The reference exports one program over its mesh; the port's
    rank exports its own shard's (a world of one here)."""
    from jax.sharding import Mesh
    from pgl_tpu.nn import GCNConv as JGCNConv
    from pgl_tpu.parallel import HaloGraph as JHaloGraph
    from pgl_tpu_torch.nn import GCNConv
    from pgl_tpu_torch.parallel import HaloGraph
    from pgl_tpu_torch.utils.export import op_calls
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 64, (200, 2))
    feat = rng.normal(size=(64, 8)).astype(np.float32)
    jg = __import__("pgl_tpu").Graph(edges, num_nodes=64,
                                     node_feat={"h": feat})
    jhg = JHaloGraph.from_graph(jg, Mesh(np.array(jax.devices()), ("node",)))
    jx = jhg.shard_node_values(feat)
    jlayer = JGCNConv(input_size=8, output_size=4)
    params = jlayer.init(jax.random.key(0), jhg, jx)
    jpath = str(tmp_path / "halo_model.bin")
    j_export_model(lambda x: jlayer.apply(params, jhg, x), (jx,), jpath)
    want = jhg.unshard_node_values(JPredictor(jpath).run(jx))

    hg = HaloGraph.from_graph(Graph(edges, num_nodes=64,
                                    node_feat={"h": feat}), device="cpu")
    layer = GCNConv(8, 4, device="cpu")
    layer.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params), "cpu"))
    x = hg.node_feat["h"]
    path = str(tmp_path / "halo.pt2")
    program = export_model(lambda x: layer(hg, x), (x,), path)
    assert op_calls(program) == {"spmm": 2, "all_to_all": 1}
    out = Predictor(path).run(x)
    with torch.no_grad():
        assert torch.equal(out, layer(hg, x))
    np.testing.assert_allclose(hg.unshard_node_values(out), want,
                               rtol=1e-5, atol=1e-6)


# -- profiler and platform ----------------------------------------------------

def test_stage_timer(caplog):
    """Totals and counts by stage (``sync_value`` waits on its device: a
    CPU tensor needs nothing), the reference's log line, and ``reset``."""
    timer = StageTimer()
    with timer.stage("a"):
        x = torch.ones(10) * 2
    with timer.stage("a", sync_value={"x": [x]}):
        x = x + 1
    with timer.stage("b"):
        pass
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=log.name):
            totals = timer.report(reset=True)
    finally:
        log.removeHandler(caplog.handler)
    assert set(totals) == {"a", "b"} and totals["a"] > 0
    assert timer.counts == {} and timer.totals == {}
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2 and lines[0].startswith("stage a ")
    assert "calls      2" in lines[0]


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` profiles its block and writes a Chrome trace naming the
    annotated range and the operators."""
    with trace(str(tmp_path / "prof")):
        with annotate("my_stage"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    text = (tmp_path / "prof" / files[0]).read_text()
    assert "my_stage" in text and "aten::mm" in text


@pytest.mark.parametrize("env,default,want", [
    ("cpu", None, "cpu"), ("CPU", None, "cpu"), (None, "cpu", "cpu"),
    ("cuda", None, RuntimeError), ("gpu", None, RuntimeError),
    (None, None, RuntimeError), ("tpu", None, ValueError)])
def test_select_platform(monkeypatch, env, default, want):
    """``PGL_TPU_PLATFORM`` (else ``default``) picks the device; cuda, gpu
    and unset mean the card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if env is None:
        monkeypatch.delenv("PGL_TPU_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("PGL_TPU_PLATFORM", env)
    if isinstance(want, str):
        assert platform.select_platform(default) == torch.device(want)
    else:
        with pytest.raises(want):
            platform.select_platform(default)
