"""Helpers of the ``examples_torch/`` parity tests: each reference
script under ``examples/`` and its port under ``examples_torch/`` imported
by path, and the comparisons (``close``: the largest error within ``tol``
of the largest magnitude)."""

import functools
import importlib.util
import math
import pathlib
import threading

import numpy as np
import pytest
import torch

import jax

from pgl_tpu_torch.utils.convert import flax_to_state_dict

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def ref(rel):
    """The reference script ``examples/<rel>`` as a module."""
    return _load(ROOT / "examples" / rel, "ref_")


@functools.lru_cache(maxsize=None)
def port(rel):
    """Its port ``examples_torch/<rel>`` as a module."""
    return _load(ROOT / "examples_torch" / rel, "port_")


def _load(path, prefix):
    name = prefix + "_".join(path.relative_to(ROOT).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol=TOL, floor=1e-6):
    """|got - want| <= tol · max(floor, max |want|), elementwise."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), floor)
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    assert err <= tol * scale, f"max error {err} > {tol} x {scale}"


def same_graph(a, b):
    np.testing.assert_array_equal(np.asarray(a.edges), np.asarray(b.edges))
    assert a.num_nodes == b.num_nodes
    assert sorted(a.node_feat) == sorted(b.node_feat)
    for k in a.node_feat:
        np.testing.assert_array_equal(np.asarray(a.node_feat[k]),
                                      np.asarray(b.node_feat[k]))


def close_grads(module, grads):
    """The port module's parameter gradients against the reference's flax
    gradient tree. Each is held to its own largest magnitude or the
    module's largest gradient, whichever is larger: a gradient that
    cancels to 0 (a key bias under a softmax, say) sums terms of the
    module's scale, and float32 leaves an error of that scale. Frozen
    parameters (an LSTM cell's input bias, which flax does not have) have
    none."""
    want = flax_to_state_dict(numpy_tree(grads), "cpu")
    got = dict(module.named_parameters())
    assert sorted(got) == sorted(want)
    floor = max(float(w.abs().max()) for w in want.values())
    for name, p in got.items():
        if p.requires_grad:
            close(p.grad, want[name], floor=floor)
        else:
            assert not want[name].any(), name


# -- end-to-end runs ----------------------------------------------------------

@pytest.fixture
def run(monkeypatch, capsys):
    """``run(rel, *argv)``: the port's ``main`` on the CPU; returns (its
    printed output, its result dict). Ranks it starts get one thread."""
    monkeypatch.setenv("PGL_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def call(rel, *argv):
        capsys.readouterr()
        result = port(rel).main(list(argv))
        return capsys.readouterr().out, result

    return call


def bounded(call, rel, *argv, timeout=120.0):
    """``call(rel, *argv)`` in a thread joined with ``timeout``: a script
    whose Dataloader forks workers (as ``tests/test_torch_data.py`` bounds
    its worker tests) fails here instead of hanging the run."""
    got = {}

    def body():
        try:
            got["value"] = call(rel, *argv)
        except BaseException as e:  # noqa: B902 (re-raised below)
            got["error"] = e

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"{rel} did not finish in {timeout} s"
    if "error" in got:
        raise got["error"]
    return got["value"]


def finite_loss(result):
    assert math.isfinite(result["loss_last"]), result
    assert math.isfinite(result["loss_first"]), result


# -- the reference's smoke runs (tests/test_examples.py) ----------------------
