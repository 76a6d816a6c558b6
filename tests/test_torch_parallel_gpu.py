"""The parallel port on the card: two gloo ranks share ``cuda:0`` and run
a halo GCN and GAT (K1 over the shard layouts and the exchange's backward,
K9/K10 over the unified source table), held against the single-graph port
on the same card with the same weights at ``chip_smoke.check``'s
``1e-4 * max(1, |x|)``; the feature gradient has the same bits on two runs.

Needs a CUDA card: skips with a reason without one; on the card, ``pytest
-m gpu tests/test_torch_parallel_gpu.py``. Imports neither JAX nor
``pgl_tpu``.
"""

import tempfile

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from chip_smoke import check
from chip_smoke import skewed_graph

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def card_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "pytest -m gpu tests/test_torch_parallel_gpu.py)")
    from pgl_tpu_torch.ops.kernels import _build
    _build.build("segment_kernels", "attention_kernels")
    rng = np.random.default_rng(3)
    n = 3000
    inputs = dict(N=n, EDGES=skewed_graph(n, 40000, seed=4),
                  FEAT=rng.normal(size=(n, 16)).astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/inputs.npz", **inputs)
        yield ranks.finish(ranks.start("gpu", 2, tmp), tmp, timeout=600)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_two_rank_halo_model_on_the_card(card_runs, name):
    res = card_runs
    t = torch.as_tensor
    check(f"{name} out", t(res[f"{name}_out"]), t(res[f"{name}_one_out"]))
    check(f"{name} grad x", t(res[f"{name}_grad_x_0"]),
          t(res[f"{name}_one_grad_x"]))
    np.testing.assert_array_equal(res[f"{name}_grad_x_0"],
                                  res[f"{name}_grad_x_1"])
    names = [k[len(name) + 10:] for k in res
             if k.startswith(f"{name}_one_grad/")]
    assert names
    for k in names:
        check(f"{name} grad {k}", t(res[f"{name}_grad/{k}"]),
              t(res[f"{name}_one_grad/{k}"]))
    for r in range(2):
        assert int(res[f"{name}_k1_{r}"]) > 0
        assert (int(res[f"{name}_attn_{r}"]) > 0) == (name == "gat")
