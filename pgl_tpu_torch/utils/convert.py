"""Carry ``pgl_tpu`` (flax) parameters over to the port's ``state_dict``.

Takes the parameter tree as nested dicts of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), so this module needs no JAX. A flax
``Dense`` kernel ``<path>/kernel`` of shape [in, out] becomes the
``nn.Linear`` weight ``<path>.weight`` of shape [out, in]; a ``LayerNorm``
``scale`` and an ``Embed`` ``embedding`` [num, features] become the
``weight`` of ``nn.LayerNorm`` and ``nn.Embedding``, shape kept; every other
leaf (``bias`` and friends) keeps its name and shape. So a model whose
submodules carry flax's names takes the tree as it is: ``BipartiteSAGE``'s
``self_{l}`` and ``neigh_{l}`` Denses become its ``nn.Linear`` layers of
the same names.

A flax ``OptimizedLSTMCell`` at ``<path>`` (eight Denses: ``ii``, ``if``,
``ig``, ``io`` without bias on the input, ``hi``, ``hf``, ``hg``, ``ho``
with bias on the hidden state) becomes the ``nn.LSTMCell`` at ``<path>``:
``weight_ih`` and ``weight_hh`` stack the transposed kernels in torch's
gate order (i, f, g, o), ``bias_hh`` the hidden biases, and ``bias_ih`` is
0 (``nn/aggregation.py``'s cells keep it there).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .. import resolve_device

__all__ = ["flax_to_state_dict"]


_GATES = "ifgo"


def _lstm_cell(cell: Mapping):
    """An ``OptimizedLSTMCell``'s eight Denses as ``nn.LSTMCell``'s four
    parameters (numpy)."""
    def stack(side, leaf):
        return np.concatenate([np.asarray(cell[side + g][leaf]).T
                               for g in _GATES])
    bias_hh = np.concatenate([np.asarray(cell["h" + g]["bias"])
                              for g in _GATES])
    return {"weight_ih": stack("i", "kernel"),
            "weight_hh": stack("h", "kernel"), "bias_ih":
            np.zeros_like(bias_hh), "bias_hh": bias_hh}


def _flatten(tree: Mapping, prefix: str = ""):
    if set(tree) == {side + g for side in "ih" for g in _GATES}:
        for leaf, array in _lstm_cell(tree).items():
            yield f"{prefix}.{leaf}" if prefix else leaf, array
        return
    for name, value in tree.items():
        path = f"{prefix}.{name}" if prefix else str(name)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def flax_to_state_dict(params: Mapping,
                       device=None) -> Dict[str, torch.Tensor]:
    """``state_dict`` on ``device`` (default: the CUDA card) for a flax
    parameter tree; a top-level ``{"params": ...}`` wrapper is unwrapped."""
    device = resolve_device(device)
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, value in _flatten(params):
        array = np.asarray(value)
        head, _, leaf = path.rpartition(".")
        if leaf == "kernel" and array.ndim == 2:
            leaf, array = "weight", array.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        path = f"{head}.{leaf}" if head else leaf
        out[path] = torch.tensor(array, device=device)
    return out
