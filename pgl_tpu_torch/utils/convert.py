"""Carry ``pgl_tpu`` (flax) parameters over to the port's ``state_dict``.

Takes the parameter tree as nested dicts of numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), so this module needs no JAX. A flax
``Dense`` kernel ``<path>/kernel`` of shape [in, out] becomes the
``nn.Linear`` weight ``<path>.weight`` of shape [out, in]; a ``LayerNorm``
``scale`` and an ``Embed`` ``embedding`` [num, features] become the
``weight`` of ``nn.LayerNorm`` and ``nn.Embedding``, shape kept; every other
leaf (``bias`` and friends) keeps its name and shape.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .. import resolve_device

__all__ = ["flax_to_state_dict"]


def _flatten(tree: Mapping, prefix: str = ""):
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
