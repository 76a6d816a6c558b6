"""Mixed-precision helpers for bf16 training on the card (port of
``pgl_tpu/utils/amp.py``).

K1, the SpMM behind every sum and mean, K1w behind ``send_ue_recv``, the
dedup SpMM K5/K6 (and the weighted K6) on a graph with dedup layouts, and
the attention kernels behind ``GATConv`` and ``TransformerConv``, per edge
(K9/K10) and per count-matrix cell (K7/K8), take bf16 tables
(``ops/kernels/``: f32 arithmetic, each stored value rounded once), so the
recipe is the reference's: parameters and activations in bf16, the master
weights, the optimizer's state and the loss in float32. Only K11
(``Graph.sddmm_csc``) takes float32 alone, as the reference's kernel
does.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["to_bf16", "to_f32", "bf16_params_policy"]


def _map_leaves(tree: Any, fn: Callable) -> Any:
    """``tree`` (a tensor, or nested dicts, lists and tuples of them: a
    state dict too) with ``fn`` applied to each tensor; other leaves as
    they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_leaves(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return tree


def _cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of ``tree`` cast to ``dtype``, differentiably
    (a gradient flows back to the original tensors)."""
    return _map_leaves(tree, lambda t: t.to(dtype) if t.is_floating_point()
                       else t)


def to_bf16(tree: Any) -> Any:
    """Cast every floating leaf to bfloat16 (ints/bools untouched)."""
    return _cast_floats(tree, torch.bfloat16)


def to_f32(tree: Any) -> Any:
    """Cast every floating leaf to float32."""
    return _cast_floats(tree, torch.float32)


def bf16_params_policy(loss_fn: Callable) -> Callable:
    """Wrap ``loss_fn(params, *args, **kwargs)``, which returns a scalar
    loss tensor: the wrapped function evaluates it at bf16 copies of the
    float32 master parameters ``params`` (a tensor, or nested dicts, lists
    and tuples of them, e.g. ``dict(model.named_parameters())`` for
    ``torch.func.functional_call``) and returns ``(loss, grads)``, the
    gradients float32, shaped as ``params``. The gradient flows back
    through the casts, so each master that requires grad also gets it in
    ``.grad``, accumulated as ``backward`` does, for a ``torch.optim``
    optimizer over the masters (whose state stays float32).

    >>> params = dict(model.named_parameters())
    >>> loss, grads = bf16_params_policy(
    ...     lambda p: ce(functional_call(model, p, (g, x)), y))(params)
    >>> opt.step()
    """
    def wrapped(params, *args, **kwargs):
        loss = loss_fn(to_bf16(params), *args, **kwargs)
        masters = []
        _map_leaves(params, masters.append)
        masters = [p for p in masters
                   if p.is_floating_point() and p.requires_grad]
        loss.backward(inputs=masters)
        grads = _cast_floats(
            _map_leaves(params, lambda p: p.grad if p.grad is not None
                        else torch.zeros_like(p)), torch.float32)
        return loss.detach(), grads
    return wrapped

