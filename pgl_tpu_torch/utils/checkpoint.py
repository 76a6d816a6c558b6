"""Checkpoint / resume (port of ``pgl_tpu/utils/checkpoint.py``; reference:
``paddle.save/load`` state dicts in every example, PGLBox ``save_model`` +
warm start).

Trees of training state (nested dicts, lists and tuples of tensors, numpy
arrays and Python scalars: a model's and an optimizer's ``state_dict``, a
step counter) saved with ``torch.save`` into a directory, where the
reference writes orbax checkpoints; ``CheckpointManager`` keeps the newest
``max_to_keep`` steps as the reference's does. Numpy arrays are stored as
tensors beside a marker and come back as numpy arrays, so a checkpoint
loads with ``weights_only=True``.

A sharded state is each rank's own: every rank saves and restores the
shard on its device (the reference restores a mesh-sharded array with its
sharding from one checkpoint).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]

_FILE = "tree.pt"
_NDARRAY = "__ndarray__"


def _encode(tree: Any) -> Any:
    if isinstance(tree, np.ndarray):
        return {_NDARRAY: torch.from_numpy(np.ascontiguousarray(tree))}
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return type(tree)((k, _encode(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_encode(v) for v in tree)
    return tree


def _decode(tree: Any, target: Any) -> Any:
    """The saved ``tree`` with numpy arrays back; where ``target`` (same
    structure, or None) has a tensor, the saved one on its device and in
    its dtype, where it has a numpy array, one of its dtype."""
    if isinstance(tree, dict) and set(tree) == {_NDARRAY}:
        array = tree[_NDARRAY].numpy()
        if isinstance(target, np.ndarray):
            array = array.astype(target.dtype, copy=False)
        return array
    if isinstance(tree, torch.Tensor):
        if isinstance(target, torch.Tensor):
            return tree.to(device=target.device, dtype=target.dtype)
        return tree
    if isinstance(tree, dict):
        sub = target if isinstance(target, dict) else {}
        return type(tree)((k, _decode(v, sub.get(k)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        sub = (target if isinstance(target, (list, tuple))
               and len(target) == len(tree) else [None] * len(tree))
        return type(tree)(_decode(v, t) for v, t in zip(tree, sub))
    return tree


def save_pytree(path: str, tree: Any):
    """One-shot save of ``tree`` into the directory ``path``, replacing
    what it held."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_encode(tree), os.path.join(tmp, _FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_pytree(path: str, target: Optional[Any] = None) -> Any:
    """The tree saved in ``path``: its tensors on the CPU, or, given a
    ``target`` of the same structure, on each target tensor's device and in
    its dtype."""
    tree = torch.load(os.path.join(os.path.abspath(path), _FILE),
                      map_location="cpu", weights_only=True)
    return _decode(tree, target)


class CheckpointManager:
    """Step-indexed training checkpoints with retention.

    >>> mgr = CheckpointManager(dir, max_to_keep=3)
    >>> mgr.save(step, {"model": model.state_dict(),
    ...                 "opt": opt.state_dict()})
    >>> state = mgr.restore()            # latest
    >>> state = mgr.restore(step=100)
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: Any):
        """Save ``state`` as ``step``, then drop all but the newest
        ``max_to_keep`` steps (None: keep every step)."""
        save_pytree(self._path(step), state)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)

    def restore(self, step: Optional[int] = None,
                target: Optional[Any] = None) -> Any:
        """The state saved at ``step`` (default: the latest), as
        :func:`load_pytree` gives it; ``FileNotFoundError`` when there is
        none."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoints found")
        if not os.path.exists(os.path.join(self._path(step), _FILE)):
            raise FileNotFoundError(f"no checkpoint of step {step} in "
                                    f"{self.directory}")
        return load_pytree(self._path(step), target)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The saved steps, ascending."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, _FILE)))

    def close(self):
        """Nothing to release: every save is finished when it returns."""
