"""pgl_tpu_torch — the PyTorch/CUDA port of ``pgl_tpu``.

Mirrors ``pgl_tpu``'s layout module for module, with torch tensors and
autograd where ``pgl_tpu`` uses JAX arrays, flax and ``custom_vjp``. Every
Pallas kernel of the ported paths has a counterpart written by hand for
Hopper (``sm_90a``) under ``ops/kernels/``; beside each sits the plain
PyTorch version that CPU tensors run.

This package imports torch and numpy only: never jax, flax, optax or
anything under ``pgl_tpu``.

Entry points put data on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit device they raise (see
:func:`resolve_device`).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "Graph", "BiGraph", "HeterGraph", "Message",
           "math", "ops", "nn", "utils", "sampling", "datasets", "models",
           "partition", "native"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point should use.

    ``None`` means the CUDA card, and raises when there is none: there is
    no silent "cuda if available, else cpu". Pass ``device="cpu"`` to run
    the plain PyTorch versions on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


# the submodules import resolve_device from here: bind it first
from .graph import Graph  # noqa: E402
from .bigraph import BiGraph  # noqa: E402
from .heter_graph import HeterGraph  # noqa: E402
from .message import Message  # noqa: E402
from . import math  # noqa: E402
from . import ops  # noqa: E402
from . import nn  # noqa: E402
from . import utils  # noqa: E402
from . import sampling  # noqa: E402
from . import datasets  # noqa: E402
from . import models  # noqa: E402
from . import partition  # noqa: E402
from . import native  # noqa: E402
