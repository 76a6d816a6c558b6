"""Device selection for the scripts (port of ``pgl_tpu/utils/platform.py``).

The reference's ``select_platform()`` sets JAX's platform from the
``PGL_TPU_PLATFORM`` environment variable. Here it reads the same
variable and returns the ``torch.device`` the script should use, through
:func:`pgl_tpu_torch.resolve_device`: ``cpu``, ``cuda`` or ``gpu`` (the
same card); unset (and no ``default``), the card, raising when there is
none.
"""

import os

import torch

from .. import resolve_device

__all__ = ["select_platform"]

_NAMES = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def select_platform(default=None) -> torch.device:
    """The device named by ``PGL_TPU_PLATFORM`` (else ``default``; None
    means the CUDA card)."""
    plat = os.environ.get("PGL_TPU_PLATFORM") or default
    if plat is None:
        return resolve_device(None)
    name = str(plat).lower()
    if name not in _NAMES:
        raise ValueError(f"PGL_TPU_PLATFORM={plat!r}: choose cpu, cuda or "
                         "gpu")
    return resolve_device(_NAMES[name])
