"""Which implementation a message-passing reduction runs.

Port of ``pgl_tpu/ops/dispatch.py:22-59`` and of the dedup selection rule
of ``pgl_tpu/graph.py:580-637``. For a kernel, the rule is the tensor's
device and nothing else: a CUDA tensor goes to the Hopper kernel, a CPU
tensor to the kernel's plain PyTorch version. The reference's edge
threshold (``_MIN_EDGES``, for K1 and the attention alike) and its lane
padding to 128 are TPU matters and are not carried over.

Which SpMM family a graph uses is decided once, at ``Graph.tensor()`` time,
from the module constants below (read there, so tests and ``chip_smoke.py``
may set them before building a graph). The band, ratio and counts gates
were set on a TPU and are carried from the reference until a card
measurement sets them; ``DEDUP`` itself was set on the card.
"""

from __future__ import annotations

import torch

__all__ = ["use_spmm_kernel", "use_attention_kernel", "use_sddmm_kernel",
           "DEDUP", "DEDUP_MIN_EDGES", "DEDUP_MAX_EDGES",
           "DEDUP_MAX_RATIO", "COUNTS_MAX", "COUNTS_BUDGET_BYTES"]

# Build the unique-source ("dedup") layouts and run K5/K6 for sum and mean
# on graphs that pass the gates below; False runs K1 on every graph (the
# reference's PGL_TPU_DEDUP=0, pgl_tpu/graph.py:581). Set by the SpMM
# device time per step of the bench headline GCN, whose graph passes every
# gate (chip_smoke.py, H100 80GB HBM3, power limit 700.00 W): K1 0.658 ms
# over 5 launches, the dedup path 2.988 ms (K5; K6 2.810 ms). The dense
# float32 apply of K5/K6 does 2*256*128*D operations a pair though 1.6% of
# the count cells are nonzero there; decide again once it skips them.
DEDUP = False

# Edge band of the dedup layouts (pgl_tpu/graph.py:582-584; set on a TPU).
DEDUP_MIN_EDGES = 262_144
DEDUP_MAX_EDGES = 64 * 1024 * 1024

# Largest padded unique-source ratio (unique rows padded to 128-row
# windows, over edges) for which the dedup layouts are built
# (pgl_tpu/graph.py:597; set on a TPU as the break-even of its A/B sweep).
DEDUP_MAX_RATIO = 0.55

# bf16 holds a count exactly up to 256: above that multiplicity the counts
# are not cached and every call rebuilds them (K6)
# (pgl_tpu/ops/pallas/dedup_kernels.py:601).
COUNTS_MAX = 256

# Bytes the cached count matrices of both layouts may take on the device
# (PGL_TPU_COUNTS_BUDGET_MB=512, pgl_tpu/graph.py:621; set on a TPU). Over
# it, the dedup SpMM runs K6.
COUNTS_BUDGET_BYTES = 512_000_000


def _use_kernel(tensor: torch.Tensor, what: str) -> bool:
    kind = tensor.device.type
    if kind == "cpu":
        return False
    if kind != "cuda":
        raise ValueError(f"no {what} for device {tensor.device}")
    if tensor.dtype != torch.float32:
        raise TypeError(
            f"the CUDA {what} takes float32 features, got {tensor.dtype}")
    return True


def use_spmm_kernel(feature: torch.Tensor) -> bool:
    """True to launch the CUDA SpMM, False to run its plain version.

    Raises for a CUDA tensor of a dtype the kernel does not take, and for
    any device other than CUDA or the CPU.
    """
    return _use_kernel(feature, "SpMM")


def use_attention_kernel(tensor: torch.Tensor) -> bool:
    """True to launch the CUDA attention kernels (K9/K10), False to run
    their plain versions; raises as :func:`use_spmm_kernel` does (the port
    of ``use_fused_attention``, whose other gates are the TPU's)."""
    return _use_kernel(tensor, "attention")


def use_sddmm_kernel(tensor: torch.Tensor) -> bool:
    """True to launch the CUDA SDDMM (K11), False to run its plain version;
    raises as :func:`use_spmm_kernel` does. The reference's other gate, the
    TPU backend (``pgl_tpu/graph.py:458``), is the device here."""
    return _use_kernel(tensor, "SDDMM")
