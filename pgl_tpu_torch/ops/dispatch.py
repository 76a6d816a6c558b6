"""Which implementation a message-passing reduction runs.

Port of ``pgl_tpu/ops/dispatch.py:22-59`` and of the dedup selection rule
of ``pgl_tpu/graph.py:580-637``. For a kernel, the rule is the tensor's
device and nothing else: a CUDA tensor goes to the Hopper kernel, a CPU
tensor to the kernel's plain PyTorch version. The reference's edge
threshold (``_MIN_EDGES``, for K1 and the attention alike) and its lane
padding to 128 are TPU matters and are not carried over. Its dtype gate
(``pgl_tpu/ops/dispatch.py:29-30``: float32 and bfloat16 to the kernel,
every other dtype to the segment path) is :func:`plain_on_cuda` for
integers, float16 and float64, which ``Graph`` and the layers read to
route such a CUDA tensor to the plain path. Each wrapper names the dtypes
its kernel takes and raises on any other: float32 and bf16 at K1
(:func:`use_spmm_kernel`), K1w (:func:`use_weighted_spmm_kernel`), the
per-edge attention K9/K10 (:func:`use_attention_kernel`), the dedup SpMM
K5/K6 (:func:`use_dedup_kernel`; K4 reads no feature) and the count-matrix
attention K7/K8 (:func:`use_dedup_attention_kernel`), whose bf16
instantiations load bf16 tables, compute in float32 and round each stored
value once; float32 only at K11 (:func:`use_sddmm_kernel`), whose reference
kernel takes float32 alone (its float32 scratch,
``pgl_tpu/ops/pallas/sddmm_kernels.py:397-398``, takes no bf16 rows), so a
bf16 tensor on the card raises there. Nothing casts a bf16 tensor to
float32 to reach a kernel. :func:`traced` tells a wrapper that
``torch.export`` or ``torch.compile`` is tracing it.

Which SpMM family a graph uses is decided once, at ``Graph.tensor()`` time,
from the module constants below (read there, so tests and ``chip_smoke.py``
may set them before building a graph). The band, ratio and counts gates
were set on a TPU and are carried from the reference until a card
measurement sets them; ``DEDUP`` itself was set on the card.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = ["plain_on_cuda", "use_spmm_kernel", "use_weighted_spmm_kernel",
           "use_dedup_kernel", "fused_attention_graph",
           "use_attention_kernel", "use_dedup_attention_kernel",
           "use_sddmm_kernel", "traced", "DEDUP",
           "DEDUP_MIN_EDGES", "DEDUP_MAX_EDGES",
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


def plain_on_cuda(*tensors) -> bool:
    """True where one of ``tensors`` (None ignored) lies on the card as a
    tensor of a dtype the reference sends to its segment path: integer (or
    bool), float16 or float64. ``Graph`` and the layers then take the plain
    path (the segment path, the edge-space attention) with the tensors that
    the kernel wrappers would have received. A float32 or bf16 CUDA tensor
    reaches the wrapper, which launches its kernel or (bf16 at K11, the one
    kernel without a bf16 instantiation) raises, and a CPU tensor runs the
    wrapper's plain version."""
    return any(t is not None and t.device.type == "cuda"
               and t.dtype not in (torch.float32, torch.bfloat16)
               for t in tensors)


def _use_kernel(tensor: torch.Tensor, what: str,
                dtypes=(torch.float32,)) -> bool:
    kind = tensor.device.type
    if kind == "cpu":
        return False
    if kind != "cuda":
        raise ValueError(f"no {what} for device {tensor.device}")
    if tensor.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(
            f"the CUDA {what} takes {names} features, got {tensor.dtype}")
    return True


def use_spmm_kernel(feature: torch.Tensor) -> bool:
    """True to launch the CUDA SpMM (K1, float32 or bf16), False to run its
    plain version.

    Raises for a CUDA tensor of a dtype the kernel does not take, and for
    any device other than CUDA or the CPU.
    """
    return _use_kernel(feature, "SpMM", (torch.float32, torch.bfloat16))


def use_weighted_spmm_kernel(feature: torch.Tensor) -> bool:
    """True to launch the CUDA weighted SpMM (K1w, float32 or bf16), False
    to run its plain version; raises as :func:`use_spmm_kernel` does."""
    return _use_kernel(feature, "weighted SpMM",
                       (torch.float32, torch.bfloat16))


def use_dedup_kernel(feature: torch.Tensor) -> bool:
    """True to launch the CUDA dedup SpMM (K5/K6, float32 or bf16), False
    to run its plain version; raises as :func:`use_spmm_kernel` does."""
    return _use_kernel(feature, "dedup SpMM",
                       (torch.float32, torch.bfloat16))


def fused_attention_graph(graph) -> bool:
    """True where ``graph`` has the attention kernels' work lists (a
    ``Graph``); False for a ``BiGraph``, whose source and destination
    spaces differ, so the attention layers take their unfused path on it
    (``pgl_tpu/ops/dispatch.py:51-55``)."""
    return hasattr(graph, "_attention_layouts")


def use_attention_kernel(tensor: torch.Tensor) -> bool:
    """True to launch the CUDA per-edge attention kernels (K9/K10, float32
    or bf16), False to run their plain versions; raises as
    :func:`use_spmm_kernel` does (the port of ``use_fused_attention``,
    whose other gates are the TPU's)."""
    return _use_kernel(tensor, "attention", (torch.float32, torch.bfloat16))


def use_dedup_attention_kernel(tensor: torch.Tensor) -> bool:
    """True to launch the CUDA count-matrix attention kernels (K7/K8,
    float32 or bf16), False to run their plain versions; raises as
    :func:`use_spmm_kernel` does."""
    return _use_kernel(tensor, "count-matrix attention",
                       (torch.float32, torch.bfloat16))


def use_sddmm_kernel(tensor: torch.Tensor) -> bool:
    """True to launch the CUDA SDDMM (K11, float32 only: the reference's
    kernel raises on bf16), False to run its plain version; raises as
    :func:`use_spmm_kernel` does. The reference's other gate, the TPU
    backend (``pgl_tpu/graph.py:458``), is the device here."""
    return _use_kernel(tensor, "SDDMM")


def traced(tensor: torch.Tensor) -> bool:
    """True while ``torch.export`` or ``torch.compile`` traces the call
    that received ``tensor`` (a fake stand-in, or dynamo's): no kernel can
    be launched on it, nor a collective run."""
    return torch.compiler.is_compiling() or is_fake(tensor)
