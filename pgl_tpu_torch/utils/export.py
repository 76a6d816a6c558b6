"""Model export / serving (port of ``pgl_tpu/utils/export.py``; reference:
``examples/gnn_depoly`` — ``paddle.jit.to_static`` + InputSpec export and
``paddle.inference`` serving, ``export_model.py:58-83`` /
``python_deploy.py:26-44``).

``torch.export`` traces the closed inference function into an
``ExportedProgram`` saved as one ``.pt2`` file; the graph's layouts and the
model's weights become the program's constants. Every forward kernel is a
custom op that the program calls by name, its CUDA implementation the
launch of the hand-written kernel and its CPU one the plain version:
``torch.ops.pgl_tpu_torch.spmm`` (K1), ``::spmm_weighted`` (K1w),
``::spmm_dedup`` (K5, K6 and the weighted K6), ``::gat_attention`` and
``::dot_attention`` (K9), ``::dedup_gat_attention`` and
``::dedup_dot_attention`` (K7) and ``::sddmm`` (K11); the halo exchange's
all-to-all and the all-reduces are ``::all_to_all`` and ``::all_reduce``
(``parallel/comm.py``). Loading a program needs those ops registered:
this module imports every module that registers one (the reference's
StableHLO artifact carries its kernels inside).

:func:`export_model` first calls the function once, eagerly and without
gradients: that builds what a graph builds on its first call from host
arrays (the attention kernels' work lists, the count-matrix cells, the
SDDMM's slots, a ``HaloGraph``'s attention layouts), which a trace cannot
do, and loads the kernels' libraries. A program with collectives records
the world size and this rank; :class:`Predictor` raises unless it runs in
a process group of that size, on that rank. Departures from the
reference: its program is one SPMD program over the mesh, with the
shards' layouts as its inputs' shardings; here every rank of the group
exports its own artifact (its shard's layouts are the program's
constants) and serves it on the same rank of a world of the same size.
Collectives on a group other than the world do not export
(``NotImplementedError`` at the trace).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Sequence

import torch
import torch.distributed as dist

# every module that registers a custom op, so that a program loads
from ..ops.kernels import (attention_kernels, dedup_attention,  # noqa: F401
                           dedup_kernels, sddmm_kernels, segment_kernels)
from ..parallel import comm  # noqa: F401

__all__ = ["export_model", "load_model", "Predictor", "op_calls"]

# the artifact's record of the world its collectives ran in
_META = "pgl_tpu_torch.json"
_COLLECTIVES = ("all_to_all", "all_reduce")


class _Closed(torch.nn.Module):
    """A closed function as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def op_calls(program) -> dict:
    """``{op name: calls}`` of the ``pgl_tpu_torch`` ops in ``program``'s
    graph (``"spmm"``, ``"gat_attention"``, ``"all_to_all"``, ...)."""
    out = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(
                "pgl_tpu_torch."):
            name = str(node.target).split(".")[1]
            out[name] = out.get(name, 0) + 1
    return out


def export_model(fn: Callable, example_args: Sequence, path: str):
    """Export ``fn`` traced at ``example_args`` to ``path`` and return the
    ``ExportedProgram``.

    ``fn`` must be a closed inference function (model and graph captured),
    e.g. ``lambda x: model(graph, x)``; it is called once eagerly, then
    traced, both without gradients, on the devices of its captured tensors
    and of ``example_args``. For a function that runs collectives every
    rank of the world calls this together, each with its own ``path``.
    """
    example_args = tuple(example_args)
    with torch.no_grad():
        fn(*example_args)           # builds the lazy layouts (module doc)
        program = torch.export.export(_Closed(fn), example_args,
                                      strict=False)
    # own copies of the constants: torch.export.save cannot write a view
    # of a larger buffer (a packed layout's arrays) or an empty one
    for name, value in list(program.constants.items()):
        if isinstance(value, torch.Tensor):
            program.constants[name] = value.clone()
    # no copy of the example inputs in the artifact (a node feature table
    # would be most of it); serving needs none
    program.example_inputs = None
    meta = {}
    if any(name in _COLLECTIVES for name in op_calls(program)):
        meta = {"world_size": dist.get_world_size(),
                "rank": dist.get_rank()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path, extra_files={_META: json.dumps(meta)})
    return program


def load_model(path: str):
    """The ``ExportedProgram`` saved at ``path``; ``.module()`` calls it."""
    return torch.export.load(path)


def _load(path: str):
    """``(program, what export_model recorded of the world)``, the record
    empty for a program without collectives."""
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    return program, json.loads(extra[_META] or "{}")


class Predictor:
    """Serving wrapper (reference ``python_deploy.py:26-44`` analog). A
    program with collectives needs a process group (``parallel.comm.
    init``) of the size it was exported in, and this process on the rank
    that exported it; otherwise this raises."""

    def __init__(self, path: str):
        program, meta = _load(path)
        if meta:
            want = (meta["world_size"], meta["rank"])
            if not dist.is_initialized():
                raise RuntimeError(
                    f"{path} runs collectives in a world of {want[0]} "
                    f"ranks (exported by rank {want[1]}): join one first "
                    "(pgl_tpu_torch.parallel.comm.init)")
            got = (dist.get_world_size(), dist.get_rank())
            if got != want:
                raise RuntimeError(
                    f"{path} was exported by rank {want[1]} of {want[0]}; "
                    f"this process is rank {got[1]} of {got[0]}")
        self.world = meta
        self._module = program.module()

    def run(self, *inputs):
        with torch.no_grad():
            return self._module(*(x if isinstance(x, torch.Tensor)
                                  else torch.as_tensor(x) for x in inputs))
