"""Model export / serving (port of ``pgl_tpu/utils/export.py``; reference:
``examples/gnn_depoly`` — ``paddle.jit.to_static`` + InputSpec export and
``paddle.inference`` serving, ``export_model.py:58-83`` /
``python_deploy.py:26-44``).

``torch.export`` traces the closed inference function into an
``ExportedProgram`` saved as one ``.pt2`` file; the graph's layouts and the
model's weights become the program's constants. K1 is the custom op
``torch.ops.pgl_tpu_torch.spmm`` (``ops/kernels/segment_kernels.py``), so
the program calls it by name, and loading one needs ``pgl_tpu_torch``
imported (this module imports it): the reference's StableHLO artifact
carries its kernels inside. A function that runs a collective (a
``HaloGraph``'s exchange, a ``ShardedGraph``'s all-reduce) does not
export: the trace raises ``NotImplementedError`` there.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch

from ..ops.kernels import segment_kernels  # noqa: F401  (registers K1's op)

__all__ = ["export_model", "load_model", "Predictor"]


class _Closed(torch.nn.Module):
    """A closed function as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_model(fn: Callable, example_args: Sequence, path: str):
    """Export ``fn`` traced at ``example_args`` to ``path`` and return the
    ``ExportedProgram``.

    ``fn`` must be a closed inference function (model and graph captured),
    e.g. ``lambda x: model(graph, x)``; it is traced without gradients, on
    the devices of its captured tensors and of ``example_args``.
    """
    with torch.no_grad():
        program = torch.export.export(_Closed(fn), tuple(example_args),
                                      strict=False)
    # own copies of the constants: torch.export.save cannot write a view
    # of a larger buffer (a packed layout's arrays) or an empty one
    for name, value in list(program.constants.items()):
        if isinstance(value, torch.Tensor):
            program.constants[name] = value.clone()
    # no copy of the example inputs in the artifact (a node feature table
    # would be most of it); serving needs none
    program.example_inputs = None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return program


def load_model(path: str):
    """The ``ExportedProgram`` saved at ``path``; ``.module()`` calls it."""
    return torch.export.load(path)


class Predictor:
    """Serving wrapper (reference ``python_deploy.py:26-44`` analog)."""

    def __init__(self, path: str):
        self._module = load_model(path).module()

    def run(self, *inputs):
        with torch.no_grad():
            return self._module(*(x if isinstance(x, torch.Tensor)
                                  else torch.as_tensor(x) for x in inputs))
