"""Sequence aggregation of each node's incoming messages by an LSTM (port of
``pgl_tpu/nn/aggregation.py``).

The messages, in the CSC order of the graph's ``adj_dst_index``, are packed
by ``segment_padding`` into ``[N, max_degree, d]``; an LSTM runs over each
node's valid prefix, and the node's output is the hidden state after its
last message (zeros for a node without messages). As in the reference, a
node keeps only its first ``max_degree`` messages.

The cell is one ``torch.nn.LSTMCell`` holding flax's
``OptimizedLSTMCell``: its ``weight_ih`` stacks the input kernels ``ii``,
``if``, ``ig``, ``io``, its ``weight_hh`` and ``bias_hh`` the recurrent
``hi``, ``hf``, ``hg``, ``ho``, in torch's gate order (i, f, g, o), and
``bias_ih``, which flax's cell does not have, stays 0 and takes no
gradient (``utils/convert.py`` maps the eight Denses onto the three).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from .. import resolve_device
from ..ops.segment import segment_padding
from .conv import lecun_normal_

__all__ = ["LSTMAggregation", "lstm_aggregate"]


def lstm_cell(input_size: int, hidden_size: int,
              generator: torch.Generator) -> nn.LSTMCell:
    """flax ``OptimizedLSTMCell``'s parameters and draws in an
    ``nn.LSTMCell``: lecun-normal input kernels, an orthogonal recurrent
    kernel a gate, zero biases, and ``bias_ih`` fixed at 0."""
    cell = nn.LSTMCell(input_size, hidden_size)
    lecun_normal_(cell.weight_ih, generator)
    with torch.no_grad():
        for block in cell.weight_hh.view(4, hidden_size, hidden_size):
            nn.init.orthogonal_(block, generator=generator)
        cell.bias_hh.zero_()
        cell.bias_ih.zero_()
    cell.bias_ih.requires_grad_(False)
    return cell


def lstm_scan(cell: nn.LSTMCell, seq, lengths):
    """flax ``nn.RNN`` over ``cell`` with ``seq_lengths``: the hidden state
    after each sequence's last valid step, from zeros. ``seq`` [N, L, d],
    ``lengths`` [N] -> [N, hidden]; zeros where the length is 0."""
    h = seq.new_zeros(seq.shape[0], cell.hidden_size)
    c = torch.zeros_like(h)
    for t in range(seq.shape[1]):
        h_t, c_t = cell(seq[:, t], (h, c))
        live = (lengths > t)[:, None]
        h = torch.where(live, h_t, h)
        c = torch.where(live, c_t, c)
    return h


class LSTMAggregation(nn.Module):
    """Aggregate each destination's incoming messages with an LSTM
    (``pgl_tpu/nn/aggregation.py:24-53``): ``hidden_size`` wide, over at
    most the first ``max_degree`` messages of each node in CSC order.
    ``input_size``, the messages' width (inferred by flax), defaults to
    ``hidden_size``. Called as ``layer(graph, msgs)`` with ``msgs`` [E, d]
    in the original edge order; nodes without messages give zeros. The
    cell is the submodule ``OptimizedLSTMCell_0``, the name flax gives the
    reference's."""

    def __init__(self, hidden_size: int, max_degree: int = 32, *,
                 input_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.max_degree = max_degree
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.add_module("OptimizedLSTMCell_0", lstm_cell(
            hidden_size if input_size is None else input_size, hidden_size,
            gen))
        self.to(resolve_device(device))

    def forward(self, graph, msgs):
        idx = graph.adj_dst_index
        padded, mask, _ = segment_padding(
            msgs.index_select(0, idx.sorted_eid), idx.segment_ids,
            num_segments=graph.num_nodes, max_len=self.max_degree)
        return lstm_scan(self.OptimizedLSTMCell_0, padded, mask.sum(1))


def lstm_aggregate(graph, msgs, params: Mapping, hidden_size: int,
                   max_degree: int = 32):
    """Functional form of :class:`LSTMAggregation` on ``msgs``' device:
    ``params`` is the layer's ``state_dict`` (``utils.convert.
    flax_to_state_dict`` of the reference's parameters)."""
    layer = LSTMAggregation(hidden_size, max_degree,
                            input_size=msgs.shape[-1], device=msgs.device)
    layer.load_state_dict(params)
    return layer(graph, msgs)
