"""Device-sampled GraphSAGE (port of ``pgl_tpu/models/sampled_sage.py``).

:class:`~pgl_tpu_torch.sampling.NeighborSampler` emits fixed-shape padded
blocks ``(frontier, neighbors [M, k], mask [M, k])`` a layer, and
:class:`BipartiteSAGE` consumes them directly: the feature table stays on
the device and each depth's rows are gathered by ``index_select``, so
sampling, gathers, the SAGE layers, the loss and the gradients run with no
host round trip a batch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..nn.conv import _dense

__all__ = ["BipartiteSAGE"]


class BipartiteSAGE(nn.Module):
    """L-layer mean-aggregating GraphSAGE over padded ego blocks.

    Call with the full ``[N, D]`` feature table, the seed node ids, and the
    ``sampled`` list ``NeighborSampler.sample(seeds, generator)[0]``
    (deepest layer first; as many blocks as ``num_layers``). Returns
    ``[B, num_class]`` logits for the seeds.

    Layer ``l`` has the Denses ``self_{l}`` and ``neigh_{l}`` (flax's names,
    so ``utils.convert.flax_to_state_dict`` carries a tree); hidden layers
    take ReLU and L2 normalisation, the last is linear. A masked slot's row
    is gathered at a clamped id and counts as 0: the reference multiplies
    it by the mask, which gives the same sum wherever its gathered row is
    finite.
    """

    def __init__(self, input_size: int, num_class: int, num_layers: int = 2,
                 hidden_size: int = 128, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.num_layers = num_layers
        for l in range(num_layers):
            d_in = input_size if l == 0 else hidden_size
            d_out = num_class if l == num_layers - 1 else hidden_size
            self.add_module(f"self_{l}", _dense(d_in, d_out, gen))
            self.add_module(f"neigh_{l}", _dense(d_in, d_out, gen))
        self.to(resolve_device(device))

    def forward(self, feature_table, seeds, sampled):
        entries = sampled[::-1]   # shallow first: entries[0]'s frontier is
        L = len(entries)          # the seeds
        if L != self.num_layers:
            raise ValueError(f"sampled has {L} blocks, model expects "
                             f"{self.num_layers}")
        n = feature_table.shape[0]

        def gather(ids):
            return feature_table.index_select(
                0, ids.reshape(-1).to(torch.int64).clamp(0, n - 1))

        # depth-i rows: depth 0 the seeds, depth i the flattened
        # neighbours of depth i-1 (padded, with replacement)
        hs = [gather(torch.as_tensor(seeds, device=feature_table.device))]
        for _, neigh, _ in entries:
            hs.append(gather(neigh))
        for l in range(L):
            last = l == L - 1
            lin_self = getattr(self, f"self_{l}")
            lin_neigh = getattr(self, f"neigh_{l}")
            nxt = []
            for i in range(L - l):
                _, neigh, mask = entries[i]
                h_self = hs[i]
                k = neigh.shape[1]
                h_neigh = hs[i + 1].reshape(h_self.shape[0], k, -1)
                m = mask[..., None]
                agg = torch.where(m, h_neigh, 0).sum(1) / \
                    m.to(h_self.dtype).sum(1).clamp(min=1.0)
                h = lin_self(h_self) + lin_neigh(agg)
                if not last:
                    h = torch.relu(h)
                    norm = torch.linalg.vector_norm(h, dim=-1,
                                                    keepdim=True)
                    h = h / norm.clamp(min=1e-12)
                nxt.append(h)
            hs = nxt
        return hs[0]
