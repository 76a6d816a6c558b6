"""RGCN on a heterogeneous graph with ``pgl_tpu_torch`` (port of
``examples/rgcn/train.py``; reference: ``examples/rgcn``): typed-edge
relational convolution with basis decomposition, full-batch node
classification on a synthetic multi-relation community graph."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pgl_tpu_torch.heter_graph import HeterGraph
from pgl_tpu_torch.nn import RGCNConv
from pgl_tpu_torch.utils.convert import flax_to_state_dict
from pgl_tpu_torch.utils.platform import select_platform


def synthetic_relational(num_nodes=600, num_classes=4, num_rels=3, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes)
    edges = {}
    for r in range(num_rels):
        src = np.repeat(np.arange(num_nodes), 4)
        dst = rng.integers(0, num_nodes, num_nodes * 4)
        # each relation correlates with labels differently
        if r == 0:
            keep = labels[src] == labels[dst]
        elif r == 1:
            keep = (labels[src] + 1) % num_classes == labels[dst]
        else:
            keep = rng.random(len(src)) < 0.3
        edges[f"rel_{r}"] = np.stack([src[keep], dst[keep]], axis=1)
    feat = (np.eye(num_classes)[labels] @
            rng.normal(size=(num_classes, 16)) +
            1.5 * rng.normal(size=(num_nodes, 16))).astype(np.float32)
    return HeterGraph(edges, num_nodes=num_nodes,
                      node_feat={"h": feat}), labels


class RGCN(nn.Module):
    """Two RGCNConv (``l1``, ``l2``) with relu between them."""

    def __init__(self, input_size, etypes, num_class, hidden=32,
                 num_bases=2, *, generator=None, device=None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.l1 = RGCNConv(input_size, hidden, etypes, num_bases,
                           generator=gen, device=device)
        self.l2 = RGCNConv(hidden, num_class, etypes, num_bases,
                           generator=gen, device=device)

    def forward(self, hg, x):
        return self.l2(hg, torch.relu(self.l1(hg, x)))


def load_reference_params(module, params):
    """The reference module's flax tree (numpy arrays) into ``module``."""
    device = next(module.parameters()).device
    module.load_state_dict(flax_to_state_dict(params, device), strict=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--lr", type=float, default=0.01)
    args = parser.parse_args(argv)
    device = select_platform()

    hg, labels = synthetic_relational()
    hgt = hg.tensor(device)
    x = hgt[hg.edge_types[0]].node_feat["h"]
    y = torch.as_tensor(labels, device=device).long()
    rngp = np.random.default_rng(0).permutation(hg.num_nodes)
    train_idx = torch.as_tensor(rngp[:400], device=device)
    test_idx = torch.as_tensor(rngp[400:], device=device)

    model = RGCN(x.shape[1], tuple(sorted(hg.edge_types)), num_class=4,
                 generator=torch.Generator().manual_seed(0), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    losses = []
    t0 = time.time()
    for epoch in range(args.epochs):
        opt.zero_grad()
        loss = F.cross_entropy(model(hgt, x)[train_idx], y[train_idx])
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        logits = model(hgt, x)
    acc = float((logits[test_idx].argmax(-1) == y[test_idx]).float().mean())
    ms = (time.time() - t0) / args.epochs * 1000
    print(f"RGCN: test acc {acc:.4f} ({ms:.2f} ms/epoch)")
    losses = torch.stack(losses).cpu().numpy()
    return {"test_acc": acc, "ms_per_epoch": ms,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
