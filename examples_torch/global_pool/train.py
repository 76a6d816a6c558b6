"""Global pooling comparison on ``pgl_tpu_torch`` (port of
``examples/global_pool/train.py``; reference: ``examples/global_pool``): a
GIN encoder with a selectable graph-level readout — ``sum``/``mean``/``max``
(GraphPool), ``GlobalAttention``, ``Set2Set``, or ``GMT`` (Graph Multiset
Transformer) — trained on a synthetic motif classification task (cycle vs
star vs ladder graphs), mirroring the reference's GIN + pool study on the
TU datasets (``examples/global_pool/global_pool.py:32-76``)."""

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

from pgl_tpu_torch import Graph
from pgl_tpu_torch.nn import (GINConv, GraphPool, GlobalAttention, Set2Set,
                              GraphMultisetTransformer)
from pgl_tpu_torch.nn.conv import _dense
from pgl_tpu_torch.utils.convert import flax_to_state_dict
from pgl_tpu_torch.utils.platform import select_platform

POOLS = ("sum", "mean", "max", "GlobalAttention", "Set2Set", "GMT")


def make_motif(kind, n, rng):
    """cycle / star / ladder on ~n nodes; constant features force the
    readout to rely on structure."""
    if kind == 0:          # cycle
        src = np.arange(n)
        dst = (src + 1) % n
    elif kind == 1:        # star
        src = np.concatenate([np.zeros(n - 1, int), np.arange(1, n)])
        dst = np.concatenate([np.arange(1, n), np.zeros(n - 1, int)])
    else:                  # ladder (two rails + rungs)
        half = max(n // 2, 2)
        n = 2 * half
        rail = np.arange(half - 1)
        src = np.concatenate([rail, rail + half, np.arange(half)])
        dst = np.concatenate([rail + 1, rail + half + 1,
                              np.arange(half) + half])
    edges = np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])], 1)
    feat = np.ones((n, 8), np.float32)
    return Graph(edges, num_nodes=n, node_feat={"h": feat})


def make_batches(num_graphs, batch_size, seed):
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for _ in range(num_graphs):
        kind = int(rng.integers(0, 3))
        n = int(rng.integers(6, 14))
        graphs.append(make_motif(kind, n, rng))
        labels.append(kind)
    batches = []
    for lo in range(0, num_graphs, batch_size):
        gs = graphs[lo:lo + batch_size]
        if len(gs) < batch_size:
            break
        batches.append((Graph.disjoint(gs),
                        np.asarray(labels[lo:lo + batch_size])))
    return batches


class GINWithReadout(nn.Module):
    """GIN encoder -> selected global readout -> MLP classifier
    (reference ``examples/global_pool/global_pool.py``). The submodules
    carry the flax module's names: ``gin_{i}``, ``gate``, ``s2s``,
    ``gmt``, ``head``, ``classifier``."""

    def __init__(self, input_size, num_class, pool_type, num_layers=3,
                 hidden_size=32, *, generator=None, device=None):
        super().__init__()
        if pool_type not in POOLS:
            raise ValueError(f"pool_type must be one of {POOLS}")
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.pool_type = pool_type
        self.num_layers = num_layers
        H = hidden_size
        for i in range(num_layers):
            self.add_module(f"gin_{i}", GINConv(
                input_size if i == 0 else H, H, activation="relu",
                generator=gen, device=device))
        if pool_type == "GlobalAttention":
            self.gate = _dense(H, 1, gen)
        elif pool_type == "Set2Set":
            self.s2s = Set2Set(H, n_iters=2, generator=gen, device=device)
        elif pool_type == "GMT":
            self.gmt = GraphMultisetTransformer(
                input_dim=H, hidden_dim=H, output_dim=H, num_heads=4,
                num_nodes=32, generator=gen, device=device)
        self.head = _dense(2 * H if pool_type == "Set2Set" else H, H, gen)
        self.classifier = _dense(H, num_class, gen)
        self.to(device)

    def forward(self, graph, feature):
        for i in range(self.num_layers):
            feature = getattr(self, f"gin_{i}")(graph, feature)
        if self.pool_type in ("sum", "mean", "max"):
            h = GraphPool(self.pool_type)(graph, feature)
        elif self.pool_type == "GlobalAttention":
            # the gate is this module's own (flax binds it to the parent)
            h = GlobalAttention(gate=self.gate)(graph, feature)
        elif self.pool_type == "Set2Set":
            h = self.s2s(graph, feature)
        else:
            h = self.gmt(graph, feature)
        return self.classifier(torch.relu(self.head(h)))


def load_reference_params(module, params):
    """The reference module's flax tree (numpy arrays) into ``module``."""
    device = next(module.parameters()).device
    module.load_state_dict(flax_to_state_dict(params, device), strict=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pool_type", default="GlobalAttention",
                        choices=POOLS)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-graphs", type=int, default=512)
    parser.add_argument("--lr", type=float, default=5e-3)
    args = parser.parse_args(argv)
    device = select_platform()

    batches = make_batches(args.num_graphs, args.batch_size, seed=0)
    test_batches = make_batches(128, args.batch_size, seed=1)
    model = GINWithReadout(input_size=8, num_class=3,
                           pool_type=args.pool_type,
                           generator=torch.Generator().manual_seed(0),
                           device=device)
    tensors = [(g.tensor(device), torch.as_tensor(y, device=device).long())
               for g, y in batches]
    test_tensors = [(g.tensor(device),
                     torch.as_tensor(y, device=device).long())
                    for g, y in test_batches]
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    losses = []
    t0 = time.time()
    for epoch in range(args.epochs):
        total = 0.0
        for g, y in tensors:
            opt.zero_grad()
            loss = F.cross_entropy(model(g, g.node_feat["h"]), y)
            loss.backward()
            opt.step()
            total += loss.item()
        losses.append(total / len(tensors))
        if epoch % 5 == 0:
            print(f"epoch {epoch}: loss {total/len(tensors):.4f}")

    correct = count = 0
    with torch.no_grad():
        for g, y in test_tensors:
            pred = model(g, g.node_feat["h"]).argmax(-1)
            correct += int((pred == y).sum())
            count += len(y)
    s = (time.time() - t0) / args.epochs
    print(f"global_pool[{args.pool_type}]: test acc {correct/count:.4f} "
          f"({s:.2f} s/epoch)")
    return {"test_acc": correct / count, "s_per_epoch": s,
            "steps_per_epoch": len(tensors), "loss_first": losses[0],
            "loss_last": losses[-1]}


if __name__ == "__main__":
    main()
