"""Hierarchical graph classification with SAGPool on ``pgl_tpu_torch``
(port of ``examples/sag_pool/train.py``; reference: ``examples/sag_pool``):
GCN → self-attention top-k pooling → GCN → global readout.

The two phases of the reference stay: a *plan* step picks the kept nodes
and rebuilds the pooled graph from concrete values outside autograd, then
the differentiable forward re-derives the scores and runs the dense math
with the selection held constant. Gradients flow through ``h[rank] *
score[rank]`` exactly as in the reference; only the integer selection is
planned outside autograd."""

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

from pgl_tpu_torch import Graph, math as gmath
from pgl_tpu_torch.nn import GCNConv
from pgl_tpu_torch.nn.conv import _dense
from pgl_tpu_torch.nn.functional import graph_pool
from pgl_tpu_torch.utils.convert import flax_to_state_dict
from pgl_tpu_torch.utils.platform import select_platform
from pgl_tpu_torch.utils.transform import filter_adj


class SAGPoolNet(nn.Module):
    """``conv1`` → ``score_gnn`` top-k → ``conv2`` → mean|max readout →
    ``head`` (the flax module's names)."""

    def __init__(self, input_size, hidden, num_class, ratio=0.5, *,
                 generator=None, device=None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.ratio = ratio
        self.conv1 = GCNConv(input_size, hidden, generator=gen,
                             device=device)
        self.score_gnn = GCNConv(hidden, 1, generator=gen, device=device)
        self.conv2 = GCNConv(hidden, hidden, generator=gen, device=device)
        self.head = _dense(2 * hidden, num_class, gen)
        self.to(device)

    def scored(self, graph, x):
        h = torch.relu(self.conv1(graph, x))
        score = torch.tanh(self.score_gnn(graph, h).reshape(-1))
        return h, score

    @torch.no_grad()
    def plan(self, graph, x):
        """Pooling plan: which nodes survive, and the pooled graph they
        induce. Concrete values only, outside autograd."""
        h, score = self.scored(graph, x)
        batch = graph.graph_node_id
        _, rank = gmath.segment_topk(h, score, batch,
                                     num_segments=graph.num_graph,
                                     ratio=self.ratio)
        rank_np = rank.cpu().numpy()
        new_batch = batch.cpu().numpy()[rank_np]
        edges, _ = filter_adj(graph.edges.cpu().numpy(), rank_np,
                              num_nodes=int(score.shape[0]))
        counts = np.bincount(new_batch, minlength=graph.num_graph)
        gni = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        pooled = Graph(edges, num_nodes=len(rank_np), _graph_node_index=gni,
                       _num_graph=graph.num_graph).tensor(x.device)
        return rank, pooled

    def forward(self, graph, x, rank, pooled):
        """Differentiable forward with the plan held constant."""
        h, score = self.scored(graph, x)
        hp = h[rank] * score[rank][:, None]
        h2 = torch.relu(self.conv2(pooled, hp))
        readout = torch.cat([graph_pool(pooled, h2, "mean"),
                             graph_pool(pooled, h2, "max")], -1)
        return self.head(readout)


def load_reference_params(module, params):
    """The reference module's flax tree (numpy arrays) into ``module``."""
    device = next(module.parameters()).device
    module.load_state_dict(flax_to_state_dict(params, device), strict=True)


def make_motif(kind, n, rng):
    if kind == 0:          # cycle
        src = np.arange(n)
        dst = (src + 1) % n
    else:                  # star
        src = np.concatenate([np.zeros(n - 1, int), np.arange(1, n)])
        dst = np.concatenate([np.arange(1, n), np.zeros(n - 1, int)])
    edges = np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])], 1)
    feat = np.ones((n, 8), np.float32)
    return Graph(edges, num_nodes=n, node_feat={"h": feat}), kind


def make_batches(num_graphs, batch_size, seed, device):
    rng = np.random.default_rng(seed)
    pairs = [make_motif(int(rng.integers(0, 2)), int(rng.integers(6, 14)),
                        rng) for _ in range(num_graphs)]
    out = []
    for lo in range(0, num_graphs - batch_size + 1, batch_size):
        gs, ys = zip(*pairs[lo:lo + batch_size])
        out.append((Graph.disjoint(list(gs)).tensor(device),
                    torch.as_tensor(ys, device=device).long()))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-graphs", type=int, default=256)
    parser.add_argument("--ratio", type=float, default=0.5)
    args = parser.parse_args(argv)
    device = select_platform()

    batches = make_batches(args.num_graphs, args.batch_size, 0, device)
    test = make_batches(96, args.batch_size, 1, device)

    model = SAGPoolNet(input_size=8, hidden=32, num_class=2,
                       ratio=args.ratio,
                       generator=torch.Generator().manual_seed(0),
                       device=device)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)

    losses = []
    t0 = time.time()
    for epoch in range(args.epochs):
        total = 0.0
        for g, y in batches:
            # phase 1: concrete pooling plan with the current params
            rank, pooled = model.plan(g, g.node_feat["h"])
            # phase 2: differentiable loss with the plan as constants
            opt.zero_grad()
            loss = F.cross_entropy(model(g, g.node_feat["h"], rank, pooled),
                                   y)
            loss.backward()
            opt.step()
            total += loss.item()
        losses.append(total / len(batches))
        if epoch % 5 == 0:
            print(f"epoch {epoch}: loss {total/len(batches):.4f}")

    correct = count = 0
    with torch.no_grad():
        for g, y in test:
            rank, pooled = model.plan(g, g.node_feat["h"])
            pred = model(g, g.node_feat["h"], rank, pooled).argmax(-1)
            correct += int((pred == y).sum())
            count += len(y)
    s = (time.time() - t0) / args.epochs
    print(f"SAGPool graph classification: test acc {correct/count:.4f} "
          f"({s:.2f} s/epoch)")
    return {"test_acc": correct / count, "s_per_epoch": s,
            "steps_per_epoch": len(batches), "loss_first": losses[0],
            "loss_last": losses[-1]}


if __name__ == "__main__":
    main()
