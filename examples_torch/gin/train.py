"""Graph classification with GIN on ``pgl_tpu_torch`` (port of
``examples/gin/train.py``; reference: ``examples/gin``): batched disjoint
graphs + sum pooling, trained on a synthetic motif task (cycle graphs vs
star graphs of varying size)."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch
import torch.nn.functional as F

from pgl_tpu_torch import Graph
from pgl_tpu_torch.models import GIN
from pgl_tpu_torch.utils.platform import select_platform


def make_motif(kind, n, rng):
    """cycle vs star on n nodes; features = degree one-hot-ish."""
    if kind == 0:          # cycle
        src = np.arange(n)
        dst = (src + 1) % n
    else:                  # star
        src = np.concatenate([np.zeros(n - 1, int), np.arange(1, n)])
        dst = np.concatenate([np.arange(1, n), np.zeros(n - 1, int)])
    edges = np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])], 1)
    # constant features force the model to rely on structure
    feat = np.ones((n, 8), np.float32)
    return Graph(edges, num_nodes=n, node_feat={"h": feat})


def make_batches(num_graphs, batch_size, seed):
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for _ in range(num_graphs):
        kind = int(rng.integers(0, 2))
        n = int(rng.integers(5, 12))
        graphs.append(make_motif(kind, n, rng))
        labels.append(kind)
    batches = []
    for lo in range(0, num_graphs, batch_size):
        gs = graphs[lo:lo + batch_size]
        if len(gs) < batch_size:
            break
        batch = Graph.disjoint(gs)
        batches.append((batch, np.asarray(labels[lo:lo + batch_size])))
    return batches


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-graphs", type=int, default=512)
    args = parser.parse_args(argv)
    device = select_platform()

    batches = make_batches(args.num_graphs, args.batch_size, seed=0)
    test_batches = make_batches(128, args.batch_size, seed=1)

    model = GIN(input_size=8, num_class=2, num_layers=3, hidden_size=32,
                generator=torch.Generator().manual_seed(0), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    tensors = [(g.tensor(device), torch.as_tensor(y, device=device).long())
               for g, y in batches]
    test_tensors = [(g.tensor(device),
                     torch.as_tensor(y, device=device).long())
                    for g, y in test_batches]

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
    print(f"GIN graph classification: test acc {correct/count:.4f} "
          f"({s:.2f} s/epoch)")
    return {"test_acc": correct / count, "s_per_epoch": s,
            "steps_per_epoch": len(tensors), "loss_first": losses[0],
            "loss_last": losses[-1]}


if __name__ == "__main__":
    main()
