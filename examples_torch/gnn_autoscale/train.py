"""GNNAutoScale training on ``pgl_tpu_torch`` (port of
``examples/gnn_autoscale/train.py``; reference:
``apps/GNNAutoScale/examples/run.py``): METIS-partitioned batches with
per-layer historical embeddings — train a full-graph GCN one partition at a
time, evaluate with exact full-graph inference."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch
import torch.nn.functional as F

from pgl_tpu_torch.apps.gnn_autoscale import ScalableGNN, partition_batches
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.nn import GCNConv
from pgl_tpu_torch.utils.platform import select_platform


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-parts", type=int, default=4)
    parser.add_argument("--method", default="metis",
                        choices=["metis", "random"])
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--lr", type=float, default=0.01)
    args = parser.parse_args(argv)
    device = select_platform()

    g, labels = community_graph(num_nodes=800, num_classes=4, feat_dim=16,
                                avg_degree=8, seed=3)
    batches = partition_batches(g, args.num_parts, method=args.method)
    feat = np.asarray(g.node_feat["h"])
    y = labels

    l1 = GCNConv(16, args.hidden, activation="relu",
                 generator=torch.Generator().manual_seed(0), device=device)
    l2 = GCNConv(args.hidden, 4, generator=torch.Generator().manual_seed(1),
                 device=device)
    gas = ScalableGNN(g.num_nodes, layers=[l1, l2],
                      hidden_dims=[args.hidden], device=device)
    opt = torch.optim.Adam([*l1.parameters(), *l2.parameters()],
                           lr=args.lr)

    losses = []
    t0 = time.time()
    for epoch in range(args.epochs):
        # double-buffered: batch k+1's history pull and batch k-1's push
        # overlap batch k's step (reference base_model.py:31-100 overlap)
        total = 0.0
        for b, halo in gas.iter_batches(batches):
            x = torch.as_tensor(feat[b["nodes"]], device=device)
            yb = torch.as_tensor(y[b["nodes"][:b["batch_size"]]],
                                 device=device).long()
            opt.zero_grad()
            out, fresh = gas.forward_batch(b, x, halo)
            loss = F.cross_entropy(out, yb)
            loss.backward()
            gas.push_fresh_async(b, [f.detach() for f in fresh])
            opt.step()
            total += loss.item()
        gas.pool.synchronize()
        losses.append(total / len(batches))
    logits = gas.inference_full(g, g.node_feat["h"])
    acc = float((logits.argmax(-1).cpu().numpy() == y).mean())
    ms = (time.time() - t0) / args.epochs * 1000
    print(f"GAS ({args.method}, {args.num_parts} parts): acc {acc:.4f} "
          f"({ms:.1f} ms/epoch)")
    return {"acc": acc, "ms_per_epoch": ms, "loss_first": losses[0],
            "loss_last": losses[-1]}


if __name__ == "__main__":
    main()
