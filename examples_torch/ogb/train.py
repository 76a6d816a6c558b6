"""ogbn-arxiv-style full-batch node classification on ``pgl_tpu_torch``
(port of ``examples/ogb/train.py``; reference:
``ogb_examples/nodeproppred/unimp`` arxiv config): UniMP or GCN over an OGB
node-property dataset.

With ``--data-path`` at an extracted ogbn_arxiv directory (``raw/`` and
``split/time/``) it trains on the real graph, and a loader error ends the
run. Without it (no downloads here) it trains on an arxiv-shaped
synthetic graph: 20,000 nodes, or with ``--full-scale`` ogbn-arxiv's
169,343 nodes, 128 features and 40 classes, made undirected with
self-loops. The planted partition keeps about one drawn edge in thirteen,
so the graph has about 2 edges a node, not arxiv's 7 (the run prints its
edge count).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch
import torch.nn.functional as F

from pgl_tpu_torch.datasets import OgbnArxivDataset, community_graph
from pgl_tpu_torch.models import GCN, UniMP
from pgl_tpu_torch.utils.platform import select_platform
from pgl_tpu_torch.utils.transform import add_self_loops, to_undirected


def load_data(use_synthetic_scale, data_path=None):
    if data_path:
        ds = OgbnArxivDataset(data_path=data_path)
        return (ds.graph, ds.feature, ds.y.reshape(-1), ds.train_index,
                ds.val_index, ds.test_index, ds.num_classes)
    n = 169343 if use_synthetic_scale else 20000
    g, y = community_graph(num_nodes=n, num_classes=40, feat_dim=128,
                           avg_degree=7, noise=1.6, p_inter=0.05, seed=0)
    g = add_self_loops(to_undirected(g))
    perm = np.random.default_rng(0).permutation(n)
    k = n // 2
    return (g, g.node_feat["h"], y, perm[:k], perm[k:k + n // 4],
            perm[k + n // 4:], 40)


def build_model(name, input_size, num_class, hidden, device, seed=0):
    """The reference's two models (``examples/ogb/train.py:70-80``)."""
    gen = torch.Generator().manual_seed(seed)
    if name == "GCN":
        return GCN(input_size=input_size, num_class=num_class, num_layers=3,
                   hidden_size=hidden, dropout=0.3, generator=gen,
                   device=device)
    return UniMP(input_size=input_size, num_class=num_class, num_layers=2,
                 hidden_size=hidden // 2, num_heads=2, dropout=0.1,
                 generator=gen, device=device)


def forward(model, gt, x, y, train_mask, training=False):
    if isinstance(model, UniMP):
        return model(gt, x, y, train_mask, training=training)
    return model(gt, x, training=training)


def train_loss(model, gt, x, y, train_idx, train_mask, training=True):
    logits = forward(model, gt, x, y, train_mask, training)
    return F.cross_entropy(logits[train_idx], y[train_idx])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="GCN", choices=["GCN", "UniMP"])
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--hidden", type=int, default=128)
    parser.add_argument("--lr", type=float, default=5e-3)
    parser.add_argument("--full-scale", action="store_true",
                        help="synthetic graph at full arxiv scale")
    parser.add_argument("--data-path", default=None,
                        help="extracted ogbn_arxiv dir (raw/ + split/time/)"
                             "; omit to run the synthetic graph")
    args = parser.parse_args(argv)
    device = select_platform()

    graph, feat, y, train_idx, val_idx, test_idx, ncls = load_data(
        args.full_scale, args.data_path)
    gt = graph.tensor(device)
    x = torch.as_tensor(np.asarray(feat, dtype=np.float32), device=device)
    yt = torch.as_tensor(np.asarray(y), device=device).long()
    train_idx = torch.as_tensor(np.asarray(train_idx), device=device).long()
    test_idx = torch.as_tensor(np.asarray(test_idx), device=device).long()
    train_mask = torch.zeros(gt.num_nodes, dtype=torch.bool, device=device)
    train_mask[train_idx] = True

    model = build_model(args.model, x.shape[1], ncls, args.hidden, device)
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr,
                            weight_decay=1e-4)

    losses = []
    t0 = time.time()
    for epoch in range(args.epochs):
        opt.zero_grad()
        loss = train_loss(model, gt, x, yt, train_idx, train_mask)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        logits = forward(model, gt, x, yt, train_mask)
    acc = float((logits.argmax(-1)[test_idx] == yt[test_idx]).float().mean())
    ms = (time.time() - t0) / args.epochs * 1000
    print(f"{args.model}: test acc {acc:.4f} "
          f"({ms:.1f} ms/epoch, {gt.num_edges} edges)")
    losses = torch.stack(losses).cpu().numpy()
    return {"test_acc": acc, "ms_per_epoch": ms, "num_edges": gt.num_edges,
            "num_nodes": gt.num_nodes, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
