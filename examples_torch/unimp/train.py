"""UniMP training on ``pgl_tpu_torch`` (port of ``examples/unimp/train.py``;
reference: ``ogb_examples/nodeproppred/unimp``): masked-label-propagation
graph transformer. During training a random subset of train-node labels is
fed to the model (the rest masked) so it learns to propagate label
information; evaluation feeds all train labels.

With ``--data-path`` at an extracted ogbn_arxiv directory it trains on the
OGB time split, and a loader error ends the run; without it, on a
planted-partition synthetic graph."""

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
from pgl_tpu_torch.models import UniMP
from pgl_tpu_torch.utils.platform import select_platform
from pgl_tpu_torch.utils.transform import add_self_loops, to_undirected


def masked_label_loss(logits, y, train_mask, feed):
    """Cross-entropy over the train nodes whose label was not fed."""
    losses = F.cross_entropy(logits, y, reduction="none")
    mask = (train_mask & ~feed).float()
    return (losses * mask).sum() / mask.sum().clamp(min=1)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--heads", type=int, default=2)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--label-rate", type=float, default=0.6,
                        help="fraction of train labels fed during training")
    parser.add_argument("--lr", type=float, default=5e-3)
    parser.add_argument("--data-path", default=None,
                        help="extracted ogbn_arxiv dir (raw/ + split/time/)"
                             "; omit to run the planted-partition synthetic")
    args = parser.parse_args(argv)
    device = select_platform()

    if args.data_path:
        # reference config: ogb_examples/nodeproppred/unimp (arxiv
        # full-batch); the OGB time split replaces the random one
        ds = OgbnArxivDataset(data_path=args.data_path)
        g = add_self_loops(to_undirected(ds.graph))
        feat = ds.feature.astype(np.float32)
        y = ds.y.reshape(-1)
        num_class = ds.num_classes
        train_idx_np, test_idx_np = ds.train_index, ds.test_index
    else:
        g, y = community_graph(num_nodes=1500, num_classes=5, feat_dim=32,
                               avg_degree=6, noise=1.4, p_inter=0.1, seed=1)
        g = add_self_loops(to_undirected(g))
        feat = np.asarray(g.node_feat["h"])
        num_class = 5
        perm = np.random.default_rng(0).permutation(g.num_nodes)
        train_idx_np, test_idx_np = perm[:600], perm[900:]

    gt = g.tensor(device)
    x = torch.as_tensor(np.asarray(feat, np.float32), device=device)
    yt = torch.as_tensor(np.asarray(y), device=device).long()
    test_idx = torch.as_tensor(np.asarray(test_idx_np), device=device).long()
    train_mask = torch.zeros(g.num_nodes, dtype=torch.bool, device=device)
    train_mask[torch.as_tensor(np.asarray(train_idx_np),
                               device=device).long()] = True

    model = UniMP(input_size=x.shape[1], num_class=num_class,
                  num_layers=args.layers, hidden_size=args.hidden,
                  num_heads=args.heads, dropout=0.1,
                  generator=torch.Generator().manual_seed(0), device=device)
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr,
                            weight_decay=5e-4)
    gen = torch.Generator(device=device).manual_seed(7)

    @torch.no_grad()
    def evaluate():
        logits = model(gt, x, yt, train_mask)
        return (logits.argmax(-1)[test_idx] == yt[test_idx]).float().mean()

    losses = []
    t0 = time.time()
    best = 0.0
    for epoch in range(args.epochs):
        # feed a random subset of train labels; predict the rest
        feed = train_mask & (torch.rand(g.num_nodes, generator=gen,
                                        device=device) < args.label_rate)
        opt.zero_grad()
        logits = model(gt, x, yt, feed, training=True)
        loss = masked_label_loss(logits, yt, train_mask, feed)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 20 == 0 or epoch == args.epochs - 1:
            acc = float(evaluate())
            best = max(best, acc)
    ms = (time.time() - t0) / args.epochs * 1000
    print(f"UniMP: test acc {best:.4f} ({ms:.1f} ms/epoch)")
    losses = torch.stack(losses).cpu().numpy()
    return {"test_acc": best, "ms_per_epoch": ms,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
