"""Link prediction on ``pgl_tpu_torch`` (port of
``examples/link_prediction/train.py``; reference: graphsage link-pred
configs and Graph4Rec's in-batch-negative training): GCN encoder +
dot-product scorer, trained with negative sampling on observed edges,
evaluated by AUC on held-out edges. The held-out edges are removed from the
training graph entirely."""

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
from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.nn import GCNConv
from pgl_tpu_torch.utils.convert import flax_to_state_dict
from pgl_tpu_torch.utils.platform import select_platform
from pgl_tpu_torch.utils.transform import add_self_loops, to_undirected


class Encoder(nn.Module):
    """Two GCNConv, relu on the first (``examples/link_prediction/
    train.py:31-37``); the layers carry flax's names ``GCNConv_0`` and
    ``GCNConv_1``."""

    def __init__(self, input_size, hidden=64, *, generator=None,
                 device=None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.GCNConv_0 = GCNConv(input_size, hidden, activation="relu",
                                 generator=gen, device=device)
        self.GCNConv_1 = GCNConv(hidden, hidden, generator=gen,
                                 device=device)

    def forward(self, g, x):
        return self.GCNConv_1(g, self.GCNConv_0(g, x))


def load_reference_params(module, params):
    """The reference module's flax tree (numpy arrays) into ``module``."""
    device = next(module.parameters()).device
    module.load_state_dict(flax_to_state_dict(params, device), strict=True)


def auc_score(pos, neg):
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    n_pos, n_neg = len(pos), len(neg)
    return (ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2) / (
        n_pos * n_neg)


def split_edges(g):
    """Held-out tenth of the edges (test) and the rest (train)."""
    edges = np.asarray(g.edges)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(edges))
    test_edges = edges[perm[:len(edges) // 10]]
    train_edges = edges[perm[len(edges) // 10:]]
    return train_edges, test_edges, rng


def link_loss(h, te, neg_dst):
    pos = (h[te[:, 0]] * h[te[:, 1]]).sum(-1)
    neg = (h[te[:, 0]] * h[neg_dst]).sum(-1)
    return -F.logsigmoid(pos).mean() - F.logsigmoid(-neg).mean()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--lr", type=float, default=5e-3)
    args = parser.parse_args(argv)
    device = select_platform()

    g, _ = community_graph(num_nodes=1000, num_classes=5, feat_dim=32,
                           avg_degree=10, seed=0)
    train_edges, test_edges, rng = split_edges(g)
    train_g = Graph(train_edges, num_nodes=g.num_nodes,
                    node_feat=dict(g.node_feat))
    gt = add_self_loops(to_undirected(train_g)).tensor(device)
    x = gt.node_feat["h"]
    te = torch.as_tensor(train_edges, device=device).long()

    model = Encoder(x.shape[1], hidden=args.hidden,
                    generator=torch.Generator().manual_seed(0),
                    device=device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    gen = torch.Generator(device=device).manual_seed(1)

    losses = []
    t0 = time.time()
    for epoch in range(args.epochs):
        neg_dst = torch.randint(0, gt.num_nodes, (te.shape[0],),
                                generator=gen, device=device)
        opt.zero_grad()
        loss = link_loss(model(gt, x), te, neg_dst)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    with torch.no_grad():
        h = model(gt, x).cpu().numpy()
    pos = (h[test_edges[:, 0]] * h[test_edges[:, 1]]).sum(-1)
    neg_dst = rng.integers(0, g.num_nodes, len(test_edges))
    neg = (h[test_edges[:, 0]] * h[neg_dst]).sum(-1)
    # note: the community fixture's structural ceiling is ~0.76 AUC
    # (≈71% of positives are intra-community, 20% of random negatives are)
    auc = float(auc_score(pos, neg))
    ms = (time.time() - t0) / args.epochs * 1000
    print(f"link prediction: AUC {auc:.4f} ({ms:.1f} ms/epoch)")
    losses = torch.stack(losses).cpu().numpy()
    return {"auc": auc, "ms_per_epoch": ms, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
