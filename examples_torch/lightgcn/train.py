"""LightGCN collaborative filtering on ``pgl_tpu_torch`` (port of
``examples/lightgcn/train.py``; reference: ``examples/lightgcn``): users and
items share one id space, parameter-free normalized propagation averages
the layer outputs, and BPR ranking loss trains the embeddings. Synthetic
implicit feedback from latent user/item clusters stands in for the
Gowalla-style datasets."""

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
from pgl_tpu_torch.nn import LightGCNConv
from pgl_tpu_torch.utils.platform import select_platform


def make_interactions(num_users, num_items, per_user, num_clusters, seed):
    """Users interact mostly with items of their own latent cluster."""
    rng = np.random.default_rng(seed)
    ucl = rng.integers(0, num_clusters, num_users)
    icl = rng.integers(0, num_clusters, num_items)
    items_of = [np.nonzero(icl == c)[0] for c in range(num_clusters)]
    pairs = []
    for u in range(num_users):
        own = items_of[ucl[u]]
        for _ in range(per_user):
            if rng.random() < 0.9 and len(own):
                i = int(own[rng.integers(len(own))])
            else:
                i = int(rng.integers(num_items))
            pairs.append((u, i))
    return np.unique(np.asarray(pairs), axis=0), ucl, icl


def interaction_graph(pairs, U, I):
    """One id space, users [0, U), items [U, U+I); undirected."""
    src, dst = pairs[:, 0], pairs[:, 1] + U
    edges = np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])], 1)
    return Graph(edges, num_nodes=U + I)


def split_pairs(pairs):
    """Train/test split of the interactions."""
    rng = np.random.default_rng(1)
    mask = rng.random(len(pairs)) < 0.9
    return pairs[mask], pairs[~mask]


def propagate(conv, emb, g, layers):
    """LightGCN: mean of the embeddings at every propagation depth."""
    outs = [emb]
    h = emb
    for _ in range(layers):
        h = conv(g, h)
        outs.append(h)
    return torch.stack(outs).mean(0)


def bpr_loss(conv, e, g, layers, tr_u, tr_i, neg):
    h = propagate(conv, e, g, layers)
    pos = (h[tr_u] * h[tr_i]).sum(-1)
    ngs = (h[tr_u] * h[neg]).sum(-1)
    bpr = -F.logsigmoid(pos - ngs).mean()
    reg = 1e-4 * (e[tr_u] ** 2 + e[tr_i] ** 2 + e[neg] ** 2).sum(-1).mean()
    return bpr + reg


def recall_at_20(h, U, train_pairs, test_pairs):
    """recall@20 over held-out interactions, train items masked."""
    users = np.unique(test_pairs[:, 0])
    scores = h[users] @ h[U:].T
    for row, u in enumerate(users):
        seen = train_pairs[train_pairs[:, 0] == u][:, 1]
        scores[row, seen] = -np.inf
    top = np.argsort(-scores, 1)[:, :20]
    hits = total = 0
    for row, u in enumerate(users):
        held = set(test_pairs[test_pairs[:, 0] == u][:, 1].tolist())
        hits += len(held & set(top[row].tolist()))
        total += len(held)
    return hits / total


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--users", type=int, default=400)
    parser.add_argument("--items", type=int, default=600)
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--layers", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--lr", type=float, default=5e-2)
    args = parser.parse_args(argv)
    device = select_platform()

    pairs, ucl, icl = make_interactions(args.users, args.items, per_user=12,
                                        num_clusters=4, seed=0)
    U, I = args.users, args.items
    gt = interaction_graph(pairs, U, I).tensor(device)
    train_pairs, test_pairs = split_pairs(pairs)

    conv = LightGCNConv()
    gen = torch.Generator(device=device).manual_seed(0)
    emb = (torch.randn(U + I, args.dim, generator=gen, device=device)
           * 0.1).requires_grad_()
    opt = torch.optim.Adam([emb], lr=args.lr)

    tr_u = torch.as_tensor(train_pairs[:, 0], device=device).long()
    tr_i = torch.as_tensor(train_pairs[:, 1] + U, device=device).long()

    losses = []
    t0 = time.time()
    for epoch in range(args.epochs):
        neg = torch.randint(U, U + I, (tr_u.shape[0],), generator=gen,
                            device=device)
        opt.zero_grad()
        loss = bpr_loss(conv, emb, gt, args.layers, tr_u, tr_i, neg)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 20 == 0:
            print(f"epoch {epoch}: bpr loss {loss.item():.4f}")

    with torch.no_grad():
        h = propagate(conv, emb, gt, args.layers).cpu().numpy()
    recall = recall_at_20(h, U, train_pairs, test_pairs)
    ms = (time.time() - t0) / args.epochs * 1000
    print(f"LightGCN: recall@20 {recall:.4f} ({ms:.1f} ms/epoch)")
    losses = torch.stack(losses).cpu().numpy()
    return {"recall@20": recall, "ms_per_epoch": ms,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
