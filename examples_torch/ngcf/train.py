"""NGCF collaborative filtering on ``pgl_tpu_torch`` (port of
``examples/ngcf/train.py``; reference: ``examples/ngcf``): user/item
embeddings propagated through NGCF convs (neighbor sum + elementwise
interaction term), the per-layer outputs L2-normalized and concatenated,
trained with BPR ranking loss — the reference's Gowalla/Amazon/Yelp recipe
(``examples/ngcf/model.py:71-137``) on synthetic implicit feedback from
latent user/item clusters."""

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
from pgl_tpu_torch.nn import NGCFConv
from pgl_tpu_torch.utils.convert import flax_to_state_dict
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
    return np.unique(np.asarray(pairs), axis=0)


class NGCF(nn.Module):
    """Stacked NGCFConv (``ngcf_{i}``); returns the concat of the
    L2-normalized per-layer embeddings (reference
    ``examples/ngcf/model.py:96-121``)."""

    def __init__(self, dim, num_layers=3, *, generator=None, device=None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"ngcf_{i}", NGCFConv(dim, dim, generator=gen,
                                                  device=device))

    def forward(self, graph, emb):
        outs = [emb]
        h = emb
        for i in range(self.num_layers):
            h = getattr(self, f"ngcf_{i}")(graph, h)
            norm = h.norm(dim=-1, keepdim=True)
            outs.append(h / norm.clamp(min=1e-12))
        return torch.cat(outs, dim=-1)


def load_reference_params(module, params):
    """The reference module's flax tree (numpy arrays) into ``module``."""
    device = next(module.parameters()).device
    module.load_state_dict(flax_to_state_dict(params, device), strict=True)


def bpr_loss(model, e, g, tr_u, tr_i, neg):
    h = model(g, e)
    pos = (h[tr_u] * h[tr_i]).sum(-1)
    ngs = (h[tr_u] * h[neg]).sum(-1)
    bpr = -F.logsigmoid(pos - ngs).mean()
    reg = 1e-4 * (e[tr_u] ** 2 + e[tr_i] ** 2 + e[neg] ** 2).sum(-1).mean()
    return bpr + reg


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--users", type=int, default=400)
    parser.add_argument("--items", type=int, default=600)
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--layers", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--lr", type=float, default=1e-2)
    args = parser.parse_args(argv)
    device = select_platform()

    pairs = make_interactions(args.users, args.items, per_user=12,
                              num_clusters=4, seed=0)
    U, I = args.users, args.items
    src, dst = pairs[:, 0], pairs[:, 1] + U
    edges = np.stack([np.concatenate([src, dst]),
                      np.concatenate([dst, src])], 1)
    gt = Graph(edges, num_nodes=U + I).tensor(device)

    rng = np.random.default_rng(1)
    mask = rng.random(len(pairs)) < 0.9
    train_pairs, test_pairs = pairs[mask], pairs[~mask]

    gen = torch.Generator(device=device).manual_seed(0)
    emb = (torch.randn(U + I, args.dim, generator=gen, device=device)
           * 0.1).requires_grad_()
    model = NGCF(args.dim, num_layers=args.layers,
                 generator=torch.Generator().manual_seed(1), device=device)
    opt = torch.optim.Adam([emb, *model.parameters()], lr=args.lr)

    tr_u = torch.as_tensor(train_pairs[:, 0], device=device).long()
    tr_i = torch.as_tensor(train_pairs[:, 1] + U, device=device).long()

    losses = []
    t0 = time.time()
    for epoch in range(args.epochs):
        neg = torch.randint(U, U + I, (tr_u.shape[0],), generator=gen,
                            device=device)
        opt.zero_grad()
        loss = bpr_loss(model, emb, gt, tr_u, tr_i, neg)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 20 == 0:
            print(f"epoch {epoch}: bpr loss {loss.item():.4f}")

    with torch.no_grad():
        h = model(gt, emb).cpu().numpy()
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
    ms = (time.time() - t0) / args.epochs * 1000
    print(f"NGCF: recall@20 {hits/total:.4f} ({ms:.1f} ms/epoch)")
    losses = torch.stack(losses).cpu().numpy()
    return {"recall@20": hits / total, "ms_per_epoch": ms,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
