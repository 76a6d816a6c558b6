"""Graph-based clustering on ``pgl_tpu_torch`` (port of
``examples/clustering/train.py``; reference:
``examples/graph_based_clustering_demo``): node2vec embeddings + k-means.
The reference trains node2vec on Cora and runs sklearn k-means on the
embedding file; here the walks/skip-gram run on the same pipeline and a
small numpy k-means (k-means++ seeding) does the clustering, scored by
normalized mutual information against the planted communities."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch
import torch.nn.functional as F

from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.native.graph_kernel import skip_gram_gen_pair
from pgl_tpu_torch.sampling import node2vec_walk
from pgl_tpu_torch.utils.platform import select_platform
from pgl_tpu_torch.utils.transform import to_undirected


def kmeans(x, k, iters=50, seed=0):
    """numpy k-means with k-means++ seeding."""
    rng = np.random.default_rng(seed)
    centers = [x[rng.integers(len(x))]]
    for _ in range(k - 1):  # k-means++: sample far points
        d2 = np.min([((x - c) ** 2).sum(1) for c in centers], 0)
        centers.append(x[rng.choice(len(x), p=d2 / d2.sum())])
    centers = np.stack(centers)
    for _ in range(iters):
        assign = ((x[:, None] - centers[None]) ** 2).sum(-1).argmin(1)
        for c in range(k):
            pts = x[assign == c]
            if len(pts):
                centers[c] = pts.mean(0)
    return assign


def nmi(a, b):
    """Normalized mutual information between two labelings."""
    eps = 1e-12
    ka, kb = a.max() + 1, b.max() + 1
    joint = np.zeros((ka, kb))
    for i, j in zip(a, b):
        joint[i, j] += 1
    joint /= len(a)
    pa, pb = joint.sum(1), joint.sum(0)
    mi = (joint * np.log(joint / (pa[:, None] * pb[None] + eps) + eps)).sum()
    ha = -(pa * np.log(pa + eps)).sum()
    hb = -(pb * np.log(pb + eps)).sum()
    return mi / max(np.sqrt(ha * hb), eps)


def pair_loss(e, s, d, neg):
    """Skip-gram over one embedding table, one negative a pair."""
    pos = (e[s] * e[d]).sum(-1)
    ngs = (e[s] * e[neg]).sum(-1)
    return (-F.logsigmoid(pos) - F.logsigmoid(-ngs)).mean()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--clusters", type=int, default=4)
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--steps", type=int, default=400)
    args = parser.parse_args(argv)
    device = select_platform()

    g, y = community_graph(num_nodes=600, num_classes=args.clusters,
                           feat_dim=8, avg_degree=10, noise=2.0,
                           p_inter=0.05, seed=0)
    g = to_undirected(g)
    n = g.num_nodes

    walks = node2vec_walk(g, np.arange(n).repeat(4), 20, p=0.25, q=4.0,
                          seed=0)
    src, dst = skip_gram_gen_pair(walks, 5, seed=1)

    gen = torch.Generator(device=device).manual_seed(0)
    emb = (torch.randn(n, args.dim, generator=gen, device=device)
           * 0.1).requires_grad_()
    opt = torch.optim.Adam([emb], lr=0.025)
    B = 4096
    src_d = torch.as_tensor(src, device=device).long()
    dst_d = torch.as_tensor(dst, device=device).long()

    rng = np.random.default_rng(2)
    losses = []
    t0 = time.time()
    for _ in range(args.steps):
        sel = torch.as_tensor(rng.integers(0, len(src), B), device=device)
        neg = torch.randint(0, n, (B,), generator=gen, device=device)
        opt.zero_grad()
        loss = pair_loss(emb, src_d[sel], dst_d[sel], neg)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    ms = (time.time() - t0) / max(args.steps, 1) * 1e3

    e = emb.detach().cpu().numpy()
    e /= np.linalg.norm(e, axis=1, keepdims=True).clip(1e-9)
    assign = kmeans(e, args.clusters, seed=3)
    score = float(nmi(np.asarray(y), assign))
    print(f"graph clustering: NMI {score:.4f} over {args.clusters} clusters")
    losses = torch.stack(losses).cpu().numpy()
    return {"nmi": score, "ms_per_step": ms, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
