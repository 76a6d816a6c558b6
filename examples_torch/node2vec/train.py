"""node2vec embeddings + downstream node classification on
``pgl_tpu_torch`` (port of ``examples/node2vec/train.py``; reference:
``examples/node2vec``): p/q-biased second-order walks feed skip-gram
training; a linear probe on the frozen embeddings measures quality.
``--plus`` switches to the node2vec+ accumulated-neighborhood variant."""

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
from pgl_tpu_torch.sampling import node2vec_walk, node2vec_walk_plus
from pgl_tpu_torch.utils.platform import select_platform
from pgl_tpu_torch.utils.transform import to_undirected


def pair_loss(e, s, d, neg):
    """Skip-gram over one embedding table, one negative a pair."""
    pos = (e[s] * e[d]).sum(-1)
    ngs = (e[s] * e[neg]).sum(-1)
    return (-F.logsigmoid(pos) - F.logsigmoid(-ngs)).mean()


def linear_probe(e, y, num_class, steps=200, lr=0.1, seed=3):
    """Softmax regression on frozen embeddings (Adam from zeros) trained
    on a random half, accuracy on the other half."""
    n = len(e)
    perm = np.random.default_rng(seed).permutation(n)
    tr, te = perm[:n // 2], perm[n // 2:]
    ej = torch.as_tensor(e)
    yj = torch.as_tensor(np.asarray(y), device=ej.device).long()
    w = torch.zeros(e.shape[1], num_class, dtype=ej.dtype,
                    device=ej.device, requires_grad=True)
    popt = torch.optim.Adam([w], lr=lr)
    for _ in range(steps):
        popt.zero_grad()
        F.cross_entropy(ej[tr] @ w, yj[tr]).backward()
        popt.step()
    with torch.no_grad():
        return float(((ej[te] @ w).argmax(-1) == yj[te]).float().mean())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--p", type=float, default=0.25)
    parser.add_argument("--q", type=float, default=4.0)
    parser.add_argument("--plus", action="store_true",
                        help="node2vec+ (accumulated-neighborhood bias)")
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--walk-len", type=int, default=20)
    parser.add_argument("--win", type=int, default=5)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--steps-per-epoch", type=int, default=200)
    args = parser.parse_args(argv)
    device = select_platform()

    g, y = community_graph(num_nodes=600, num_classes=4, feat_dim=8,
                           avg_degree=10, noise=2.0, p_inter=0.05, seed=0)
    g = to_undirected(g)
    n = g.num_nodes

    walker = node2vec_walk_plus if args.plus else node2vec_walk
    t0 = time.time()
    srcs, dsts = [], []
    for epoch in range(args.epochs):
        walks = walker(g, np.arange(n), args.walk_len, p=args.p, q=args.q,
                       seed=epoch)
        s, d = skip_gram_gen_pair(walks, args.win, seed=epoch)
        srcs.append(s)
        dsts.append(d)
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    print(f"{len(src)} pairs from {args.epochs} walk epochs "
          f"({'node2vec+' if args.plus else 'node2vec'}, "
          f"p={args.p} q={args.q})")

    gen = torch.Generator(device=device).manual_seed(0)
    emb = (torch.randn(n, args.dim, generator=gen, device=device)
           * 0.1).requires_grad_()
    opt = torch.optim.Adam([emb], lr=0.025)
    B = 4096
    src_d = torch.as_tensor(src, device=device).long()
    dst_d = torch.as_tensor(dst, device=device).long()

    rng = np.random.default_rng(2)
    losses = []
    t1 = time.time()
    total_steps = args.epochs * args.steps_per_epoch
    for i in range(total_steps):
        sel = torch.as_tensor(rng.integers(0, len(src), B), device=device)
        neg = torch.randint(0, n, (B,), generator=gen, device=device)
        opt.zero_grad()
        loss = pair_loss(emb, src_d[sel], dst_d[sel], neg)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    ms = (time.time() - t1) / max(total_steps, 1) * 1e3

    # linear probe on frozen embeddings
    acc = linear_probe(emb.detach(), y, 4)
    losses = torch.stack(losses).cpu().numpy()
    print(f"node2vec: probe acc {acc:.4f} "
          f"(skip-gram loss {losses[-1]:.4f}, {time.time()-t0:.1f}s)")
    return {"probe_acc": acc, "ms_per_step": ms,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
