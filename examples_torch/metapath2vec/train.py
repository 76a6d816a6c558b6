"""metapath2vec on ``pgl_tpu_torch`` (port of
``examples/metapath2vec/train.py``; reference: ``examples/metapath2vec/``):
metapath-guided walks over a heterogeneous graph feed a skip-gram objective
on the device.
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

from pgl_tpu_torch.heter_graph import HeterGraph
from pgl_tpu_torch.native.graph_kernel import skip_gram_gen_pair
from pgl_tpu_torch.sampling import metapath_randomwalk
from pgl_tpu_torch.utils.platform import select_platform


def synthetic_heter(num_users=500, num_items=700, seed=0):
    """user—item bipartite with 4 planted communities."""
    rng = np.random.default_rng(seed)
    N = num_users + num_items
    u_com = rng.integers(0, 4, num_users)
    i_com = rng.integers(0, 4, num_items)
    src, dst = [], []
    for u in range(num_users):
        for _ in range(6):
            it = rng.integers(0, num_items)
            if u_com[u] == i_com[it] or rng.random() < 0.1:
                src.append(u)
                dst.append(num_users + it)
    edges = {
        "u2i": np.stack([src, dst], axis=1),
        "i2u": np.stack([dst, src], axis=1),
    }
    node_types = [(i, "u" if i < num_users else "i") for i in range(N)]
    return (HeterGraph(edges, num_nodes=N, node_types=node_types),
            np.concatenate([u_com, i_com]))


def skipgram_loss(emb, ctx, src, dst, neg):
    """Negative-sampling skip-gram: ``neg`` [B, K] negatives a pair."""
    h = emb[src]
    pos = (h * ctx[dst]).sum(-1)
    negs = torch.einsum("bd,bkd->bk", h, ctx[neg])
    return -F.logsigmoid(pos).mean() - F.logsigmoid(-negs).mean()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--metapath", default="u2i-i2u")
    parser.add_argument("--walk-len", type=int, default=12)
    parser.add_argument("--win-size", type=int, default=3)
    parser.add_argument("--embed-dim", type=int, default=64)
    parser.add_argument("--neg-num", type=int, default=5)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--batch-pairs", type=int, default=1024)
    parser.add_argument("--walks-per-node", type=int, default=4)
    args = parser.parse_args(argv)
    device = select_platform()

    hg, communities = synthetic_heter()
    N = hg.num_nodes

    gen = torch.Generator(device=device).manual_seed(0)
    emb = (torch.randn(N, args.embed_dim, generator=gen, device=device)
           * 0.1).requires_grad_()
    ctx = torch.zeros(N, args.embed_dim, device=device, requires_grad=True)
    opt = torch.optim.Adam([emb, ctx], lr=5e-3)

    starts = np.tile(hg.nodes_by_type("u"), args.walks_per_node)
    losses = []
    steps_all, t_all = 0, 0.0
    for epoch in range(args.epochs):
        walks = metapath_randomwalk(hg, starts, args.metapath,
                                    args.walk_len, seed=epoch)
        src, dst = skip_gram_gen_pair(walks, args.win_size, seed=epoch)
        src_d = torch.as_tensor(src, device=device).long()
        dst_d = torch.as_tensor(dst, device=device).long()
        t0, total, steps = time.time(), 0.0, 0
        for lo in range(0, len(src) - args.batch_pairs + 1,
                        args.batch_pairs):
            neg = torch.randint(0, N, (args.batch_pairs, args.neg_num),
                                generator=gen, device=device)
            opt.zero_grad()
            loss = skipgram_loss(emb, ctx, src_d[lo:lo + args.batch_pairs],
                                 dst_d[lo:lo + args.batch_pairs], neg)
            loss.backward()
            opt.step()
            total += loss.item()
            steps += 1
        losses.append(total / max(steps, 1))
        steps_all += steps
        t_all += time.time() - t0
        print(f"epoch {epoch}: loss {total/max(steps,1):.4f} "
              f"({steps} steps, {time.time()-t0:.1f}s)")

    e = emb.detach().cpu().numpy()
    e = e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-9)
    sample = np.random.default_rng(0).choice(N, 400, replace=False)
    sims = e[sample] @ e.T
    np.put_along_axis(sims, sample[:, None], -np.inf, axis=1)
    agree = float((communities[sims.argmax(1)]
                   == communities[sample]).mean())
    print(f"1-NN community agreement: {agree:.4f}")
    return {"nn_agreement": agree,
            "ms_per_step": t_all / max(steps_all, 1) * 1e3,
            "loss_first": losses[0], "loss_last": losses[-1]}


if __name__ == "__main__":
    main()
