"""DeepWalk / node2vec skip-gram embedding training on ``pgl_tpu_torch``
(port of ``examples/deepwalk/train.py``; reference: ``examples/deepwalk/``,
``examples/node2vec/``): C++ host kernels generate walks and skip-gram
pairs in Dataloader workers, the device trains a negative-sampling
skip-gram objective over an embedding table.
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

from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.native.graph_kernel import skip_gram_gen_pair
from pgl_tpu_torch.sampling import random_walk, node2vec_walk
from pgl_tpu_torch.utils.data import StreamDataset, Dataloader
from pgl_tpu_torch.utils.platform import select_platform


class WalkPairDataset(StreamDataset):
    def __init__(self, graph, walk_len, win_size, batch_pairs, p=1.0, q=1.0,
                 epoch_seed=0):
        self.graph = graph
        self.walk_len = walk_len
        self.win_size = win_size
        self.batch_pairs = batch_pairs
        self.p, self.q = p, q
        self.epoch_seed = epoch_seed

    def __iter__(self):
        batches = list(self.graph.node_batch_iter(256,
                                                  seed=self.epoch_seed))
        for i, nodes in enumerate(self._shard_iter(batches)):
            seed = self.epoch_seed * 131 + i
            if self.p == 1.0 and self.q == 1.0:
                walks = random_walk(self.graph, nodes, self.walk_len,
                                    seed=seed)
            else:
                walks = node2vec_walk(self.graph, nodes, self.walk_len,
                                      self.p, self.q, seed=seed)
            src, dst = skip_gram_gen_pair(walks, self.win_size, seed=seed)
            for lo in range(0, len(src) - self.batch_pairs + 1,
                            self.batch_pairs):
                yield (src[lo:lo + self.batch_pairs],
                       dst[lo:lo + self.batch_pairs])


def skipgram_loss(emb, ctx, src, dst, neg):
    """Negative-sampling skip-gram: ``neg`` [B, K] negatives a pair."""
    h = emb[src]
    pos = (h * ctx[dst]).sum(-1)
    negs = torch.einsum("bd,bkd->bk", h, ctx[neg])
    return -F.logsigmoid(pos).mean() - F.logsigmoid(-negs).mean()


def nn_agreement(emb, labels, n_sample, seed=0):
    """1-NN label agreement in (cosine) embedding space."""
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    sample = np.random.default_rng(seed).choice(len(emb), n_sample,
                                                replace=False)
    sims = emb[sample] @ emb.T
    np.put_along_axis(sims, sample[:, None], -np.inf, axis=1)
    return float((labels[sims.argmax(1)] == labels[sample]).mean())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--embed-dim", type=int, default=64)
    parser.add_argument("--walk-len", type=int, default=20)
    parser.add_argument("--win-size", type=int, default=5)
    parser.add_argument("--neg-num", type=int, default=5)
    parser.add_argument("--batch-pairs", type=int, default=4096)
    parser.add_argument("--p", type=float, default=1.0)
    parser.add_argument("--q", type=float, default=1.0)
    parser.add_argument("--num-workers", type=int, default=2)
    args = parser.parse_args(argv)
    device = select_platform()

    graph, labels = community_graph(num_nodes=2000, num_classes=4,
                                    feat_dim=1, avg_degree=10, seed=0)
    N = graph.num_nodes

    gen = torch.Generator(device=device).manual_seed(0)
    emb = (torch.randn(N, args.embed_dim, generator=gen, device=device)
           * 0.1).requires_grad_()
    ctx = torch.zeros(N, args.embed_dim, device=device, requires_grad=True)
    opt = torch.optim.Adam([emb, ctx], lr=5e-3)

    losses = []
    steps_all, t_all = 0, 0.0
    for epoch in range(args.epochs):
        ds = WalkPairDataset(graph, args.walk_len, args.win_size,
                             args.batch_pairs, args.p, args.q, epoch)
        loader = Dataloader(ds, batch_size=1,
                            num_workers=args.num_workers,
                            collate_fn=lambda b: b[0])
        t0, steps, total = time.time(), 0, 0.0
        for src, dst in loader:
            neg = torch.randint(0, N, (len(src), args.neg_num),
                                generator=gen, device=device)
            opt.zero_grad()
            loss = skipgram_loss(emb, ctx,
                                 torch.as_tensor(src, device=device).long(),
                                 torch.as_tensor(dst, device=device).long(),
                                 neg)
            loss.backward()
            opt.step()
            steps += 1
            total += loss.item()
        losses.append(total / max(steps, 1))
        steps_all += steps
        t_all += time.time() - t0
        print(f"epoch {epoch}: loss {total/max(steps,1):.4f} "
              f"({steps} steps, {time.time()-t0:.1f}s)")

    # quality check: 1-NN label agreement in embedding space
    agree = nn_agreement(emb.detach().cpu().numpy(), labels, 500)
    print(f"1-NN label agreement: {agree:.4f}")
    return {"nn_agreement": agree,
            "ms_per_step": t_all / max(steps_all, 1) * 1e3,
            "loss_first": losses[0], "loss_last": losses[-1]}


if __name__ == "__main__":
    main()
