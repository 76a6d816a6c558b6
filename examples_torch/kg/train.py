"""Knowledge-graph embedding training on ``pgl_tpu_torch`` (port of
``examples/kg/train.py``; reference: ``apps/Graph4KG/train.py``):
score-function model + self-adversarial negative sampling + filtered
MRR/Hits@k evaluation. Reads FB15k-style triple files when ``--data-path``
is given (a loader error ends the run); otherwise trains on a synthetic
relational graph.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

from pgl_tpu_torch.models.kg import KGEModel, filtered_ranks, mrr_hits
from pgl_tpu_torch.utils.platform import select_platform


def load_triples(path):
    """FB15k format: train.txt/valid.txt/test.txt with 'h\\tr\\tt' names."""
    ent2id, rel2id = {}, {}

    def read(split):
        triples = []
        with open(os.path.join(path, f"{split}.txt")) as f:
            for line in f:
                h, r, t = line.strip().split("\t")
                triples.append((ent2id.setdefault(h, len(ent2id)),
                                rel2id.setdefault(r, len(rel2id)),
                                ent2id.setdefault(t, len(ent2id))))
        return np.asarray(triples, dtype=np.int64)

    train, valid, test = read("train"), read("valid"), read("test")
    return train, valid, test, len(ent2id), len(rel2id)


def synthetic_triples(num_ents=2000, num_rels=8, per_rel=2000, seed=0,
                      latent_dim=16):
    """Planted-TransE task: sample true entity points and relation
    translations, link each (h, r) to the entity nearest h* + r* — exactly
    realizable by the model family, so metrics measure the trainer."""
    rng = np.random.default_rng(seed)
    ents = rng.normal(size=(num_ents, latent_dim))
    rels = rng.normal(size=(num_rels, latent_dim)) * 0.5
    triples = []
    for r in range(num_rels):
        heads = rng.choice(num_ents, per_rel, replace=False)
        shifted = ents[heads] + rels[r]
        # nearest entity to each shifted point
        d = ((shifted[:, None, :] - ents[None, :, :]) ** 2).sum(-1)
        tails = d.argmin(1)
        triples.extend((int(h), r, int(t)) for h, t in zip(heads, tails))
    triples = np.asarray(triples, dtype=np.int64)
    rng.shuffle(triples)
    n = len(triples)
    return (triples[:int(n * 0.9)], triples[int(n * 0.9):int(n * 0.95)],
            triples[int(n * 0.95):], num_ents, num_rels)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--score", default="transe",
                        choices=["transe", "distmult", "complex", "rotate",
                                 "quate", "ote"])
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--embed-dim", type=int, default=128)
    parser.add_argument("--gamma", type=float, default=12.0)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--neg-num", type=int, default=64)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--eval-batch", type=int, default=256)
    args = parser.parse_args(argv)
    device = select_platform()

    if args.data_path:
        train, valid, test, n_ents, n_rels = load_triples(args.data_path)
    else:
        train, valid, test, n_ents, n_rels = synthetic_triples()
    print(f"ents {n_ents} rels {n_rels} train {len(train)} test {len(test)}")

    model = KGEModel(n_ents, n_rels, args.embed_dim, score=args.score,
                     gamma=args.gamma, device=device)
    params = model.params
    opt = torch.optim.Adam(list(params.values()), lr=args.lr)
    train_d = torch.as_tensor(train, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        idx = torch.randint(0, len(train), (args.batch_size,),
                            generator=gen, device=device)
        batch = train_d[idx]
        neg = torch.randint(0, n_ents, (args.neg_num,), generator=gen,
                            device=device)
        opt.zero_grad()
        loss = model.loss_fn(params, batch[:, 0], batch[:, 1], batch[:, 2],
                             neg)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % 500 == 0:
            print(f"step {i}: loss {loss.item():.4f} "
                  f"({time.time()-t0:.1f}s)")
    ms = (time.time() - t0) / max(args.steps, 1) * 1e3

    # filtered tail-prediction evaluation
    known = {}
    for h, r, t in np.concatenate([train, valid, test]):
        known.setdefault((int(h), int(r)), set()).add(int(t))
    ranks = []
    with torch.no_grad():
        for lo in range(0, len(test), args.eval_batch):
            batch = test[lo:lo + args.eval_batch]
            scores = model.predict_all_tails(
                params, torch.as_tensor(batch[:, 0], device=device),
                torch.as_tensor(batch[:, 1], device=device))
            mask = np.zeros((len(batch), n_ents), dtype=bool)
            for i, (h, r, t) in enumerate(batch):
                mask[i, list(known.get((int(h), int(r)), ()))] = True
            ranks.append(filtered_ranks(
                scores, torch.as_tensor(batch[:, 2], device=device),
                torch.as_tensor(mask, device=device)).cpu().numpy())
    metrics = mrr_hits(np.concatenate(ranks))
    print(" ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    losses = torch.stack(losses).cpu().numpy()
    return {**metrics, "ms_per_step": ms, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
