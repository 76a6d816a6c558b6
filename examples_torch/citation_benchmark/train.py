"""Citation benchmark runner on ``pgl_tpu_torch`` (port of
``examples/citation_benchmark/train.py``): full-batch semi-supervised node
classification, one model per ``--model`` flag (GCN/GAT/APPNP/SGC/GCNII/...),
public split.

With ``--data-path`` pointing at downloaded Cora/Planetoid files it
reproduces the reference setting, and a loader error ends the run; without
it (no downloads here) it trains on a synthetic planted-community graph of
Cora's shape.

Usage:
  python train.py --model GCN [--dataset cora] [--data-path DIR]
                  [--epochs 200] [--runs 1]

Runs on the CUDA card; ``PGL_TPU_PLATFORM=cpu`` runs it on the CPU.
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

from pgl_tpu_torch.datasets import (CoraDataset, CitationDataset,
                                    community_graph)
from pgl_tpu_torch.models import (GCN, GAT, APPNPModel, SGC, SSGC, GATv2,
                                  GPRGNN, FAGCN, DeepGCNII, BernNet,
                                  ChebNetII, LSTMSage)
from pgl_tpu_torch.utils.platform import select_platform
from pgl_tpu_torch.utils.transform import add_self_loops, to_undirected


MODELS = {
    "GCN": lambda d, c, **kw: GCN(input_size=d, num_class=c, hidden_size=16,
                                  **kw),
    "LSTMSage": lambda d, c, **kw: LSTMSage(input_size=d, num_class=c,
                                            hidden_size=16, **kw),
    "GAT": lambda d, c, **kw: GAT(input_size=d, num_class=c, **kw),
    "APPNP": lambda d, c, **kw: APPNPModel(input_size=d, num_class=c, **kw),
    "SGC": lambda d, c, **kw: SGC(input_size=d, num_class=c, **kw),
    "GCNII": lambda d, c, **kw: DeepGCNII(input_size=d, num_class=c,
                                          k_hop=16, **kw),
    "BernNet": lambda d, c, **kw: BernNet(input_size=d, num_class=c, **kw),
    "ChebNetII": lambda d, c, **kw: ChebNetII(input_size=d, num_class=c,
                                              **kw),
    "SSGC": lambda d, c, **kw: SSGC(input_size=d, num_class=c, **kw),
    "GATv2": lambda d, c, **kw: GATv2(input_size=d, num_class=c, **kw),
    "GPRGNN": lambda d, c, **kw: GPRGNN(input_size=d, num_class=c, **kw),
    "FAGCN": lambda d, c, **kw: FAGCN(input_size=d, num_class=c, **kw),
}


def load_data(args):
    if args.data_path:
        if args.dataset == "cora":
            ds = CoraDataset(data_path=args.data_path)
        else:
            ds = CitationDataset(args.dataset, data_path=args.data_path)
        feat = ds.graph.node_feat["words"]
        return (ds.graph, feat, ds.y, ds.train_index, ds.val_index,
                ds.test_index, ds.num_classes)
    # synthetic stand-in with Cora's shape
    g, y = community_graph(num_nodes=2708, num_classes=7, feat_dim=1433,
                           avg_degree=4, noise=1.2, p_inter=0.15, seed=0)
    g = add_self_loops(to_undirected(g))
    rng = np.random.default_rng(0)
    perm = rng.permutation(2708)
    return (g, g.node_feat["h"], y, perm[:140], perm[200:500],
            perm[500:1500], 7)


def make_optimizer(model, lr, weight_decay):
    """optax.adamw: ``p <- p - lr (adam + wd p)``, torch's decoupled
    decay."""
    return torch.optim.AdamW(model.parameters(), lr=lr,
                             weight_decay=weight_decay)


def train_loss(model, gt, x, y, train_idx, training=True):
    logits = model(gt, x, training=training)
    return F.cross_entropy(logits[train_idx], y[train_idx])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="GCN", choices=sorted(MODELS))
    parser.add_argument("--dataset", default="cora",
                        choices=["cora", "citeseer", "pubmed"])
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--weight-decay", type=float, default=5e-4)
    parser.add_argument("--runs", type=int, default=1)
    args = parser.parse_args(argv)
    device = select_platform()

    graph, feat, y, train_idx, val_idx, test_idx, num_classes = \
        load_data(args)
    gt = graph.tensor(device)
    x = torch.as_tensor(np.asarray(feat, dtype=np.float32), device=device)
    y = torch.as_tensor(np.asarray(y), device=device).long()
    train_idx, val_idx, test_idx = (
        torch.as_tensor(np.asarray(i), device=device).long()
        for i in (train_idx, val_idx, test_idx))

    accs, losses = [], []
    ms = 0.0
    for run in range(args.runs):
        model = MODELS[args.model](
            x.shape[1], num_classes,
            generator=torch.Generator().manual_seed(run), device=device)
        opt = make_optimizer(model, args.lr, args.weight_decay)

        @torch.no_grad()
        def evaluate():
            pred = model(gt, x).argmax(-1)
            return ((pred[val_idx] == y[val_idx]).float().mean(),
                    (pred[test_idx] == y[test_idx]).float().mean())

        best_val, best_test = 0.0, 0.0
        run_losses = []
        t0 = time.time()
        for epoch in range(args.epochs):
            opt.zero_grad()
            loss = train_loss(model, gt, x, y, train_idx)
            loss.backward()
            opt.step()
            run_losses.append(loss.detach())
            if epoch % 10 == 0 or epoch == args.epochs - 1:
                val_acc, test_acc = evaluate()
                if float(val_acc) > best_val:
                    best_val, best_test = float(val_acc), float(test_acc)
        dt = (time.time() - t0) / args.epochs
        ms = dt * 1000
        print(f"run {run}: best val {best_val:.4f} test {best_test:.4f} "
              f"({dt*1000:.2f} ms/epoch)")
        accs.append(best_test)
        losses = torch.stack(run_losses).cpu().numpy()
    print(f"{args.model}: test acc {np.mean(accs):.4f} ± {np.std(accs):.4f}")
    return {"test_acc": float(np.mean(accs)),
            "test_acc_std": float(np.std(accs)), "ms_per_epoch": ms,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
