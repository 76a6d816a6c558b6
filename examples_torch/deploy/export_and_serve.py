"""Inference deployment on ``pgl_tpu_torch`` (port of
``examples/deploy/export_and_serve.py``; reference: ``examples/gnn_depoly``
— ``paddle.jit.to_static`` export + ``paddle.inference`` serving): train a
GCN, export the closed inference function with ``torch.export`` (K1 is the
custom op ``torch.ops.pgl_tpu_torch.spmm`` in the program), reload it in a
fresh Predictor and serve node classifications."""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch
import torch.nn.functional as F

from pgl_tpu_torch.datasets import community_graph
from pgl_tpu_torch.models import GCN
from pgl_tpu_torch.utils.export import export_model, Predictor
from pgl_tpu_torch.utils.platform import select_platform


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--epochs", type=int, default=100)
    args = parser.parse_args(argv)
    device = select_platform()

    g, y = community_graph(num_nodes=500, num_classes=4, feat_dim=32,
                           avg_degree=8, seed=0)
    gt = g.tensor(device)
    x = gt.node_feat["h"]
    yt = torch.as_tensor(y, device=device).long()
    model = GCN(input_size=32, num_class=4, hidden_size=32, dropout=0.0,
                generator=torch.Generator().manual_seed(0), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    losses = []
    for _ in range(args.epochs):
        opt.zero_grad()
        loss = F.cross_entropy(model(gt, x), yt)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    model.eval()
    with torch.no_grad():
        direct = model(gt, x)
    acc_train = float((direct.argmax(-1) == yt).float().mean())
    print(f"trained: acc {acc_train:.3f}")

    out_path = args.out or os.path.join(tempfile.mkdtemp(), "gcn.pt2")
    export_model(lambda feats: model(gt, feats), [x], out_path)
    print(f"exported to {out_path} "
          f"({os.path.getsize(out_path)/1e6:.2f} MB)")

    predictor = Predictor(out_path)
    logits = predictor.run(x).cpu().numpy()
    direct = direct.cpu().numpy()
    max_err = float(np.abs(logits - direct).max())
    acc_serve = float((logits.argmax(-1) == y).mean())
    print(f"served: acc {acc_serve:.3f} (max |served-direct| = {max_err:.2e})")
    losses = torch.stack(losses).cpu().numpy()
    return {"acc_train": acc_train, "acc_serve": acc_serve,
            "max_err": max_err, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
