"""Minibatch GraphSAGE on ``pgl_tpu_torch`` (port of
``examples/graphsage/train.py``; reference: ``examples/graphsage/
cpu_sample_version/train.py``): a multiprocess Dataloader runs
``graphsage_sample`` in workers, batches are bucket-padded to static shapes,
and each worker also builds the padded batch's K1 layouts on the host, so
the step on the card builds nothing.

With ``--data-path`` pointing at the Reddit npz files this is the reference
Reddit pipeline (a loader error ends the run); otherwise a synthetic
community graph keeps it runnable. ``--device-sampler`` samples on the
device instead (``NeighborSampler`` + ``BipartiteSAGE``).
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

from pgl_tpu_torch.datasets import RedditDataset, community_graph
from pgl_tpu_torch.models import GraphSage
from pgl_tpu_torch.sampling import make_padded_batch_fn, padded_batch_graph
from pgl_tpu_torch.utils.data import Dataset, Dataloader
from pgl_tpu_torch.utils.platform import select_platform


class ShardedNodeDataset(Dataset):
    def __init__(self, nodes, labels):
        self.nodes = np.asarray(nodes)
        self.labels = np.asarray(labels)

    def __getitem__(self, idx):
        return self.nodes[idx], self.labels[idx]

    def __len__(self):
        return len(self.nodes)


def masked_ce(logits, y, mask):
    losses = F.cross_entropy(logits, y, reduction="none")
    return (losses * mask).sum() / mask.sum().clamp(min=1.0)


def run_device_sampled(args, graph, feat, train_nodes, train_y, test_nodes,
                       test_y, num_classes, device):
    """Device pipeline: NeighborSampler + BipartiteSAGE sample, gather
    features, run the layers, the loss and the gradients on the device — no
    host sampling, no per-batch host-to-device copy of a batch (the
    reference's GPU NeighborSampler path)."""
    from pgl_tpu_torch.models import BipartiteSAGE
    from pgl_tpu_torch.sampling import NeighborSampler

    sampler = NeighborSampler(graph, samples=args.samples, device=device)
    model = BipartiteSAGE(input_size=np.asarray(feat).shape[1],
                          num_class=num_classes,
                          num_layers=len(args.samples),
                          hidden_size=args.hidden,
                          generator=torch.Generator().manual_seed(1),
                          device=device)
    feat_dev = torch.as_tensor(np.asarray(feat, np.float32), device=device)
    all_y = np.zeros(graph.num_nodes, np.int64)
    all_y[np.asarray(train_nodes)] = np.asarray(train_y)
    all_y[np.asarray(test_nodes)] = np.asarray(test_y)
    y_dev = torch.as_tensor(all_y, device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(2)

    B = args.batch_size
    train_nodes = np.asarray(train_nodes)
    losses = []
    steps_all, t_all = 0, 0.0
    for epoch in range(args.epochs):
        order = np.random.default_rng(epoch).permutation(len(train_nodes))
        t0, steps, total = time.time(), 0, 0.0
        for lo in range(0, len(order) - B + 1, B):
            seeds = torch.as_tensor(train_nodes[order[lo:lo + B]],
                                    device=device)
            sampled, _ = sampler.sample(seeds, gen)
            opt.zero_grad()
            loss = F.cross_entropy(model(feat_dev, seeds, sampled),
                                   y_dev[seeds])
            loss.backward()
            opt.step()
            steps += 1
            total += loss.item()
        losses.append(total / max(steps, 1))
        steps_all += steps
        t_all += time.time() - t0
        print(f"epoch {epoch}: loss {total/max(steps,1):.4f} "
              f"({steps} steps, {time.time()-t0:.1f}s, device-sampled)")

    correct = tested = 0
    test_nodes = np.asarray(test_nodes)
    with torch.no_grad():
        for lo in range(0, len(test_nodes) - B + 1, B):
            seeds = torch.as_tensor(test_nodes[lo:lo + B], device=device)
            sampled, _ = sampler.sample(seeds, gen)
            pred = model(feat_dev, seeds, sampled).argmax(-1)
            correct += int((pred.cpu().numpy()
                            == all_y[test_nodes[lo:lo + B]]).sum())
            tested += B
    acc = correct / max(tested, 1)
    print(f"test acc: {acc:.4f}")
    return {"test_acc": acc, "ms_per_step": t_all / max(steps_all, 1) * 1e3,
            "loss_first": losses[0], "loss_last": losses[-1]}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--samples", type=int, nargs="+", default=[25, 10])
    parser.add_argument("--hidden", type=int, default=128)
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--device-sampler", action="store_true",
                        help="sample on device (BipartiteSAGE) instead of "
                             "Dataloader workers")
    args = parser.parse_args(argv)
    device = select_platform()

    if args.data_path:
        ds = RedditDataset(data_path=args.data_path)
        graph, feat = ds.graph, ds.feature
        train_nodes, train_y = ds.train_index, ds.train_label
        test_nodes, test_y = ds.test_index, ds.test_label
        num_classes = ds.num_classes
    else:
        graph, y = community_graph(num_nodes=3000, num_classes=5,
                                   feat_dim=64, avg_degree=10, seed=0)
        feat = graph.node_feat["h"]
        perm = np.random.default_rng(0).permutation(3000)
        train_nodes, test_nodes = perm[:2000], perm[2000:]
        train_y, test_y = y[train_nodes], y[test_nodes]
        num_classes = 5

    if args.device_sampler:
        return run_device_sampled(args, graph, feat, train_nodes, train_y,
                                  test_nodes, test_y, num_classes, device)

    n_bucket = 1 << int(np.ceil(np.log2(
        args.batch_size * (1 + np.prod(args.samples)) + 1)))
    e_bucket = n_bucket * 4
    model = GraphSage(input_size=np.asarray(feat).shape[1],
                      num_class=num_classes, hidden_size=args.hidden,
                      dropout=0.0, generator=torch.Generator().manual_seed(0),
                      device=device)
    # the collate samples, pads and builds the batch graph's K1 layouts,
    # numpy only, in the workers: one int32 buffer a batch
    batch_fn = make_padded_batch_fn(graph, args.samples, n_bucket, e_bucket,
                                    pack=True, layouts=True)
    feat_dev = torch.as_tensor(np.asarray(feat, np.float32), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def device_batch(buf):
        return padded_batch_graph(torch.from_numpy(buf).to(device),
                                  n_bucket, e_bucket, host=buf)

    losses = []
    steps_all, t_all = 0, 0.0
    for epoch in range(args.epochs):
        loader = Dataloader(ShardedNodeDataset(train_nodes, train_y),
                            batch_size=args.batch_size, shuffle=True,
                            num_workers=args.num_workers,
                            collate_fn=batch_fn, seed=epoch)
        t0, steps, loss = time.time(), 0, None
        for buf in loader:
            g, sidx, smask, y_b, mask = device_batch(buf)
            x = feat_dev.index_select(0, sidx.long()) * smask
            opt.zero_grad()
            loss = masked_ce(model(g, x), y_b.long(), mask)
            loss.backward()
            opt.step()
            loss = loss.detach()
            steps += 1
        losses.append(loss.item())
        steps_all += steps
        t_all += time.time() - t0
        print(f"epoch {epoch}: loss {loss.item():.4f} "
              f"({steps} steps, {time.time()-t0:.1f}s)")

    # evaluation with the same sampler
    correct = tested = 0
    eval_loader = Dataloader(ShardedNodeDataset(test_nodes, test_y),
                             batch_size=args.batch_size,
                             collate_fn=batch_fn)
    with torch.no_grad():
        for buf in eval_loader:
            g, sidx, smask, y_b, mask = device_batch(buf)
            x = feat_dev.index_select(0, sidx.long()) * smask
            pred = model(g, x).argmax(-1)
            m = mask > 0
            correct += int((pred[m] == y_b.long()[m]).sum())
            tested += int(m.sum())
    acc = correct / max(tested, 1)
    print(f"test acc: {acc:.4f}")
    return {"test_acc": acc, "ms_per_step": t_all / max(steps_all, 1) * 1e3,
            "loss_first": losses[0], "loss_last": losses[-1]}


if __name__ == "__main__":
    main()
