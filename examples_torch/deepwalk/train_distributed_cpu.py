"""Distributed deepwalk on ``pgl_tpu_torch``: N trainer processes against
async parameter servers (port of ``examples/deepwalk/
train_distributed_cpu.py``; reference: ``examples/deepwalk/
train_distributed_cpu.py`` — fleet ``a_sync=True`` with 2 pservers + N
trainers; published result BlogCatalog MacroF1 0.233).

Topology (all localhost):

  S shard servers   ``pgl_tpu_torch.distributed.ps.EmbeddingShardService``,
                    each owning rows ``id % S == shard`` of the emb/ctx
                    tables, applying adagrad on push; they run as server
                    threads of this launching process.
  T trainers        processes of this script (``--trainer``), each walking
                    its own slice of start nodes, generating skip-gram
                    pairs (C++ kernel), pulling unique rows to the script's
                    device (the card, or the CPU with
                    ``PGL_TPU_PLATFORM=cpu``), running the pair loss and
                    pushing sparse grads async.
  launcher          after every trainer is done, dumps the table and fits
                    a one-vs-rest logistic probe -> MacroF1.

Every wait is bounded (``TRAINER_TIMEOUT_S``, the reference's 1200 s);
a trainer that fails makes the
script exit non-zero.

Run:  python examples_torch/deepwalk/train_distributed_cpu.py
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

TRAINER_TIMEOUT_S = 1200    # the longest the launcher waits for its trainers


def macro_f1_probe(emb, labels, train_frac=0.5, seed=0, epochs=300,
                   lr=0.5):
    """One-vs-rest logistic probe on frozen embeddings -> MacroF1.

    numpy-only (no sklearn); good enough to rank embedding quality the way
    the reference's scoring scripts do.
    """
    n, k = labels.shape
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    tr, te = order[: int(n * train_frac)], order[int(n * train_frac):]
    x = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    xt = np.concatenate([x, np.ones((n, 1), np.float32)], axis=1)
    w = np.zeros((xt.shape[1], k), np.float32)
    y = labels.astype(np.float32)
    for _ in range(epochs):
        z = xt[tr] @ w
        p = 1.0 / (1.0 + np.exp(-z))
        g = xt[tr].T @ (p - y[tr]) / len(tr)
        w -= lr * g
    p = 1.0 / (1.0 + np.exp(-(xt[te] @ w)))
    # reference eval convention: predict top-|labels| per node
    kcounts = labels[te].sum(1).astype(int)
    pred = np.zeros_like(labels[te])
    for i, kc in enumerate(kcounts):
        if kc > 0:
            pred[i, np.argsort(-p[i])[:kc]] = 1
    f1s = []
    for c in range(k):
        tp = int((pred[:, c] & labels[te][:, c]).sum())
        fp = int((pred[:, c] & ~labels[te][:, c].astype(bool)).sum())
        fn = int((~pred[:, c].astype(bool) & labels[te][:, c]).sum())
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1s.append(2 * prec * rec / max(prec + rec, 1e-9))
    return float(np.mean(f1s))


def run_trainer(args):
    """One trainer: a walk-based Graph4Rec trainer on the PS tables,
    starting walks from the nodes ``id % trainers == rank``."""
    from pgl_tpu_torch.apps.graph4rec import Graph4RecTrainer
    from pgl_tpu_torch.datasets import blogcatalog_shaped_graph
    from pgl_tpu_torch.utils.config import Config
    from pgl_tpu_torch.utils.platform import select_platform

    device = select_platform()
    rank, world = args.trainer, args.trainers
    g, _ = blogcatalog_shaped_graph(seed=0, num_nodes=args.nodes)
    cfg = Config({
        "model_type": "walk_based", "walk_mode": "deepwalk",
        "embed_dim": 32, "walk_len": 12, "win_size": 3, "neg_num": 4,
        "walks_per_node": 2, "batch_pairs": 2048, "epochs": args.epochs,
        "lr": 0.1,
    })
    tr = Graph4RecTrainer(cfg, graph=g, seed=100 + rank,
                          ps_addresses=args.ps.split(","), device=device)
    # shard start nodes across trainers (the reference shards files)
    orig = tr._start_nodes

    def sharded():
        nodes = np.asarray(orig())
        return nodes[nodes % world == rank]

    tr._start_nodes = sharded
    t0 = time.time()
    losses = []
    for epoch in range(args.epochs):      # Graph4RecTrainer.train's loop
        total, steps = 0.0, 0
        for bs, bd, valid in tr.batches(epoch):
            total += float(tr.step(bs, bd, valid))
            steps += 1
        losses.append(total / max(steps, 1))
    for t in tr.ps.values():
        t.flush()
        t.close()
    with open(os.path.join(args.out, f"trainer{rank}.json"), "w") as f:
        json.dump({"losses": losses, "seconds": time.time() - t0}, f)


def wait_trainers(procs, out_dir, timeout):
    """Wait at most ``timeout`` seconds for every trainer; on a failed or
    late one stop the rest and exit non-zero."""
    deadline = time.time() + timeout
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad or time.time() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            r = bad[0] if bad else 0
            with open(os.path.join(out_dir, f"trainer{r}.log")) as f:
                sys.stderr.write(f.read()[-4000:])
            raise SystemExit(f"trainer {r} failed" if bad else
                             f"trainers did not finish in {timeout} s")
        time.sleep(0.05)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(os.path.join(out_dir, f"trainer{bad[0]}.log")) as f:
            sys.stderr.write(f.read()[-4000:])
        raise SystemExit(f"trainer {bad[0]} failed")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--trainers", type=int, default=4)
    ap.add_argument("--shards", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--trainer", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ps", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.trainer is not None:
        return run_trainer(args)

    from pgl_tpu_torch.datasets import blogcatalog_shaped_graph
    from pgl_tpu_torch.distributed.ps import (PSEmbedding,
                                              start_shard_server)
    from pgl_tpu_torch.utils.platform import select_platform

    select_platform()       # the trainers' device: fail here without it
    servers = [start_shard_server(s, args.shards)
               for s in range(args.shards)]
    addrs = [f"127.0.0.1:{s.port}" for s in servers]
    print(f"shard servers: {addrs}")
    try:
        with tempfile.TemporaryDirectory(prefix="dist_deepwalk_") as out:
            t0 = time.time()
            procs, logs = [], []
            for r in range(args.trainers):
                log = open(os.path.join(out, f"trainer{r}.log"), "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), *argv,
                     "--trainer", str(r), "--ps", ",".join(addrs),
                     "--out", out], stdout=log, stderr=subprocess.STDOUT))
            try:
                wait_trainers(procs, out, TRAINER_TIMEOUT_S)
            finally:
                for log in logs:
                    log.close()
            losses = []
            for r in range(args.trainers):
                with open(os.path.join(out, f"trainer{r}.json")) as f:
                    losses.append(json.load(f)["losses"])
                print(f"trainer {r} done, final loss {losses[-1][-1]:.4f}")
            wall = time.time() - t0
            print(f"training wall: {wall:.1f}s "
                  f"({args.trainers} trainers x {args.shards} shards)")

        # rank-0-style eval: dump the table and probe
        g, labels = blogcatalog_shaped_graph(seed=0, num_nodes=args.nodes)
        emb = PSEmbedding(addrs, "emb", g.num_nodes, 32).dump()
        f1 = macro_f1_probe(emb, labels)
        print(f"MacroF1 (one-vs-rest probe): {f1:.4f}  "
              "(reference dist deepwalk on real BlogCatalog: 0.233)")
    finally:
        for s in servers:
            s.stop()
    return {"macro_f1": f1, "wall_s": wall,
            "trainer_losses": [t[-1] for t in losses],
            "loss_first": float(np.mean([t[0] for t in losses])),
            "loss_last": float(np.mean([t[-1] for t in losses]))}


if __name__ == "__main__":
    main()
