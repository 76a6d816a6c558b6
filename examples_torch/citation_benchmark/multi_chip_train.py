"""Multi-process full-batch citation training over a HaloGraph on
``pgl_tpu_torch`` (port of ``examples/citation_benchmark/
multi_chip_train.py``; reference: ``examples/citation_benchmark/
multi_gpu_train.py`` + ``DistGPUGraph``, ``pgl/graph.py:1410-1553``).

Nodes are partitioned over the ranks of a ``torch.distributed`` group (one
rank a process; METIS-style cut minimization), each rank exchanges only the
boundary (halo) rows with the others, and comm volume is proportional to
the partition cut, not to N. The parameters are replicated and their
gradients summed over the ranks each step.

``--nprocs`` sets the number of ranks; the default is one rank a visible
card. Ranks that share a card talk over gloo, one rank a card over NCCL; on
the CPU (``PGL_TPU_PLATFORM=cpu``) over gloo:

  PGL_TPU_PLATFORM=cpu python multi_chip_train.py --nprocs 4 --epochs 150

The script starts its ranks as processes of itself (``--rank``), waits for
them at most ``RANK_TIMEOUT_S`` seconds and exits non-zero if any fails.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pgl_tpu_torch.datasets import cora_shaped_graph
from pgl_tpu_torch.nn.conv import _dense
from pgl_tpu_torch.parallel import HaloGraph, comm
from pgl_tpu_torch.utils.convert import flax_to_state_dict
from pgl_tpu_torch.utils.platform import select_platform
from pgl_tpu_torch.utils.transform import add_self_loops, to_undirected


class HaloGCN(nn.Module):
    """2-layer symmetric-normalized GCN over this rank's halo shard — the
    same ``send_u_recv`` contract as the single-process layers (``lin_0``,
    ``lin_1``: the flax module's names)."""

    def __init__(self, input_size, hidden, num_class, *, generator=None,
                 device=None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.lin_0 = _dense(input_size, hidden, gen)
        self.lin_1 = _dense(hidden, num_class, gen)
        self.to(device)

    def forward(self, hg, x, training=False):
        deg = hg.indegree().to(x.dtype).clamp(min=1.0) ** -0.5
        for i, lin in enumerate((self.lin_0, self.lin_1)):
            h = lin(x)
            x = hg.send_u_recv(h * deg[:, None], "sum") * deg[:, None]
            if i == 0:
                x = torch.relu(x)
        return x


class HaloGAT(nn.Module):
    """2-layer GAT — each layer runs the per-edge additive attention (K9/K10
    on the card) on this rank's shard after one boundary-row exchange."""

    def __init__(self, input_size, hidden, num_class, *, generator=None,
                 device=None):
        super().__init__()
        from pgl_tpu_torch.nn import GATConv
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.gat_0 = GATConv(input_size, hidden, num_heads=8, feat_drop=0.0,
                             attn_drop=0.6, activation="elu", generator=gen,
                             device=device)
        self.gat_1 = GATConv(hidden * 8, num_class, num_heads=1,
                             feat_drop=0.0, attn_drop=0.0, generator=gen,
                             device=device)

    def forward(self, hg, x, training=False):
        return self.gat_1(hg, self.gat_0(hg, x, training=training))


class HaloUniMP(nn.Module):
    """UniMP (TransformerConv stack, no label embedding) — dot-score
    attention per shard (K9/K10 dot mode on the card)."""

    def __init__(self, input_size, hidden, num_class, *, generator=None,
                 device=None):
        super().__init__()
        from pgl_tpu_torch.models import UniMP
        self.unimp = UniMP(input_size, num_class, num_layers=2,
                           hidden_size=hidden, num_heads=2, dropout=0.1,
                           use_label_embed=False, generator=generator,
                           device=device)

    def forward(self, hg, x, training=False):
        return self.unimp(hg, x, training=training)


MODELS = {"gcn": HaloGCN, "gat": HaloGAT, "unimp": HaloUniMP}
RANK_TIMEOUT_S = 1800       # the longest the launcher waits for its ranks


def load_reference_params(module, params):
    """The reference module's flax tree (numpy arrays) into ``module``."""
    device = next(module.parameters()).device
    module.load_state_dict(flax_to_state_dict(params, device), strict=True)


def citation_graph():
    g, labels, train_index = cora_shaped_graph(seed=0)
    return add_self_loops(to_undirected(g)), labels, train_index


def kernel_launches():
    """This process's kernel launches by family and shape (the wrappers'
    counts: K1 by ``(layout, D)``, the attention by ``(kernel, H, ...)``);
    empty on the CPU, where the plain versions run."""
    from pgl_tpu_torch.ops.kernels import attention_kernels, segment_kernels
    return {" ".join(map(str, key)): n
            for module in (segment_kernels, attention_kernels)
            for key, n in module.LAUNCHES_BY_SHAPE.items() if n}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(argv, size, out_dir, timeout):
    """Run ``size`` ranks of this script (``--rank r``) and wait for them;
    on a failed or late rank stop the others and exit non-zero. Returns
    rank 0's output."""
    port = free_port()
    procs, logs = [], []
    for r in range(size):
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv, "--rank",
             str(r), "--port", str(port), "--out", out_dir],
            stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, LOCAL_RANK=str(r))))
    deadline = time.time() + timeout
    failed = None
    while any(p.poll() is None for p in procs) and failed is None:
        failed = next((r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)), None)
        if time.time() > deadline:
            failed = "timeout"
        time.sleep(0.05)
    failed = failed if failed is not None else next(
        (r for r, p in enumerate(procs) if p.returncode != 0), None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for log in logs:
        log.close()
    if failed is not None:
        r = 0 if failed == "timeout" else failed
        with open(os.path.join(out_dir, f"rank{r}.log")) as f:
            sys.stderr.write(f.read()[-4000:])
        raise SystemExit(f"rank {failed} failed" if failed != "timeout"
                         else f"ranks did not finish in {timeout} s")
    with open(os.path.join(out_dir, "rank0.log")) as f:
        return f.read()


def run_rank(args):
    """One rank: join the group, take this rank's shard and train."""
    device = select_platform()
    size, rank = args.nprocs, args.rank
    if device.type == "cuda":
        device = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
    backend = "nccl" if device.type == "cuda" and \
        size <= torch.cuda.device_count() else "gloo"
    comm.init(backend, device=device,
              init_method=f"tcp://127.0.0.1:{args.port}", world_size=size,
              rank=rank)
    g, labels, train_index = citation_graph()
    N = g.num_nodes
    parts = np.load(os.path.join(args.out, "parts.npy")) \
        if args.partition == "metis" else None
    hg = HaloGraph.from_graph(g, parts=parts, partition=args.partition,
                              device=device)

    full_bytes = N * 4 * size                # psum-style [N] per shard
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"devices={size} halo={hg.halo_size} rows/layer "
        f"(comm {hg.comm_bytes_per_exchange/2**10:.0f} KiB/exchange/"
        f"feature-col vs {full_bytes/2**10:.0f} KiB full-replication)")
    rep = hg.scaling_report(feat_dim=g.node_feat["h"].shape[1])
    say(f"projected scaling efficiency {rep['scaling_efficiency']:.2f} "
        f"(edge skew {rep['edge_skew']:.2f}, "
        f"halo rows/shard {rep['halo_rows_recv']})")

    train_mask = np.zeros(N, np.float32)
    train_mask[np.asarray(train_index)] = 1.0
    test_mask = 1.0 - train_mask
    y = hg.shard_node_values(np.asarray(labels)).long()
    w_train = hg.shard_node_values(train_mask)
    w_test = hg.shard_node_values(test_mask)
    x = hg.node_feat["h"]
    n_train = float(train_mask.sum())

    model = MODELS[args.model](x.shape[1], args.hidden,
                               int(labels.max()) + 1,
                               generator=torch.Generator().manual_seed(0),
                               device=device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    params = list(model.parameters())

    losses = []
    t0 = time.time()
    for epoch in range(args.epochs):
        opt.zero_grad()
        logits = model(hg, x, training=True)
        # the ranks' losses sum to the global loss; so do the gradients
        loss = (F.cross_entropy(logits, y, reduction="none")
                * w_train).sum() / n_train
        loss.backward()
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        comm.all_reduce_(flat)
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p))
            at += p.numel()
        opt.step()
        total = comm.all_reduce_(loss.detach().clone())
        losses.append(total)
        if epoch % 25 == 0:
            say(f"epoch {epoch}: loss {float(total):.4f}")
    with torch.no_grad():
        pred = model(hg, x).argmax(-1)
        hit = comm.all_reduce_(((pred == y).float() * w_test).sum())
    acc = float(hit) / float(test_mask.sum())
    ms = (time.time() - t0) / args.epochs * 1000
    say(f"halo-sharded {args.model.upper()} [{args.partition} partition, "
        f"{size} devices]: test acc {acc:.4f} ({ms:.1f} ms/epoch)")
    if rank == 0:
        losses = torch.stack(losses).cpu().numpy()
        with open(os.path.join(args.out, "result.json"), "w") as f:
            json.dump({"test_acc": acc, "ms_per_epoch": ms,
                       "halo_size": hg.halo_size,
                       "loss_first": float(losses[0]),
                       "loss_last": float(losses[-1]),
                       "launches": kernel_launches()}, f)
    torch.distributed.destroy_process_group()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--hidden", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--partition", default="metis",
                        choices=["metis", "range"])
    parser.add_argument("--model", default="gcn",
                        choices=["gcn", "gat", "unimp"])
    parser.add_argument("--nprocs", type=int, default=None,
                        help="ranks (default: one a visible card)")
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        return run_rank(args)

    device = select_platform()
    if args.nprocs is None:
        args.nprocs = torch.cuda.device_count() \
            if device.type == "cuda" else 1
        argv += ["--nprocs", str(args.nprocs)]
    with tempfile.TemporaryDirectory(prefix="halo_citation_") as out:
        if args.partition == "metis":
            # one METIS assignment, computed here and handed to every rank
            from pgl_tpu_torch.partition import metis_partition
            g, _, _ = citation_graph()
            np.save(os.path.join(out, "parts.npy"), np.asarray(
                metis_partition(g, args.nprocs, balance="in_edges")))
        print(launch_ranks(argv, args.nprocs, out, RANK_TIMEOUT_S), end="")
        with open(os.path.join(out, "result.json")) as f:
            return json.load(f)


if __name__ == "__main__":
    main()
