#!/usr/bin/env python3
"""Where a step of the PGLBox model at full width goes, by embedding gather.

chip_smoke.py phase 17 (f)'s configuration (``PGLBoxGNNModel`` at
``emb_size`` 64, sage_mean with the sum interaction, 2 layers sampled
(25, 10) on the card over phase 16's 2M-edge user-item graph and its
reverse, two slot tables of 1,000 and 100 values, batches of 1,024 edges,
``neg_num`` 5, Adam) takes 2 warm-up and 3 timed steps and one step under
torch.profiler twice: with the model's gathers as they are
(``F.embedding``, whose backward sums each row's duplicates after a sort)
and as plain indexing (``table[ids]``, whose backward,
``indexing_backward_kernel``, serialises a row's duplicates: a depth-2
frontier of 2.2M ids holds ~22,000 copies of each of the 100 slot
values). Prints each variant's step ms and its kernels by device time.
Needs one CUDA card:

    python3 experiments/torch_spmm/pglbox_gather_step.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pgl_tpu_torch import HeterGraph  # noqa: E402
from pgl_tpu_torch.apps import pglbox_model as pm  # noqa: E402
from pgl_tpu_torch.sampling import HeteroNeighborSampler  # noqa: E402


def embed_by_indexing(table, ids):
    """``pm._embed`` as plain indexing."""
    return table[pm._clamp(ids, table.shape[0])]


def main():
    if not torch.cuda.is_available():
        print("pglbox_gather_step: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    src, dst = cs.g4r_edges()
    n = cs.G4R_USERS + cs.G4R_ITEMS
    pairs = np.stack([src, dst], 1)
    hg = HeterGraph({cs.PGLBOX_ETYPES[0]: pairs,
                     cs.PGLBOX_ETYPES[1]: pairs[:, ::-1]}, num_nodes=n)
    sampler = HeteroNeighborSampler(hg, cs.PGLBOX_SAMPLES, device=dev)
    rng = np.random.default_rng(0)
    slots = {k: torch.as_tensor(rng.integers(0, v, n), device=dev)
             for k, v in cs.PGLBOX_SLOTS.items()}
    by_embedding = pm._embed
    for name, embed in (("F.embedding", by_embedding),
                        ("indexing", embed_by_indexing)):
        pm._embed = embed
        model = pm.PGLBoxGNNModel(
            n, cs.PGLBOX_EMB, cs.PGLBOX_ETYPES, 2, cs.PGLBOX_SLOTS,
            "sage_mean", generator=torch.Generator().manual_seed(0),
            device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=cs.PGLBOX_LR)
        gen = torch.Generator(device=dev).manual_seed(1)

        def step():
            opt.zero_grad(set_to_none=True)
            b = rng.integers(0, len(pairs), cs.PGLBOX_BATCH)
            batch = cs.pglbox_batch(pairs, sampler, b, gen, dev)
            loss = cs.pglbox_loss(model, slots, batch)
            loss.backward()
            opt.step()

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"[{name}] step ms {[round(t, 2) for t in times]}", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=12), flush=True)
    pm._embed = by_embedding
    return 0


if __name__ == "__main__":
    sys.exit(main())
