#!/usr/bin/env python3
"""Where the time of one training step of the port's headline GCN goes.

Trains the chip_smoke.py main path (its headline_graph and
headline_trainer: powerlaw_graph(131072, 16, feat_dim=128, seed=0);
GCN(128, 16, num_layers=3, hidden_size=128, dropout=0); Adam at lr 1e-3)
for 5 warm-up steps, then traces 10 steps with torch.profiler and
prints the device kernels by self time, their sum per step by kind, the
step's wall time under the profiler (host clock, ended by a synchronize).
Without the profiler it times 20 steps back to back (one synchronize at
the end) and the host time each step() call takes to return, which says
whether the host's launches or the device bound the step; the idle share
is 1 - (kernel time per step) / (back-to-back step time). ``--dedup``
builds the graph with ``dispatch.DEDUP`` on, so the step's SpMMs run K5
over the dedup layouts instead of K1. Needs one CUDA card:

    python3 experiments/torch_spmm/profile_step.py [--dedup]
"""

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import headline_graph, headline_trainer  # noqa: E402

STEPS = 10
KINDS = (("spmm", ("spmm_rows", "spmm_packs", "spmm_combine", "dedup_apply",
                   "dedup_combine")),
         ("gemm", ("gemm", "cutlass", "cublas", "sm90_xmma", "Kernel2")),
         ("optimizer", ("multi_tensor", "adam", "Adam")),
         ("reduction", ("reduce", "Reduce")),
         ("index", ("index", "scatter", "gather")),
         ("elementwise", ("elementwise", "Elementwise", "vectorized")))


def kind_of(name):
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    dedup = "--dedup" in sys.argv[1:]
    _, step = headline_trainer(headline_graph(dedup))
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    host = []
    t0 = time.perf_counter()
    for _ in range(20):
        t1 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    chained_ms = (time.perf_counter() - t0) * 1e3 / 20
    host_ms = float(np.median(host)) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    # device-side spans of user annotations (Optimizer.step#...) overlap
    # the kernels they enclose; count kernels only
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Optimizer.")]

    def self_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else e.self_cuda_time_total

    kernels.sort(key=self_us, reverse=True)
    by_kind = defaultdict(float)
    for e in kernels:
        by_kind[kind_of(e.key)] += self_us(e) / 1e3 / STEPS
        print(f"{self_us(e) / 1e3 / STEPS:9.4f} ms/step {e.count // STEPS:4d}"
              f"x  {e.key[:110]}")
    busy = sum(by_kind.values())
    print(json.dumps({"device": smi, "dedup": dedup,
                      "chained_ms_per_step": chained_ms,
                      "host_ms_per_step_call": host_ms,
                      "host_ms_per_step_call_min": min(host) * 1e3,
                      "profiled_wall_ms_per_step": wall_ms,
                      "device_busy_ms_per_step": busy,
                      "idle_share": (1 - busy / chained_ms) if busy else None,
                      "by_kind_ms_per_step": dict(by_kind)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
