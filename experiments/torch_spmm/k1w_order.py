#!/usr/bin/env python3
"""What K1w's weight-gradient pass pays for the edge order.

K1w reads each edge's weight, and writes its weight gradient, at the edge's
original id (``edge_id``): in a random edge order those are 4-byte accesses
at random addresses, one an edge. This script builds the bench headline
graph (``chip_smoke.headline_host``: 2,097,152 edges) three times with the
same edges in three orders: as generated, sorted by source (the CSR
layout's edge ids then run in order) and sorted by destination (the CSC
layout's do), and times with CUDA events, at FAGCN's width (D = 64, one
weight an edge): K1 over CSR, K1w's forward over CSC, its backward over CSR
as the main path runs it (dx and dw in one launch), dx alone and dw alone.
Needs one CUDA card:

    python3 experiments/torch_spmm/k1w_order.py
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import check_weighted, headline_host, time_ms  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("k1w_order: no CUDA device", file=sys.stderr)
        return 1
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    edges = np.asarray(headline_host().edges)
    N, D = 131072, 64
    dev = torch.device("cuda")
    result = {"device": smi}
    for order, perm in (
            ("generated", np.arange(len(edges))),
            ("by_source", np.argsort(edges[:, 0], kind="stable")),
            ("by_destination", np.argsort(edges[:, 1], kind="stable"))):
        g = Graph(edges[perm], num_nodes=N).tensor(dev)
        csc, csr = g._spmm_layouts
        E = g.num_edges
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(N, D, device=dev, generator=gen)
        w = torch.randn(E, 1, device=dev, generator=gen)
        cot = torch.randn(N, D, device=dev, generator=gen)
        out = torch.empty(N, D, device=dev)
        part = torch.empty(max(csc.item_partials, csr.item_partials), D,
                           device=dev)
        dw = torch.empty(E, 1, device=dev)
        runs = {
            "k1_csr": lambda: sk._launch(cot, csr, out, part),
            "k1w_fwd_csc": lambda: sk._launch_weighted(x, w, csc, out, part,
                                                       1),
            "k1w_bwd_csr": lambda: sk._launch_weighted(cot, w, csr, out,
                                                       part, 1, 1, x, dw),
            "k1w_dx_csr": lambda: sk._launch_weighted(cot, w, csr, out, part,
                                                      1),
            "k1w_dw_csr": lambda: sk._launch_weighted(cot, w, csr, None,
                                                      None, 1, 1, x, dw)}
        ms = {k: time_ms(fn, 50) for k, fn in runs.items()}
        runs["k1w_bwd_csr"]()
        torch.cuda.synchronize()
        err = check_weighted(f"{order} bwd", x, w, cot, csc, csr, "mul",
                             None, out, dw)
        ms["max_abs_err"] = max(err.values())
        result[order] = ms
        print(f"[k1w order] {order}: " + ", ".join(
            f"{k} {v:.5f}" for k, v in ms.items()), flush=True)
        del g, csc, csr
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
