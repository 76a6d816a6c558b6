#!/usr/bin/env python3
"""Which single PyTorch calls compute K1w's functions, and how fast.

K1w (the sorted SpMM on weighted messages, mul) computes, over a layout:
the forward ``out[d] = Σ_e w[e, h] · x[s_e]`` per head h, dx the same over
the transposed layout, and dw ``dw[e, h] = <g[d_e], x[s_e]>`` over head h's
columns. This script tries the library calls that could compute one of
them in one call, on the bench headline graph at FAGCN's shape (one weight
an edge, D = 64) and on the bench GAT graph at GATv2's (8 heads of 8, and
one head of 16):

- forward, H = 1: ``torch.sparse.mm`` on a CSR matrix of the weights;
- forward, H > 1: ``torch.bmm`` on H such matrices batched, as CSR and as
  COO, over the features' heads (an ``[H, N, Dh]`` view);
- dw: ``torch.sparse.sampled_addmm`` on a CSR matrix with the CSR layout's
  pattern (rows the sources), ``x`` and ``g.T`` (``beta=0``), batched over
  the heads for H > 1.

Each call that runs is checked against the float64 plain version (max
|err|, values in the layout's order) and timed with CUDA events; a call
that raises is reported with its error. Needs one CUDA card:

    python3 experiments/torch_spmm/library_calls.py
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

from chip_smoke import gat_host, headline_host, time_ms  # noqa: E402


def batched(lay, values, N, H):
    """H CSR matrices of ``lay``'s pattern, head h's values ``values[h]``."""
    return torch.sparse_csr_tensor(
        lay.indptr.expand(H, -1).contiguous(),
        lay.indices.expand(H, -1).contiguous(), values, size=(H, N, N))


def candidates(lay, N, H, w, x, g):
    """name → (function of no arguments, its result → [E or N, ...] in the
    order of the plain version below)."""
    wl = w.index_select(0, lay.edge_id)  # [E, H] in the layout's order
    E, D = lay.num_edges, x.shape[1]
    if H == 1:
        A = torch.sparse_csr_tensor(lay.indptr, lay.indices, wl[:, 0],
                                    size=(N, N))
        P = torch.sparse_csr_tensor(lay.indptr, lay.indices,
                                    torch.zeros(E, device=x.device),
                                    size=(N, N))
        return {
            "fwd sparse.mm csr": (lambda: torch.sparse.mm(A, x),
                                  lambda r: r),
            "dw sampled_addmm csr": (
                lambda: torch.sparse.sampled_addmm(P, g, x.T, beta=0),
                lambda r: r.values()[:, None])}
    Ab = batched(lay, wl.T.contiguous(), N, H)
    Pb = batched(lay, torch.zeros(H, E, device=x.device), N, H)
    xv = x.view(N, H, D // H).transpose(0, 1)
    gv = g.view(N, H, D // H).transpose(0, 1)
    heads = lambda r: r.transpose(0, 1).reshape(N, D)  # noqa: E731
    out = {"fwd bmm csr batched": (lambda: torch.bmm(Ab, xv), heads)}
    try:
        Ac = Ab.to_sparse_coo()
        out["fwd bmm coo batched"] = (lambda: torch.bmm(Ac, xv), heads)
    except Exception as e:  # noqa: BLE001 - a probe: report and go on
        out["fwd bmm coo batched"] = (e, None)
    out["dw sampled_addmm csr batched"] = (
        lambda: torch.sparse.sampled_addmm(Pb, gv, xv.transpose(1, 2),
                                           beta=0),
        lambda r: r.values().T)
    return out


def plain(lay, N, H, w, x, g):
    """float64: the forward over ``lay`` ([N, D]) and dw over it ([E, H],
    the layout's order) with ``lay``'s rows as the gathered-from side."""
    E, D = lay.num_edges, x.shape[1]
    x64, g64, w64 = x.double(), g.double(), w.double()
    m = x64.index_select(0, lay.indices).reshape(E, H, D // H)
    m = (m * w64.index_select(0, lay.edge_id)[:, :, None]).reshape(E, D)
    fwd = torch.zeros(N, D, dtype=torch.float64, device=x.device
                      ).index_add_(0, lay.seg_ids, m)
    dw = (g64.index_select(0, lay.seg_ids)
          * x64.index_select(0, lay.indices)).reshape(E, H, D // H).sum(-1)
    return fwd, dw


def main():
    if not torch.cuda.is_available():
        print("library_calls: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    result = {"device": smi, "torch": torch.__version__}
    for graph, host, shapes in (("headline", headline_host, [(1, 64)]),
                                ("gat_graph", gat_host, [(8, 64), (1, 16)])):
        g = host().tensor(dev)
        N = g.num_nodes
        csc, csr = g._spmm_layouts
        for H, D in shapes:
            gen = torch.Generator(device=dev).manual_seed(H * 100 + D)
            x = torch.randn(N, D, device=dev, generator=gen)
            w = torch.randn(g.num_edges, H, device=dev, generator=gen)
            cot = torch.randn(N, D, device=dev, generator=gen)
            # the forward over CSC gathers x; dw over CSR (rows the
            # sources): here the pattern's rows s, columns d, so the dense
            # pair is (x at the rows, cot at the columns)
            want_fwd, _ = plain(csc, N, H, w, x, cot)
            _, want_dw = plain(csr, N, H, w, cot, x)
            cands = candidates(csc, N, H, w, x, cot)
            cands.update({k: v for k, v in
                          candidates(csr, N, H, w, cot, x).items()
                          if k.startswith("dw")})
            for name, (fn, view) in cands.items():
                key = f"{graph} H={H} D={D} {name}"
                if isinstance(fn, Exception):
                    result[key] = {"error": repr(fn)[:300]}
                else:
                    try:
                        got = view(fn()).double()
                        torch.cuda.synchronize()
                        want = want_fwd if name.startswith("fwd") else want_dw
                        err = float((got - want).abs().max())
                        ms = time_ms(fn, 20)
                        result[key] = {"ms": ms, "max_abs_err": err}
                    except Exception as e:  # noqa: BLE001 - report, go on
                        result[key] = {"error": repr(e)[:300]}
                print(f"[library] {key}: {result[key]}", flush=True)
        del g, csc, csr
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/library_calls.json", "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
