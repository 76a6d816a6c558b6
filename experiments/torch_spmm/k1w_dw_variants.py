#!/usr/bin/env python3
"""Where K1w's weight-gradient pass spends its time: patched builds.

The pass that writes dw alone (the dedup route's, and the larger part of
the CSR launch that writes dx and dw) took about 3x the pass that writes dx
alone on the bench headline graph, whatever the edge order
(``k1w_order.py``), in K1w's first version, which kept K1's 8 gathered
rows in flight a lane. This script compiles patched copies of
``csrc/segment_kernels.cu`` (one ``nvcc`` each, in parallel, into the
git-ignored build directory), swaps each in for the module's library, and
times with CUDA events at FAGCN's shape (D = 64, one weight an edge, the
headline graph) and GATv2's first layer (D = 64, 8 heads, the bench GAT
graph): the forward over CSC, dx alone, dw alone, and both; and prints the
registers of the weight-gradient kernel. Variants of K1w's rows in flight
(``kUnrollWeighted``; K1 keeps 8):

* ``as_is``: the source (4);
* ``unroll8`` (the first version) and ``unroll2``;
* ``blocks3``: 8, with at least 3 blocks an SM for the weight-gradient
  kernels (``__launch_bounds__``' second argument);
* ``no_scan`` and ``no_store`` (timing only; their dw is wrong): 8,
  without the segmented shuffle scan, and without the dw store (its value
  kept live in the dx sum);
* ``sum_branch``: the sum for ``out`` behind a run-time branch in every
  launch, the forward's too (the source decides it at compile time where
  a launch writes no dw);
* ``sum_always``: the sum for ``out`` made in every launch, stored only
  where ``out`` is given (the source skips it on the launch of dw alone).

Launches timed: the forward, dx alone, dw alone as the wrapper launches it
(``dw``: no weights read, no sum) and as it did before (``dw_wop1``: the
weights read and the sum made), and dx with dw.

Correct variants are checked against float64. Needs one CUDA card:

    python3 experiments/torch_spmm/k1w_dw_variants.py
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

from chip_smoke import (check_weighted, gat_host, headline_host,  # noqa: E402
                        time_ms)

UNROLL = "constexpr int kUnrollWeighted = 4;"
EIGHT = (UNROLL, "constexpr int kUnrollWeighted = 8;")
VARIANTS = {
    "as_is": [],
    "unroll8": [EIGHT],
    "unroll2": [(UNROLL, "constexpr int kUnrollWeighted = 2;")],
    "blocks3": [EIGHT,
                ("__global__ void __launch_bounds__(kPieceWarps * 32)\n"
                 "spmm_pieces(",
                 "__global__ void __launch_bounds__(kPieceWarps * 32,\n"
                 "                                  DWOP != kNone ? 3 : 1)\n"
                 "spmm_pieces(")],
    "no_scan": [EIGHT, ("if (same >> k & 1u) p += t;", "p += 0.f * t;")],
    "no_store": [EIGHT, ("*o = cont ? *o + p : p;",
                         "acc[0] += p * static_cast<float>(o == nullptr);")],
    "sum_branch": [("const bool store = DWOP == kNone || out != nullptr;",
                    "const bool store = out != nullptr;")],
    "sum_always": [("\n        if (store) {", "\n        {"),
                   ("\n    if (store) {", "\n    {"),
                   ("if (g == 0 && active) store_vec",
                    "if (store && g == 0 && active) store_vec")],
}
CORRECT = ("as_is", "unroll8", "unroll2", "blocks3", "sum_branch",
           "sum_always")


def build(names):
    from pgl_tpu_torch.ops.kernels import _build
    src = open(_build.CSRC / "segment_kernels.cu").read()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: patch target not found once")
            text = text.replace(old, new)
        cu = out / f"segment_kernels_{name}.cu"
        cu.write_text(text)
        so = out / f"libsegment_kernels_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        # registers of the weight-gradient kernel at D = 64 (VEC 4, LPR 16)
        regs, current = {}, None
        for line in log.splitlines():
            if "Function properties for" in line:
                current = line.split()[-1]
            elif "registers" in line and current and \
                    "spmm_piecesILi4ELi16ELi1ELi" in current:
                mode = "dw" if "ELi1ELi1E" in current else "dx"
                regs[mode] = int(line.split("Used ")[1].split()[0])
        libs[name] = (so, regs)
    return libs


def main():
    if not torch.cuda.is_available():
        print("k1w_dw_variants: no CUDA device", file=sys.stderr)
        return 1
    from pgl_tpu_torch.ops.kernels import _build
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build(VARIANTS)
    dev = torch.device("cuda")
    cases = [("fagcn_headline", headline_host().tensor(dev), 1, 64),
             ("gatv2_gat_graph", gat_host().tensor(dev), 8, 64)]
    result = {"device": smi}
    for name, (so, regs) in libs.items():
        _build._LOADED["segment_kernels"] = ctypes.CDLL(str(so))
        for tag, g, H, D in cases:
            csc, csr = g._spmm_layouts
            N, E = g.num_nodes, g.num_edges
            gen = torch.Generator(device=dev).manual_seed(0)
            x = torch.randn(N, D, device=dev, generator=gen)
            w = torch.randn(E, H, device=dev, generator=gen)
            cot = torch.randn(N, D, device=dev, generator=gen)
            out = torch.empty(N, D, device=dev)
            part = torch.empty(max(csc.num_partials, csr.num_partials), D,
                               device=dev)
            dw = torch.empty(E, H, device=dev)
            ms = {
                "fwd": time_ms(lambda: sk._launch_weighted(
                    x, w, csc, out, part, 1), 50),
                "dx": time_ms(lambda: sk._launch_weighted(
                    cot, w, csr, out, part, 1), 50),
                "dw": time_ms(lambda: sk._launch_weighted(
                    cot, w, csr, None, None, 0, 1, x, dw), 50),
                "dw_wop1": time_ms(lambda: sk._launch_weighted(
                    cot, w, csr, None, None, 1, 1, x, dw), 50),
                "dx_dw": time_ms(lambda: sk._launch_weighted(
                    cot, w, csr, out, part, 1, 1, x, dw), 50)}
            if name in CORRECT:
                fwd = torch.empty_like(out)
                sk._launch_weighted(x, w, csc, fwd, part, 1)
                sk._launch_weighted(cot, w, csr, out, part, 1, 1, x, dw)
                torch.cuda.synchronize()
                err = check_weighted(f"{name} {tag}", x, w, cot, csc, csr,
                                     "mul", fwd, out, dw)
                ms["max_abs_err"] = max(err.values())
            result[f"{name}/{tag}"] = ms
            print(f"[variant] {name} {tag}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in ms.items()), flush=True)
        result[f"{name}/registers"] = regs
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
