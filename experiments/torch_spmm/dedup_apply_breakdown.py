#!/usr/bin/env python3
"""Where the dedup apply (K5, K6, the weighted K6) spends its time:
patched builds.

This script compiles patched copies of ``csrc/dedup_kernels.cu`` (one
``nvcc`` each, in parallel, into the git-ignored build directory), swaps
each in for the module's library, and times one launch with CUDA events on
the bench headline under ``DEDUP`` (both layouts): K5 at D = 128 and 16,
K6 at D = 128, the weighted K6 at D = 64 (FAGCN's width). Each variant
removes one part of the kernel, so the time it saves is that part's cost
where the parts do not overlap:

* ``as_is``: the source;
* ``no_mma``: no MMAs (no ldmatrix of B, no A fragments);
* ``no_split``: the window is not split into its bf16 planes;
* ``no_gather``: the window rows are not gathered;
* ``no_counts``: K5 does not load its counts;
* ``no_build``: K6 does not build C from the edges;
* ``no_flush``: the output tile is not stored (the compiler then drops the
  MMAs as well: read it beside ``no_mma``);
* ``k16_only``: no m16n8k8 on a half-zero tile (every nonzero k-step runs
  m16n8k16).

Only ``as_is`` and ``k16_only`` compute the product; they are checked
against float64. Needs one CUDA card:

    python3 experiments/torch_spmm/dedup_apply_breakdown.py
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

from chip_smoke import (check, check_dedup, headline_graph,  # noqa: E402
                        headline_host, time_ms, weighted_terms)

SPLIT = ("    for (int i = threadIdx.x; i < kW * CW / 4; i += kApplyThreads) {"
         "\n      const int c = i / (CW / 4);")
VARIANTS = {
    "as_is": [],
    "no_mma": [("  constexpr int NP = FA ? 6 : 3;  // products a tile\n",
                "  constexpr int NP = FA ? 6 : 3;  // products a tile\n"
                "  return;\n")],
    "no_split": [(SPLIT, "    if (false)\n" + SPLIT)],
    "no_gather": [("    if (vec) {\n#pragma unroll\n      for (int k = 0; k < KV;",
                   "    if (false) {\n    } else if (vec) {\n#pragma unroll\n"
                   "      for (int k = 0; k < KV;")],
    "no_counts": [("      if constexpr (MODE == kCached) {\n        bf16* cb",
                   "      if constexpr (MODE == kCached) if (false) {\n"
                   "        bf16* cb")],
    "no_build": [("      if (rem == 0)\n        build_c",
                  "      if (false)\n        build_c")],
    "no_flush": [("  auto flush_rows = [&]() {\n",
                  "  auto flush_rows = [&]() {\n    return;\n")],
    "k16_only": [("    if (m == 3) {", "    if (m != 0) {")],
}
CORRECT = ("as_is", "k16_only")


def build(names):
    from pgl_tpu_torch.ops.kernels import _build
    src = open(_build.CSRC / "dedup_kernels.cu").read()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: patch target not found once")
            text = text.replace(old, new)
        cu = out / f"dedup_kernels_{name}.cu"
        cu.write_text(text)
        so = out / f"libdedup_kernels_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = so
    return libs


def main():
    if not torch.cuda.is_available():
        print("dedup_apply_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from pgl_tpu_torch.ops.kernels import _build
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build(VARIANTS)
    dev = torch.device("cuda")
    g = headline_graph(True, headline_host())
    N, E = g.num_nodes, g.num_edges
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(E, device=dev, generator=gen)
    xs = {d: torch.randn(N, d, device=dev, generator=gen)
          for d in (128, 64, 16)}
    cases = [(lay, k1, kernel, d)
             for lay, k1 in zip(g._dedup_layouts, g._spmm_layouts)
             for kernel, d in (("K5", 128), ("K5", 16), ("K6", 128),
                               ("weighted K6", 64))]
    result = {"device": smi}
    for name, so in libs.items():
        _build._LOADED["dedup_kernels"] = ctypes.CDLL(str(so))
        times = []
        for lay, k1, kernel, d in cases:
            x = xs[d]
            counts = lay.counts if kernel == "K5" else None
            wk = w if kernel == "weighted K6" else None
            out = torch.empty(lay.n_pad, d, device=dev)
            part = torch.empty(lay.num_partials * dk.NB, d, device=dev)
            ms = time_ms(lambda: dk._launch_apply(x, lay, counts, out, part,
                                                  wk), 20)
            if name in CORRECT:
                with torch.no_grad():
                    if wk is None:
                        check_dedup(f"{name} {kernel}", out[:N], x, lay)
                    else:
                        want, scale = weighted_terms(x, w[:, None], k1,
                                                     "mul")
                        check(f"{name} {kernel}", out[:N], want, scale)
            key = f"{kernel} {lay.kind} D={d}"
            result[f"{name}/{key}"] = ms
            times.append(f"{key} {ms:.5f}")
        print(f"[variant] {name}: " + ", ".join(times), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
