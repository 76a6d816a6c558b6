#!/usr/bin/env python3
"""The host cost of K1's custom op on the headline GCN's float32 step.

A traced K1 call goes through ``torch.ops.pgl_tpu_torch.spmm`` (so that
``torch.export`` records it); an eager one launches directly
(``segment_kernels._spmm_one``). This measures what routing every eager
call through the op too would cost: it trains chip_smoke.py's main path (``phase_train(g, "K1")``: the headline
graph, GCN(128, 16, 3 layers, hidden 128), Adam at lr 1e-3, 3 warm-up and
20 timed steps, 5 K1 launches a step asserted) four times in one process,
direct, op, op, direct, and prints each run's median step ms and the
two settings' means. Needs one CUDA card:

    python3 experiments/torch_spmm/custom_op_step.py
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import headline_graph, phase_train  # noqa: E402
from pgl_tpu_torch.ops.kernels import _build  # noqa: E402
from pgl_tpu_torch.ops.kernels import segment_kernels as sk  # noqa: E402




def main():
    if not torch.cuda.is_available():
        print("custom_op_step: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build("segment_kernels")
    g = headline_graph(False)
    runs = {"direct": [], "op": []}
    direct = sk._spmm_one
    for setting in ("direct", "op", "op", "direct"):
        sk._spmm_one = direct if setting == "direct" else sk._spmm_op_call
        train, _ = phase_train(g, f"K1 {setting}")
        runs[setting].append(train["step_ms"])
    sk._spmm_one = direct
    mean = {k: float(np.mean(v)) for k, v in runs.items()}
    print(json.dumps({"step_ms": runs, "mean_ms": mean,
                      "op_over_direct": mean["op"] / mean["direct"],
                      "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
