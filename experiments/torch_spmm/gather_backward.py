#!/usr/bin/env python3
"""The backward of an edge-space gather over a hub destination, two ways.

``TransformerConv``'s edge-space route (UniMP's last layer) gathers q per
edge as ``q[dst]`` and ``segment_softmax`` gathers the softmax denominator
as ``denom[dst]``. On the bench GAT graph (``chip_smoke.gat_host``:
powerlaw_graph(65536, 16, feat_dim=128, seed=1), whose node 0 takes 38% of
the 1,048,576 edges) PyTorch runs the backward of such an indexing gather
as ``indexing_backward_kernel``, which sums the duplicates of one index in
one warp. This script times, with CUDA events, forward plus backward of the
two gathers of the UniMP step's last layer (width 40: one head of 40
classes; width 1: the denominator) two ways: advanced indexing (what the
port runs) and ``index_select`` (whose backward is ``index_add_``). It
checks that both give the same forward bits and gradients within 1e-4 of
each other relative to the gradient's largest magnitude. Needs one CUDA
card:

    python3 experiments/torch_spmm/gather_backward.py
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

from chip_smoke import gat_host, time_ms  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("gather_backward: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    host = gat_host()
    dst = torch.as_tensor(host.edges[:, 1], device=dev).long()
    N, E = host.num_nodes, dst.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"device": smi, "edges": E,
           "largest_in_degree": int(torch.bincount(dst).max())}
    for width in (40, 1):
        x = torch.randn(N, width, device=dev, generator=gen,
                        requires_grad=True)
        g = torch.randn(E, width, device=dev, generator=gen)
        grads, ms = {}, {}
        for way, gather in (("indexing", lambda: x[dst]),
                            ("index_select", lambda: x.index_select(0, dst))):
            def step():
                x.grad = None
                gather().backward(g)
            ms[way] = time_ms(step, 5)
            step()
            grads[way] = x.grad.clone()
        if not torch.equal(x[dst], x.index_select(0, dst)):
            raise AssertionError("the two gathers differ")
        scale = float(grads["indexing"].abs().max())
        err = float((grads["indexing"] - grads["index_select"]).abs().max())
        if err > 1e-4 * scale:
            raise AssertionError(f"width {width}: gradients differ by {err}")
        out[f"width_{width}"] = dict(ms_fwd_bwd=ms, max_grad_diff=err,
                                     grad_scale=scale)
        print(f"[gather] width {width}: forward + backward {ms['indexing']:.4f}"
              f" ms by indexing, {ms['index_select']:.4f} ms by index_select "
              f"(gradients agree to {err:.3e} of {scale:.3e})", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
