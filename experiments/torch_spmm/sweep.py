#!/usr/bin/env python3
"""Work-list sweep for the port's sorted SpMM, K1
(pgl_tpu_torch/ops/kernels/csrc/segment_kernels.cu).

K1's work list is built on the host when a layout is built, from three
module constants of ``segment_kernels``: ``MIN_PIECE`` and ``ROW_PIECES``
(a row of more than ``MIN_PIECE`` edges is cut into about ``ROW_PIECES``
pieces of ``MIN_PIECE`` to ``ET`` edges) and ``PACK_ROW`` (the longest row
packed with its neighbours). This times K1 for several settings at the
shapes of the main paths: the bench headline graph
(``powerlaw_graph(131072, 16, seed=0)``, CSC and CSR at D = 128, 16, 64),
the bench GAT graph (``powerlaw_graph(65536, 16, seed=1)``, D = 64, 16) and
``build_uniq_reduce``'s layout on it (the reference's fold of pair-slot
rows onto nodes, D = 1, 8, 16, 64, 256),
with CUDA events over 50 warm launches, each result checked against the
plain version in float64 with chip_smoke.py's ``check_spmm``. Needs one
CUDA card:

    python3 experiments/torch_spmm/sweep.py
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

from chip_smoke import (check_spmm, dedup_attention_of,  # noqa: E402
                        dispatch_settings, gat_host, headline_host, time_ms)
from pgl_tpu_torch.ops.kernels import dedup_attention as da  # noqa: E402
from pgl_tpu_torch.ops.kernels import segment_kernels as sk  # noqa: E402

# (MIN_PIECE, ROW_PIECES, PACK_ROW); the first is the module's default,
# (ET, 1, ...) cuts every long row into pieces of ET edges
SETTINGS = ((sk.MIN_PIECE, sk.ROW_PIECES, sk.PACK_ROW), (sk.ET, 1, 8),
            (32, 128, 8), (128, 128, 8), (64, 64, 8), (64, 128, 32))


def shapes(head, gat, dev):
    """(tag, layout, rows of the gathered table, D) of every K1 row."""
    out = []
    for name, g, widths in (("headline", head, (128, 16, 64)),
                            ("bench GAT", gat, (64, 16))):
        for kind, idx in (("csc", g.adj_dst_index), ("csr", g.adj_src_index)):
            lay = sk.build_spmm_layout(idx.indptr, idx.sorted_v, g.num_nodes,
                                       kind=kind, device=dev)
            out += [(f"{name} {kind}", lay, g.num_nodes, d) for d in widths]
    with dispatch_settings(DEDUP=False):
        att = dedup_attention_of(gat.tensor(dev), dev)
    red = da.build_uniq_reduce(att.layout, att.num_rows)
    out += [("red", red, red.max_index + 1, d) for d in (1, 8, 16, 64, 256)]
    return out


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    head, gat = headline_host(), gat_host()
    gen = torch.Generator(device=dev).manual_seed(0)
    default = sk.MIN_PIECE, sk.ROW_PIECES, sk.PACK_ROW
    try:
        for setting in SETTINGS:
            sk.MIN_PIECE, sk.ROW_PIECES, sk.PACK_ROW = setting
            for tag, lay, n, d in shapes(head, gat, dev):
                x = torch.randn(n, d, device=dev, generator=gen)
                out = torch.empty(lay.num_rows, d, device=dev)
                part = torch.empty(lay.item_partials, d, device=dev)
                ms = time_ms(lambda: sk._launch(x, lay, out, part), 50)
                with torch.no_grad():
                    err = check_spmm(f"{tag} D={d}", out, x, lay)
                print(f"MIN_PIECE={setting[0]} ROW_PIECES={setting[1]} "
                      f"PACK_ROW={setting[2]} {tag} D={d}: {ms:.5f} ms "
                      f"(items {lay.items.shape[0]}, partials "
                      f"{lay.item_partials}; max |err| {err:.3e})",
                      flush=True)
    finally:
        sk.MIN_PIECE, sk.ROW_PIECES, sk.PACK_ROW = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
