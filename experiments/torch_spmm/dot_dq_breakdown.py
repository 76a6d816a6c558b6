#!/usr/bin/env python3
"""Where the dot-mode K10-dq spends its time at GATConv's many-head shape
(43, 2, 8): patched builds of this tree's staged kernel and of a
revision's kernel, side by side.

This script compiles patched copies of ``csrc/attention_kernels.cu`` (one
``nvcc`` each, in parallel, into the git-ignored build directory): the
tree's (``dot_dq_staged``, patched in ``csrc/dot_staged.cuh``, which the
copy includes) and the revision's (default ``b8eb749``, whose
``dot_dq_pieces`` loaded each edge's k and v columns straight from global
memory; its sources come from ``k1_k10_before_after.py --extract --rev
b8eb749``). Each
variant removes one part of the K10-dq kernel, and only of it, so the time
it saves is that part's cost where the parts do not overlap:

* ``as_is``: the source;
* ``no_rows``: no k and v rows reach the kernel (the tree's: no ``cp.async``
  of the rows into the ring; the revision's: no loads, each slot uses q and
  g in their place);
* ``no_trees``: no head reductions (each slot's score is its own q * k and
  g . v its own product, no shuffles);
* ``no_exp``: no ``expf`` (p is the shifted score itself);
* ``no_sync`` (the tree's only): no ``cp.async`` wait and no ``__syncwarp``
  in the edge loop.

Each shape is timed in turns (every variant, then again in reverse order)
with CUDA events and the two runs averaged, on the bench GAT graph at
(43, 2, 8) with leaky 0.2 at rates 0 and 0.3 and at UniMP's (2, 128, 128)
at rate 0. Only ``as_is`` computes dq: the tree's is held against the
revision's bit for bit. The ``ptxas`` registers and spills of each
variant's K10-dq kernels print first, and one JSON line of all times ends
the output, after the card's name and power limit. Needs one CUDA card:

    python3 experiments/torch_spmm/k1_k10_before_after.py --extract \
        --rev b8eb749
    python3 experiments/torch_spmm/dot_dq_breakdown.py [--rev R]
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from k1_k10_before_after import old_dir, registers  # noqa: E402

# (text, replacement) pairs, applied inside the K10-dq kernel's body only
TREE = {
    "as_is": [],
    "no_rows": [("        stage_ring(st, k + s * DS, DS, cls1, lane);\n"
                 "        stage_ring(st + o_v, v + s * C, C, cls2, lane);\n",
                 "        (void)st;\n        (void)s;\n")],
    "no_trees": [("      head_dot<NC, WIDE ? kWide : kNarrow>(qr, kd[e], wp, "
                  "sd[e]);\n"
                  "      head_sum<NC, WIDE ? kWide : kNarrow>(gv[e], wp);\n",
                  "      for (int c = 0; c < NC; ++c) sd[e][c] = qr[c] * "
                  "kd[e][c];\n")],
    "no_exp": [(": expf(leaky(sd[e][c], slope) - lse_h);",
                ": leaky(sd[e][c], slope) - lse_h;")],
    "no_sync": [("    cp_async_wait<S - 1>();\n    __syncwarp();\n", ""),
                ("    __syncwarp();  // every lane is done with this ring "
                 "slot before it refills\n", "")],
}
OLD = {
    "as_is": [],
    "no_rows": [("? __ldg(k + static_cast<size_t>(s) * DS + sl.scol[c])",
                 "? qr[c] * static_cast<float>(s)"),
                ("? __ldg(v + static_cast<size_t>(s) * C + sl.vcol[c])",
                 "? gr[c] * static_cast<float>(s)")],
    "no_trees": [("        head_dot<NC>(qr, kk[u], wp, sd);\n",
                  "        for (int c = 0; c < NC; ++c) sd[c] = qr[c] * "
                  "kk[u][c];\n"),
                 ("        head_sum<NC>(gv, wp);\n", "")],
    "no_exp": [("const float p = expf(leaky(sd[c], slope) - ls[c]);",
                "const float p = leaky(sd[c], slope) - ls[c];")],
}
# the file that holds each source's K10-dq kernel, where the kernel starts
# and where the next one begins
FILE = {"tree": "dot_staged.cuh", "old": "attention_kernels.cu"}
BODY = {"tree": ("dot_dq_staged(const T*", "// The dkv pass"),
        "old": ("dot_dq_pieces(const float*", "// Dot-mode K10-dkv")}


def patched(text, body, patches, tag):
    start = text.index(body[0])
    end = text.index(body[1], start)
    kernel = text[start:end]
    for old, new in patches:
        if kernel.count(old) != 1:
            raise RuntimeError(f"{tag}: patch target not found once: {old!r}")
        kernel = kernel.replace(old, new)
    return text[:start] + kernel + text[end:]


def build(rev):
    """Compile every variant in parallel; returns {tag: (CDLL, ptxas log)}."""
    from pgl_tpu_torch.ops.kernels import _build
    out = _build.BUILD_DIR / "dq_variants"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"tree": _build.CSRC, "old": old_dir(rev)}
    if not (sources["old"] / "attention_kernels.cu").exists():
        raise SystemExit(f"{sources['old']} has no sources: run "
                         "k1_k10_before_after.py --extract first")
    procs = {}
    for which, variants in (("tree", TREE), ("old", OLD)):
        text = (sources[which] / FILE[which]).read_text()
        for name, patches in variants.items():
            tag = f"{which}/{name}"
            # a directory a variant: a source's own directory comes first
            # in its quoted includes, so the patched file shadows the tree's
            d = out / f"{which}_{name}"
            d.mkdir(exist_ok=True)
            (d / FILE[which]).write_text(patched(text, BODY[which], patches,
                                                 tag))
            cu = d / "attention_kernels.cu"
            if FILE[which] != cu.name:
                cu.write_text((sources[which] / cu.name).read_text())
            so = d / "libattention.so"
            procs[tag] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                 str(sources[which]), "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed\n{log}")
        libs[tag] = (ctypes.CDLL(str(so)), log)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rev", default="b8eb749")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dot_dq_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (UNIMP_SHAPE, dispatch_settings, dot_inputs,
                            gat_host, time_ms)
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(a.rev)
    for tag, (lib, log) in libs.items():
        lib.pgl_dot_dq_f32.argtypes = ak._lib().pgl_dot_dq_f32.argtypes
        for args, regs, spill in registers(log, r"dot_dq_(pieces|staged)"):
            print(f"[ptxas] {tag} {args}: {regs} registers, {spill} B "
                  "spilled", flush=True)

    dev = torch.device("cuda")
    with dispatch_settings(DEDUP=False):
        g = gat_host().tensor(dev)
    csc = g._attention_layouts()[0]
    N = g.num_nodes
    gen = torch.Generator(device=dev).manual_seed(3)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": smi, "rev": a.rev}
    for shape, leaky, rate in (((43, 2, 8), 0.2, 0.0), ((43, 2, 8), 0.2, 0.3),
                               (UNIMP_SHAPE, 0.0, 0.0)):
        H, dsh, dvh = shape
        q, k, v, g_out = dot_inputs(N, shape, dev, gen)
        thresh, inv_keep = ak._drop_args(rate)
        with torch.no_grad():
            out, lse = ak._dot_fwd_cuda(q, k, v, csc, leaky, dsh, dvh, rate,
                                        seed)
            delta = (g_out.reshape(N, H, dvh)
                     * out.reshape(N, H, dvh)).sum(-1)
        dq = {tag: torch.empty(N, H * dsh, device=dev) for tag in libs}
        part = torch.empty(csc.num_partials, H * dsh, device=dev)

        def launch(tag):
            rc = libs[tag][0].pgl_dot_dq_f32(
                0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                g_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                csc.indices.data_ptr(), csc.pieces.data_ptr(),
                csc.pieces.shape[0], csc.split_rows.data_ptr(),
                csc.split_ptr.data_ptr(), csc.split_rows.shape[0], H, dsh,
                dvh, leaky, seed.data_ptr(), thresh, inv_keep,
                dq[tag].data_ptr(), part.data_ptr(), stream)
            assert rc == 0, (tag, rc)

        for tag in libs:
            launch(tag)
        torch.cuda.synchronize()
        same = torch.equal(dq["tree/as_is"], dq["old/as_is"])
        order = list(libs)
        runs = {tag: [] for tag in libs}
        for tag in order + order[::-1]:
            runs[tag].append(time_ms(lambda: launch(tag), 20))
        name = f"{shape} leaky={leaky} rate={rate}"
        times = {tag: sum(t) / 2 for tag, t in runs.items()}
        result[name] = dict(ms=times, runs=runs, same_bits_as_old=same)
        print(f"[breakdown] {name}: same_bits_as_old {same}; " + ", ".join(
            f"{tag} {ms:.5f}" for tag, ms in times.items()), flush=True)
        del q, k, v, g_out, out, lse, delta, dq, part
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
