#!/usr/bin/env python3
"""Where K1w and the additive K8's node walk spend their time: patched
builds, timed on one card.

Compiles patched copies of ``csrc/segment_kernels.cu`` and
``csrc/dedup_attention.cu`` (one ``nvcc`` each, all in parallel, into the
git-ignored build directory), swaps each in for the module's library, and
times with CUDA events (each a mean over warm launches, every variant in
turns with the source's build). K1w at FAGCN's shape (D = 64, one weight an
edge, the bench headline graph) and GATv2's two layers ((D, H) = (64, 8)
and (16, 1), the bench GAT graph): the forward over CSC, dx alone, dx with
dw, and dw alone over CSR, beside K1 over the same layouts; the same on
the headline graph with its edges sorted by source (the CSR layout's edge
ids then run in order, so w and dw are read and written in order) and by
destination (the CSC layout's do). K8 (the row pass and the node walk) at
the GAT's (8, 8) and (1, 16) on the bench GAT graph's count matrix.
Variants (timing only where marked, their results are wrong):

* K1w ``unroll_k1``: K1's rows in flight (8 at one vector a lane; the
  source holds half); ``unroll_k1_b3``: the same with at least 3 blocks an
  SM (85 registers) for the weighted kernels; ``unroll2``: 2;
  ``k1_u4``: K1 itself at K1w's rows in flight (4 at one vector a lane);
  ``w_const`` (timing only): every weight 1, none read; ``no_eid``
  (timing only): each edge's position in the layout taken for its id, so
  no edge id is read and w and dw are read and written in layout order;
  ``no_xr`` (timing only): mul's dw without the row table's gather;
  ``no_tree`` (timing only): dw's per-head shuffle tree removed;
  ``no_store`` (timing only): dw's store removed, its value kept live;
* K8 ``u2``, ``u4``, ``u8``: 2, 4 or 8 cells in flight a lane group at 2
  slots a lane (the source: 1); ``b4``: at least 4 blocks an SM (64
  registers); ``halves_u4``: 4 cells in flight a half warp where two
  halves share a warp ((1, 16); the source: 2).

Prints each kernel's registers and spills per variant, then one JSON line.
Needs one CUDA card:

    python3 experiments/torch_spmm/k1w_k8_variants.py
"""

import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (GAT_SHAPES, attention_inputs,  # noqa: E402
                        dedup_attention_of, gat_host, headline_host,
                        time_ms)

K1W_UNROLL = ("      : DWOP != kNone && NV > 1     ? 1\n"
              "                                    : (k1 > 1 ? k1 / 2 : 1);")
K1_UNROLL = "      WOP == kNone && DWOP == kNone ? k1\n"
K1_BOUNDS = "__launch_bounds__(kItemWarps * 32, ItemBlocks<VEC, NV>::value)"
K8_WHOLE = "dedup_attn_bwd_nodes<NC, NodeUnroll<NC, 1>::value, 1>"
K8_HALVES = "dedup_attn_bwd_nodes<NC, NodeUnroll<NC, 2>::value, 2>"


def k8_whole(u):
    return [(K8_WHOLE, f"dedup_attn_bwd_nodes<NC, NC == 2 ? {u} : "
                       "NodeUnroll<NC, 1>::value, 1>")]


VARIANTS = {
    "segment_kernels": {
        "as_is": [],
        "unroll_k1": [(K1W_UNROLL, "      : k1;")],
        "unroll_k1_b3": [
            (K1W_UNROLL, "      : k1;"),
            (K1_BOUNDS, "__launch_bounds__(kItemWarps * 32, WOP != kNone "
                        "|| DWOP != kNone ? 3 : ItemBlocks<VEC, NV>::value)",
             2)],
        "unroll2": [(K1W_UNROLL, "      : 2;")],
        "k1_u4": [(K1_UNROLL,
                   "      WOP == kNone && DWOP == kNone ? k1 / 2\n")],
        "w_const": [("load_vec<T, 1>(wt.w + static_cast<size_t>(e) * wt.H "
                     "+ hd.head[k], w1);", "w1[0] = 1.f;")],
        "no_eid": [("mine_e = has ? __ldg(wt.eid + pc.y + lane) : 0;",
                    "mine_e = has ? pc.y + lane : 0;"),
                   ("next_id = next_e < pc.z ? __ldg(wt.eid + next_e) : 0;",
                    "next_id = next_e < pc.z ? next_e : 0;"),
                   ("se[lane] = __ldg(wt.eid + pc.y + lane);",
                    "se[lane] = pc.y + lane;")],
        "no_xr": [("gather_row<VEC, L, NV>(wt.xrow, pc.x, D, c0, l, true, "
                   "xr);", "zero(xr);"),
                  ("gather_row<VEC, L, NV>(wt.xrow, pc.x + dr, D, c0, l, "
                   "live, xr[u]);", "zero(xr[u]);")],
        "no_tree": [("head_tree<U, L, NV>(p, hd.same, l);", "", 2)],
        "no_store": [("*o = to_elem<T>((hd.cont >> k & 1u) ? elem_f32(*o) "
                      "+ p[k] : p[k]);",
                      "if (p[k] == 1234.5f) *o = to_elem<T>(p[k]);")],
    },
    "dedup_attention": {
        "as_is": [],
        "u2": k8_whole(2),
        "u4": k8_whole(4),
        "u8": k8_whole(8),
        "b4": [("template <int NC, int U, int G>\n"
                "__global__ void __launch_bounds__(kWarps * 32)\n"
                "dedup_attn_bwd_nodes(",
                "template <int NC, int U, int G>\n"
                "__global__ void __launch_bounds__(kWarps * 32, 4)\n"
                "dedup_attn_bwd_nodes(")],
        "halves_u4": [(K8_HALVES, "dedup_attn_bwd_nodes<NC, 4, 2>")],
    },
}
TIMING_ONLY = ("w_const", "no_eid", "no_xr", "no_tree", "no_store")


def build():
    """Every variant of both sources, compiled in parallel: {(source,
    variant): (CDLL, {kernel: (registers, spill bytes)})}."""
    from pgl_tpu_torch.ops.kernels import _build
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, variants in VARIANTS.items():
        src = (_build.CSRC / f"{source}.cu").read_text()
        for name, patches in variants.items():
            text = src
            for old, new, *count in patches:
                if text.count(old) != (count[0] if count else 1):
                    raise RuntimeError(f"{source} {name}: patch target "
                                       "not found as often as expected")
                text = text.replace(old, new)
            cu = out / f"{source}_{name}.cu"
            cu.write_text(text)
            so = out / f"lib{source}_{name}.so"
            procs[source, name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        regs, entry, spill = {}, None, 0
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                regs[entry] = (int(m.group(1)), spill)
                entry = None
        libs[key] = (ctypes.CDLL(str(so)), regs)
    return libs


def main():
    if not torch.cuda.is_available():
        print("k1w_k8_variants: no CUDA device", file=sys.stderr)
        return 1
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import _build
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    libs = build()
    shown = (r"spmm_(rows|packs)ILi4ELi(16|4)ELi1E",
             r"dedup_attn_bwd_nodesILi[12]E")
    for (source, name), (_, regs) in sorted(libs.items()):
        for entry, (r, spill) in sorted(regs.items()):
            if any(re.search(p, entry) for p in shown):
                args = re.search(r"I(?:L[ib][^E]*E)+", entry).group(0)
                kernel = re.search(r"(spmm_rows|spmm_packs|"
                                   r"dedup_attn_bwd_nodes)", entry).group(1)
                print(f"[ptxas] {source} {name} {kernel}{args}: {r} "
                      f"registers, {spill} B spilled", flush=True)

    # the modules' own libraries, their argument types set
    real = {"segment_kernels": sk._lib(), "dedup_attention": da._lib()}
    entry_points = {"segment_kernels": ("pgl_spmm_f32",
                                        "pgl_spmm_weighted_f32"),
                    "dedup_attention": ("pgl_dedup_attn_bwd_f32",)}

    def use(source, name):
        lib = libs[source, name][0]
        for f in entry_points[source]:
            fn, ref = getattr(lib, f), getattr(real[source], f)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        _build._LOADED[source] = lib

    rows = []

    def turns(tag, source, fn, iters=30):
        """Each variant of ``source`` timed in turns with the source's
        build (as_is, variant, variant, as_is)."""
        res = {}
        for name in VARIANTS[source]:
            t = []
            for v in ("as_is", name, name, "as_is"):
                use(source, v)
                t.append(time_ms(fn, iters))
            res[name] = (t[1] + t[2]) / 2
            res[name + "_as_is"] = (t[0] + t[3]) / 2
        _build._LOADED[source] = real[source]
        rows.append(dict(tag=tag, **res))
        print(f"[variants] {tag}: " + ", ".join(
            f"{n} {res[n]:.5f} (as_is {res[n + '_as_is']:.5f})"
            for n in VARIANTS[source]), flush=True)

    gen = torch.Generator(device=dev).manual_seed(5)

    def k1w_rows(tag, g, H, D):
        csc, csr = g._spmm_layouts
        N, E = g.num_nodes, g.num_edges
        x = torch.randn(N, D, device=dev, generator=gen)
        w = torch.randn(E, H, device=dev, generator=gen)
        cot = torch.randn(N, D, device=dev, generator=gen)
        out = torch.empty(N, D, device=dev)
        part = torch.empty(max(csc.item_partials, csr.item_partials), D,
                           device=dev)
        dw = torch.empty(E, H, device=dev)
        for kind, fn in (
                ("k1 csc", lambda: sk._launch(x, csc, out, part)),
                ("k1 csr", lambda: sk._launch(cot, csr, out, part)),
                ("fwd csc", lambda: sk._launch_weighted(x, w, csc, out,
                                                        part, 1)),
                ("dx csr", lambda: sk._launch_weighted(cot, w, csr, out,
                                                       part, 1)),
                ("dx+dw csr", lambda: sk._launch_weighted(
                    cot, w, csr, out, part, 1, 1, x, dw)),
                ("dw csr", lambda: sk._launch_weighted(
                    cot, w, csr, None, None, 0, 1, x, dw))):
            turns(f"K1w {tag} H={H} D={D} {kind}", "segment_kernels", fn)

    edges = np.asarray(headline_host().edges)
    for order, perm in (
            ("headline", np.arange(len(edges))),
            ("headline by source", np.argsort(edges[:, 0], kind="stable")),
            ("headline by destination",
             np.argsort(edges[:, 1], kind="stable"))):
        g = Graph(edges[perm], num_nodes=131072).tensor(dev)
        k1w_rows(order, g, 1, 64)
        del g
        torch.cuda.empty_cache()
    g = gat_host().tensor(dev)
    for H, D in ((8, 64), (1, 16)):
        k1w_rows("bench GAT graph", g, H, D)
    # the weights in the CSC layout's order (w [E, 8] is 32 MB)
    gat_edges = np.asarray(gat_host().edges)
    g_sorted = Graph(gat_edges[np.argsort(gat_edges[:, 1], kind="stable")],
                     num_nodes=g.num_nodes).tensor(dev)
    k1w_rows("bench GAT graph by destination", g_sorted, 8, 64)
    del g_sorted

    att = dedup_attention_of(g, dev, counts=False)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    for H, dvh in GAT_SHAPES:
        a_dst, a_src, v, g_out = attention_inputs(att.num_rows, H, dvh, dev,
                                                  gen)
        with torch.no_grad():
            out, lse = da._fwd_cuda(a_dst, a_src, v, att, 0.2, dvh, 0.0,
                                    seed)
            delta = (g_out.reshape(-1, H, dvh)
                     * out.reshape(-1, H, dvh)).sum(-1)
            bwd = (a_dst, a_src, v, g_out, lse, delta)
            want = da._bwd_cuda(*bwd, att, 0.2, dvh, 0.0, seed)
            for name in VARIANTS["dedup_attention"]:
                use("dedup_attention", name)
                got = da._bwd_cuda(*bwd, att, 0.2, dvh, 0.0, seed)
                diff = max(float((a - b).abs().max())
                           for a, b in zip(got, want))
                print(f"[variants] K8 ({H}, {dvh}) {name}: max |diff| "
                      f"against the source's {diff:.3e}", flush=True)
            turns(f"K8 ({H}, {dvh}) rate 0", "dedup_attention",
                  lambda: da._bwd_cuda(*bwd, att, 0.2, dvh, 0.0, seed))
    print(json.dumps({"variants": rows, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
