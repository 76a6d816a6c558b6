#!/usr/bin/env python3
"""The additive forward (K9 over the CSC edges, K7 over the count matrix's
cells, ``gat_fwd_groups`` with its merge ``gat_fwd_combine``) in variants,
timed on one card at the GAT's (8, 8) and (1, 16) on the bench GAT graph,
rates 0 and 0.6.

Patched builds of ``csrc/attention_kernels.cu`` and
``csrc/dedup_attention.cu`` (each variant's copy of the sources and
headers in its own directory of the git-ignored build directory, one
``nvcc`` each, all in parallel) swapped in for the modules' libraries:

* ``u1``, ``u2``, ``u8``: 1, 2 or 8 edges in flight a lane group where an
  edge's vectors hold at most 4 floats a lane (the source: 4; 2 up to 8
  floats, else 1), and half that many cells;
* ``cells_full``: as many cells in flight as edges (the source: half);
* ``two_exp``: the online update with two exps an edge and head,
  exp(m - m') and exp(s - m') (the source: one, exp(-|s - m|));
* ``combine_w16``: split rows merged by 16 warps a row, the dot mode's
  count (the source: 32 up to two slots a lane);
* ``combine_serial``, ``combine_ahead8``, ``combine_ahead16``: a combine
  warp loading 1, 8 or 16 pieces' partials before it merges them (the
  source: 4 up to four slots a lane);
* ``two_pass``: split rows merged in two passes (the row's max of each
  head over its pieces, then the pieces' sums rescaled to it, 32
  columns a lane each, 32 warps a row, no piece waiting on another) by
  ``two_pass_merge`` below;
* ``b4``: at least 4 blocks an SM;

and on the source's build, by the work list:

* ``pack_row=P``: the lists rebuilt with ``attention_kernels.PACK_ROW`` =
  P (rows of at most P edges or cells a lane group each; the source: 32,
  K10's).

Each variant is timed in turns with the source (source, variant, variant,
source): CUDA events over 50 calls, and the device ms by kernel from
torch.profiler (the forward and the combine apart). Its results are held
against the source's (the largest difference). Prints the registers and
spills of each build's forward and combine, then one JSON line. Needs one
CUDA card:

    python3 experiments/torch_spmm/fwd_variants.py
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

from chip_smoke import (GAT_SHAPES, attention_inputs,  # noqa: E402
                        dedup_attention_of, gat_host, kernel_split_ms,
                        time_ms)

UNROLL = "edges = VEC * NV <= 4 ? 4 : (VEC * NV <= 8 ? 2 : 1)"
ONE_EXP = """  const float t = expf(-fabsf(s - m));
  const bool up = s > m;
  sc = up ? t : 1.f;
  p = c * (up ? 1.f : t);
  m = up ? s : m;"""
TWO_EXP = """  const float mn = fmaxf(m, s);
  sc = expf(m - mn);
  p = c * expf(s - mn);
  m = mn;"""
WARPS = "value = NC <= 2 ? 32 : CombineWarps<NC>::value"
AHEAD = "value = NC >= 8 ? 16 / NC : 4"
COMBINE = """    PGL_NC_SWITCH(nc, {
      constexpr int W = FwdCombineWarps<NC>::value;
      gat_fwd_combine<NC, W><<<n_split, W * 32, 0, s>>>(
          partials, split_rows, split_ptr, H, dvh, dvh_p, inv_keep, out,
          lse);
    })"""
TWO_PASS_LAUNCH = """    two_pass_merge<<<n_split, 32 * 32, 0, s>>>(
        partials, split_rows, split_ptr, H, dvh, inv_keep, out, lse);"""
# the two-pass merge, put before the launcher; every sum in a fixed order
TWO_PASS = """__global__ void __launch_bounds__(1024)
two_pass_merge(const float* __restrict__ partials,
               const int* __restrict__ split_rows,
               const int* __restrict__ split_ptr, int H, int dvh,
               float inv_keep, float* __restrict__ out,
               float* __restrict__ lse) {
  __shared__ float red[32][32];
  __shared__ float M[1024];
  __shared__ float tot[1024];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = H * dvh;
  const size_t P = static_cast<size_t>(C + 2 * H);
  const int p0 = split_ptr[blockIdx.x], p1 = split_ptr[blockIdx.x + 1];
  const size_t r = split_rows[blockIdx.x];
  for (int h0 = 0; h0 < H; h0 += 32) {
    const int h = h0 + lane;
    float mx = kMaskValue;
    if (h < H) {
#pragma unroll 8
      for (int p = p0 + w; p < p1; p += 32)
        mx = fmaxf(mx, __ldg(partials + p * P + C + h));
    }
    red[w][lane] = mx;
    __syncthreads();
    if (w == 0 && h < H) {
      float t = red[0][lane];
      for (int v = 1; v < 32; ++v) t = fmaxf(t, red[v][lane]);
      M[h] = t;
    }
    __syncthreads();
  }
  for (int c0 = 0; c0 < C + H; c0 += 32) {
    const int c = c0 + lane;
    float t = 0.f;
    if (c < C + H) {
      const int h = c < C ? c / dvh : c - C;
      const int col = c < C ? c : C + H + h;
      const float mh = M[h];
#pragma unroll 8
      for (int p = p0 + w; p < p1; p += 32) {
        const float* part = partials + p * P;
        t += __ldg(part + col) * expf(__ldg(part + C + h) - mh);
      }
    }
    red[w][lane] = t;
    __syncthreads();
    if (w == 0 && c < C + H) {
      float sum = 0.f;
      for (int v = 0; v < 32; ++v) sum += red[v][lane];
      tot[c] = sum;
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < C + H; c += 1024) {
    const int h = c < C ? c / dvh : c - C;
    const float l = tot[C + h];
    if (c < C)
      out[r * C + c] = l > 0.f ? tot[c] * (inv_keep / fmaxf(l, 1e-30f))
                               : 0.f;
    else
      lse[r * H + h] = l > 0.f ? M[h] + logf(l) : 0.f;
  }
}

"""
LAUNCHER = "// The forward of one call: gat_fwd_groups over the work list"
BOUNDS = ("__global__ void __launch_bounds__(kWarps * 32)\ngat_fwd_groups(",
          "__global__ void __launch_bounds__(kWarps * 32, 4)\n"
          "gat_fwd_groups(")

VARIANTS = {
    "u1": [(UNROLL, "edges = 1")],
    "u2": [(UNROLL, "edges = VEC * NV <= 4 ? 2 : 1")],
    "u8": [(UNROLL, "edges = VEC * NV <= 4 ? 8 : (VEC * NV <= 8 ? 4 : 1)")],
    "cells_full": [("value = CELLS && edges > 1 ? edges / 2 : edges",
                    "value = edges")],
    "two_exp": [(ONE_EXP, TWO_EXP)],
    "combine_w16": [(WARPS, "value = CombineWarps<NC>::value")],
    "combine_serial": [(AHEAD, "value = 1")],
    "combine_ahead8": [(AHEAD, "value = NC >= 8 ? 16 / NC : 8")],
    "combine_ahead16": [(AHEAD, "value = NC >= 16 ? 1 : 16 / NC")],
    "two_pass": [(COMBINE, TWO_PASS_LAUNCH),
                 (LAUNCHER, TWO_PASS + LAUNCHER)],
    "b4": [BOUNDS],
}
PACK_ROWS = (8, 16, 64, 256)
LIBS = ("attention_kernels", "dedup_attention")
ENTRIES = {"attention_kernels": "pgl_gat_fwd_f32",
           "dedup_attention": "pgl_dedup_attn_fwd_f32"}


def build():
    """Every variant, compiled in parallel: {variant: ({lib: CDLL},
    {entry: (registers, spill bytes)})}."""
    from pgl_tpu_torch.ops.kernels import _build
    root = _build.BUILD_DIR / "variants"
    procs = {}
    for name, patches in VARIANTS.items():
        d = root / f"fwd_{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        files = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu*")}
        for old, new in patches:
            hits = [f for f, text in files.items() if old in text]
            if len(hits) != 1 or files[hits[0]].count(old) != 1:
                raise RuntimeError(f"{name}: patch target not found once")
            files[hits[0]] = files[hits[0]].replace(old, new)
        for f, text in files.items():
            (d / f).write_text(text)
        for lib in LIBS:
            so = d / f"lib{lib}.so"
            procs[name, lib] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(d / f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    out = {}
    for (name, lib), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} {lib}: nvcc failed\n{log}")
        libs, regs = out.setdefault(name, ({}, {}))
        libs[lib] = ctypes.CDLL(str(so))
        regs.update(registers(log))
    return out


def registers(log):
    """{mangled entry: (registers, spill bytes)} of the forward and the
    combine in an ``nvcc -Xptxas -v`` log."""
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
            k = re.search(r"(gat_fwd_groupsILi4ELi1ELb1ELb[01]E|"
                          r"gat_fwd_combineILi[12]ELi\d+E|two_pass_merge)",
                          entry)
            if k:
                regs[k.group(1)] = (int(m.group(1)), spill)
            entry = None
    return regs


def main():
    if not torch.cuda.is_available():
        print("fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    from pgl_tpu_torch.ops.kernels import _build
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import dedup_attention as da

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    real = {"attention_kernels": ak._lib(), "dedup_attention": da._lib()}
    src_regs = {}
    for lib in LIBS:
        path = _build.build(lib)[lib]
        src_regs.update(registers(path.with_suffix(".log").read_text()))
    variants = build()
    for name, regs in [("source", src_regs)] + [
            (n, r) for n, (_, r) in sorted(variants.items())]:
        for entry, (r, spill) in sorted(regs.items()):
            print(f"[ptxas] {name} {entry}: {r} registers, {spill} B "
                  "spilled", flush=True)

    def use(name):
        for lib, fn_name in ENTRIES.items():
            new = variants[name][0][lib]
            fn, ref = getattr(new, fn_name), getattr(real[lib], fn_name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            _build._LOADED[lib] = new

    def as_is():
        for lib in LIBS:
            _build._LOADED[lib] = real[lib]

    def measure(fn):
        split = kernel_split_ms(fn)
        return time_ms(fn, 50), sum(split.values()), split

    rows = []

    def turns(tag, base, variant, enter, leave, diff):
        t = []
        for which in ("base", "v", "v", "base"):
            if which == "v":
                enter()
                t.append(measure(variant))
                leave()
            else:
                t.append(measure(base))
        row = dict(tag=tag, base_ms=(t[0][0] + t[3][0]) / 2,
                   ms=(t[1][0] + t[2][0]) / 2,
                   base_device_ms=(t[0][1] + t[3][1]) / 2,
                   device_ms=(t[1][1] + t[2][1]) / 2,
                   base_split_ms=t[0][2], split_ms=t[1][2], max_diff=diff)
        rows.append(row)
        print(f"[variants] {tag}: {row['ms']:.5f} ms (source "
              f"{row['base_ms']:.5f}); device {row['device_ms']:.5f} ms "
              f"(source {row['base_device_ms']:.5f}); by kernel "
              f"{row['split_ms']} (source {row['base_split_ms']}); max "
              f"|diff| {diff:.3e}", flush=True)

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    g = gat_host().tensor(dev)
    N = g.num_nodes
    csc, _ = g._attention_layouts()
    att = dedup_attention_of(g, dev, counts=False)
    relaid = {}
    keep = ak.PACK_ROW
    for P in PACK_ROWS:
        ak.PACK_ROW = P
        relaid[P] = (ak.build_attention_layouts(
            g.adj_dst_index.numpy(), g.adj_src_index.numpy(), N,
            device=dev)[0], da.build_dedup_attention(att.layout, N))
    ak.PACK_ROW = keep
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    for H, dvh in GAT_SHAPES:
        a_dst, a_src, v, _ = attention_inputs(N, H, dvh, dev, gen)
        for rate in (0.0, 0.6):
            runs = {"K9": lambda lay=csc: ak._fwd_cuda(
                        a_dst, a_src, v, lay, 0.2, dvh, rate, seed),
                    "K7": lambda lay=att: da._fwd_cuda(
                        a_dst, a_src, v, lay, 0.2, dvh, rate, seed)}
            for kernel, run in runs.items():
                label = f"{kernel} ({H}, {dvh}) rate={rate}"
                with torch.no_grad():
                    want = run()
                    for name in VARIANTS:
                        use(name)
                        d = diff(run(), want)
                        as_is()
                        turns(f"{label} {name}", run, run,
                              lambda n=name: use(n), as_is, d)
                    for P, lays in relaid.items():
                        lay = lays[0] if kernel == "K9" else lays[1]
                        turns(f"{label} pack_row={P}", run,
                              lambda lay=lay: run(lay), lambda: None,
                              lambda: None, diff(run(lay), want))
    print(json.dumps({"variants": rows, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
