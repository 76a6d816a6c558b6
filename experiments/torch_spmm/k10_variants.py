#!/usr/bin/env python3
"""The additive K10 (K10-dq over CSC, K10-dkv over CSR) in variants, timed
on one card at the GAT's (8, 8) and (1, 16) on the bench GAT graph, rate 0.

Patched builds of ``csrc/attention_kernels.cu`` (one ``nvcc`` each, all in
parallel, into the git-ignored build directory) swapped in for the
module's library:

* ``u2``, ``u8``: 2 or 8 edges in flight a lane group in K10-dq where an
  edge's vectors hold at most 4 floats a lane, and half that in K10-dkv
  (the source: 4 and 2);
* ``b4``: at least 4 blocks an SM (64 registers);
* ``packed`` (K10-dkv): each edge reads its destination's a_dst, lse and
  delta as one 16-byte load from a packed [N, H, 4] table, built by torch
  from the three where delta is computed, its time counted;

and on the source's build, by the wrapper's arguments:

* ``memset``: the outputs zeroed by a memset launch before the kernel,
  and no zero tail (the empty-row list not passed);
* ``pack_row=P``: the work list rebuilt with ``PACK_ROW`` = P (the rows of
  at most P edges a lane group each; the source: 32).

Each variant is timed in turns with the source (source, variant, variant,
source): CUDA events over 50 calls, and the device ms by kernel from
torch.profiler. Its results are held against the source's (the largest
difference). Prints the registers and spills of each build's K10, then one
JSON line. Needs one CUDA card:

    python3 experiments/torch_spmm/k10_variants.py
"""

import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

from chip_smoke import (GAT_SHAPES, attention_inputs, gat_host,  # noqa: E402
                        kernel_split_ms, time_ms)

UNROLL = "dq = VEC * NV <= 4 ? 4 : (VEC * NV <= 8 ? 2 : 1)"
DKV_LOADS = """            ad[u][k] = on ? __ldg(a_dst + dh) : 0.f;
            ls[u][k] = on ? __ldg(lse + dh) : 0.f;
            dl[u][k] = on ? __ldg(delta + dh) : 0.f;"""
PACKED_LOADS = """            const float4 t4 =
                on ? __ldg(reinterpret_cast<const float4*>(a_dst) + dh)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
            ad[u][k] = t4.x;
            ls[u][k] = t4.y;
            dl[u][k] = t4.z;"""


def bounds(kernel):
    head = f"template <int VEC, int NV, bool V4>\n__global__ void "
    return (head + f"__launch_bounds__(kWarps * 32)\n{kernel}(",
            head + f"__launch_bounds__(kWarps * 32, 4)\n{kernel}(")


VARIANTS = {
    "as_is": [],
    "u2": [(UNROLL, "dq = VEC * NV <= 4 ? 2 : 1")],
    "u8": [(UNROLL, "dq = VEC * NV <= 4 ? 8 : (VEC * NV <= 8 ? 4 : 1)")],
    "b4": [bounds("gat_dq_groups"), bounds("gat_dkv_groups")],
    "packed": [(DKV_LOADS, PACKED_LOADS)],
}
PACK_ROWS = (8, 16, 64, 256)


def build():
    """Every variant, compiled in parallel: {variant: (CDLL, {kernel:
    (registers, spill bytes)})}."""
    from pgl_tpu_torch.ops.kernels import _build
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "attention_kernels.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: patch target not found once")
            text = text.replace(old, new)
        cu = out / f"attention_kernels_{name}.cu"
        cu.write_text(text)
        so = out / f"libattention_kernels_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
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
        libs[name] = (ctypes.CDLL(str(so)), regs)
    return libs


def main():
    if not torch.cuda.is_available():
        print("k10_variants: no CUDA device", file=sys.stderr)
        return 1
    from pgl_tpu_torch.ops.kernels import _build
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    libs = build()
    for name, (_, regs) in sorted(libs.items()):
        for entry, (r, spill) in sorted(regs.items()):
            m = re.search(r"(gat_dq_groups|gat_dkv_groups)(ILi4ELi1ELb1E)",
                          entry)
            if m:
                print(f"[ptxas] {name} {m.group(1)}{m.group(2)}: {r} "
                      f"registers, {spill} B spilled", flush=True)

    real = ak._lib()

    def use(name):
        lib = libs[name][0]
        for f in ("pgl_gat_dq_f32", "pgl_gat_dkv_f32"):
            fn, ref = getattr(lib, f), getattr(real, f)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        _build._LOADED["attention_kernels"] = lib

    def as_is():
        _build._LOADED["attention_kernels"] = real

    def measure(fn):
        split = kernel_split_ms(fn)
        return time_ms(fn, 50), sum(split.values()), split

    rows = []

    def turns(tag, base, variant, enter, leave):
        """``variant`` (entered by ``enter``, left by ``leave``) in turns
        with ``base`` on the source's build."""
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
                   device_ms=(t[1][1] + t[2][1]) / 2, split_ms=t[1][2])
        rows.append(row)
        print(f"[variants] {tag}: {row['ms']:.5f} ms (source "
              f"{row['base_ms']:.5f}); device {row['device_ms']:.5f} ms "
              f"(source {row['base_device_ms']:.5f}); by kernel "
              f"{row['split_ms']}", flush=True)

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    g = gat_host().tensor(dev)
    csc, csr = g._attention_layouts()
    N = g.num_nodes
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    relaid = {}
    for P in PACK_ROWS:
        keep = ak.PACK_ROW
        ak.PACK_ROW = P
        relaid[P] = ak.build_attention_layouts(
            g.adj_dst_index.numpy(), g.adj_src_index.numpy(), N, device=dev)
        ak.PACK_ROW = keep
    for H, dvh in GAT_SHAPES:
        a_dst, a_src, v, g_out = attention_inputs(N, H, dvh, dev, gen)
        with torch.no_grad():
            out, lse = ak._fwd_cuda(a_dst, a_src, v, csc, 0.2, dvh, 0.0, seed)
            delta = (g_out.reshape(N, H, dvh)
                     * out.reshape(N, H, dvh)).sum(-1)
        bwd = (a_dst, a_src, v, g_out, lse, delta)
        runs = {"K10-dq": lambda lay=csc: (ak._dq_cuda(
                    *bwd, lay, 0.2, dvh, 0.0, seed),),
                "K10-dkv": lambda lay=csr: ak._dkv_cuda(
                    *bwd, lay, 0.2, dvh, 0.0, seed)}
        for kernel, run in runs.items():
            with torch.no_grad():
                want = run()
                for name in VARIANTS:
                    if name in ("as_is", "packed"):
                        continue
                    use(name)
                    print(f"[variants] {kernel} ({H}, {dvh}) {name}: max "
                          f"|diff| {diff(run(), want):.3e}", flush=True)
                    as_is()
                    turns(f"{kernel} ({H}, {dvh}) {name}", run, run,
                          lambda n=name: use(n), as_is)
                for P, (c2, r2) in relaid.items():
                    lay = c2 if kernel == "K10-dq" else r2
                    print(f"[variants] {kernel} ({H}, {dvh}) pack_row={P}: "
                          f"max |diff| {diff(run(lay), want):.3e}",
                          flush=True)
                    turns(f"{kernel} ({H}, {dvh}) pack_row={P}", run,
                          lambda lay=lay: run(lay), lambda: None,
                          lambda: None)
            memset = memset_run(ak, kernel, bwd, csc, csr, dvh, seed)
            print(f"[variants] {kernel} ({H}, {dvh}) memset: max |diff| "
                  f"{diff(memset(), want):.3e}", flush=True)
            turns(f"{kernel} ({H}, {dvh}) memset", run, memset,
                  lambda: None, lambda: None)

        def packed():
            table = torch.stack([a_dst, lse, delta, torch.zeros_like(lse)],
                                dim=-1)
            return ak._dkv_cuda(table, a_src, v, g_out, lse, delta, csr,
                                0.2, dvh, 0.0, seed)

        with torch.no_grad():
            want = runs["K10-dkv"]()
            use("packed")
            print(f"[variants] K10-dkv ({H}, {dvh}) packed: max |diff| "
                  f"{diff(packed(), want):.3e}", flush=True)
            as_is()
            turns(f"K10-dkv ({H}, {dvh}) packed (its pack counted)",
                  runs["K10-dkv"], packed, lambda: use("packed"), as_is)
    print(json.dumps({"variants": rows, "device": smi}), flush=True)
    return 0


def memset_run(ak, kernel, bwd, csc, csr, dvh, seed):
    """The source's K10 without its zero tail: outputs from torch.zeros
    (a memset launch each) and no empty-row list."""
    a_dst = bwd[0]
    N, H = a_dst.shape
    thresh, inv_keep = ak._drop_args(0.0)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in bwd]

    def args(lay):
        n = lay.k10_items.shape[0]
        return (lay.k10_items.data_ptr(), lay.k10_long, n - lay.k10_long,
                lay.empty_rows.data_ptr(), 0, lay.split_rows.data_ptr(),
                lay.split_ptr.data_ptr(), lay.split_rows.shape[0], H, dvh,
                *ak.k10_lanes(H, dvh), 0.2, seed.data_ptr(), thresh,
                inv_keep)

    def dq():
        da = torch.zeros(N, H, device=a_dst.device)
        part = torch.empty(csc.num_partials, H, device=a_dst.device)
        rc = ak._lib().pgl_gat_dq_f32(
            0, *ptrs, csc.indices.data_ptr(), *args(csc), da.data_ptr(),
            part.data_ptr(), stream)
        assert rc == 0, rc
        return (da,)

    def dkv():
        da = torch.zeros(N, H, device=a_dst.device)
        dv = torch.zeros(N, H * dvh, device=a_dst.device)
        part = torch.empty(csr.num_partials, H + H * dvh,
                           device=a_dst.device)
        rc = ak._lib().pgl_gat_dkv_f32(
            0, *ptrs, csr.indices.data_ptr(), csr.eidx.data_ptr(),
            *args(csr), da.data_ptr(), dv.data_ptr(), part.data_ptr(),
            stream)
        assert rc == 0, rc
        return da, dv

    return dq if kernel == "K10-dq" else dkv


if __name__ == "__main__":
    sys.exit(main())
