#!/usr/bin/env python3
"""K1 (the sorted SpMM), K1w, the dot-mode K9, K10-dq and K10-dkv, the
dot-mode K7 and K8, and the additive K8 of a git revision beside this
tree's, timed in one process on one card.

    # with git (the card's copy of the repo has none): write the
    # revision's sources into _archive/before_<rev>/ (git-ignored)
    python experiments/torch_spmm/k1_k10_before_after.py --extract [--rev R]
    # on the card: build both, check, time in turns
    python experiments/torch_spmm/k1_k10_before_after.py [--rev R]

The revision (default ``38de6bd``) gives ``segment_kernels.cu``,
``attention_kernels.cu``, ``dedup_attention.cu``, ``attention_common.cuh``
and, where it has one, ``dot_staged.cuh`` (``git show <rev>:<path>``); they
are compiled
with ``_build.NVCC_FLAGS`` into ``_archive/before_<rev>/build/`` and
loaded with ctypes beside the tree's libraries. Every shape is timed old, new, new, old (CUDA events, each a
mean over warm launches) and the two runs of each averaged, so "no slower
than before" is a comparison on one card. Shapes: K1 on the bench headline
(CSC and CSR at D = 128, 16, 64), on the bench GAT graph (D = 64, 16), over
``build_uniq_reduce``'s layout (the reference's fold of pair-slot rows
onto nodes, bench GAT graph; D = 1, 8, 16, 64, 256) and over ``by_src``/``by_dst`` (K11's backward on the headline, D
= 128), each beside ``torch.sparse.mm``; K1w (``k1w``) at FAGCN's and
GATv2's shapes, forward, dx with dw and dw alone (the revision's on the
pieces of ``cut_rows`` at 512 edges, which it walked; both against float64
and each other);
K10-dkv-dot (``k10``), K9-dot (``k9``) and K10-dq-dot (``k10dq``) at
UniMP's (2, 128, 128) on the UniMP stand-in and on the bench GAT graph at
rates 0 and 0.3, and at GATConv's many-head (43, 2, 8) with leaky 0.2 on
the bench GAT graph; K7-dot (``k7``) and K8-dot (``k8``: against a
revision that had the dot slot pass, before fd49ea7, such as ``--rev
12a5247``; the revision's counted with its two K1 folds of the slot rows
over ``build_uniq_reduce``'s layout, which the tree's node walk replaces)
at UniMP's shape on the bench GAT graph's
count matrix at rates 0 and 0.3, and ``k7`` also prints both builds'
digests of out | lse | dq on ``chip_smoke.PARENT_BITS_CASES`` (the
revision's are the pinned ``PARENT_BITS``); the additive K8 (``k8add``) at
the GAT's (8, 8) and (1, 16) on the bench GAT graph's count matrix at
rates 0 and 0.6, the revision's counted with its slot pass's two K1 folds
over ``build_uniq_reduce``'s layout (this tree's K1), whether d a_dst and
K7's out and lse keep the revision's bits, and both against float64;
the additive K10 (``k10add``: K10-dq over CSC and K10-dkv over CSR, both
on this tree's K9's lse and delta) at the GAT's (8, 8) and (1, 16) on the
bench GAT graph at rates 0 and 0.6, both builds against float64, with
each build's K10 a GAT step at rate 0 (both kernels at both shapes);
against a4b9325, the last revision with the one-warp-a-piece K10
(``--extract --rev a4b9325``, then ``--rev a4b9325 --only k10add``); the
additive K9 (``k9add``, over CSC) and K7 (``k7add``, over the bench GAT
graph's count matrix) at the GAT's (8, 8) and (1, 16), rates 0 and 0.6,
both builds against float64 and each other, split by kernel (the forward
and its merge of split rows apart, device ms by torch.profiler), with
each build's K9 and K7 a GAT step at rate 0; against e1f22d9, the last
revision with the one-warp-a-piece forward (``--extract --rev e1f22d9``,
then ``--rev e1f22d9 --only k9add k7add``).
``--only`` picks among k1, k1w, k10, k9, k10dq, k7, k8, k8add, k10add,
k9add, k7add.

``--bf16`` runs the bf16 arm instead (``bf16_arm``), for ``k10`` (K10-dkv),
``k10dq`` and ``k8`` (the dot K8, the cell forms of the same two passes)
against a revision with the same entry points (``--rev 41478a7``, the
parent of the bf16 ring): it builds the revision's
``attention_kernels_bf16`` and ``dedup_attention_bf16`` beside the tree's,
and the tree's again at each ring depth of ``--depths`` (a copy of
``csrc/`` with ``kBf16RingSteps`` set, ``_archive/ring_steps_<S>/``);
compares every build's bf16 dq, dk and dv
(and K9's out and lse, and K8's) with the revision's bit for bit at
UniMP's shape on the UniMP stand-in (rates 0 and 0.3), at the four shapes
of ``test_bf16_dot_attention_matches_plain_version`` on its graph and (K8)
on phase 6's multigraph, each within ``check_bf16`` of float64 and the
same bits on a second run; compares the ``cuobjdump -sass`` of every staged
instantiation, float32 and bf16, of the two builds (the forward, K9 and
K7, and the float32 backward must be unchanged); times the
bf16 K10-dq and K10-dkv of every build at UniMP's shape, rates 0 and 0.3,
in turns (revision, tree, each depth, then in reverse) beside the float32
kernels on the same values, and the bf16 K8 (revision, tree, tree,
revision) on the bench GAT graph's count matrix; and times the amp UniMP
step (phase 18's trainer) on each build's libraries, revision, tree, tree,
revision.
New results
are held against the float64
plain version (``chip_smoke.check_spmm``) and old against new (the dot
kernels: the largest difference, and whether the bits agree;
``chip_smoke.py`` holds them against float64). The ``ptxas`` registers and spills of both
versions' kernels print first. One JSON line of all rows ends the output,
after the card's name and power limit.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
CSRC = "pgl_tpu_torch/ops/kernels/csrc"
SOURCES = ("segment_kernels.cu", "attention_kernels.cu",
           "dedup_attention.cu", "attention_common.cuh", "dot_staged.cuh",
           "additive_groups.cuh")
LIBS = ("segment_kernels", "attention_kernels", "dedup_attention")
# the bf16 arm's libraries: (library, source), built with -DPGL_BF16
LIBS_BF16 = (("attention_kernels_bf16", "attention_kernels"),
             ("dedup_attention_bf16", "dedup_attention"))


def old_dir(rev):
    return ROOT / "_archive" / f"before_{rev}"


def extract(rev):
    d = old_dir(rev)
    d.mkdir(parents=True, exist_ok=True)
    wrote = []
    for name in SOURCES:
        got = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                             cwd=ROOT, capture_output=True, text=True)
        if got.returncode:      # a header the revision did not have yet
            continue
        (d / name).write_text(got.stdout)
        wrote.append(name)
    print(f"wrote {', '.join(wrote)} of {rev} to {d}")


def build_old(rev):
    """Compile the revision's three sources in parallel; returns {name:
    CDLL} and the ptxas logs."""
    from pgl_tpu_torch.ops.kernels import _build
    d = old_dir(rev)
    if not (d / SOURCES[0]).exists():
        raise SystemExit(f"{d} has no sources: run with --extract first")
    (d / "build").mkdir(exist_ok=True)
    procs = {}
    for name in LIBS:
        so = d / "build" / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(d / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"old {name} failed to build:\n{logs[name]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs, logs


def build_bf16(src_dir, out_dir):
    """Compile the bf16 libraries of ``LIBS_BF16`` from the sources in
    ``src_dir`` with ``-DPGL_BF16``, in parallel, into ``out_dir``;
    returns ({library: CDLL}, {library: .so path}, {library: ptxas
    log})."""
    from pgl_tpu_torch.ops.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in LIBS_BF16:
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DPGL_BF16", "-o", str(so),
             str(src_dir / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, paths, logs = {}, {}, {}
    for name, (so, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} from {src_dir} failed to build:\n"
                               f"{logs[name]}")
        libs[name], paths[name] = ctypes.CDLL(str(so)), so
    return libs, paths, logs


def ring_steps_copy(depth):
    """A copy of the tree's ``csrc/`` in ``_archive/ring_steps_<depth>/``
    whose bf16 ring is ``depth`` steps deep (``kBf16RingSteps``)."""
    d = ROOT / "_archive" / f"ring_steps_{depth}"
    d.mkdir(parents=True, exist_ok=True)
    for f in (ROOT / CSRC).glob("*.cu*"):
        text = f.read_text()
        if f.name == "attention_common.cuh":
            text, n = re.subn(r"constexpr int kBf16RingSteps = \d+;",
                              f"constexpr int kBf16RingSteps = {depth};",
                              text)
            if n != 1:
                raise RuntimeError("kBf16RingSteps not found once")
        (d / f.name).write_text(text)
    return d


# a staged dot kernel's name and template arguments (T, NC, FULL, WIDE,
# CELLS), which key its SASS: the rest of a mangled name differs between
# builds (the anonymous namespace's hash; a parameter's spelled type)
STAGED_KEY = re.compile(r"(dot_\w+?_staged)I(f|13__nv_bfloat16)Li(\d+)ELb(\d)"
                        r"ELb(\d)ELb(\d)E")


def sass_functions(so):
    """{(kernel, T, NC, FULL, WIDE, CELLS): its SASS} of the staged dot
    kernels of a library (``cuobjdump -sass``; names in the code blanked),
    or None where the toolkit has no cuobjdump."""
    from pgl_tpu_torch.ops.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            k = STAGED_KEY.search(m.group(1))
            key = k.groups() if k else None
            if key is not None:
                out[key] = []
        elif key is not None:
            out[key].append(re.sub(r"_Z\S+", "_Z", line.strip()))
    return {k: "\n".join(v) for k, v in out.items()}


def registers(log, pattern):
    """(the kernel's match of ``pattern`` and its template arguments,
    registers, spill bytes) of each entry of ``log`` whose mangled name
    matches ``pattern``."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(pattern, m.group(1))
            name = m.group(1) if k else None
            kernel = k.group(0) if k else ""
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            args = re.search(r"I(?:L[ib][^E]*E)+", name)
            out.append((kernel + (args.group(0) if args else name),
                        int(m.group(1)), spill))
            name = None
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rev", default="38de6bd")
    ap.add_argument("--extract", action="store_true")
    kinds = ("k1", "k1w", "k10", "k9", "k10dq", "k7", "k8", "k8add",
             "k10add", "k9add", "k7add")
    ap.add_argument("--only", choices=kinds, nargs="+", default=kinds,
                    help="the kernels to time (default: all)")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 arm (k10, k10dq, k8) instead")
    ap.add_argument("--depths", type=int, nargs="*", default=(),
                    help="bf16 ring depths to build the tree at besides "
                    "its own")
    a = ap.parse_args()
    if a.extract:
        extract(a.rev)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("k1_k10_before_after: no CUDA device", file=sys.stderr)
        return 1
    if a.bf16:
        return bf16_arm(a)
    from chip_smoke import (GAT_SHAPES, PARENT_BITS_CASES, UNIMP_SHAPE,
                            attention_inputs, bits_digest, check,
                            check_dedup_attention, check_spmm,
                            check_weighted, dedup_attention_of,
                            dispatch_settings, dot_inputs, gat_host,
                            headline_host, kernel_split_ms,
                            parent_bits_case,
                            parent_bits_graph, run_dedup_attention,
                            run_dedup_dot, time_ms, unimp_host)
    from pgl_tpu_torch.ops.kernels import dedup_kernels as dk
    from pgl_tpu_torch.ops.kernels import _build
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import dedup_attention as da
    from pgl_tpu_torch.ops.kernels import segment_kernels as sk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    old, old_logs = build_old(a.rev)
    new = _build.build(*LIBS)
    new_logs = {n: p.with_suffix(".log").read_text() for n, p in new.items()}
    lib_of = {"K1": "segment_kernels", "K1w": "segment_kernels",
              "K7-dot": "dedup_attention", "K8-dot": "dedup_attention",
              "K8": "dedup_attention", "K7": "dedup_attention"}
    for tag, logs, pat in (
            ("old K1", old_logs, r"spmm_(rows|packs)ILi\d+ELi\d+ELi\d+EE"),
            ("new K1", new_logs,
             r"spmm_(rows|packs)ILi\d+ELi\d+ELi\d+ELi0ELi0E"),
            ("old K1w", old_logs, r"spmm_pieces"),
            ("new K1w", new_logs,
             r"spmm_(rows|packs)ILi\d+ELi\d+ELi\d+E(?!Li0ELi0E)"),
            ("old K8", old_logs, r"dedup_attn_bwd_(rows|slots)"),
            ("new K8", new_logs, r"dedup_attn_bwd_(rows|nodes)"),
            ("old K10-dkv-dot", old_logs, r"dot_dkv_(pieces|staged)"),
            ("new K10-dkv-dot", new_logs, r"dot_dkv_staged"),
            ("old K9-dot", old_logs, r"dot_fwd_(pieces|staged)"),
            ("new K9-dot", new_logs, r"dot_fwd_staged"),
            ("old K10-dq-dot", old_logs, r"dot_dq_(pieces|staged)"),
            ("new K10-dq-dot", new_logs, r"dot_dq_staged"),
            ("old K7-dot", old_logs, r"dedup_dot_fwd"),
            ("new K7-dot", new_logs, r"dot_fwd_staged"),
            ("old K8-dot", old_logs, r"dedup_dot_bwd_(rows|slots)"),
            ("new K8-dot", new_logs, r"dot_(dq|dkv)_staged"),
            ("old K10 additive", old_logs, r"gat_(dq|dkv)_pieces"),
            ("new K10 additive", new_logs, r"gat_(dq|dkv)_groups"),
            ("old K9 additive", old_logs, r"gat_fwd_(pieces|combine)"),
            ("new K9 additive", new_logs,
             r"gat_fwd_(groups\w*ELb0E|combine)"),
            ("old K7 additive", old_logs, r"(dedup_attn_fwd|gat_fwd_combine)"),
            ("new K7 additive", new_logs,
             r"gat_fwd_(groups\w*ELb1E|combine)")):
        for args, regs, spill in registers(
                logs[lib_of.get(tag.split()[1], "attention_kernels")], pat):
            print(f"[ptxas] {tag} {args}: {regs} registers, {spill} B "
                  "spilled", flush=True)

    p, i = ctypes.c_void_p, ctypes.c_int
    seg = old["segment_kernels"]
    # the revision's K1 takes this tree's work list (items, rows then
    # packs) or, before it, the pieces of cut_rows (the parent's)
    old_k1_new_abi = "int n_packs" in (
        old_dir(a.rev) / "segment_kernels.cu").read_text()
    seg.pgl_spmm_f32.argtypes = (sk._lib().pgl_spmm_f32.argtypes
                                 if old_k1_new_abi else
                                 [i, p, p, p, i, p, p, i, i, p, p, p])
    # the revision's K1w: one warp a piece of cut_rows at 512 edges
    seg.pgl_spmm_weighted_f32.argtypes = [i, i, i, p, p, p, p, i, p, i, p,
                                          p, i, i, p, p, p, p, p]
    att = old["attention_kernels"]
    for fn in ("pgl_dot_fwd_f32", "pgl_dot_dq_f32", "pgl_dot_dkv_f32"):
        getattr(att, fn).argtypes = getattr(ak._lib(), fn).argtypes
    ded = old["dedup_attention"]
    f = ctypes.c_float
    cells = [p] * 3 + [p, i, p, p, i]   # node, unique row, count; pieces
    dot = [i, i, i, f, p, i, f]          # H, dsh, dvh, slope, seed, ...
    slots = [p] * 5 + [i]
    ded.pgl_dedup_dot_fwd_f32.argtypes = [i] + [p] * 3 + cells + dot + [p] * 4
    ded.pgl_dedup_dot_bwd_f32.argtypes = ([i] + [p] * 6 + cells + slots + dot
                                          + [p] * 5)
    # the revision's additive K7 (one warp a piece of the cells in row
    # order, as every revision before the lane-group forward) and K8 (its
    # row pass and slot pass)
    ded.pgl_dedup_attn_fwd_f32.argtypes = ([i] + [p] * 6 + [p, i, p, p, i]
                                           + dot[1:] + [p] * 4)
    ded.pgl_dedup_attn_bwd_f32.argtypes = ([i] + [p] * 9 + [p, i, p, p, i]
                                           + slots + dot[1:] + [p] * 5)

    # the revision's additive K9 and K10: one warp a piece of cut_rows
    # (K10 before a4b9325's child, K9 to e1f22d9)
    work = [p, i, p, p, i, i, i, f, p, i, f]
    att.pgl_gat_fwd_f32.argtypes = [i] + [p] * 4 + work + [p] * 4
    att.pgl_gat_dq_f32.argtypes = [i] + [p] * 7 + work + [p] * 3
    att.pgl_gat_dkv_f32.argtypes = [i] + [p] * 8 + work + [p] * 4

    pieces_of = {}

    def old_pieces(lay):
        """The revision's K1w work list: ``cut_rows`` at 512 edges (pieces,
        split rows, their pointer, the partial count), on the card."""
        key = id(lay)
        if key not in pieces_of:
            pc, rows_, ptr = sk.cut_rows(lay.indptr.cpu().numpy(), 512)
            pieces_of[key] = tuple(
                torch.as_tensor(a.astype(np.int32), device=dev)
                for a in (pc, rows_, ptr)) + (int(ptr[-1]),)
        return pieces_of[key]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def old_k1(x, lay, out, part):
        if old_k1_new_abi:
            work = (lay.indptr.data_ptr(), lay.items.data_ptr(),
                    lay.items.shape[0] - lay.item_packs, lay.item_packs,
                    lay.item_split_rows.data_ptr(),
                    lay.item_split_ptr.data_ptr(),
                    lay.item_split_rows.shape[0])
        else:
            pc, rows_, ptr, _ = old_pieces(lay)
            work = (pc.data_ptr(), pc.shape[0], rows_.data_ptr(),
                    ptr.data_ptr(), rows_.shape[0])
        rc = seg.pgl_spmm_f32(
            0, x.data_ptr(), lay.indices.data_ptr(), *work, x.shape[1],
            out.data_ptr(), part.data_ptr(), stream())
        assert rc == 0, rc

    rows = []

    def turns(name, fn_old, fn_new, iters, **extra):
        t = [time_ms(f, iters) for f in (fn_old, fn_new, fn_new, fn_old)]
        o, n = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        rows.append(dict(name=name, old_ms=o, new_ms=n, ratio=n / o,
                         runs=t, **extra))
        more = "".join(f", {k} {v:.6g}" if isinstance(v, float) else
                       f", {k} {v}" for k, v in extra.items())
        print(f"[before/after] {name}: old {o:.5f} ms, new {n:.5f} ms "
              f"(new/old {n / o:.3f}; runs {', '.join(f'{v:.5f}' for v in t)}"
              f"){more}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(3)

    def k1_rows(tag, lay, n_src, widths):
        A = torch.sparse_csr_tensor(lay.indptr, lay.indices,
                                    torch.ones(lay.num_edges, device=dev),
                                    size=(lay.num_rows, n_src))
        for d in widths:
            x = torch.randn(n_src, d, device=dev, generator=gen)
            outs = [torch.empty(lay.num_rows, d, device=dev)
                    for _ in range(2)]
            part = torch.empty(max(old_pieces(lay)[3], lay.item_partials),
                               d, device=dev)
            old_k1(x, lay, outs[0], part)
            sk._launch(x, lay, outs[1], part)
            with torch.no_grad():
                err = check_spmm(f"{tag} D={d}", outs[1], x, lay)
                diff = float((outs[0] - outs[1]).abs().max()) \
                    if outs[0].numel() else 0.0
            lib = time_ms(lambda: torch.sparse.mm(A, x), 50)
            turns(f"K1 {tag} D={d}", lambda: old_k1(x, lay, outs[0], part),
                  lambda: sk._launch(x, lay, outs[1], part), 100,
                  library_ms=lib, max_abs_err=err, old_new_max_diff=diff,
                  items=int(lay.items.shape[0]))

    def k1w_rows(tag, g, op, H, D):
        """K1w of both builds at (op, H, D): the forward over CSC, dx with
        dw and dw alone over CSR, timed in turns; the new held against
        float64 and both against each other."""
        csc, csr = g._spmm_layouts
        N, E = g.num_nodes, g.num_edges
        x = torch.randn(N, D, device=dev, generator=gen)
        w = torch.randn(E, H, device=dev, generator=gen)
        cot = torch.randn(N, D, device=dev, generator=gen)
        wop = sk._OPS[op]
        mul = op == "mul"
        cases = {"fwd csc": (x, csc, wop, 0, None, True),
                 "dx+dw csr": (cot, csr, 1 if mul else 0, wop, x, True),
                 "dw csr": (cot, csr, 0, wop, x, False)}
        for kind, (src, lay, wo, dwo, xrow, with_out) in cases.items():
            res = {}

            def buffers(n_part):
                out = torch.empty(N, D, device=dev) if with_out else None
                part = (torch.empty(n_part, D, device=dev) if with_out
                        else None)
                dw = torch.empty(E, H, device=dev) if dwo else None
                return out, part, dw

            def old_run():
                pc, rows_, ptr, n_part = old_pieces(lay)
                out, part, dw = buffers(n_part)
                rc = seg.pgl_spmm_weighted_f32(
                    0, wo, dwo, src.data_ptr(), lay.indices.data_ptr(),
                    lay.edge_id.data_ptr(), w.data_ptr(), H, pc.data_ptr(),
                    pc.shape[0], rows_.data_ptr(), ptr.data_ptr(),
                    rows_.shape[0], D, sk._ptr(out), sk._ptr(part),
                    sk._ptr(xrow if mul else None), sk._ptr(dw), stream())
                assert rc == 0, rc
                res["old"] = out, dw

            def new_run():
                out, part, dw = buffers(lay.item_partials)
                sk._launch_weighted(src, w, lay, out, part, wo, dwo,
                                    xrow if mul else None, dw)
                res["new"] = out, dw

            old_run()
            new_run()
            torch.cuda.synchronize()
            (o_out, o_dw), (n_out, n_dw) = res["old"], res["new"]
            with torch.no_grad():
                fwd = kind.startswith("fwd")
                err = max(check_weighted(
                    f"{tag} {op} H={H} D={D} {kind}", x, w, cot, csc, csr,
                    op, n_out if fwd else None,
                    n_out if not fwd else None, n_dw).values())
                diff = max(float((a - b).abs().max())
                           for a, b in ((o_out, n_out), (o_dw, n_dw))
                           if a is not None and a.numel())
            turns(f"K1w {tag} {op} H={H} D={D} {kind}", old_run, new_run,
                  50, max_abs_err=err, old_new_max_diff=diff,
                  items=int(lay.items.shape[0]),
                  old_pieces=int(old_pieces(lay)[0].shape[0]))

    def dkv_rows(tag, g, rates, shape=UNIMP_SHAPE, leaky=0.0):
        H, dsh, dvh = shape
        csc, csr = g._attention_layouts()
        N = g.num_nodes
        q, k, v, g_out = dot_inputs(N, shape, dev, gen)
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        for rate in rates:
            with torch.no_grad():
                out, lse = ak._dot_fwd_cuda(q, k, v, csc, leaky, dsh, dvh,
                                            rate, seed)
                delta = (g_out.reshape(N, H, dvh)
                         * out.reshape(N, H, dvh)).sum(-1)
            ins = (q, k, v, g_out, lse, delta)
            thresh, inv_keep = ak._drop_args(rate)
            res = {}

            def old_dkv():
                dk = torch.empty(N, H * dsh, device=dev)
                dv = torch.empty(N, H * dvh, device=dev)
                part = torch.empty(csr.num_partials, H * (dsh + dvh),
                                   device=dev)
                rc = att.pgl_dot_dkv_f32(
                    0, *(t.data_ptr() for t in ins), csr.indices.data_ptr(),
                    csr.eidx.data_ptr(), csr.pieces.data_ptr(),
                    csr.pieces.shape[0], csr.split_rows.data_ptr(),
                    csr.split_ptr.data_ptr(), csr.split_rows.shape[0], H,
                    dsh, dvh, leaky, seed.data_ptr(), thresh, inv_keep,
                    dk.data_ptr(), dv.data_ptr(), part.data_ptr(), stream())
                assert rc == 0, rc
                res["old"] = dk, dv

            def new_dkv():
                res["new"] = ak._dot_dkv_cuda(*ins, csr, leaky, dsh, dvh,
                                              rate, seed)
            old_dkv()
            new_dkv()
            with torch.no_grad():
                diff = max(float((o - n_).abs().max())
                           for o, n_ in zip(res["old"], res["new"]))
                same = all(torch.equal(o, n_)
                           for o, n_ in zip(res["old"], res["new"]))
            turns(f"K10-dkv-dot {tag} {shape} leaky={leaky} rate={rate}",
                  old_dkv, new_dkv, 20, old_new_max_diff=diff,
                  same_bits_as_old=same)

    def fwd_dq_rows(tag, g, shape, leaky, rates):
        """K9-dot and K10-dq-dot of both builds on the same inputs (dq on
        the new K9's lse and delta), timed in turns."""
        H, dsh, dvh = shape
        csc = g._attention_layouts()[0]
        N = g.num_nodes
        q, k, v, g_out = dot_inputs(N, shape, dev, gen)
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        split = (csc.split_rows.data_ptr(), csc.split_ptr.data_ptr(),
                 csc.split_rows.shape[0])
        for rate in rates:
            thresh, inv_keep = ak._drop_args(rate)
            with torch.no_grad():
                out, lse = ak._dot_fwd_cuda(q, k, v, csc, leaky, dsh, dvh,
                                            rate, seed)
                delta = (g_out.reshape(N, H, dvh)
                         * out.reshape(N, H, dvh)).sum(-1)
            res = {}

            def old_fwd():
                o = torch.empty(N, H * dvh, device=dev)
                ls = torch.empty(N, H, device=dev)
                part = torch.empty(csc.num_partials, H * dvh + 2 * H,
                                   device=dev)
                rc = att.pgl_dot_fwd_f32(
                    0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    csc.indices.data_ptr(), csc.pieces.data_ptr(),
                    csc.pieces.shape[0], *split, H, dsh, dvh, leaky,
                    seed.data_ptr(), thresh, inv_keep, o.data_ptr(),
                    ls.data_ptr(), part.data_ptr(), stream())
                assert rc == 0, rc
                res["old_fwd"] = o, ls

            def new_fwd():
                res["new_fwd"] = ak._dot_fwd_cuda(q, k, v, csc, leaky, dsh,
                                                  dvh, rate, seed)

            def old_dq():
                dq = torch.empty(N, H * dsh, device=dev)
                part = torch.empty(csc.num_partials, H * dsh, device=dev)
                rc = att.pgl_dot_dq_f32(
                    0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    g_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    csc.indices.data_ptr(), csc.pieces.data_ptr(),
                    csc.pieces.shape[0], *split, H, dsh, dvh, leaky,
                    seed.data_ptr(), thresh, inv_keep, dq.data_ptr(),
                    part.data_ptr(), stream())
                assert rc == 0, rc
                res["old_dq"] = (dq,)

            def new_dq():
                res["new_dq"] = (ak._dot_dq_cuda(
                    q, k, v, g_out, lse, delta, csc, leaky, dsh, dvh, rate,
                    seed),)

            for name, fo, fn, key in (("K9-dot", old_fwd, new_fwd, "fwd"),
                                      ("K10-dq-dot", old_dq, new_dq, "dq")):
                if {"fwd": "k9", "dq": "k10dq"}[key] not in only:
                    continue
                fo()
                fn()
                with torch.no_grad():
                    pairs = list(zip(res["old_" + key], res["new_" + key]))
                    diff = max(float((o - n_).abs().max()) for o, n_ in pairs)
                    same = all(torch.equal(o, n_) for o, n_ in pairs)
                turns(f"{name} {tag} {shape} leaky={leaky} rate={rate}", fo,
                      fn, 20, old_new_max_diff=diff, same_bits_as_old=same)
            del out, lse, delta
            res.clear()

    def old_k7(att, q, k, v, shape, leaky, rate, seed):
        """The revision's dot-mode K7: (out, lse)."""
        H, dsh, dvh = shape
        N = q.shape[0]
        thresh, inv_keep = ak._drop_args(rate)
        out = torch.empty(N, H * dvh, device=dev)
        lse = torch.empty(N, H, device=dev)
        part = torch.empty(att.num_partials, H * dvh + 2 * H, device=dev)
        rc = ded.pgl_dedup_dot_fwd_f32(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), *old_cells(att), H,
            dsh, dvh, leaky, seed.data_ptr(), thresh, inv_keep,
            out.data_ptr(), lse.data_ptr(), part.data_ptr(), stream())
        assert rc == 0, rc
        return out, lse

    def old_k8(att, bwd, shape, leaky, rate, seed):
        """The revision's dot-mode K8 and its two folds over ``red`` (this
        tree's K1): (dq, dk, dv) on node rows."""
        H, dsh, dvh = shape
        N, lay = bwd[0].shape[0], att.layout
        S, slot_lists, red = slot_view(att)
        thresh, inv_keep = ak._drop_args(rate)
        dq = torch.empty(N, H * dsh, device=dev)
        dk = torch.empty(S, H * dsh, device=dev)
        dv = torch.empty(S, H * dvh, device=dev)
        part = torch.empty(att.num_partials, H * dsh, device=dev)
        rc = ded.pgl_dedup_dot_bwd_f32(
            0, *(t.data_ptr() for t in bwd), *old_cells(att),
            lay.uv.data_ptr(), lay.pairs.data_ptr(),
            *(t.data_ptr() for t in slot_lists), S, H, dsh, dvh,
            leaky, seed.data_ptr(), thresh, inv_keep, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), part.data_ptr(), stream())
        assert rc == 0, rc
        return dq, sk._spmm_cuda(dk, red), sk._spmm_cuda(dv, red)

    def old_cells(att):
        return (att.cell_src.data_ptr(), att.cell_urow.data_ptr(),
                att.cell_cnt.data_ptr(), att.pieces.data_ptr(),
                att.pieces.shape[0], att.split_rows.data_ptr(),
                att.split_ptr.data_ptr(), att.split_rows.shape[0])

    def dedup_dot_rows(tag, att, shape, leaky, rates):
        """K7-dot and K8-dot of both builds on the same inputs (K8 on the
        new K7's lse and delta), timed in turns; the revision's K8 with
        its two folds."""
        H, dsh, dvh = shape
        N = att.num_rows
        q, k, v, g_out = dot_inputs(N, shape, dev, gen)
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        for rate in rates:
            with torch.no_grad():
                out, lse = da._dot_fwd_cuda(q, k, v, att, leaky, dsh, dvh,
                                            rate, seed)
                delta = (g_out.reshape(N, H, dvh)
                         * out.reshape(N, H, dvh)).sum(-1)
            bwd = (q, k, v, g_out, lse, delta)
            res = {}

            def old_fwd():
                res["old"] = old_k7(att, q, k, v, shape, leaky, rate, seed)

            def new_fwd():
                res["new"] = da._dot_fwd_cuda(q, k, v, att, leaky, dsh, dvh,
                                              rate, seed)

            def old_bwd():
                res["old"] = old_k8(att, bwd, shape, leaky, rate, seed)

            def new_bwd():
                res["new"] = da._dot_bwd_cuda(*bwd, att, leaky, dsh, dvh,
                                              rate, seed)

            # the outputs that keep the revision's bits: out and lse (K7),
            # dq (K8); dk and dv are summed in another order
            for kind, name, fo, fn, n_same in (
                    ("k7", "K7-dot", old_fwd, new_fwd, 2),
                    ("k8", "K8-dot", old_bwd, new_bwd, 1)):
                if kind not in only:
                    continue
                fo()
                fn()
                with torch.no_grad():
                    pairs = list(zip(res["old"], res["new"]))
                    diff = [float((o - n_).abs().max()) for o, n_ in pairs]
                    same = all(torch.equal(o, n_)
                               for o, n_ in pairs[:n_same])
                extra = {"dk_dv_max_diff": max(diff[1:])} \
                    if kind == "k8" else {}
                turns(f"{name} {tag} {shape} leaky={leaky} rate={rate}", fo,
                      fn, 20, old_new_max_diff=max(diff),
                      same_bits_as_old=same, **extra)
            del out, lse, delta, bwd
            res.clear()

    slot_views = {}

    def slot_view(att):
        """What the revision's slot passes read and their folds: the slot
        count S, the cells by pair slot (slot_ptr, slot_dst, slot_cnt) and
        ``build_uniq_reduce``'s layout."""
        if id(att) not in slot_views:
            lay = att.layout
            dst, urow, slot = (t.cpu().numpy()
                               for t in da._edge_slots(lay))
            first = np.ones(len(dst), dtype=bool)
            first[1:] = (slot[1:] != slot[:-1]) | (dst[1:] != dst[:-1])
            starts = np.flatnonzero(first)
            S = lay.num_pairs * dk.W
            lists = tuple(
                torch.as_tensor(a.astype(np.int32), device=dev)
                for a in (np.searchsorted(slot[starts], np.arange(S + 1)),
                          dst[starts], np.diff(np.append(starts, len(dst)))))
            slot_views[id(att)] = (S, lists,
                                   da.build_uniq_reduce(lay, att.num_rows))
        return slot_views[id(att)]

    def k8add_rows(tag, att, rates):
        """The additive K7 and K8 of both builds at the GAT's shapes (K8 on
        the new K7's lse and delta; the revision's K8 with its slot pass
        and its two K1 folds over ``build_uniq_reduce``'s layout), timed in
        turns; whether K7's out and lse and K8's d a_dst keep the
        revision's bits; the new held against float64."""
        lay, N = att.layout, att.num_rows
        S, slot_lists, red = slot_view(att)
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        for H, dvh in GAT_SHAPES:
            ins = attention_inputs(N, H, dvh, dev, gen)
            for rate in rates:
                thresh, inv_keep = ak._drop_args(rate)
                with torch.no_grad():
                    new = run_dedup_attention(att, ins, rate, seed)
                    err = max(check_dedup_attention(
                        tag, att, ins, rate, seed, new).values())
                out, lse = new[:2]
                a_dst, a_src, v, g_out = ins
                delta = (g_out.reshape(N, H, dvh)
                         * out.reshape(N, H, dvh)).sum(-1)
                bwd = (a_dst, a_src, v, g_out, lse, delta)
                res = {}

                def old_fwd():
                    o = torch.empty(N, H * dvh, device=dev)
                    ls = torch.empty(N, H, device=dev)
                    part = torch.empty(att.num_partials, H * dvh + 2 * H,
                                       device=dev)
                    rc = ded.pgl_dedup_attn_fwd_f32(
                        0, a_dst.data_ptr(), a_src.data_ptr(), v.data_ptr(),
                        *old_cells(att), H, dvh, 0.2, seed.data_ptr(),
                        thresh, inv_keep, o.data_ptr(), ls.data_ptr(),
                        part.data_ptr(), stream())
                    assert rc == 0, rc
                    res["old"] = o, ls

                def new_fwd():
                    res["new"] = da._fwd_cuda(a_dst, a_src, v, att, 0.2,
                                              dvh, rate, seed)

                def old_bwd():
                    da_ = torch.empty(N, H, device=dev)
                    dsrc = torch.empty(S, H, device=dev)
                    dv = torch.empty(S, H * dvh, device=dev)
                    part = torch.empty(att.num_partials, H, device=dev)
                    rc = ded.pgl_dedup_attn_bwd_f32(
                        0, *(t.data_ptr() for t in bwd), *old_cells(att),
                        lay.uv.data_ptr(), lay.pairs.data_ptr(),
                        *(t.data_ptr() for t in slot_lists), S, H, dvh, 0.2,
                        seed.data_ptr(), thresh, inv_keep, da_.data_ptr(),
                        dsrc.data_ptr(), dv.data_ptr(), part.data_ptr(),
                        stream())
                    assert rc == 0, rc
                    res["old"] = (da_, sk._spmm_cuda(dsrc, red),
                                  sk._spmm_cuda(dv, red))

                def new_bwd():
                    res["new"] = da._bwd_cuda(*bwd, att, 0.2, dvh, rate,
                                              seed)

                for name, fo, fn, n_same in (("K7", old_fwd, new_fwd, 2),
                                             ("K8", old_bwd, new_bwd, 1)):
                    fo()
                    fn()
                    with torch.no_grad():
                        pairs = list(zip(res["old"], res["new"]))
                        diff = [float((o - n_).abs().max()) for o, n_ in
                                pairs]
                        same = all(torch.equal(o, n_)
                                   for o, n_ in pairs[:n_same])
                    extra = {"dsrc_dv_max_diff": max(diff[1:])} \
                        if name == "K8" else {}
                    if name == "K8":   # device ms by kernel, both builds
                        extra["old_split_ms"] = kernel_split_ms(fo)
                        extra["new_split_ms"] = kernel_split_ms(fn)
                    turns(f"{name} additive {tag} H={H} dvh={dvh} "
                          f"rate={rate}", fo, fn, 20, max_abs_err=err,
                          old_new_max_diff=max(diff),
                          same_bits_as_old=same, **extra)
                res.clear()

    def k10add_rows(tag, g, rates):
        """The additive K10-dq and K10-dkv of both builds at the GAT's
        shapes, both on this tree's K9's lse and delta, timed in turns
        (and split by kernel, device ms by torch.profiler); both held
        against float64."""
        csc, csr = g._attention_layouts()
        N = g.num_nodes
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        for H, dvh in GAT_SHAPES:
            a_dst, a_src, v, g_out = attention_inputs(N, H, dvh, dev, gen)
            for rate in rates:
                thresh, inv_keep = ak._drop_args(rate)
                with torch.no_grad():
                    out, lse = ak._fwd_cuda(a_dst, a_src, v, csc, 0.2, dvh,
                                            rate, seed)
                    delta = (g_out.reshape(N, H, dvh)
                             * out.reshape(N, H, dvh)).sum(-1)
                    bwd = (a_dst, a_src, v, g_out, lse, delta)
                    d64 = [t.double() for t in bwd]
                    want = {"dq": (ak.gat_dq_reference(
                        *d64, csc, 0.2, dvh, rate, seed),),
                        "dkv": ak.gat_dkv_reference(*d64, csr, 0.2, dvh,
                                                    rate, seed)}
                ptrs = [t.data_ptr() for t in bwd]
                res = {}

                def old_run(lay, key):
                    da_ = torch.empty(N, H, device=dev)
                    dv = torch.empty(N, H * dvh, device=dev)
                    width = H if key == "dq" else H + H * dvh
                    part = torch.empty(lay.num_partials, width, device=dev)
                    work_args = (lay.pieces.data_ptr(), lay.pieces.shape[0],
                                 lay.split_rows.data_ptr(),
                                 lay.split_ptr.data_ptr(),
                                 lay.split_rows.shape[0], H, dvh, 0.2,
                                 seed.data_ptr(), thresh, inv_keep)
                    if key == "dq":
                        rc = att.pgl_gat_dq_f32(
                            0, *ptrs, lay.indices.data_ptr(), *work_args,
                            da_.data_ptr(), part.data_ptr(), stream())
                        res["old"] = (da_,)
                    else:
                        rc = att.pgl_gat_dkv_f32(
                            0, *ptrs, lay.indices.data_ptr(),
                            lay.eidx.data_ptr(), *work_args, da_.data_ptr(),
                            dv.data_ptr(), part.data_ptr(), stream())
                        res["old"] = (da_, dv)
                    assert rc == 0, rc

                def new_dq():
                    res["new"] = (ak._dq_cuda(*bwd, csc, 0.2, dvh, rate,
                                              seed),)

                def new_dkv():
                    res["new"] = ak._dkv_cuda(*bwd, csr, 0.2, dvh, rate,
                                              seed)

                for name, key, lay, fn in (("K10-dq", "dq", csc, new_dq),
                                           ("K10-dkv", "dkv", csr,
                                            new_dkv)):
                    def fo(lay=lay, key=key):
                        old_run(lay, key)
                    fo()
                    fn()
                    torch.cuda.synchronize()
                    label = f"{name} additive {tag} H={H} dvh={dvh} rate={rate}"
                    with torch.no_grad():
                        errs = {b: max(check(f"{b} {label}", t, w)
                                       for t, w in zip(res[b], want[key]))
                                for b in ("old", "new")}
                        diff = max(float((o - n_).abs().max())
                                   for o, n_ in zip(res["old"], res["new"]))
                    turns(label, fo, fn, 50, max_abs_err=errs["new"],
                          old_max_abs_err=errs["old"],
                          old_new_max_diff=diff, H=H, dvh=dvh, rate=rate,
                          kernel=name, old_split_ms=kernel_split_ms(fo),
                          new_split_ms=kernel_split_ms(fn))
                res.clear()
        step = {b: sum(r[f"{b}_ms"] for r in rows
                       if r.get("kernel", "").startswith("K10-")
                       and r.get("rate") == 0.0) for b in ("old", "new")}
        rows.append(dict(name="K10 additive a GAT step, rate 0", **step))
        print(f"[before/after] K10 additive a GAT step (dq and dkv at both "
              f"shapes, rate 0): old {step['old']:.5f} ms, new "
              f"{step['new']:.5f} ms (new/old "
              f"{step['new'] / step['old']:.3f})", flush=True)

    def fwd_add_rows(kernel, tag, lay, rates, new_fwd, old_fwd, plain):
        """The additive forward (K9 over ``lay``'s CSC edges, or K7 over its
        cells) of both builds at the GAT's shapes, timed in turns and split
        by kernel; both held against float64 (``plain``) and each other."""
        N = lay.num_rows
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        for H, dvh in GAT_SHAPES:
            a_dst, a_src, v, _ = attention_inputs(N, H, dvh, dev, gen)
            ins = (a_dst, a_src, v)
            for rate in rates:
                res = {}

                def fo():
                    res["old"] = old_fwd(ins, lay, H, dvh, rate, seed)

                def fn():
                    res["new"] = new_fwd(*ins, lay, 0.2, dvh, rate, seed)

                fo()
                fn()
                torch.cuda.synchronize()
                label = (f"{kernel} additive {tag} H={H} dvh={dvh} "
                         f"rate={rate}")
                with torch.no_grad():
                    want = plain(*(t.double() for t in ins), lay, 0.2, dvh,
                                 rate, seed)
                    errs = {b: max(check(f"{b} {label}", t, w)
                                   for t, w in zip(res[b], want))
                            for b in ("old", "new")}
                    diff = max(float((o - n_).abs().max())
                               for o, n_ in zip(res["old"], res["new"]))
                    same = all(map(torch.equal, res["old"], res["new"]))
                turns(label, fo, fn, 50, max_abs_err=errs["new"],
                      old_max_abs_err=errs["old"], old_new_max_diff=diff,
                      same_bits_as_old=same, H=H, dvh=dvh, rate=rate,
                      kernel=kernel, old_split_ms=kernel_split_ms(fo),
                      new_split_ms=kernel_split_ms(fn))
                res.clear()
        step = {b: sum(r[f"{b}_ms"] for r in rows
                       if r.get("kernel") == kernel
                       and r.get("rate") == 0.0) for b in ("old", "new")}
        dev_ms = {b: sum(sum(r[f"{b}_split_ms"].values()) for r in rows
                         if r.get("kernel") == kernel
                         and r.get("rate") == 0.0) for b in ("old", "new")}
        rows.append(dict(name=f"{kernel} additive a GAT step, rate 0",
                         device_old=dev_ms["old"], device_new=dev_ms["new"],
                         **step))
        print(f"[before/after] {kernel} additive a GAT step (both shapes, "
              f"rate 0): old {step['old']:.5f} ms, new {step['new']:.5f} "
              f"ms (new/old {step['new'] / step['old']:.3f}); device old "
              f"{dev_ms['old']:.5f} ms, new {dev_ms['new']:.5f} ms "
              f"(new/old {dev_ms['new'] / dev_ms['old']:.3f})", flush=True)

    def old_fwd_out(H, dvh, n_part, N):
        return (torch.empty(N, H * dvh, device=dev),
                torch.empty(N, H, device=dev),
                torch.empty(n_part, H * dvh + 2 * H, device=dev))

    def old_k9add(ins, lay, H, dvh, rate, seed):
        """The revision's K9: one warp a piece of ``cut_rows``."""
        thresh, inv_keep = ak._drop_args(rate)
        out, lse, part = old_fwd_out(H, dvh, lay.num_partials, lay.num_rows)
        rc = att.pgl_gat_fwd_f32(
            0, *(t.data_ptr() for t in ins), lay.indices.data_ptr(),
            lay.pieces.data_ptr(), lay.pieces.shape[0],
            lay.split_rows.data_ptr(), lay.split_ptr.data_ptr(),
            lay.split_rows.shape[0], H, dvh, 0.2, seed.data_ptr(), thresh,
            inv_keep, out.data_ptr(), lse.data_ptr(), part.data_ptr(),
            stream())
        assert rc == 0, rc
        return out, lse

    def old_k7add(ins, cells, H, dvh, rate, seed):
        """The revision's K7: one warp a piece of the row-ordered cells."""
        thresh, inv_keep = ak._drop_args(rate)
        out, lse, part = old_fwd_out(H, dvh, cells.num_partials,
                                     cells.num_rows)
        rc = ded.pgl_dedup_attn_fwd_f32(
            0, *(t.data_ptr() for t in ins), *old_cells(cells), H, dvh,
            0.2, seed.data_ptr(), thresh, inv_keep, out.data_ptr(),
            lse.data_ptr(), part.data_ptr(), stream())
        assert rc == 0, rc
        return out, lse

    def k7_plain(a_dst, a_src, v, cells, *args):
        return da.dedup_attention_reference(a_dst, a_src, v, cells.layout,
                                            *args)

    def parent_digests():
        """Both builds' digests of out | lse | dq on the pinned cases."""
        att = parent_bits_graph(dev)
        for shape, leaky, rate in PARENT_BITS_CASES:
            ins, seed = parent_bits_case(att, shape, rate, dev)
            q, k, v, g_out = ins
            H, dsh, dvh = shape
            with torch.no_grad():
                out, lse = old_k7(att, q, k, v, shape, leaky, rate, seed)
                delta = (g_out.reshape(-1, H, dvh)
                         * out.reshape(-1, H, dvh)).sum(-1)
                dq = old_k8(att, (q, k, v, g_out, lse, delta), shape, leaky,
                            rate, seed)[0]
                new = run_dedup_dot(att, ins, shape, rate, seed, leaky)
            old_d, new_d = bits_digest(out, lse, dq), bits_digest(*new[:3])
            rows.append(dict(name=f"digest {shape} {leaky} {rate}",
                             old=old_d, new=new_d, same=old_d == new_d))
            print(f"[digest] {(shape, leaky, rate)!r}: {old_d!r} old, "
                  f"{new_d!r} new, same {old_d == new_d}", flush=True)

    only = set(a.only)
    if only & {"k1", "k1w"}:
        g = headline_host().tensor(dev)
        csc, csr = g._spmm_layouts
        if "k1" in only:
            for kind, lay in (("headline csc", csc), ("headline csr", csr)):
                k1_rows(kind, lay, g.num_nodes, (128, 16, 64))
        if "k1w" in only:
            k1w_rows("FAGCN headline", g, "mul", 1, 64)
        if "k1" in only:
            sdd = g.sddmm_layout()
            S = max(sdd.by_src.max_index, sdd.by_dst.max_index) + 1
            for lay in (sdd.by_src, sdd.by_dst):
                k1_rows(lay.kind, lay, S, (128,))
            del sdd
        del g, csc, csr
        torch.cuda.empty_cache()

    with dispatch_settings(DEDUP=False):
        g = gat_host().tensor(dev)
    csc, csr = g._spmm_layouts
    if "k1" in only:
        for kind, lay in (("bench GAT csc", csc), ("bench GAT csr", csr)):
            k1_rows(kind, lay, g.num_nodes, (64, 16))
    if "k1w" in only:
        k1w_rows("GATv2 layer 0", g, "mul", 8, 64)
        k1w_rows("GATv2 layer 1", g, "mul", 1, 16)
    if "k1" in only:
        att = dedup_attention_of(g, dev)
        red = da.build_uniq_reduce(att.layout, att.num_rows)
        k1_rows("red", red, red.max_index + 1, (1, 8, 16, 64, 256))
        del red, att
    if "k10" in only:
        dkv_rows("bench GAT graph", g, (0.0, 0.3))
        dkv_rows("bench GAT graph", g, (0.0, 0.3), (43, 2, 8), 0.2)
    if only & {"k9", "k10dq"}:
        fwd_dq_rows("bench GAT graph", g, UNIMP_SHAPE, 0.0, (0.0, 0.3))
        fwd_dq_rows("bench GAT graph", g, (43, 2, 8), 0.2, (0.0, 0.3))
    if only & {"k7", "k8"}:
        if "k7" in only:
            parent_digests()
        dedup_dot_rows("bench GAT graph", dedup_attention_of(g, dev, False),
                       UNIMP_SHAPE, 0.0, (0.0, 0.3))
    if "k8add" in only:
        k8add_rows("bench GAT graph", dedup_attention_of(g, dev, False),
                   (0.0, 0.6))
    if "k10add" in only:
        k10add_rows("bench GAT graph", g, (0.0, 0.6))
    if "k9add" in only:
        fwd_add_rows("K9", "bench GAT graph", g._attention_layouts()[0],
                     (0.0, 0.6), ak._fwd_cuda, old_k9add,
                     ak.gat_attention_reference)
    if "k7add" in only:
        fwd_add_rows("K7", "bench GAT graph",
                     dedup_attention_of(g, dev, False), (0.0, 0.6),
                     da._fwd_cuda, old_k7add, k7_plain)
    del g, csc, csr
    torch.cuda.empty_cache()

    if only & {"k10", "k9", "k10dq"}:
        g = unimp_host()[0].tensor(dev)
        if "k10" in only:
            dkv_rows("UniMP stand-in", g, (0.0, 0.3))
        if only & {"k9", "k10dq"}:
            fwd_dq_rows("UniMP stand-in", g, UNIMP_SHAPE, 0.0, (0.0, 0.3))
    print(json.dumps({"before_after": rows, "rev": a.rev, "device": smi}))
    return 0


def bf16_arm(a):
    """The bf16 dot K10-dq, K10-dkv and K8 of the revision ``a.rev``, the
    tree and the tree at each ring depth of ``a.depths``: bits, SASS of the
    staged kernels, times in turns, and the amp UniMP step (the module's
    docstring)."""
    import torch
    from chip_smoke import (UNIMP_SHAPE, attention_graph, bf16_inputs,
                            check_bf16, check_dedup_dot, check_dot,
                            dedup_attention_of, dispatch_settings,
                            dot_inputs, gat_host, k7_case_atts, run_dot,
                            run_dedup_dot, same_bits, time_ms, unimp_host,
                            unimp_trainer)
    from pgl_tpu_torch import Graph
    from pgl_tpu_torch.ops.kernels import _build
    from pgl_tpu_torch.ops.kernels import attention_kernels as ak
    from pgl_tpu_torch.ops.kernels import dedup_attention as da

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    bf = torch.bfloat16
    only = set(a.only)
    d = old_dir(a.rev)
    if not (d / "attention_kernels.cu").exists():
        raise SystemExit(f"{d} has no sources: run with --extract first")
    # build -> ({library: CDLL}, {library: .so}, {library: ptxas log})
    builds = {"old": build_bf16(d, d / "build_bf16")}
    tree = _build.build("segment_kernels", "attention_kernels",
                        "dedup_attention", *(n for n, _ in LIBS_BF16))
    builds["tree"] = ({n: _build.load(n) for n, _ in LIBS_BF16},
                      {n: tree[n] for n, _ in LIBS_BF16},
                      {n: tree[n].with_suffix(".log").read_text()
                       for n, _ in LIBS_BF16})
    for depth in a.depths:
        src = ring_steps_copy(depth)
        builds[f"S={depth}"] = build_bf16(src, src / "build")
    depth_of = {}
    for b, (libs, _, logs) in builds.items():
        fn = getattr(libs["attention_kernels_bf16"],
                     "pgl_dot_ring_steps_bf16", None)
        depth_of[b] = fn() if fn is not None else 3  # before: kStageSteps
        for name, log in logs.items():
            for args, regs, spill in registers(
                    log, r"dot_(fwd|dq|dkv)_staged"):
                print(f"[ptxas] {b} (S={depth_of[b]}) {name} {args}: "
                      f"{regs} registers, {spill} B spilled", flush=True)
    rows = []

    class Entries:
        """The bf16 wrappers of ``ak`` and ``da`` on build ``b``'s
        libraries (the tree's argtypes); float32 calls stay the tree's."""
        def __init__(self, b):
            self.libs = builds[b][0]

        def __enter__(self):
            self.saved = {ak: ak._entry, da: da._entry}
            for mod, lib_name in ((ak, "attention_kernels_bf16"),
                                  (da, "dedup_attention_bf16")):
                lib, tree_entry = self.libs[lib_name], self.saved[mod]

                def entry(name, t, lib=lib, tree_entry=tree_entry):
                    if t.dtype != bf:
                        return tree_entry(name, t)
                    fn = getattr(lib, f"{name}_bf16")
                    if fn.argtypes is None:
                        ref = tree_entry(name, t)
                        fn.argtypes, fn.restype = ref.argtypes, ref.restype
                    return fn
                mod._entry = entry
            return self

        def __exit__(self, *exc):
            for mod, e in self.saved.items():
                mod._entry = e

    def on(b, fn):
        def run():
            with Entries(b):
                return fn()
        return run

    def same_all(xs, ys):
        return all(map(same_bits, xs, ys))

    # SASS of the staged kernels in both builds, float32 and bf16: the
    # forward (K9, K7) must run the code it ran before
    build_old(a.rev)
    so = {"old": {**builds["old"][1], **{
              n: d / "build" / f"lib{n}.so"
              for n in ("attention_kernels", "dedup_attention")}},
          "tree": {**builds["tree"][1], "attention_kernels":
                   tree["attention_kernels"],
                   "dedup_attention": tree["dedup_attention"]}}
    sass = {b: {n: sass_functions(p) for n, p in so[b].items()}
            for b in so}
    for name in so["old"]:
        o, n = sass["old"][name], sass["tree"][name]
        if o is None or n is None:
            print("[sass] not measured: no cuobjdump", flush=True)
            break
        for kernel in ("dot_fwd_staged", "dot_dq_staged", "dot_dkv_staged"):
            fns = sorted(k for k in o if k[0] == kernel)
            same = {k: k in n and o[k] == n[k] for k in fns}
            rows.append(dict(name=f"sass {name} {kernel}",
                             same=sum(same.values()), kernels=len(fns)))
            print(f"[sass] {name} {kernel}: the same SASS in both builds "
                  f"in {sum(same.values())} of {len(fns)} instantiations",
                  flush=True)

    gen = torch.Generator(device=dev).manual_seed(27)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)

    def bits_rows(tag, lays, shape, leaky, rates, n):
        """Every build's bf16 K9, K10-dq and K10-dkv against the
        revision's bit for bit, the tree's against float64 and twice."""
        ins = bf16_inputs(dot_inputs(n, shape, dev, gen))
        for rate in rates:
            got = {b: on(b, lambda: run_dot(lays, ins, shape, leaky, rate,
                                            seed))() for b in builds}
            again = on("tree", lambda: run_dot(lays, ins, shape, leaky,
                                               rate, seed))()
            err = check_dot(f"bf16 {tag}", lays, ins, shape, leaky, rate,
                            seed, got["tree"], rule=check_bf16)
            same = {b: {"fwd": same_all(got[b][:2], got["old"][:2]),
                        "dq": same_bits(got[b][2], got["old"][2]),
                        "dkv": same_all(got[b][3:], got["old"][3:])}
                    for b in builds if b != "old"}
            twice = same_all(got["tree"], again)
            rows.append(dict(name=f"bits {tag} {shape} rate={rate}",
                             same_as_old=same, twice=twice,
                             max_abs_err=err))
            print(f"[bits] {tag} {shape} leaky={leaky} rate={rate}: same "
                  f"as the revision {same}; the tree's twice {twice}; max "
                  f"|err| vs float64 {err}", flush=True)

    def k8_bits(tag, att, shape, rates):
        ins = bf16_inputs(dot_inputs(att.num_rows, shape, dev, gen))
        for rate in rates:
            got = {b: on(b, lambda: run_dedup_dot(att, ins, shape, rate,
                                                  seed))() for b in builds}
            again = on("tree", lambda: run_dedup_dot(att, ins, shape, rate,
                                                     seed))()
            err = check_dedup_dot(f"bf16 {tag}", att, ins, shape, rate,
                                  seed, got["tree"], rule=check_bf16)
            same = {b: {"fwd": same_all(got[b][:2], got["old"][:2]),
                        "bwd": same_all(got[b][2:], got["old"][2:])}
                    for b in builds if b != "old"}
            twice = same_all(got["tree"], again)
            rows.append(dict(name=f"K8 bits {tag} {shape} rate={rate}",
                             same_as_old=same, twice=twice,
                             max_abs_err=err))
            print(f"[K8 bits] {tag} {shape} rate={rate}: same as the "
                  f"revision {same}; the tree's twice {twice}; max |err| "
                  f"vs float64 {err}", flush=True)

    def turns(name, fns, iters, **extra):
        """``fns`` {label: call} timed in order and then in reverse (CUDA
        events), each label's two runs averaged."""
        order = list(fns) + list(fns)[::-1]
        t = {b: [] for b in fns}
        for b in order:
            t[b].append(time_ms(fns[b], iters))
        ms = {b: sum(v) / len(v) for b, v in t.items()}
        rows.append(dict(name=name, ms=ms, runs=t, **extra))
        print(f"[before/after] {name}: " + ", ".join(
            f"{b} {v:.5f} ms" for b, v in ms.items())
            + f" (tree/old {ms['tree'] / ms['old']:.3f})", flush=True)

    test_shapes = ((2, 128, 128, 0.0), (8, 16, 16, 0.0), (43, 2, 8, 0.2),
                   (3, 5, 7, 0.0))
    if only & {"k10", "k10dq"}:
        g = Graph(attention_graph(3000, 40000, seed=4), num_nodes=3000
                  ).tensor(dev)
        for *shape, leaky in test_shapes:
            bits_rows("test graph", g._attention_layouts(), tuple(shape),
                      leaky, (0.0, 0.3), 3000)
        del g
        host_u, labels = unimp_host()
        g = host_u.tensor(dev)
        lays = g._attention_layouts()
        csc, csr = lays
        bits_rows("UniMP stand-in", lays, UNIMP_SHAPE, 0.0, (0.0, 0.3),
                  g.num_nodes)
        H, dsh, dvh = UNIMP_SHAPE
        ins = bf16_inputs(dot_inputs(g.num_nodes, UNIMP_SHAPE, dev, gen))
        f32 = tuple(t.float() for t in ins)
        for rate in (0.0, 0.3):
            bwd = {}
            for dt, tabs in (("bf16", ins), ("f32", f32)):
                with torch.no_grad():
                    out, lse = ak._dot_fwd_cuda(*tabs[:3], csc, 0.0, dsh,
                                                dvh, rate, seed)
                bwd[dt] = (*tabs, lse, ak._delta(tabs[3], out, H, dvh))
            args = (0.0, dsh, dvh, rate, seed)
            for kind, kernel, lay in (("k10dq", ak._dot_dq_cuda, csc),
                                      ("k10", ak._dot_dkv_cuda, csr)):
                if kind not in only:
                    continue
                fns = {b: on(b, lambda k=kernel, lay=lay: k(
                    *bwd["bf16"], lay, *args)) for b in builds}
                fns["f32"] = lambda k=kernel, lay=lay: k(*bwd["f32"], lay,
                                                         *args)
                name = {"k10dq": "K10-dq", "k10": "K10-dkv"}[kind]
                turns(f"bf16 {name} UniMP stand-in {UNIMP_SHAPE} "
                      f"rate={rate}", fns, 20, depth=depth_of)
        # the amp UniMP step, phase 18's trainer, on each build
        _, step = unimp_trainer(g, labels, bf16=True)

        def steps(b, n=10):
            with Entries(b):
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    step()
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        t = [steps(b) for b in ("old", "tree", "tree", "old")]
        step_ms = {"old": (t[0] + t[3]) / 2, "tree": (t[1] + t[2]) / 2}
        rows.append(dict(name="amp UniMP step", ms=step_ms, runs=t))
        print(f"[amp UniMP step] old {step_ms['old']:.4f} ms, tree "
              f"{step_ms['tree']:.4f} ms (tree/old "
              f"{step_ms['tree'] / step_ms['old']:.3f}; runs "
              f"{', '.join(f'{v:.4f}' for v in t)})", flush=True)
        del g, lays, csc, csr, ins, f32, bwd, step
        torch.cuda.empty_cache()
    if "k8" in only:
        att = k7_case_atts(dev)["multi"]
        for *shape, _ in test_shapes:
            k8_bits("multigraph", att, tuple(shape), (0.0, 0.3))
        with dispatch_settings(DEDUP=False):
            g = gat_host().tensor(dev)
        att = dedup_attention_of(g, dev, False)
        k8_bits("bench GAT graph", att, UNIMP_SHAPE, (0.0, 0.3))
        H, dsh, dvh = UNIMP_SHAPE
        ins = bf16_inputs(dot_inputs(att.num_rows, UNIMP_SHAPE, dev, gen))
        for rate in (0.0, 0.3):
            with torch.no_grad():
                out, lse = da._dot_fwd_cuda(*ins[:3], att, 0.0, dsh, dvh,
                                            rate, seed)
            bwd = (*ins, lse, ak._delta(ins[3], out, H, dvh))
            fns = {b: on(b, lambda: da._dot_bwd_cuda(
                *bwd, att, 0.0, dsh, dvh, rate, seed))
                for b in ("old", "tree")}
            turns(f"bf16 K8-dot bench GAT graph {UNIMP_SHAPE} rate={rate}",
                  fns, 20)
    print(json.dumps({"before_after_bf16": rows, "rev": a.rev,
                      "depths": depth_of, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
