"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled into
``build/lib<name>-<hash>.so`` on first use, where the hash covers the
source, the headers of ``csrc/`` and the flags, so an edited source or
header is rebuilt. A library of ``VARIANTS`` is another source compiled
with extra flags: ``<name>_bf16`` holds the bf16 entry points of
``<name>.cu`` (``-DPGL_BF16``), so each half of a source's instantiations
is its own ``nvcc``, the two built in parallel. The library is
loaded with ctypes; no PyTorch headers are compiled. A failed build raises
with the compiler's output. ``nvcc``'s own report (``-Xptxas -v``:
registers, shared memory, spills per kernel) is kept beside the library as
``lib<name>-<hash>.log``.

Nothing here runs at import: the CPU tests import every module, and this
host need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library -> (source, extra flags)
VARIANTS = {"segment_kernels_bf16": ("segment_kernels", ("-DPGL_BF16",)),
            "attention_kernels_bf16": ("attention_kernels", ("-DPGL_BF16",)),
            "dedup_kernels_bf16": ("dedup_kernels", ("-DPGL_BF16",)),
            "dedup_attention_bf16": ("dedup_attention", ("-DPGL_BF16",))}

_LOADED: dict = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on first use")
    return found


def _source(name: str):
    """(the source of library ``name``, its nvcc flags)."""
    src, extra = VARIANTS.get(name, (name, ()))
    return CSRC / f"{src}.cu", (*NVCC_FLAGS, *extra)


def _target(name: str) -> Path:
    # the headers are shared, so each of them is part of every source
    source, flags = _source(name)
    parts = [source, *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> dict:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together. Returns ``{name: path}``."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
            source, flags = _source(n)
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *flags, "-o", str(tmp), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            t = todo[n]
            t.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, t)  # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _LOADED[name] = lib
    return lib
