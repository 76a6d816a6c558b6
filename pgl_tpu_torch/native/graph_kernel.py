"""ctypes bindings for the C++ host graph kernels (``graph_kernel.cc``).

Port of ``pgl_tpu/native/graph_kernel.py:1-145`` for what ``Graph`` calls:
:func:`build_index` and :func:`sample_subset_with_eid`. The library is
compiled with ``g++`` at first use (never at import) into
``build/libgraph_kernel-<hash>.so``, where the hash covers the source and
the flags; a temporary name renamed atomically lets several processes build
at once. A failed build raises with the compiler's output. The reference
falls back to numpy when its build fails; the port does not, so a sample
never depends on whether the compiler ran. :func:`build_index_reference` is
the plain numpy version the tests hold the native build against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["build_index", "build_index_reference", "sample_subset_with_eid",
           "build", "CXX", "CXX_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "graph_kernel.cc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()

_i64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_ll = ctypes.c_longlong


def build() -> Path:
    """Compile ``graph_kernel.cc`` unless its library exists; returns the
    library's path. Raises with the compiler's output when it fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    target = BUILD_DIR / f"libgraph_kernel-{digest[:16]}.so"
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"host kernel build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host kernel build failed ({CXX} exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)   # atomic: concurrent builds agree
    return target


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.build_index.argtypes = [_i64, _i64, _ll, _ll, _i64, _i64,
                                        _i64, _i64]
            lib.build_index.restype = None
            lib.sample_subset_with_eid.argtypes = [
                _i64, _i64, _i64, _i64, _ll, _ll, _ll, _i64, _i64, _i64]
            lib.sample_subset_with_eid.restype = None
            _lib = lib
        return _lib


def _c(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _check_ids(name, ids, n):
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"{name} ids in [{ids.min()}, {ids.max()}] out of "
                         f"range for {n} nodes")


def build_index(u, v, num_nodes):
    """O(E + N) CSR build by a counting sort on ``u``. Returns (degree,
    sorted_v, sorted_eid, indptr), all int64."""
    u, v = _c(u), _c(v)
    E, N = len(u), int(num_nodes)
    if len(v) != E:
        raise ValueError(f"{E} sources and {len(v)} destinations")
    _check_ids("edge source", u, N)
    lib = _load()
    degree = np.empty(N, dtype=np.int64)
    sorted_v = np.empty(E, dtype=np.int64)
    sorted_eid = np.empty(E, dtype=np.int64)
    indptr = np.empty(N + 1, dtype=np.int64)
    lib.build_index(u, v, E, N, degree, sorted_v, sorted_eid, indptr)
    return degree, sorted_v, sorted_eid, indptr


def build_index_reference(u, v, num_nodes):
    """The plain numpy version of :func:`build_index` (a stable argsort):
    the same four arrays."""
    u, v = _c(u), _c(v)
    N = int(num_nodes)
    degree = np.bincount(u, minlength=N).astype(np.int64)
    indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(degree, out=indptr[1:])
    order = np.argsort(u, kind="stable")
    return degree, v[order], order.astype(np.int64), indptr


def sample_subset_with_eid(indptr, sorted_v, sorted_eid, query, max_degree,
                           seed=0):
    """Uniform ≤ ``max_degree`` neighbour sample of each query node, without
    replacement. Returns (out_indptr [Q+1], out_v, out_eid), packed ragged
    arrays."""
    indptr, sorted_v, sorted_eid, query = map(_c, (indptr, sorted_v,
                                                   sorted_eid, query))
    if int(max_degree) < 0:
        raise ValueError(f"max_degree must be >= 0, got {max_degree}")
    if len(sorted_v) != len(sorted_eid) or indptr[-1] != len(sorted_v):
        raise ValueError("indptr, sorted_v and sorted_eid do not describe "
                         "one index")
    _check_ids("query", query, len(indptr) - 1)
    lib = _load()
    Q = len(query)
    cap = Q * int(max_degree)
    out_indptr = np.empty(Q + 1, dtype=np.int64)
    out_v = np.empty(cap, dtype=np.int64)
    out_eid = np.empty(cap, dtype=np.int64)
    lib.sample_subset_with_eid(indptr, sorted_v, sorted_eid, query, Q,
                               int(max_degree), int(seed), out_indptr, out_v,
                               out_eid)
    n = out_indptr[-1]
    return out_indptr, out_v[:n], out_eid[:n]
