"""Per-edge graph attention: the kernels behind ``GATConv`` and
``TransformerConv``.

Port of ``pgl_tpu/ops/pallas/attention_kernels.py`` (``_attn_kernel``
forward, K9; ``_attn_bwd_dq_kernel`` and ``_attn_bwd_dkv_kernel`` backward,
K10) in both of its score modes onto hand-written CUDA kernels for Hopper,
``csrc/attention_kernels.cu``, whose note gives the design: additive
(``fused_gat_attention``, GAT's ``a_dst + a_src``) and dot
(``fused_graph_attention``, per-head ``q·k``).

* :func:`build_attention_layouts` builds, once on the host (numpy), the
  two sides the kernels walk: CSC (rows are destinations, edges in the
  reference's CSC order, so an edge's position is the dropout hash's
  counter) and CSR (rows are sources), which carries for every edge its CSC
  position, the reference's ``perm`` (``pgl_tpu/graph.py:569-574``). Each
  side has two work lists: the dot kernels', every row cut into pieces of
  at most ``ET`` edges by ``segment_kernels.cut_rows``; and the additive
  K9's and K10's (:func:`k10_work_list`): the pieces of the rows longer
  than ``PACK_ROW`` edges, then the other nonempty rows by length, and the
  empty rows apart, which the kernels only zero. The count-matrix K7
  (``dedup_attention.py``) walks the same kind of list over its cells.
* :func:`k10_lanes` chooses how the additive K9 and K10 lay a row's
  columns over a lane group (16-byte vectors of one head: 4 floats or 8
  bf16), and so how many edges a warp takes at once.
* :func:`fused_gat_attention` and :func:`fused_graph_attention` are
  autograd ``Function``s with the reference's contracts (``:855-938`` and
  ``:756-777``): the forward (K9) saves ``lse``; the backward computes
  ``delta = Σ g·out`` per (row, head) in torch, then runs K10-dq over the
  CSC layout (``d a_dst`` or ``dq``) and K10-dkv over the CSR layout
  (``d a_src`` or ``dk``, and ``dv``). The dropout seed is saved, so all
  three passes draw the same mask. The kernels take float32 or bf16
  tables (``pgl_*_bf16``: loaded as bf16, computed in float32, each
  stored value rounded once to bf16); ``lse`` and ``delta`` are float32
  either way.
* The plain PyTorch versions, in edge space with ``index_add_``, over
  :func:`plain_attention` and :func:`edge_grads` (which the count-matrix
  attention's plain versions share): :func:`gat_attention_reference`,
  :func:`gat_dq_reference` and :func:`gat_dkv_reference` (additive),
  :func:`dot_attention_reference`, :func:`dot_dq_reference` and
  :func:`dot_dkv_reference` (dot). CPU tensors run them; CUDA tensors
  launch the kernels or raise. On bf16 (or fp16) tables they compute in
  float32 and round each output once, ``lse`` staying float32: the
  kernels' contract.
* A forward that ``torch.export`` or ``torch.compile`` traces
  (``dispatch.traced``) is a custom op, ``torch.ops.pgl_tpu_torch.
  gat_attention`` or ``::dot_attention`` (the CSC layout's tensors and
  integers as its arguments; its CUDA implementation the launch of K9 and
  its merge, its CPU one the plain version, its fake one the shapes of
  ``(out, lse)``), so an exported program calls K9 (``utils/export.py``);
  an eager call launches directly, as K1's does.
* :func:`gat_score_features` writes GAT's additive score as a dot
  (``:941-954``), for ``GATConv``'s many-head fallback.
* :func:`drop_keep` and :func:`apply_hash_dropout` are the reference's
  counter-hash dropout (``_drop_keep`` and ``_apply_hash_dropout``) in torch
  integer arithmetic, bit for bit.

``LAUNCHES_BY_SHAPE`` counts launches by ``(kernel, H, dvh)`` in additive
mode, kernel one of ``gat_fwd``, ``gat_dq``, ``gat_dkv``, and by
``(kernel, H, dsh, dvh)`` in dot mode, kernel one of ``dot_fwd``,
``dot_dq``, ``dot_dkv``; where a layout has split rows, each kernel's
second launch counts under its name with ``_combine``.
``LAUNCHES_BY_LAYOUT`` counts them again by ``(key, id(layout))``, so that
the launches on each of several graphs of one shape (the relations of a
heterogeneous graph) are read apart. ``LAUNCHES_BF16`` counts the bf16
launches apart, by the same keys; the other two count float32 launches
only.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ... import resolve_device
from ..dispatch import traced, use_attention_kernel
from ..segment import segment_max, segment_softmax, segment_sum
from . import _build
from .segment_kernels import _HALF, cut_rows

__all__ = ["AttentionLayout", "build_attention_layouts", "drop_keep",
           "apply_hash_dropout", "plain_attention", "edge_grads",
           "gat_attention_reference", "gat_dq_reference",
           "gat_dkv_reference", "fused_gat_attention", "head_scatter",
           "dot_attention_reference", "dot_dq_reference",
           "dot_dkv_reference", "fused_graph_attention",
           "gat_score_features", "k10_work_list", "k10_lanes", "ET",
           "PACK_ROW", "MAX_SLOTS", "LAUNCHES_BY_SHAPE", "LAUNCHES_BY_LAYOUT",
           "LAUNCHES_BF16", "reset_launches"]

# most edges in one piece (one warp's work); read when a layout is built
ET = 256
# the longest row that one lane group of the additive K10 walks alone
# (several such rows a warp, one a group); longer rows are pieces of ET
# edges whose edges the warp's groups share. At most ET; read when a layout
# is built
PACK_ROW = 32

# the kernels hold H heads of dvh_p slots (additive) or of max(dsh_p,
# dvh_p) slots (dot; widths rounded up to powers of two) in at most 16
# registers a lane
MAX_SLOTS = 512

LAUNCHES_BY_SHAPE: Counter = Counter()
LAUNCHES_BY_LAYOUT: Counter = Counter()
LAUNCHES_BF16: Counter = Counter()

_MASK32 = 0xFFFFFFFF
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches():
    """Set the launch counts to 0."""
    LAUNCHES_BY_SHAPE.clear()
    LAUNCHES_BY_LAYOUT.clear()
    LAUNCHES_BF16.clear()


@dataclass(frozen=True)
class AttentionLayout:
    """One side of the graph as the attention kernels read it (int32, one
    device).

    indices:     [E] the other end of each edge (the source for CSC, the
                 destination for CSR), in the reference's edge order
    seg_ids:     [E] row of each edge (the plain versions' scatter ids)
    eidx:        [E] CSR only: each edge's CSC position (the dropout
                 hash's counter); None for CSC, where it is the position
    pieces, split_rows, split_ptr: the work list of ``cut_rows`` (the dot
                 kernels), whose split rows the additive K9 and K10 share
    k10_items:   [P, 4] the additive K9's and K10's work list
                 (:func:`k10_work_list`): ``k10_long`` pieces (row, begin,
                 end, slot), then whole rows (row, begin, end, -1)
    empty_rows:  [Z] the rows without edges, which K9 and K10 zero
    """
    kind: str
    num_rows: int
    num_edges: int
    max_index: int        # largest gather id (-1 without edges)
    num_partials: int
    k10_long: int         # pieces at the head of ``k10_items``
    indices: torch.Tensor
    seg_ids: torch.Tensor
    eidx: Optional[torch.Tensor]
    pieces: torch.Tensor
    split_rows: torch.Tensor
    split_ptr: torch.Tensor
    k10_items: torch.Tensor
    empty_rows: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def positions(self) -> torch.Tensor:
        """The CSC position of every edge, in this layout's order."""
        if self.eidx is not None:
            return self.eidx
        return torch.arange(self.num_edges, dtype=torch.int32,
                            device=self.device)


def build_attention_layouts(dst_index, src_index, num_nodes: int,
                            device=None):
    """``(csc, csr)`` from a graph's host ``EdgeIndex``es: ``dst_index``
    groups the edges by destination (CSC), ``src_index`` by source."""
    E, N = len(dst_index.sorted_v), int(num_nodes)
    if E >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f"int32 layout: {E} edges / {N} nodes would wrap "
                         "— shard the graph first")
    inv_csc = np.empty(E, dtype=np.int64)
    inv_csc[np.asarray(dst_index.sorted_eid)] = np.arange(E)
    perm = inv_csc[np.asarray(src_index.sorted_eid)]
    device = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    def one(kind, idx, eidx):
        indptr = np.asarray(idx.indptr, dtype=np.int64)
        indices = np.asarray(idx.sorted_v, dtype=np.int64)
        pieces, split_rows, split_ptr = cut_rows(indptr, ET)
        items, n_long, empty = k10_work_list(indptr, pieces)
        return AttentionLayout(
            kind=kind, num_rows=N, num_edges=E,
            max_index=int(indices.max()) if E else -1,
            num_partials=int(split_ptr[-1]), k10_long=n_long,
            indices=put(indices),
            seg_ids=put(np.repeat(np.arange(N), np.diff(indptr))),
            eidx=None if eidx is None else put(eidx), pieces=put(pieces),
            split_rows=put(split_rows), split_ptr=put(split_ptr),
            k10_items=put(items), empty_rows=put(empty))

    return one("csc", dst_index, None), one("csr", src_index, perm)


def k10_work_list(indptr, pieces):
    """The additive K9's and K10's work list (and K7's, over the rows'
    cells) over the rows of ``indptr``, from
    ``pieces`` (``cut_rows(indptr, ET)``): ``(items [P, 4], n_long,
    empty_rows)``.

    ``items`` holds first the ``n_long`` pieces (row, begin, end, slot) of
    the rows of more than ``PACK_ROW`` edges, in piece order, each a warp's
    (its lane groups take even shares of its edges), then every other
    nonempty row as (row, begin, end, -1), by edge count descending and
    then by row, a lane group's each (so the rows a warp takes together
    are about as long). ``empty_rows`` lists the rows without edges. The
    split rows and partial slots are ``cut_rows``': a row of at most
    ``PACK_ROW <= ET`` edges is never split.
    """
    if not 0 < PACK_ROW <= ET:
        raise ValueError(f"PACK_ROW = {PACK_ROW} must be in [1, ET = {ET}]")
    indptr = np.asarray(indptr, dtype=np.int64)
    pieces = np.asarray(pieces, dtype=np.int64).reshape(-1, 4)
    deg = np.diff(indptr)
    long_ = pieces[deg[pieces[:, 0]] > PACK_ROW]
    short = np.flatnonzero((deg > 0) & (deg <= PACK_ROW))
    short = short[np.argsort(-deg[short], kind="stable")]
    rows = np.stack([short, indptr[short], indptr[short + 1],
                     np.full(len(short), -1)], axis=1)
    return (np.concatenate([long_, rows]).reshape(-1, 4), len(long_),
            np.flatnonzero(deg == 0))


def k10_lanes(H: int, dvh: int, dtype=torch.float32):
    """How the additive K9 and K10 (and K7) hold H heads of ``dvh`` columns
    of ``dtype``: ``(vec, lh, group, nv)``. A lane holds vectors of ``vec``
    consecutive columns of one head, a 16-byte vector where ``dvh`` rounds
    up to one (4 float32 where it rounds up to 4 or more, 8 bf16 where to
    8 or more), else 1 (columns past ``dvh`` are masked); head h owns the
    ``lh = dvh_p / vec`` vector slots
    ``h * lh ...`` (``dvh_p``: ``dvh`` rounded up to a power of two), slot
    ``s`` lying in lane ``s % 32`` of the group as its vector ``s // 32``;
    a lane group is ``group`` lanes (the power of two that holds the H *
    lh slots, at most 32), so a warp takes ``32 / group`` edges at once,
    and a lane holds ``nv`` vectors (more than one only where ``group`` is
    32)."""
    dvh_p = _dvh_p(dvh)
    width = 16 // torch.empty((), dtype=dtype).element_size()
    vec = width if dvh_p >= width else 1
    lh = dvh_p // vec
    slots = H * lh
    group = min(32, _dvh_p(slots))
    nv = _dvh_p(-(-slots // 32))
    return vec, lh, group, nv


# -- dropout ---------------------------------------------------------------

def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), without int64
    overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _thresh(rate: float) -> int:
    return int((1.0 - rate) * (1 << 31))


def drop_keep(idx, seed, h: int, rate: float) -> torch.Tensor:
    """Keep mask of the reference's ``_drop_keep``: a counter hash of the
    edge's CSC position ``idx``, the int32 ``seed`` (an int or a tensor)
    and the head ``h``. The reference's int32 wrap-around and logical
    shifts are taken in int64 masked to 32 bits."""
    hc = (h * 0x632BE5AB) & _MASK32
    seed = torch.as_tensor(seed, dtype=torch.int64, device=idx.device)
    x = (idx.to(torch.int64) & _MASK32) ^ ((seed + hc) & _MASK32)
    x = _mul32(x, 0x9E3779B1)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    return (x & 0x7FFFFFFF) < _thresh(rate)


def apply_hash_dropout(p, rate: float, seed, positions) -> torch.Tensor:
    """``p`` [E, H] with the kernels' dropout: edge e of CSC position
    ``positions[e]`` keeps head h when ``drop_keep`` says so, scaled by
    1 / (1 - rate) (``_apply_hash_dropout``, ``:687-696``)."""
    seed = 0 if seed is None else seed
    keep = torch.stack([drop_keep(positions, seed, h, rate)
                        for h in range(p.shape[1])], dim=1)
    return torch.where(keep, p, torch.zeros_like(p)) * (1.0 / (1.0 - rate))


# -- plain versions ----------------------------------------------------------

def _f32(*tables):
    """``tables`` as the plain versions compute them: bf16 and fp16 widened
    to float32 (the kernels' arithmetic), other dtypes as they are."""
    return tuple(t.float() if t.dtype in _HALF else t for t in tables)

def _leaky(s, slope):
    return torch.where(s >= 0, s, s * slope) if slope else s


def _ends(layout):
    """(dst, src) of every edge of ``layout``, int64."""
    rows, other = layout.seg_ids.long(), layout.indices.long()
    return (rows, other) if layout.kind == "csc" else (other, rows)


def _raw_scores(a_dst, a_src, dst, src, dsh):
    """Per-edge scores before the leaky relu, [E, H]: ``a_dst[dst] +
    a_src[src]`` (additive, ``dsh`` None) or, per head, the dot of the
    ``dsh``-wide slices of ``q = a_dst`` at ``dst`` and ``k = a_src`` at
    ``src`` (dot)."""
    if dsh is None:
        return a_dst[dst] + a_src[src]
    E, H = dst.shape[0], a_dst.shape[1] // dsh
    return (a_dst[dst].reshape(E, H, dsh)
            * a_src[src].reshape(E, H, dsh)).sum(-1)


def plain_attention(a_dst, a_src, v, dst, src, keys, leaky_slope, dvh,
                    attn_drop, seed, dsh=None):
    """``(out [N, H·dvh], lse [N, H])`` over the edges ``src[e] -> dst[e]``
    (int64), with the hash dropout keyed by ``keys[e]``: the plain forward
    of the per-edge (K9) and the count-matrix (K7) attention, additive or,
    given ``dsh``, dot (``a_dst``, ``a_src`` are then q, k [N, H·dsh]). An
    empty row gives zeros in both."""
    N = a_dst.shape[0]
    E = dst.shape[0]
    s = _leaky(_raw_scores(a_dst, a_src, dst, src, dsh), leaky_slope)
    H = s.shape[1]
    p = segment_softmax(s, dst, N)
    m = segment_max(s.detach(), dst, N)
    total = segment_sum(torch.exp(s - m[dst]), dst, N)
    lse = torch.where(total > 0, m + torch.log(total), torch.zeros_like(m))
    if attn_drop:
        p = apply_hash_dropout(p, attn_drop, seed, keys)
    msg = v[src, :H * dvh].reshape(E, H, dvh) * p[..., None]
    return segment_sum(msg.reshape(E, H * dvh), dst, N), lse


def gat_attention_reference(a_dst, a_src, v, layout: AttentionLayout,
                            leaky_slope: float = 0.2, dvh=None,
                            attn_drop: float = 0.0, seed=None):
    """The plain forward: ``(out [N, H·dvh], lse [N, H])`` over the CSC
    ``layout`` (``_xla_additive_reference``, ``:699-721``, with the hash
    dropout, plus the log-sum-exp of each row's scores; an empty row gives
    zeros in both). bf16 tables: computed in float32, ``out`` rounded once,
    ``lse`` float32."""
    dtype = v.dtype
    a_dst, a_src, v = _f32(a_dst, a_src, v)
    out, lse = plain_attention(a_dst, a_src, v, *_ends(layout),
                               layout.positions(), leaky_slope,
                               dvh or v.shape[1] // a_dst.shape[1], attn_drop,
                               seed)
    return out.to(dtype), lse


def edge_grads(a_dst, a_src, v, g, lse, delta, dst, src, keys, leaky_slope,
               dvh, attn_drop, seed, dsh=None):
    """Per edge ``src[e] -> dst[e]`` (int64) with dropout key ``keys[e]``:
    ``(q, ds, g_e)``, with q the dropped probability, ds the score's
    cotangent (``:367-386``) and g_e the destination's cotangent row
    [E, H, dvh]; scores as in :func:`plain_attention`."""
    E = dst.shape[0]
    s_raw = _raw_scores(a_dst, a_src, dst, src, dsh)
    H = s_raw.shape[1]
    p = torch.exp(_leaky(s_raw, leaky_slope) - lse[dst])
    q = apply_hash_dropout(p, attn_drop, seed, keys) if attn_drop else p
    g_e = g[dst].reshape(E, H, dvh)
    gv = (g_e * v[src].reshape(E, H, dvh)).sum(-1)
    ds = q * gv - p * delta[dst]
    if leaky_slope:
        ds = torch.where(s_raw >= 0, ds, ds * leaky_slope)
    return q, ds, g_e


def gat_dq_reference(a_dst, a_src, v, g, lse, delta,
                     layout: AttentionLayout, leaky_slope: float = 0.2,
                     dvh=None, attn_drop: float = 0.0, seed=None):
    """The plain K10-dq: ``d a_dst [N, H]`` over the CSC ``layout``
    (bf16 tables: computed in float32, rounded once)."""
    N, H = a_dst.shape
    dtype = v.dtype
    a_dst, a_src, v, g = _f32(a_dst, a_src, v, g)
    dst, src = _ends(layout)
    _, ds, _ = edge_grads(a_dst, a_src, v, g, lse, delta, dst, src,
                          layout.positions(), leaky_slope,
                          dvh or v.shape[1] // H, attn_drop, seed)
    return ds.new_zeros(N, H).index_add_(0, dst, ds).to(dtype)


def gat_dkv_reference(a_dst, a_src, v, g, lse, delta,
                      layout: AttentionLayout, leaky_slope: float = 0.2,
                      dvh=None, attn_drop: float = 0.0, seed=None):
    """The plain K10-dkv: ``(d a_src [N, H], dv [N, H·dvh])`` over the CSR
    ``layout``, whose ``eidx`` gives the dropout hash its CSC positions
    (bf16 tables: computed in float32, each output rounded once)."""
    N, H = a_src.shape
    dvh = dvh or v.shape[1] // H
    dtype = v.dtype
    a_dst, a_src, v, g = _f32(a_dst, a_src, v, g)
    dst, src = _ends(layout)
    q, ds, g_e = edge_grads(a_dst, a_src, v, g, lse, delta, dst, src,
                            layout.positions(), leaky_slope, dvh, attn_drop,
                            seed)
    return (ds.new_zeros(N, H).index_add_(0, src, ds).to(dtype),
            head_scatter(q, g_e.flatten(1), src, N).to(dtype))


def head_scatter(ds, x_e, rows, num_rows: int):
    """``out[r, h-slice] = Σ_{e: rows[e]=r} ds[e, h] · x_e[e, h-slice]``:
    the per-head sum of edge rows ``x_e`` [E, H·w] weighted by ``ds``
    [E, H], into [num_rows, H·w]."""
    E, H = ds.shape
    terms = (ds[..., None] * x_e.reshape(E, H, x_e.shape[1] // H)
             ).reshape(E, x_e.shape[1])
    return terms.new_zeros(num_rows, terms.shape[1]).index_add_(0, rows,
                                                                terms)


def dot_attention_reference(q, k, v, layout: AttentionLayout, dsh: int,
                            dvh: int, leaky_slope: float = 0.0,
                            attn_drop: float = 0.0, seed=None):
    """The plain dot-mode forward: ``(out [N, H·dvh], lse [N, H])`` over the
    CSC ``layout`` (``_xla_reference``, ``:724-751``, with the hash dropout,
    plus the log-sum-exp of each row's scores; an empty row gives zeros in
    both). bf16 tables: computed in float32, ``out`` rounded once, ``lse``
    float32."""
    dtype = v.dtype
    q, k, v = _f32(q, k, v)
    out, lse = plain_attention(q, k, v, *_ends(layout), layout.positions(),
                               leaky_slope, dvh, attn_drop, seed, dsh)
    return out.to(dtype), lse


def dot_dq_reference(q, k, v, g, lse, delta, layout: AttentionLayout,
                     dsh: int, dvh: int, leaky_slope: float = 0.0,
                     attn_drop: float = 0.0, seed=None):
    """The plain dot-mode K10-dq: ``dq [N, H·dsh]``, per head ``Σ_e ds_e ·
    k[src_e]`` over the CSC ``layout`` (bf16 tables: computed in float32,
    rounded once)."""
    dtype = v.dtype
    q, k, v, g = _f32(q, k, v, g)
    dst, src = _ends(layout)
    _, ds, _ = edge_grads(q, k, v, g, lse, delta, dst, src,
                          layout.positions(), leaky_slope, dvh, attn_drop,
                          seed, dsh)
    return head_scatter(ds, k[src], dst, q.shape[0]).to(dtype)


def dot_dkv_reference(q, k, v, g, lse, delta, layout: AttentionLayout,
                      dsh: int, dvh: int, leaky_slope: float = 0.0,
                      attn_drop: float = 0.0, seed=None):
    """The plain dot-mode K10-dkv: ``(dk [N, H·dsh], dv [N, H·dvh])``, per
    head ``Σ_e ds_e · q[dst_e]`` and ``Σ_e q_e · g[dst_e]`` over the CSR
    ``layout``, whose ``eidx`` gives the dropout hash its CSC positions
    (bf16 tables: computed in float32, each output rounded once)."""
    N = k.shape[0]
    dtype = v.dtype
    q, k, v, g = _f32(q, k, v, g)
    dst, src = _ends(layout)
    qe, ds, g_e = edge_grads(q, k, v, g, lse, delta, dst, src,
                             layout.positions(), leaky_slope, dvh, attn_drop,
                             seed, dsh)
    return (head_scatter(ds, q[dst], src, N).to(dtype),
            head_scatter(qe, g_e.flatten(1), src, N).to(dtype))


# -- CUDA --------------------------------------------------------------------

def _lib(dtype=torch.float32):
    """The library of the entry points on ``dtype``: ``attention_kernels``
    (``pgl_*_f32``) or, for bf16, ``attention_kernels_bf16`` (``pgl_*_bf16``:
    the same source built apart, so the two build in parallel)."""
    suffix = _SUFFIX[dtype]
    lib = _build.load("attention_kernels" if suffix == "f32"
                      else "attention_kernels_bf16")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the dot mode: (device, tables..., indices[, eidx], pieces, n_pieces,
    #  split_rows, split_ptr, n_split, H, dsh, dvh, slope, seed, thresh,
    #  inv_keep, outputs..., partials, stream)
    dot = [p, i, p, p, i, i, i, i, f, p, i, f]
    # the additive K9 and K10: (device, tables..., indices[, eidx], items,
    # n_long, n_short, empty_rows, n_empty, split_rows, split_ptr, n_split,
    # H, dvh, vec, lh, group, nv, slope, seed, thresh, inv_keep,
    # outputs..., partials, stream)
    k10 = [p, i, i, p, i, p, p, i] + [i] * 6 + [f, p, i, f]
    sigs = {"pgl_gat_fwd": [i] + [p] * 4 + k10 + [p] * 4,
            "pgl_gat_dq": [i] + [p] * 7 + k10 + [p] * 3,
            "pgl_gat_dkv": [i] + [p] * 8 + k10 + [p] * 4,
            "pgl_dot_fwd": [i] + [p] * 4 + dot + [p] * 4,
            "pgl_dot_dq": [i] + [p] * 7 + dot + [p] * 3,
            "pgl_dot_dkv": [i] + [p] * 8 + dot + [p] * 4,
            "pgl_dot_ring_steps": []}
    for name, argtypes in sigs.items():
        fn = getattr(lib, f"{name}_{suffix}")
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _entry(name, t):
    """The entry point ``name`` for the tables' dtype of ``t``."""
    return getattr(_lib(t.dtype), f"{name}_{_SUFFIX[t.dtype]}")


def _dvh_p(dvh: int) -> int:
    return 1 << (int(dvh) - 1).bit_length()


def _check(layout, H, dvh, *tensors, dsh=None):
    """Raise on what the kernels do not take (``dsh``: dot mode, whose
    heads hold score and value columns in the same slots). ``tensors`` are
    the tables, then (the backward) g, lse and delta: the tables and g of
    one dtype, float32 or bf16; lse and delta float32."""
    width = _dvh_p(dvh) if dsh is None else max(_dvh_p(dsh), _dvh_p(dvh))
    if H * width > MAX_SLOTS:
        what = f"width {dvh}" if dsh is None \
            else f"score width {dsh} and value width {dvh}"
        raise ValueError(f"{H} heads of {what} need {H * width} slots; the "
                         f"CUDA attention holds {MAX_SLOTS}")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA attention takes CUDA tensors, got "
                             f"one on {t.device}")
        if t.device != layout.device:
            raise ValueError(f"tensor on {t.device}, layout on "
                             f"{layout.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA attention takes contiguous tensors, "
                             f"got strides {t.stride()}")
        if t.dtype not in _SUFFIX:
            raise TypeError(f"the CUDA attention takes float32 or bf16, "
                            f"got {t.dtype}")
        if t.shape[0] != layout.num_rows or t.shape[0] <= layout.max_index:
            raise ValueError(f"table of {t.shape[0]} rows; the layout has "
                             f"{layout.num_rows} rows and gathers row "
                             f"{layout.max_index}")
    tables, stats = tensors[:4], tensors[4:]
    if len({t.dtype for t in tables}) > 1 or any(
            t.dtype != torch.float32 for t in stats):
        raise TypeError("the CUDA attention takes tables of one dtype and "
                        "float32 lse and delta, got "
                        f"{[str(t.dtype) for t in tensors]}")


def _drop_args(rate: float):
    """(thresh, inv_keep) for the kernels; thresh -1 turns dropout off."""
    if not rate:
        return -1, 1.0
    return _thresh(rate), 1.0 / (1.0 - rate)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"attention_kernels {name} launch failed: CUDA "
                           f"error {rc}")


def _count(name, layout, t, *shape, layout_id=None):
    """Count a pass's launches on the tables' dtype of ``t``;
    ``layout_id`` keys ``LAUNCHES_BY_LAYOUT`` (default ``id(layout)``)."""
    keys = [(name, *shape)]
    if layout.split_rows.shape[0]:
        keys.append((f"{name}_combine", *shape))
    for key in keys:
        if t.dtype == torch.bfloat16:
            LAUNCHES_BF16[key] += 1
        else:
            LAUNCHES_BY_SHAPE[key] += 1
            LAUNCHES_BY_LAYOUT[key, id(layout) if layout_id is None
                               else layout_id] += 1


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _f32_empty(*shape, like):
    """A float32 tensor on ``like``'s device: lse and the split rows'
    partials, float32 whatever the tables' dtype."""
    return torch.empty(*shape, dtype=torch.float32, device=like.device)


def _fwd_cuda(a_dst, a_src, v, lay, slope, dvh, rate, seed, layout_id=None):
    N, H = a_dst.shape
    _check(lay, H, dvh, a_dst, a_src, v)
    out = torch.empty(N, H * dvh, dtype=v.dtype, device=v.device)
    lse = _f32_empty(N, H, like=v)
    part = _f32_empty(lay.num_partials, H * dvh + 2 * H, like=v)
    _raise_on(_entry("pgl_gat_fwd", v)(
        v.device.index, a_dst.data_ptr(), a_src.data_ptr(), v.data_ptr(),
        lay.indices.data_ptr(),
        *_k10_args(lay, H, dvh, slope, rate, seed, v.dtype),
        out.data_ptr(), lse.data_ptr(), part.data_ptr(), _stream(v)),
        "forward")
    _count("gat_fwd", lay, v, H, dvh, layout_id=layout_id)
    return out, lse


def _k10_args(lay, H, dvh, slope, rate, seed, dtype=torch.float32):
    """The additive K9's, K10's and K7's arguments from their work list to
    ``inv_keep``: ``lay`` is an :class:`AttentionLayout` or a
    ``dedup_attention.DedupAttention``, ``dtype`` the tables'."""
    thresh, inv_keep = _drop_args(rate)
    n = lay.k10_items.shape[0]
    return (lay.k10_items.data_ptr(), lay.k10_long, n - lay.k10_long,
            lay.empty_rows.data_ptr(), lay.empty_rows.shape[0],
            lay.split_rows.data_ptr(), lay.split_ptr.data_ptr(),
            lay.split_rows.shape[0], H, dvh, *k10_lanes(H, dvh, dtype),
            slope, seed.data_ptr(), thresh, inv_keep)


def _dq_cuda(a_dst, a_src, v, g, lse, delta, lay, slope, dvh, rate, seed):
    N, H = a_dst.shape
    _check(lay, H, dvh, a_dst, a_src, v, g, lse, delta)
    da = torch.empty(N, H, dtype=v.dtype, device=v.device)
    part = _f32_empty(lay.num_partials, H, like=v)
    _raise_on(_entry("pgl_gat_dq", v)(
        v.device.index, a_dst.data_ptr(), a_src.data_ptr(), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        lay.indices.data_ptr(),
        *_k10_args(lay, H, dvh, slope, rate, seed, v.dtype),
        da.data_ptr(), part.data_ptr(), _stream(v)), "dq")
    _count("gat_dq", lay, v, H, dvh)
    return da


def _dkv_cuda(a_dst, a_src, v, g, lse, delta, lay, slope, dvh, rate, seed):
    N, H = a_src.shape
    _check(lay, H, dvh, a_dst, a_src, v, g, lse, delta)
    da = torch.empty(N, H, dtype=v.dtype, device=v.device)
    dv = torch.empty(N, H * dvh, dtype=v.dtype, device=v.device)
    part = _f32_empty(lay.num_partials, H + H * dvh, like=v)
    _raise_on(_entry("pgl_gat_dkv", v)(
        v.device.index, a_dst.data_ptr(), a_src.data_ptr(), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        lay.indices.data_ptr(), lay.eidx.data_ptr(),
        *_k10_args(lay, H, dvh, slope, rate, seed, v.dtype), da.data_ptr(),
        dv.data_ptr(), part.data_ptr(), _stream(v)), "dkv")
    _count("gat_dkv", lay, v, H, dvh)
    return da, dv


def _delta(g, out, H, dvh):
    """``delta = Σ g·out`` per (row, head), float32 on bf16 (or fp16)
    tables, the tables' dtype otherwise."""
    acc = torch.float32 if out.dtype in _HALF else out.dtype
    return (g.reshape(-1, H, dvh).to(acc)
            * out.reshape(-1, H, dvh).to(acc)).sum(-1)


def _seed_tensor(seed, device) -> torch.Tensor:
    """The dropout seed as an int32 [1] tensor on ``device`` (0 when
    None), the form the kernels read."""
    if seed is None:
        seed = 0
    return torch.as_tensor(seed, dtype=torch.int32,
                           device=device).reshape(1)


# -- K9's forward as custom ops ---------------------------------------------

# the ops' layout arguments: the CSC layout's tensors and integers (the
# forward reads no eidx), then the id that keys LAUNCHES_BY_LAYOUT
_OP_TENSORS = ("indices", "seg_ids", "pieces", "split_rows", "split_ptr",
               "k10_items", "empty_rows")
_OP_INTS = ("num_rows", "num_edges", "max_index", "num_partials", "k10_long")


def _op_args(csc: AttentionLayout):
    return ([getattr(csc, n) for n in _OP_TENSORS],
            [getattr(csc, n) for n in _OP_INTS], id(csc))


def _op_layout(tensors, ints) -> AttentionLayout:
    return AttentionLayout("csc", eidx=None, **dict(zip(_OP_INTS, ints)),
                           **dict(zip(_OP_TENSORS, tensors)))


def _lse_like(t: torch.Tensor, N: int, H: int) -> torch.Tensor:
    """An empty lse [N, H]: float32 on bf16 (or fp16) tables."""
    return t.new_empty(N, H, dtype=torch.float32 if t.dtype in _HALF
                       else t.dtype)


@torch.library.custom_op("pgl_tpu_torch::gat_attention", mutates_args=(),
                         device_types="cpu")
def _gat_op(a_dst: torch.Tensor, a_src: torch.Tensor, v: torch.Tensor,
            layout: List[torch.Tensor], ints: List[int], layout_id: int,
            leaky_slope: float, dvh: int, rate: float,
            seed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The additive K9 as an operator: the plain version on the CPU."""
    return gat_attention_reference(a_dst, a_src, v,
                                   _op_layout(layout, ints), leaky_slope,
                                   dvh, rate, seed)


@_gat_op.register_kernel("cuda")
def _gat_op_cuda(a_dst, a_src, v, layout, ints, layout_id, leaky_slope, dvh,
                 rate, seed):
    use_attention_kernel(v)
    return _fwd_cuda(a_dst, a_src, v, _op_layout(layout, ints), leaky_slope,
                     dvh, rate, seed, layout_id)


@_gat_op.register_fake
def _gat_op_fake(a_dst, a_src, v, layout, ints, layout_id, leaky_slope, dvh,
                 rate, seed):
    N, H = a_dst.shape
    return v.new_empty(N, H * dvh), _lse_like(v, N, H)


@torch.library.custom_op("pgl_tpu_torch::dot_attention", mutates_args=(),
                         device_types="cpu")
def _dot_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            layout: List[torch.Tensor], ints: List[int], layout_id: int,
            leaky_slope: float, dsh: int, dvh: int, rate: float,
            seed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dot-mode K9 as an operator: the plain version on the CPU."""
    return dot_attention_reference(q, k, v, _op_layout(layout, ints), dsh,
                                   dvh, leaky_slope, rate, seed)


@_dot_op.register_kernel("cuda")
def _dot_op_cuda(q, k, v, layout, ints, layout_id, leaky_slope, dsh, dvh,
                 rate, seed):
    use_attention_kernel(v)
    return _dot_fwd_cuda(q, k, v, _op_layout(layout, ints), leaky_slope, dsh,
                         dvh, rate, seed, layout_id)


@_dot_op.register_fake
def _dot_op_fake(q, k, v, layout, ints, layout_id, leaky_slope, dsh, dvh,
                 rate, seed):
    N, H = q.shape[0], q.shape[1] // dsh
    return v.new_empty(N, H * dvh), _lse_like(v, N, H)


class _GatAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a_dst, a_src, v, csc, csr, leaky_slope, dvh, rate,
                seed):
        args = (csc, leaky_slope, dvh, rate, seed)
        if traced(v):
            use_attention_kernel(v)     # raises on what K9 does not take
            out, lse = _gat_op(a_dst, a_src, v, *_op_args(csc),
                               float(leaky_slope), dvh, rate, seed)
        elif use_attention_kernel(v):
            out, lse = _fwd_cuda(a_dst, a_src, v, *args)
        else:
            out, lse = gat_attention_reference(a_dst, a_src, v, *args)
        ctx.save_for_backward(a_dst, a_src, v, out, lse, seed)
        ctx.meta = (csc, csr, leaky_slope, dvh, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        a_dst, a_src, v, out, lse, seed = ctx.saved_tensors
        csc, csr, slope, dvh, rate = ctx.meta
        H = a_dst.shape[1]
        g = g.contiguous()
        ins = (a_dst, a_src, v, g, lse, _delta(g, out, H, dvh))
        if use_attention_kernel(v):
            da_dst = _dq_cuda(*ins, csc, slope, dvh, rate, seed)
            da_src, dv = _dkv_cuda(*ins, csr, slope, dvh, rate, seed)
        else:
            da_dst = gat_dq_reference(*ins, csc, slope, dvh, rate, seed)
            da_src, dv = gat_dkv_reference(*ins, csr, slope, dvh, rate, seed)
        return da_dst, da_src, dv, None, None, None, None, None, None


def fused_gat_attention(a_dst, a_src, v, csc: AttentionLayout,
                        csr: AttentionLayout, leaky_slope: float = 0.2,
                        dvh=None, attn_drop: float = 0.0, drop_seed=None):
    """GAT additive attention: ``out[r] = Σ_{e: dst=r} softmax_r(leaky(
    a_dst[r] + a_src[src_e])) · v[src_e]`` per head, with the reference's
    in-kernel dropout on the probabilities (``attn_drop`` > 0: a hash of
    each edge's CSC position, the int32 ``drop_seed`` and the head; the
    softmax denominator stays undropped).

    Args:
      a_dst, a_src: [N, H] attention coefficients of destination and source.
      v: [N, H·dvh] values (no lane padding, unlike the reference's).
      csc, csr: the graph's :func:`build_attention_layouts`.
      dvh: per-head value width (default ``v.shape[1] // H``).
    Returns [N, H·dvh]; rows with no incoming edge are 0.
    """
    N, H = a_dst.shape
    dvh = dvh or v.shape[1] // H
    if a_src.shape != (N, H) or v.shape != (N, H * dvh):
        raise ValueError(f"a_dst {tuple(a_dst.shape)}, a_src "
                         f"{tuple(a_src.shape)} and v {tuple(v.shape)} are "
                         f"not [N, H], [N, H] and [N, H * {dvh}]")
    rate = float(attn_drop)
    seed = _seed_tensor(drop_seed, v.device)
    return _GatAttention.apply(a_dst.contiguous(), a_src.contiguous(),
                               v.contiguous(), csc, csr, leaky_slope, dvh,
                               rate, seed)


# -- dot mode ----------------------------------------------------------------

def _dot_fwd_cuda(q, k, v, lay, slope, dsh, dvh, rate, seed,
                  layout_id=None):
    N, H = q.shape[0], q.shape[1] // dsh
    _check(lay, H, dvh, q, k, v, dsh=dsh)
    out = torch.empty(N, H * dvh, dtype=v.dtype, device=v.device)
    lse = _f32_empty(N, H, like=v)
    part = _f32_empty(lay.num_partials, H * dvh + 2 * H, like=v)
    thresh, inv_keep = _drop_args(rate)
    _raise_on(_entry("pgl_dot_fwd", v)(
        v.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lay.indices.data_ptr(), lay.pieces.data_ptr(), lay.pieces.shape[0],
        lay.split_rows.data_ptr(), lay.split_ptr.data_ptr(),
        lay.split_rows.shape[0], H, dsh, dvh, slope, seed.data_ptr(), thresh,
        inv_keep, out.data_ptr(), lse.data_ptr(), part.data_ptr(),
        _stream(v)), "dot forward")
    _count("dot_fwd", lay, v, H, dsh, dvh, layout_id=layout_id)
    return out, lse


def _dot_dq_cuda(q, k, v, g, lse, delta, lay, slope, dsh, dvh, rate, seed):
    N, H = q.shape[0], q.shape[1] // dsh
    _check(lay, H, dvh, q, k, v, g, lse, delta, dsh=dsh)
    dq = torch.empty(N, H * dsh, dtype=v.dtype, device=v.device)
    part = _f32_empty(lay.num_partials, H * dsh, like=v)
    thresh, inv_keep = _drop_args(rate)
    _raise_on(_entry("pgl_dot_dq", v)(
        v.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        lay.indices.data_ptr(), lay.pieces.data_ptr(), lay.pieces.shape[0],
        lay.split_rows.data_ptr(), lay.split_ptr.data_ptr(),
        lay.split_rows.shape[0], H, dsh, dvh, slope, seed.data_ptr(), thresh,
        inv_keep, dq.data_ptr(), part.data_ptr(), _stream(v)), "dot dq")
    _count("dot_dq", lay, v, H, dsh, dvh)
    return dq


def _dot_dkv_cuda(q, k, v, g, lse, delta, lay, slope, dsh, dvh, rate,
                  seed):
    N, H = k.shape[0], k.shape[1] // dsh
    _check(lay, H, dvh, q, k, v, g, lse, delta, dsh=dsh)
    dk = torch.empty(N, H * dsh, dtype=v.dtype, device=v.device)
    dv = torch.empty(N, H * dvh, dtype=v.dtype, device=v.device)
    part = _f32_empty(lay.num_partials, H * (dsh + dvh), like=v)
    thresh, inv_keep = _drop_args(rate)
    _raise_on(_entry("pgl_dot_dkv", v)(
        v.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        lay.indices.data_ptr(), lay.eidx.data_ptr(), lay.pieces.data_ptr(),
        lay.pieces.shape[0], lay.split_rows.data_ptr(),
        lay.split_ptr.data_ptr(), lay.split_rows.shape[0], H, dsh, dvh,
        slope, seed.data_ptr(), thresh, inv_keep, dk.data_ptr(),
        dv.data_ptr(), part.data_ptr(), _stream(v)), "dot dkv")
    _count("dot_dkv", lay, v, H, dsh, dvh)
    return dk, dv


class _DotAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, csc, csr, leaky_slope, dsh, dvh, rate, seed):
        args = (csc, leaky_slope, dsh, dvh, rate, seed)
        if traced(v):
            use_attention_kernel(v)     # raises on what K9 does not take
            out, lse = _dot_op(q, k, v, *_op_args(csc), float(leaky_slope),
                               dsh, dvh, rate, seed)
        elif use_attention_kernel(v):
            out, lse = _dot_fwd_cuda(q, k, v, *args)
        else:
            out, lse = dot_attention_reference(q, k, v, csc, dsh, dvh,
                                               leaky_slope, rate, seed)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.meta = (csc, csr, leaky_slope, dsh, dvh, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, seed = ctx.saved_tensors
        csc, csr, slope, dsh, dvh, rate = ctx.meta
        H = q.shape[1] // dsh
        g = g.contiguous()
        ins = (q, k, v, g, lse, _delta(g, out, H, dvh))
        if use_attention_kernel(v):
            dq = _dot_dq_cuda(*ins, csc, slope, dsh, dvh, rate, seed)
            dk, dv = _dot_dkv_cuda(*ins, csr, slope, dsh, dvh, rate, seed)
        else:
            dq = dot_dq_reference(*ins, csc, dsh, dvh, slope, rate, seed)
            dk, dv = dot_dkv_reference(*ins, csr, dsh, dvh, slope, rate,
                                       seed)
        return dq, dk, dv, None, None, None, None, None, None, None


def fused_graph_attention(q, k, v, csc: AttentionLayout, csr: AttentionLayout,
                          num_heads: int, leaky_slope: float = 0.0, dsh=None,
                          dvh=None, attn_drop: float = 0.0, drop_seed=None):
    """Dot-score attention: ``out[r] = Σ_{e: dst=r} softmax_r(leaky(q[r] ·
    k[src_e])) · v[src_e]`` per head, with the reference's in-kernel dropout
    on the probabilities (as :func:`fused_gat_attention`).

    Args:
      q: [N, H·dsh] destination-side score features.
      k: [N, H·dsh] source-side score features.
      v: [N, H·dvh] values (no lane padding, unlike the reference's).
      csc, csr: the graph's :func:`build_attention_layouts`.
      num_heads: H.
      leaky_slope: nonzero applies a leaky relu to the scores (GAT).
      dsh, dvh: per-head score and value widths (default ``q.shape[1] //
        H`` and ``v.shape[1] // H``).
    Returns [N, H·dvh]; rows with no incoming edge are 0.
    """
    N, H = q.shape[0], int(num_heads)
    dsh = dsh or q.shape[1] // H
    dvh = dvh or v.shape[1] // H
    if q.shape != (N, H * dsh) or k.shape != (N, H * dsh) \
            or v.shape != (N, H * dvh):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not [N, {H} * {dsh}], "
                         f"[N, {H} * {dsh}] and [N, {H} * {dvh}]")
    seed = _seed_tensor(drop_seed, v.device)
    return _DotAttention.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), csc, csr, float(leaky_slope),
                               dsh, dvh, float(attn_drop), seed)


def gat_score_features(attn_dst, attn_src):
    """GAT's additive score ``a_dst[r] + a_src[s]`` as a dot: per head,
    ``q' = [a_dst_h, 1, 0, ...]`` and ``k' = [1, a_src_h, 0, ...]`` of
    width ``dsh = max(2, 128 // H)``, the reference's padding to its 128
    lanes (``:941-954``). Returns (q', k'), [N, H·dsh] each."""
    N, H = attn_dst.shape
    dsh = max(2, 128 // H)
    ones = attn_dst.new_ones(N, H, 1)
    pad = attn_dst.new_zeros(N, H, dsh - 2)
    q = torch.cat([attn_dst[..., None], ones, pad], dim=-1)
    k = torch.cat([ones, attn_src[..., None], pad], dim=-1)
    return q.reshape(N, H * dsh), k.reshape(N, H * dsh)
