"""Node-partitioned graphs with boundary-only (halo) feature exchange, one
rank a process.

Port of ``pgl_tpu/parallel/halo_graph.py`` onto ``torch.distributed``. The
reference holds ``[S, N_pad, ...]`` arrays sharded over a mesh and runs
each shard under ``shard_map``; here each rank holds only its own shard:

* node space is ``[N_pad, ...]`` (this rank's owned nodes, padded), edge
  space ``[E_pad, ...]`` (its ``EL_pad`` local-source edges, then its
  ``ER_pad`` remote-source edges), and the halo ``[S·H_pad, ...]`` (one
  block of ``H_pad`` rows from each rank);
* :meth:`HaloGraph.shard_node_values` / :meth:`shard_edge_values` return
  this rank's rows of the reference's layout, and
  :meth:`unshard_node_values` / :meth:`unshard_edge_values` all-gather and
  return the global ``[N, ...]`` (or ``[E, ...]``) in the original order on
  every rank (the reference's multi-process path, ``:456-469``);
* a process group (``group=``, default: the world) takes the place of
  ``mesh``/``axis``, and ``device=`` places the shard (default: the card of
  ``comm.rank_device``).

The host layout is the reference's (:func:`build_halo_partition`, a copy of
``:85-174``): ``N_pad`` padded to 256, ``H_pad`` to 8, the edge caps to
128, remote sources numbered ``p·H_pad + pos``, so a partition saved by
either package loads in the other (:meth:`HaloGraph.save`,
:meth:`HaloGraph.load`, the reference's npz).

Kernels, built from the real edges only (mask > 0), so the padding costs no
kernel work:

* sum and mean are K1 (``ops/kernels/segment_kernels.py``) twice: over the
  local layout (``N_pad`` rows gathering the owned block) and the remote
  layout (``N_pad`` rows gathering the ``S·H_pad`` halo rows, rectangular
  as ``BiGraph``'s), each with its transposed layout for the gradient; the
  halo exchange's backward is K1 over the send layout (``comm``);
* ``send_ue_recv`` takes K1w on the same layouts where ``Graph``'s rule
  takes it (mul or add, sum, one weight an edge or a head), the segment
  path otherwise (the reference composes every case, ``:636-711``);
* ``gat_attention`` / ``dot_attention`` exchange the ``a_src | v`` (``k |
  v``) payload once and run K9/K10 (``ops/kernels/attention_kernels.py``)
  over the unified local + halo source table of ``n_loc = N_pad + S·H_pad``
  rows. The layouts are square over ``n_loc`` (the reference's CSR side is
  that wide already): the CSC rows past ``N_pad`` are empty, which the work
  list gives no warp, ``a_dst`` is zero-padded and the output cut to
  ``N_pad``. An edge's dropout key is its position in the stable-by-
  destination order of the shard's local-then-remote edges, and rank r
  draws with ``seed ^ r`` (the reference's ``seed ^ axis_index``, ``:848``).

Max and min, ``send_uv``, the UDF ``send``/``recv``, ``edge_softmax`` and
``recv_edge_values`` run plain segment ops over this rank's real edges; every
in-edge of an owned node lives on its owner, so none but the gathers of
source rows needs a collective. ``outdegree`` routes the halo's counts back
by the reverse exchange.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import dispatch
from ..ops import message_passing as mp
from ..ops import segment as S
from ..ops.kernels import attention_kernels as ak
from ..ops.kernels.segment_kernels import (build_spmm_layout, spmm,
                                           spmm_weighted)
from ..utils.edge_index import EdgeIndex
from . import comm

__all__ = ["HaloGraph", "build_halo_partition"]


def _pad_to(x: int, mult: int) -> int:
    return max((x + mult - 1) // mult * mult, mult)


def build_halo_partition(edges: np.ndarray, num_nodes: int, num_shards: int,
                         parts: Optional[np.ndarray] = None):
    """Host-side construction of every index structure a HaloGraph needs
    (the reference's arrays, bit for bit): a dict of numpy arrays
    ``node_perm``, ``node_mask`` [S, N_pad], ``send_idx`` [S, S, H_pad],
    ``local_edges`` / ``remote_edges`` [S, cap, 2] (source, owned rank of
    the destination), their ``*_mask`` and ``*_perm`` [S, cap], and
    ``h_pad``, ``halo_size``, ``parts``. ``parts[v]`` assigns node ``v`` to a
    shard; it defaults to contiguous ranges."""
    edges = np.asarray(edges)
    E = edges.shape[0]
    S_ = num_shards
    if parts is None:
        per = (num_nodes + S_ - 1) // S_
        parts = np.minimum(np.arange(num_nodes) // max(per, 1), S_ - 1)
    parts = np.asarray(parts).astype(np.int64)
    if parts.shape != (num_nodes,):
        raise ValueError(f"parts must be [num_nodes], got {parts.shape}")

    owned = [np.flatnonzero(parts == s) for s in range(S_)]
    n_pad = _pad_to(max((len(o) for o in owned), default=1), 256)
    node_perm = np.zeros((S_, n_pad), np.int32)
    node_mask = np.zeros((S_, n_pad), np.float32)
    local_rank = np.zeros(num_nodes, np.int64)
    for s in range(S_):
        k = len(owned[s])
        node_perm[s, :k] = owned[s]
        node_mask[s, :k] = 1.0
        local_rank[owned[s]] = np.arange(k)

    src, dst = edges[:, 0], edges[:, 1]
    e_shard = parts[dst]
    is_local = parts[src] == e_shard

    # per (consumer s, producer p) the unique sources s needs from p: one
    # sorted-unique pass over the keys (s, p, src)
    rem = ~is_local
    rem_idx = np.flatnonzero(rem)
    s_e = e_shard[rem_idx]
    u_e = src[rem_idx].astype(np.int64)
    p_e = parts[u_e]
    key = (s_e * S_ + p_e) * np.int64(num_nodes) + u_e
    uniq, inv = np.unique(key, return_inverse=True)
    grp = uniq // num_nodes
    grp_starts = np.searchsorted(grp, np.arange(S_ * S_))
    pos_of_uniq = np.arange(len(uniq)) - grp_starts[grp]
    counts = np.bincount(grp, minlength=S_ * S_)
    h_pad = _pad_to(int(counts.max()) if len(uniq) else 1, 8)

    send_idx = np.zeros((S_, S_, h_pad), np.int32)
    send_idx[grp % S_, grp // S_, pos_of_uniq] = local_rank[uniq % num_nodes]

    halo_slot = np.zeros(E, np.int64)
    halo_slot[rem_idx] = p_e * h_pad + pos_of_uniq[inv]
    halo_size = int(len(uniq))

    def group(sel_mask, col0):
        counts = np.bincount(e_shard[sel_mask], minlength=S_)
        cap = _pad_to(int(counts.max()) if sel_mask.any() else 1, 128)
        arr = np.zeros((S_, cap, 2), np.int32)
        msk = np.zeros((S_, cap), np.float32)
        prm = np.zeros((S_, cap), np.int32)
        order = np.flatnonzero(sel_mask)
        order = order[np.lexsort((dst[order], e_shard[order]))]
        offs = np.concatenate([[0], np.cumsum(counts)])
        sh = e_shard[order]
        pos = np.arange(len(order)) - offs[sh]
        arr[sh, pos, 0] = col0[order]
        arr[sh, pos, 1] = local_rank[dst[order]]
        msk[sh, pos] = 1.0
        prm[sh, pos] = order
        return arr, msk, prm

    ledges, lmask, lperm = group(is_local, local_rank[src])
    redges, rmask, rperm = group(rem, halo_slot)

    return dict(node_perm=node_perm, node_mask=node_mask,
                send_idx=send_idx,
                local_edges=ledges, local_mask=lmask, local_perm=lperm,
                remote_edges=redges, remote_mask=rmask, remote_perm=rperm,
                h_pad=h_pad, halo_size=halo_size, parts=parts)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous ``[rows, D]`` tensor."""
    return x.reshape(x.shape[0], int(np.prod(x.shape[1:]))).contiguous()


def _column(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


class HaloGraph:
    """This rank's shard of a node-partitioned graph (see the module doc).

    Build with :meth:`from_graph` (or :meth:`load`) on every rank of
    ``group``; each rank passes the same graph (and ``parts``) and keeps its
    own shard on ``device``; the host index arrays of every shard stay on
    the host (``save``, the unshards and ``scaling_report`` read them).
    ``node_feat`` / ``edge_feat`` hold this rank's rows of the graph's
    features.
    """

    _SAVE_KEYS = ("node_perm", "node_mask", "send_idx", "local_edges",
                  "local_mask", "local_perm", "remote_edges",
                  "remote_mask", "remote_perm")

    def __init__(self, built: dict, num_nodes: int, group=None, device=None,
                 attention_layouts: bool = True, halo_dtype=None):
        self.group, size, rank = comm.world(group)
        S_ = built["node_perm"].shape[0]
        if S_ != size:
            raise ValueError(f"a partition of {S_} shards on a group of "
                             f"{size} ranks")
        self.rank = rank
        self.device = comm.rank_device(device)
        self._host = {k: np.asarray(built[k]) for k in self._SAVE_KEYS}
        self._num_nodes = int(num_nodes)
        self.h_pad = int(built["h_pad"])
        self.halo_size = int(built["halo_size"])
        self.halo_dtype = None if halo_dtype is None \
            else _torch_dtype(halo_dtype)
        self._with_attention = bool(attention_layouts)
        self._attn_layouts = None
        self.node_feat = {}
        self.edge_feat = {}
        h = self._host
        self.n_pad = h["node_perm"].shape[1]
        self.el_pad = h["local_edges"].shape[1]
        self.er_pad = h["remote_edges"].shape[1]
        self._num_edges = int(h["local_mask"].sum() + h["remote_mask"].sum())
        r = rank
        self.kl = int(h["local_mask"][r].sum())
        self.kr = int(h["remote_mask"][r].sum())
        le = h["local_edges"][r, :self.kl].astype(np.int64)
        re_ = h["remote_edges"][r, :self.kr].astype(np.int64)
        self._l_src, self._l_dst = le[:, 0], le[:, 1]
        self._r_src, self._r_dst = re_[:, 0], re_[:, 1]
        dev = self.device

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int64),
                                   device=dev)

        self.node_mask = torch.as_tensor(h["node_mask"][r], device=dev)
        self.send_idx = put(h["send_idx"][r].reshape(-1))
        self.l_src, self.r_src = put(self._l_src), put(self._r_src)
        self.dst = put(np.concatenate([self._l_dst, self._r_dst]))
        deg = np.bincount(np.concatenate([self._l_dst, self._r_dst]),
                          minlength=self.n_pad)
        self._indegree = torch.as_tensor(deg.astype(np.int32), device=dev)
        self._build_layouts()

    # -- construction -------------------------------------------------------

    @classmethod
    def from_graph(cls, graph, group=None, parts: Optional[np.ndarray] = None,
                   partition: str = "range", attention_layouts: bool = True,
                   halo_dtype=None, device=None) -> "HaloGraph":
        """Partition ``graph``'s nodes over the ranks of ``group``:
        ``partition`` "range" (contiguous ids) or "metis" (balanced by
        in-edges, since an edge runs on its destination's owner), or an
        explicit ``parts`` (which every rank should pass alike: compute
        METIS once and hand it out). Every rank builds the host layout and
        keeps its own shard; the graph's features are sharded likewise.
        ``attention_layouts=False`` makes ``gat_attention`` /
        ``dot_attention`` raise (their work lists are otherwise built on
        the first call)."""
        g = graph.numpy() if graph.is_tensor else graph
        group, size, _ = comm.world(group)
        if parts is None and partition == "metis":
            from ..partition import metis_partition
            parts = metis_partition(g, size, balance="in_edges")
        elif parts is None and partition != "range":
            raise ValueError(f"partition must be 'range' or 'metis', got "
                             f"{partition!r}")
        built = build_halo_partition(np.asarray(g.edges), g.num_nodes, size,
                                     parts)
        obj = cls(built, g.num_nodes, group, device, attention_layouts,
                  halo_dtype)
        for k, v in g.node_feat.items():
            obj.node_feat[k] = obj.shard_node_values(np.asarray(v))
        for k, v in g.edge_feat.items():
            obj.edge_feat[k] = obj.shard_edge_values(np.asarray(v))
        return obj

    def save(self, path: str):
        """Write the partition (the reference's npz: index arrays of every
        shard, features in global order) from rank 0; every rank calls it
        (the features are all-gathered) and returns once the file is
        written."""
        feats = {f"nfeat_{k}": self.unshard_node_values(v)
                 for k, v in self.node_feat.items()}
        feats.update({f"efeat_{k}": self.unshard_edge_values(v)
                      for k, v in self.edge_feat.items()})
        if self.rank == 0:
            np.savez_compressed(
                path, num_nodes=self._num_nodes, axis="node",
                h_pad=self.h_pad, halo_size=self.halo_size,
                attention=self._with_attention, **self._host, **feats)
        torch.distributed.barrier(self.group)

    @classmethod
    def load(cls, path: str, group=None, attention_layouts=None,
             device=None) -> "HaloGraph":
        """Rebuild a saved partition (either package's) on every rank of
        ``group``, which must have as many ranks as it has shards."""
        z = np.load(path, allow_pickle=False)
        built = {k: z[k] for k in cls._SAVE_KEYS}
        built["h_pad"] = int(z["h_pad"])
        built["halo_size"] = int(z["halo_size"])
        if attention_layouts is None:
            attention_layouts = bool(z["attention"])
        obj = cls(built, int(z["num_nodes"]), group, device,
                  attention_layouts)
        for k in z.files:
            if k.startswith("nfeat_"):
                obj.node_feat[k[6:]] = obj.shard_node_values(z[k])
            elif k.startswith("efeat_"):
                obj.edge_feat[k[6:]] = obj.shard_edge_values(z[k])
        return obj

    def _build_layouts(self):
        """K1's layouts on this rank's real edges: local (``N_pad`` rows
        gathering the owned block) and remote (``N_pad`` rows gathering the
        halo), each with its transpose; and the exchange's backward layout
        (owned row <- the real slots it was sent in)."""
        n_pad, n_halo, dev = self.n_pad, self.num_shards * self.h_pad, \
            self.device

        def pair(src, dst, n_src, tag):
            csc = EdgeIndex.from_edges(dst, src, n_pad)
            csr = EdgeIndex.from_edges(src, dst, n_src)
            return (build_spmm_layout(csc.indptr, csc.sorted_v, n_pad,
                                      kind=f"halo_{tag}", device=dev,
                                      edge_id=csc.sorted_eid),
                    build_spmm_layout(csr.indptr, csr.sorted_v, n_src,
                                      kind=f"halo_{tag}_t", device=dev,
                                      edge_id=csr.sorted_eid))

        self._local = pair(self._l_src, self._l_dst, n_pad, "local")
        self._remote = pair(self._r_src, self._r_dst, n_halo, "remote")
        slots = self._real_send_slots()
        rows = self._host["send_idx"][self.rank].reshape(-1)[slots]
        back = EdgeIndex.from_edges(rows.astype(np.int64), slots, n_pad)
        self._send_layout = build_spmm_layout(
            back.indptr, back.sorted_v, n_pad, kind="halo_send", device=dev)

    def _real_send_slots(self) -> np.ndarray:
        """Positions ``j·H_pad + pos`` of this rank's send buffer that rank
        j reads (its remote edges name slot ``rank·H_pad + pos``); the
        others are pads pointing at owned row 0."""
        h, r, H = self._host, self.rank, self.h_pad
        out = []
        for j in range(self.num_shards):
            k = int(h["remote_mask"][j].sum())
            used = np.unique(h["remote_edges"][j, :k, 0].astype(np.int64))
            out.append(j * H + used[used // H == r] % H)
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    # -- host <-> this rank's layout ------------------------------------------

    def shard_node_values(self, values):
        """This rank's ``[N_pad, ...]`` rows of ``values`` ``[N, ...]``
        (global order), pad rows 0, on this rank's device."""
        values = np.asarray(values)
        r = self.rank
        out = values[self._host["node_perm"][r]]
        m = self._host["node_mask"][r].reshape(
            (-1,) + (1,) * (values.ndim - 1))
        out = out * m.astype(out.dtype)
        return torch.as_tensor(np.ascontiguousarray(out), device=self.device)

    def unshard_node_values(self, x) -> np.ndarray:
        """Every rank's ``[N_pad, ...]`` rows all-gathered: ``[N, ...]`` in
        the global order, a numpy array on every rank."""
        xs = comm.all_gather(torch.as_tensor(x), self.group).cpu().numpy()
        mask = self._host["node_mask"] > 0
        out = np.zeros((self._num_nodes,) + xs.shape[2:], xs.dtype)
        out[self._host["node_perm"][mask]] = xs[mask]
        return out

    def _edge_perm_mask(self):
        h = self._host
        perm = np.concatenate([h["local_perm"], h["remote_perm"]], axis=1)
        mask = np.concatenate([h["local_mask"], h["remote_mask"]], axis=1)
        return perm, mask

    def shard_edge_values(self, values):
        """This rank's ``[E_pad, ...]`` rows of per-edge ``values`` (original
        edge order): local block then remote block, pads 0."""
        values = np.asarray(values)
        perm, mask = self._edge_perm_mask()
        r = self.rank
        out = values[perm[r]]
        out = out * mask[r].reshape((-1,) + (1,) * (values.ndim - 1)).astype(
            out.dtype)
        return torch.as_tensor(np.ascontiguousarray(out), device=self.device)

    def unshard_edge_values(self, x) -> np.ndarray:
        """Every rank's ``[E_pad, ...]`` per-edge rows all-gathered:
        ``[E, ...]`` in the original edge order, on every rank."""
        xs = comm.all_gather(torch.as_tensor(x), self.group).cpu().numpy()
        perm, mask = self._edge_perm_mask()
        mask = mask > 0
        out = np.zeros((int(mask.sum()),) + xs.shape[2:], xs.dtype)
        out[perm[mask]] = xs[mask]
        return out

    # -- properties ---------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    @property
    def num_edges(self) -> int:
        return self._num_edges

    @property
    def num_shards(self) -> int:
        return self._host["node_perm"].shape[0]

    @property
    def comm_bytes_per_exchange(self) -> int:
        """Bytes of one halo exchange of scalars, over every rank (× the
        feature width for vectors): proportional to the partition cut. A
        ``halo_dtype`` of bf16 halves it."""
        return self.halo_size * self._wire_itemsize()

    def _wire_itemsize(self) -> int:
        return 4 if self.halo_dtype is None \
            else torch.empty(0, dtype=self.halo_dtype).element_size()

    def scaling_report(self, feat_dim: int = 128, edge_ns: float = 16.0,
                       ici_gbps: float = 400.0) -> dict:
        """The reference's analytic projection (``:913-948``), from the host
        layout of every shard: edges and halo rows received per shard, the
        edge skew, the modelled comm and compute seconds and the
        efficiency. Its constants are the reference's (a TPU's per-edge time
        and link rate), not a measurement of this port."""
        h = self._host
        lm = h["local_mask"].sum(axis=1)
        rm = h["remote_mask"].sum(axis=1)
        e_s = lm + rm
        recv_rows = np.array([
            len(np.unique(h["remote_edges"][s, h["remote_mask"][s] > 0, 0]))
            for s in range(self.num_shards)], dtype=np.float64)
        wire_bytes = self._wire_itemsize()
        t_comm = recv_rows * feat_dim * wire_bytes / (ici_gbps * 1e9)
        t_comp = e_s * edge_ns * 1e-9
        t_layer = np.maximum(t_comm, t_comp)
        total_edges = float(e_s.sum())
        eff = ((total_edges * edge_ns * 1e-9)
               / (self.num_shards * t_layer.max()))
        return dict(edges_per_shard=e_s.astype(int).tolist(),
                    local_edges=lm.astype(int).tolist(),
                    remote_edges=rm.astype(int).tolist(),
                    halo_rows_recv=recv_rows.astype(int).tolist(),
                    edge_skew=float(e_s.max() / max(e_s.mean(), 1.0)),
                    t_comm_s=t_comm.tolist(), t_compute_s=t_comp.tolist(),
                    scaling_efficiency=float(eff))

    # -- the exchange and the edge layout -------------------------------------

    def _exchange(self, owned: torch.Tensor) -> torch.Tensor:
        """The halo ``[S·H_pad, ...]`` of ``owned`` ``[N_pad, ...]``."""
        return comm.halo_exchange(owned, self.send_idx, self._send_layout,
                                  self.group, self.halo_dtype)

    def _src_rows(self, owned: torch.Tensor) -> torch.Tensor:
        """Each real edge's source row, local edges then remote ones."""
        halo = self._exchange(owned)
        return torch.cat([owned.index_select(0, self.l_src),
                          halo.index_select(0, self.r_src)])

    def _to_edges(self, vals: torch.Tensor) -> torch.Tensor:
        """Real-edge rows (local then remote) into ``[E_pad, ...]``."""
        tail = tuple(vals.shape[1:])
        return torch.cat([vals[:self.kl],
                          vals.new_zeros((self.el_pad - self.kl,) + tail),
                          vals[self.kl:],
                          vals.new_zeros((self.er_pad - self.kr,) + tail)])

    def _from_edges(self, x: torch.Tensor) -> torch.Tensor:
        """The real-edge rows of ``[E_pad, ...]`` (local then remote)."""
        return torch.cat([x[:self.kl],
                          x[self.el_pad:self.el_pad + self.kr]])

    # -- message passing ----------------------------------------------------

    def send_u_recv(self, feature, reduce_op: str = "sum"):
        """``out[v] = reduce over in-edges (u, v) of feature[u]`` on this
        rank's ``[N_pad, ...]`` rows; one exchange of the boundary rows.
        sum and mean are K1 over the local and the remote layouts (the
        plain versions on the CPU; the segment path for an integer,
        float16 or float64 CUDA feature, as ``Graph``), max and min the segment path;
        a node without in-edges gives 0."""
        if reduce_op not in ("sum", "mean", "max", "min"):
            raise ValueError(reduce_op)
        if reduce_op in ("sum", "mean") and not dispatch.plain_on_cuda(
                feature):
            flat = _rows(feature)
            out = spmm(flat, *self._local)
            out = out + spmm(_rows(self._exchange(flat)), *self._remote)
            out = out.reshape((self.n_pad,) + tuple(feature.shape[1:]))
            if reduce_op == "mean":
                deg = self._indegree.clamp(min=1).to(out.dtype)
                out = out / _column(deg, out)
            return out
        return S.segment_pool(self._src_rows(feature), self.dst, reduce_op,
                              num_segments=self.n_pad)

    send_recv = send_u_recv

    def send_ue_recv(self, feature, edge_feat, message_op: str = "mul",
                     reduce_op: str = "sum"):
        """Edge-weighted aggregation; ``edge_feat`` is this rank's ``[E_pad,
        ...]`` (:meth:`shard_edge_values`). The reference's op matrix:
        add/sub/mul/div × sum/mean/max/min. mul or add with sum on one
        weight an edge or a head runs K1w over the local and remote layouts
        (``Graph.send_ue_recv``'s rule); the rest the segment path."""
        from ..graph import _kernel_weights
        mp._check_op(message_op)
        if reduce_op not in ("sum", "mean", "max", "min"):
            raise ValueError(reduce_op)
        w = None
        if (message_op in ("mul", "add") and reduce_op == "sum"
                and not dispatch.plain_on_cuda(feature)):
            w = _kernel_weights(feature, edge_feat)
        if w is not None:
            flat = _rows(feature)
            w = w.to(flat.dtype)
            wl = w[:self.kl].contiguous()
            wr = w[self.el_pad:self.el_pad + self.kr].contiguous()
            out = spmm_weighted(flat, wl, *self._local, message_op)
            out = out + spmm_weighted(_rows(self._exchange(flat)), wr,
                                      *self._remote, message_op)
            return out.reshape((self.n_pad,) + tuple(feature.shape[1:]))
        msg = self._src_rows(feature)
        ef = self._from_edges(edge_feat)
        msg = mp._COMBINE[message_op](msg, mp._broadcast_edge(ef, msg.ndim))
        return S.segment_pool(msg, self.dst, reduce_op,
                              num_segments=self.n_pad)

    def send_uv(self, src_feat, dst_feat, message_op: str = "add"):
        """Per-edge ``op(src_feat[u], dst_feat[v])`` in this rank's
        ``[E_pad, ...]`` edge layout; only boundary rows of ``src_feat``
        travel."""
        mp._check_op(message_op)
        out = mp._COMBINE[message_op](self._src_rows(src_feat),
                                      dst_feat.index_select(0, self.dst))
        return self._to_edges(out)

    def gather_src_values(self, values):
        """Each edge's source row in the ``[E_pad, ...]`` layout (one
        exchange)."""
        return self._to_edges(self._src_rows(values))

    def gather_dst_values(self, values):
        """Each edge's destination row in the ``[E_pad, ...]`` layout (no
        collective: every destination is owned here)."""
        return self._to_edges(values.index_select(0, self.dst))

    def send(self, message_func, src_feat=None, dst_feat=None,
             edge_feat=None, node_feat=None):
        """UDF message passing, ``Graph.send``'s contract: ``message_func
        (src, dst, edge)`` over dicts of ``[E_pad, ...]`` rows, source rows
        by one exchange each. Returns a dict of ``[E_pad, ...]``
        messages for :meth:`recv`."""
        if (src_feat is not None or dst_feat is not None) \
                and node_feat is not None:
            raise ValueError(
                "Can not use src/dst feat and node feat at the same time")
        src_in = dict(node_feat or {}) if node_feat is not None \
            else dict(src_feat or {})
        dst_in = dict(node_feat or {}) if node_feat is not None \
            else dict(dst_feat or {})
        msg = message_func(
            {k: self.gather_src_values(v) for k, v in src_in.items()},
            {k: self.gather_dst_values(v) for k, v in dst_in.items()},
            dict(edge_feat or {}))
        if not isinstance(msg, dict):
            raise TypeError("message_func must return a dict of tensors")
        return msg

    def recv(self, reduce_func, msg: dict):
        """Reduce per-edge messages onto their owned destinations ("sum",
        "mean", "max" or "min"; a node without messages gives 0)."""
        if not isinstance(msg, dict):
            raise TypeError("msg must be a dict")
        out = {k: self.recv_edge_values(v, reduce_func)
               for k, v in msg.items()}
        return out if len(msg) > 1 else out[next(iter(msg))]

    def recv_edge_values(self, edge_vals, reduce_op: str = "sum"):
        """Reduce ``[E_pad, ...]`` per-edge values onto their destinations
        (no collective)."""
        if reduce_op not in ("sum", "mean", "max", "min"):
            raise ValueError(reduce_op)
        return S.segment_pool(self._from_edges(edge_vals), self.dst,
                              reduce_op, num_segments=self.n_pad)

    def edge_softmax(self, logits):
        """Softmax of ``[E_pad, ...]`` logits over each owned node's
        in-edges (no collective); pad edges give 0."""
        return self._to_edges(S.segment_softmax(
            self._from_edges(logits), self.dst, self.n_pad))

    def indegree(self):
        """``[N_pad]`` int32 (from the host layout: every in-edge of an
        owned node is on its owner)."""
        return self._indegree

    def outdegree(self):
        """``[N_pad]`` int32: local out-edges counted here, the halo's
        counts routed back to their owners by the reverse exchange and
        summed over the send layout (K1)."""
        from ..ops.kernels.segment_kernels import _spmm_one
        dev = self.device
        n_halo = self.num_shards * self.h_pad
        local = torch.bincount(self.l_src, minlength=self.n_pad)
        halo = torch.bincount(self.r_src, minlength=n_halo).to(
            torch.float32)
        back = comm.all_to_all(halo.reshape(-1, 1), self.group)
        far = _spmm_one(back.contiguous(), self._send_layout).reshape(-1)
        return (local.to(dev) + far.round().to(torch.int64)).to(torch.int32)

    # -- attention ----------------------------------------------------------

    def gat_attention(self, a_dst, a_src, v, leaky_slope: float = 0.2,
                      attn_drop: float = 0.0, drop_seed=None):
        """GAT attention over this rank's owned destinations:
        ``out[r] = Σ softmax_r(leaky(a_dst[r] + a_src[src])) · v[src]``
        per head, ``a_dst``/``a_src`` ``[N_pad, H]``, ``v`` ``[N_pad,
        H·dvh]``; one exchange of the ``a_src | v`` rows. K9/K10 in
        additive mode for ``3·H <= 128``; past it the score written as a
        dot (``gat_score_features``, dot-mode K9/K10) at rate 0 and the
        plain composition under dropout, as ``GATConv``'s route. Dropout
        keys each edge by its CSC position, seeded ``drop_seed ^ rank``."""
        return self._attention("additive", a_dst, a_src, v, a_dst.shape[-1],
                               leaky_slope, attn_drop, drop_seed)

    def dot_attention(self, q, k, v, num_heads: int, attn_drop: float = 0.0,
                      drop_seed=None):
        """Dot-score attention (``TransformerConv``): ``out[r] = Σ
        softmax_r(q[r] · k[src]) · v[src]`` per head, ``q``/``k`` ``[N_pad,
        H·dsh]`` (the caller scales q), ``v`` ``[N_pad, H·dvh]``; one
        exchange of the ``k | v`` rows, then the dot-mode K9/K10."""
        return self._attention("dot", q, k, v, num_heads, 0.0, attn_drop,
                               drop_seed)

    def _attention_layouts(self):
        """``(csc, csr)`` over the unified source table (owned block, then
        the halo), square over ``n_loc`` (CSC rows past ``N_pad`` empty);
        built on the first call."""
        if not self._with_attention:
            raise RuntimeError(
                "this HaloGraph was built with attention_layouts=False; "
                "rebuild with from_graph(..., attention_layouts=True) to "
                "use gat_attention/dot_attention")
        if self._attn_layouts is None:
            n_loc = self.n_pad + self.num_shards * self.h_pad
            src = np.concatenate([self._l_src, self._r_src + self.n_pad])
            dst = np.concatenate([self._l_dst, self._r_dst])
            self._attn_layouts = ak.build_attention_layouts(
                EdgeIndex.from_edges(dst, src, n_loc),
                EdgeIndex.from_edges(src, dst, n_loc), n_loc,
                device=self.device)
        return self._attn_layouts

    def _attention(self, mode, dst_s, src_s, v, num_heads, leaky_slope,
                   attn_drop, drop_seed):
        H = int(num_heads)
        DS, DV = dst_s.shape[-1], v.shape[-1]
        if DV % H:
            raise ValueError(f"v width {DV} not divisible by heads {H}")
        if DS % H:
            raise ValueError(f"score width {DS} not divisible by {H}")
        rate = float(attn_drop)
        if rate and drop_seed is None:
            raise ValueError(
                "attn_drop > 0 requires an explicit drop_seed — without one "
                "every step would reuse the same dropout mask (vary it per "
                "step, e.g. fold the step index into the seed)")
        csc, csr = self._attention_layouts()
        dvh, dsh = DV // H, DS // H
        payload = torch.cat([src_s, v], dim=1)
        tbl = torch.cat([payload, self._exchange(payload)])
        src_tbl, v_tbl = tbl[:, :DS], tbl[:, DS:]
        seed = None
        if rate:
            seed = torch.as_tensor(drop_seed, dtype=torch.int32).reshape(
                -1)[:1] ^ self.rank
        if (dispatch.plain_on_cuda(dst_s, src_s, v)
                or (mode == "additive" and 3 * H > 128 and rate)):
            # the plain composition over the same CSC edges and keys
            dst_e, src_e = csc.seg_ids.long(), csc.indices.long()
            out, _ = ak.plain_attention(
                dst_s, src_tbl, v_tbl, dst_e, src_e, csc.positions(),
                leaky_slope, dvh, rate, None if seed is None
                else seed.to(dst_s.device), None if mode == "additive"
                else dsh)
            return out
        dst_full = torch.cat([dst_s, dst_s.new_zeros(
            (tbl.shape[0] - self.n_pad, DS))])
        if mode == "additive" and 3 * H <= 128:
            out = ak.fused_gat_attention(dst_full, src_tbl, v_tbl, csc, csr,
                                         leaky_slope, dvh=dvh,
                                         attn_drop=rate, drop_seed=seed)
        elif mode == "additive":
            q, k = ak.gat_score_features(dst_full, src_tbl)
            out = ak.fused_graph_attention(q, k, v_tbl, csc, csr, H,
                                           leaky_slope, dsh=q.shape[1] // H,
                                           dvh=dvh)
        else:
            out = ak.fused_graph_attention(dst_full, src_tbl, v_tbl, csc,
                                           csr, H, leaky_slope, dsh=dsh,
                                           dvh=dvh, attn_drop=rate,
                                           drop_seed=seed)
        return out[:self.n_pad]

    def __repr__(self):
        return (f"HaloGraph(num_nodes={self._num_nodes}, "
                f"shards={self.num_shards}, rank={self.rank}, "
                f"local={self.el_pad}, remote={self.er_pad}, "
                f"halo={self.halo_size})")


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown halo dtype {dtype!r}")
    return out
