"""Graph4Rec — config-driven recommendation-GNN toolkit (port of
``pgl_tpu/apps/graph4rec.py``).

Capability parity with ``apps/Graph4Rec`` (yaml presets in
``user_configs/``; walk-based models and ego-graph sage models over the
distributed graph engine — ``env_run/src/dist_cpu_train.py``,
``datasets/sampling.py:172-551``, ``models/model.py:35,159``).

One trainer, one config:

```yaml
model_type: walk_based            # or ego_sage, lightgcn, gat, gin, gatne
metapath: "u2i-i2u"               # walk_based
walk_len: 12
win_size: 3
neg_num: 5
samples: [5, 5]                   # ego fan-out (the first layer's is used)
embed_dim: 64
lr: 0.005
epochs: 10
batch_pairs: 1024
```

Graph source is either a local :class:`~pgl_tpu_torch.HeterGraph` (or
``Graph``) or a :class:`~pgl_tpu_torch.distributed.DistGraphClient` (walks
go through RPC). Walks and skip-gram pairs are made on the host (the C++
kernels, numpy's generator); the tables and encoders train on ``device``
(default: the card) under ``torch.optim.Adam``, or, with ``ps_addresses``,
on parameter-server shards under their adagrad.

Each step's draws come from one ``torch.Generator`` on the device (seeded
``seed + 17``): the neighbour uniforms (one ``[B, k]`` a relation for
gatne, one for the other ego models), then the negatives' permutation of
``B * neg_num`` (:meth:`Graph4RecTrainer._draws`). :meth:`~Graph4RecTrainer.
loss` and the step are functions of those draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..native.graph_kernel import skip_gram_gen_pair
from ..sampling import (metapath_randomwalk, metapath_randomwalk_dist,
                        random_walk, node2vec_walk)
from ..sampling.sage import _device_csc, _neighbors_from_uniforms
from ..utils.config import Config, load_config
from ..utils.logger import log
from .common import _inbatch_skipgram_loss

__all__ = ["Graph4RecTrainer", "PRESETS"]


# The reference ships yaml presets in ``user_configs/`` (deepwalk.yaml,
# metapath2vec.yaml, graphsage.yaml, lightgcn.yaml, ...); these are the
# same recipes as Config dicts — Graph4RecTrainer.from_preset(name) is the
# one-call equivalent of ``dist_cpu_train.py --config user_configs/X.yaml``.
PRESETS = {
    "deepwalk": dict(model_type="walk_based", walk_mode="deepwalk",
                     walk_len=24, win_size=5, neg_num=5, embed_dim=64,
                     lr=5e-3, epochs=10, batch_pairs=1024,
                     walks_per_node=4),
    "node2vec": dict(model_type="walk_based", walk_mode="node2vec",
                     p=2.0, q=0.5, walk_len=24, win_size=5, neg_num=5,
                     embed_dim=64, lr=5e-3, epochs=10, batch_pairs=1024,
                     walks_per_node=4),
    "metapath2vec": dict(model_type="walk_based", walk_mode="metapath",
                         metapath="u2i-i2u", walk_len=12, win_size=3,
                         neg_num=5, embed_dim=64, lr=5e-3, epochs=10,
                         batch_pairs=1024, walks_per_node=2),
    "graphsage": dict(model_type="ego_sage", samples=[5, 5],
                      metapath="u2i-i2u", walk_len=8, win_size=3,
                      neg_num=5, embed_dim=64, lr=5e-3, epochs=10,
                      batch_pairs=1024, walks_per_node=2),
    "lightgcn": dict(model_type="lightgcn", samples=[8],
                     metapath="u2i-i2u", walk_len=8, win_size=3,
                     neg_num=5, embed_dim=64, lr=5e-3, epochs=10,
                     batch_pairs=1024, walks_per_node=2),
    "gat": dict(model_type="gat", samples=[8], metapath="u2i-i2u",
                walk_len=8, win_size=3, neg_num=5, embed_dim=64, lr=5e-3,
                epochs=10, batch_pairs=1024, walks_per_node=2),
    "gin": dict(model_type="gin", samples=[8], metapath="u2i-i2u",
                walk_len=8, win_size=3, neg_num=5, embed_dim=64, lr=5e-3,
                epochs=10, batch_pairs=1024, walks_per_node=2),
    "gatne": dict(model_type="gatne", samples=[5], metapath="u2i-i2u",
                  walk_len=8, win_size=3, neg_num=5, embed_dim=64,
                  edge_dim=8, att_dim=8, lr=5e-3, epochs=10,
                  batch_pairs=1024, walks_per_node=2),
    "graphsage_with_features": dict(
        model_type="ego_sage", samples=[5, 5], metapath="u2i-i2u",
        walk_len=8, win_size=3, neg_num=5, embed_dim=64, lr=5e-3,
        epochs=10, batch_pairs=1024, walks_per_node=2, use_node_feat=True),
    "metapath2vec_with_features": dict(
        model_type="walk_based", walk_mode="metapath", metapath="u2i-i2u",
        walk_len=12, win_size=3, neg_num=5, embed_dim=64, lr=5e-3,
        epochs=10, batch_pairs=1024, walks_per_node=2, use_node_feat=True),
}

_EGO = ("ego_sage", "lightgcn", "gat", "gin")


class Graph4RecTrainer:
    """Single-process trainer, or one trainer replica of the reference's
    N-trainer async-PS topology when ``ps_addresses`` is given
    (``apps/Graph4Rec/env_run/src/dist_cpu_train.py:51-66``): the id/ctx
    embedding tables live sharded on :mod:`~pgl_tpu_torch.distributed.ps`
    servers, the step pulls the batch's unique rows to ``device``,
    differentiates with respect to the pulled rows only, and pushes the
    sparse grads back asynchronously (server-side adagrad).

    ``params`` holds the tensors by the reference's names (``emb``,
    ``ctx``; ``w_self``/``w_neigh`` for ego_sage, ``w``/``a_l``/``a_r``
    for gat, ``gin_eps``/``w1``/``b1``/``w2``/``b2`` for gin,
    ``edge_emb``/``w_att``/``v_att``/``w_out`` for gatne, ``w_feat`` with
    ``use_node_feat``), drawn on the CPU from a generator seeded ``seed``
    in that order (normal times 0.1; ``ctx``, the biases and ``gin_eps``
    zeros), so a seed gives the same tables on every device.
    """

    def __init__(self, config, graph=None, client=None,
                 num_nodes: Optional[int] = None, seed: int = 0,
                 ps_addresses=None, device=None):
        self.cfg = config if isinstance(config, Config) \
            else load_config(config)
        if graph is None and client is None:
            raise ValueError("provide a HeterGraph or a DistGraphClient")
        self.device = resolve_device(device)
        self.graph = graph
        self.client = client
        self.num_nodes = num_nodes or (graph.num_nodes if graph else None)
        if self.num_nodes is None:
            raise ValueError("num_nodes required with a client source")
        dim = int(self.cfg.embed_dim or 64)
        self.neg_num = int(self.cfg.neg_num or 5)
        mtype = self.mtype = self.cfg.model_type or "walk_based"
        self.ps = None
        gen = torch.Generator().manual_seed(seed)

        def normal(*shape):
            return torch.randn(shape, generator=gen) * 0.1

        init = {}
        if ps_addresses is not None:
            if mtype != "walk_based":
                raise ValueError(
                    "distributed PS training supports walk_based models "
                    f"(got model_type={mtype!r}) — dense encoder weights "
                    "would need replica synchronization")
            if getattr(self.cfg, "use_node_feat", False):
                raise ValueError(
                    "distributed PS training does not support "
                    "use_node_feat yet: the feature projection is a "
                    "dense weight that would need replica "
                    "synchronization — run single-process, or drop "
                    "use_node_feat from the config")
            from ..distributed.ps import PSEmbedding
            lr = float(self.cfg.lr or 5e-3)
            self.ps = {
                "emb": PSEmbedding(ps_addresses, "emb", self.num_nodes,
                                   dim, lr=lr, init_scale=0.1,
                                   seed=seed),
                "ctx": PSEmbedding(ps_addresses, "ctx", self.num_nodes,
                                   dim, lr=lr, init_scale=1e-4,
                                   seed=seed + 1),
            }
        else:
            init["emb"] = normal(self.num_nodes, dim)
            init["ctx"] = torch.zeros(self.num_nodes, dim)
        self.samples = int((self.cfg.samples or [5])[0])
        if mtype in _EGO:
            if graph is None:
                raise ValueError("ego models need a local graph")
            etype = (self.cfg.sage_etype or
                     (graph.edge_types[0]
                      if getattr(graph, "edge_types", None) else None))
            base = graph[etype] if etype is not None else graph
            self._csc = [_device_csc(base, self.device)]
            if mtype == "ego_sage":
                init["w_self"] = normal(dim, dim)
                init["w_neigh"] = normal(dim, dim)
            elif mtype == "gat":
                # single-head additive attention over the sampled ego
                # (reference Graph4Rec models/layers.py GAT preset)
                init["w"] = normal(dim, dim)
                init["a_l"] = normal(dim)
                init["a_r"] = normal(dim)
            elif mtype == "gin":
                init["gin_eps"] = torch.zeros(())
                init["w1"] = normal(dim, dim)
                init["b1"] = torch.zeros(dim)
                init["w2"] = normal(dim, dim)
                init["b2"] = torch.zeros(dim)
        elif mtype == "gatne":
            # GATNE-T: shared base embedding + per-edge-type edge
            # embeddings aggregated from sampled neighbors, combined with
            # self-attention over edge types
            # (reference user_configs/gatne.yaml surface)
            if graph is None or not getattr(graph, "edge_types", None):
                raise ValueError("gatne needs a local HeterGraph")
            self._csc = [_device_csc(graph[etype], self.device)
                         for etype in graph.edge_types]
            R = len(graph.edge_types)
            de = int(self.cfg.edge_dim or 8)
            da = int(self.cfg.att_dim or 8)
            init["edge_emb"] = normal(self.num_nodes, R, de)
            init["w_att"] = normal(de, da)
            init["v_att"] = normal(da)
            init["w_out"] = normal(de, dim)
        else:
            self._csc = []
        if bool(self.cfg.use_node_feat):
            feats = getattr(graph, "node_feat", None) or {}
            name = self.cfg.feat_name or "h"
            if name not in feats:
                raise ValueError(
                    f"use_node_feat: graph has no node_feat[{name!r}]")
            self._feat = torch.as_tensor(np.asarray(
                feats[name], np.float32)).to(self.device)
            init["w_feat"] = normal(self._feat.shape[1], dim)
        else:
            self._feat = None
        self.params = {k: torch.nn.Parameter(v.to(self.device))
                       for k, v in init.items()}
        self.opt = (torch.optim.Adam(list(self.params.values()),
                                     lr=float(self.cfg.lr or 5e-3))
                    if self.ps is None else None)
        self._seed = seed
        self._generator = torch.Generator(
            device=self.device).manual_seed(seed + 17)

    @classmethod
    def from_preset(cls, name: str, graph=None, client=None,
                    num_nodes: Optional[int] = None, seed: int = 0,
                    ps_addresses=None, device=None,
                    **overrides) -> "Graph4RecTrainer":
        """Instantiate one of the reference's ``user_configs`` recipes by
        name (see :data:`PRESETS`); ``overrides`` patch individual keys."""
        if name not in PRESETS:
            raise ValueError(f"unknown preset {name!r}; "
                             f"have {sorted(PRESETS)}")
        cfg = dict(PRESETS[name])
        cfg.update(overrides)
        return cls(Config(cfg), graph=graph, client=client,
                   num_nodes=num_nodes, seed=seed,
                   ps_addresses=ps_addresses, device=device)

    # -- model --------------------------------------------------------------

    def _node_input(self, p, ids):
        """Base id embedding, plus projected side features when the
        ``*_with_features`` presets set ``use_node_feat``
        (reference graphsage_with_features.yaml / metapath2vec_with_
        features.yaml)."""
        h = p["emb"][ids]
        if self._feat is not None:
            h = h + self._feat[ids] @ p["w_feat"]
        return h

    def _neighbors(self, r, ids, u):
        """Relation ``r``'s padded sample of ``ids`` given the uniforms
        ``u``: (ids [B, k] int64, mask [B, k]); a node without in-edges
        reads a clamped id, which its mask zeroes."""
        indptr, sorted_v = self._csc[r]
        neigh, mask = _neighbors_from_uniforms(indptr, sorted_v, ids, u)
        return neigh.long().clamp(0, self.num_nodes - 1), mask

    def _encode(self, p, ids, uniforms):
        h = self._node_input(p, ids)
        mtype = self.mtype
        if mtype == "walk_based":
            return h
        if mtype == "gatne":
            # per-etype edge embeddings aggregated from that etype's
            # sampled neighbors, attention-combined across etypes
            us = []
            for r, u in enumerate(uniforms):
                neigh, mask = self._neighbors(r, ids, u)
                m = mask.to(h.dtype)
                ne = p["edge_emb"][neigh, r] * m[..., None]
                us.append(ne.sum(1) / m.sum(-1, keepdim=True).clamp(min=1.0))
            U = torch.stack(us, dim=1)                     # [B, R, de]
            att = torch.einsum("bra,a->br",
                               torch.tanh(torch.einsum("brd,da->bra", U,
                                                       p["w_att"])),
                               p["v_att"])
            att = torch.softmax(att, dim=-1)               # [B, R]
            m = torch.einsum("br,brd->bd", att, U)
            return h + m @ p["w_out"]
        neigh, mask = self._neighbors(0, ids, uniforms[0])
        n_in = self._node_input(p, neigh.reshape(-1)).reshape(
            neigh.shape + (-1,))
        if mtype == "gat":
            hw = h @ p["w"]                                 # [B, d]
            nw = n_in @ p["w"]                              # [B, k, d]
            score = F.leaky_relu((hw @ p["a_l"])[:, None] + nw @ p["a_r"],
                                 negative_slope=0.2)        # [B, k]
            score = torch.where(mask, score, torch.full_like(score, -1e9))
            alpha = torch.softmax(score, dim=-1) \
                * mask.any(-1, keepdim=True)
            return F.elu(hw + torch.einsum("bk,bkd->bd", alpha, nw))
        m = mask.to(h.dtype)
        nh = n_in * m[..., None]
        agg_sum = nh.sum(1)
        agg = agg_sum / m.sum(-1, keepdim=True).clamp(min=1.0)
        if mtype == "lightgcn":
            # parameter-free mean of self and aggregated neighbors
            # (reference models/layers.py LightGCN propagation)
            return (h + agg) * 0.5
        if mtype == "gin":
            z = (1.0 + p["gin_eps"]) * h + agg_sum
            z = torch.relu(z @ p["w1"] + p["b1"])
            return z @ p["w2"] + p["b2"]
        return torch.relu(h @ p["w_self"] + agg @ p["w_neigh"])

    def _draws(self, n: int):
        """One step's draws from the trainer's generator: the neighbour
        uniforms (a ``[n, k]`` a relation for gatne, one for the other
        ego models, none for walk_based), then the negatives' permutation
        of ``n * neg_num``."""
        g, dev = self._generator, self.device
        rels = (len(self._csc) if self.mtype == "gatne"
                else int(self.mtype in _EGO))
        uniforms = [torch.rand((n, self.samples), generator=g, device=dev)
                    for _ in range(rels)]
        return uniforms, torch.randperm(n * self.neg_num, generator=g,
                                        device=dev)

    def loss(self, src, dst, valid, uniforms, perm, params=None):
        """The dense step's loss of a batch (device tensors) given its
        draws, differentiable in ``params`` (default: the trainer's)."""
        p = self.params if params is None else params
        h = self._encode(p, src, uniforms)
        return _inbatch_skipgram_loss(h, p["ctx"][dst], perm, self.neg_num,
                                      valid)

    def ps_loss(self, emb_rows, ctx_rows, inv_src, inv_dst, valid, perm):
        """The PS step's loss, a function of the PULLED unique rows
        (``emb_rows``, ``ctx_rows``) and each pair's position in them."""
        return _inbatch_skipgram_loss(emb_rows[inv_src], ctx_rows[inv_dst],
                                      perm, self.neg_num, valid)

    def step(self, bs, bd, valid, draws=None) -> torch.Tensor:
        """One training step on the numpy batch ``(bs, bd, valid)``
        (``draws``: :meth:`_draws`'s, made here when None); returns the
        loss (a device scalar)."""
        uniforms, perm = draws if draws is not None else \
            self._draws(len(bs))
        dev = self.device
        valid_t = torch.as_tensor(valid).to(dev)
        if self.ps is not None:
            u_src, inv_src = np.unique(bs, return_inverse=True)
            u_dst, inv_dst = np.unique(bd, return_inverse=True)
            er = torch.as_tensor(self.ps["emb"].pull(u_src)).to(
                dev).requires_grad_(True)
            cr = torch.as_tensor(self.ps["ctx"].pull(u_dst)).to(
                dev).requires_grad_(True)
            loss = self.ps_loss(er, cr, torch.as_tensor(inv_src).to(dev),
                                torch.as_tensor(inv_dst).to(dev), valid_t,
                                perm)
            g_er, g_cr = torch.autograd.grad(loss, (er, cr))
            self.ps["emb"].push(u_src, g_er.cpu().numpy())
            self.ps["ctx"].push(u_dst, g_cr.cpu().numpy())
            return loss.detach()
        loss = self.loss(torch.as_tensor(bs).to(dev),
                         torch.as_tensor(bd).to(dev), valid_t, uniforms,
                         perm)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    # -- data ---------------------------------------------------------------

    def _walks(self, starts, epoch: int):
        mode = self.cfg.walk_mode or "metapath"
        walk_len = int(self.cfg.walk_len or 12)
        seed = self._seed + epoch
        if self.client is not None:
            if mode != "metapath" or not self.cfg.metapath:
                raise ValueError(
                    "walks over a DistGraphClient are metapath-driven "
                    f"(walk_mode={mode!r}, metapath="
                    f"{self.cfg.metapath!r}); set walk_mode: metapath "
                    "and a metapath in the config")
            return metapath_randomwalk_dist(self.client, starts,
                                            self.cfg.metapath, walk_len,
                                            seed=seed)
        g = self.graph
        if mode == "deepwalk":
            base = g[g.edge_types[0]] if getattr(g, "edge_types", None) \
                else g
            return random_walk(base, starts, walk_len, seed=seed)
        if mode == "node2vec":
            base = g[g.edge_types[0]] if getattr(g, "edge_types", None) \
                else g
            return node2vec_walk(base, starts, walk_len,
                                 p=float(self.cfg.p or 1.0),
                                 q=float(self.cfg.q or 1.0), seed=seed)
        if not getattr(g, "edge_types", None):
            # homogeneous Graph: metapaths don't apply — deepwalk
            return random_walk(g, starts, walk_len, seed=seed)
        return metapath_randomwalk(g, starts, self.cfg.metapath, walk_len,
                                   seed=seed)

    def _start_nodes(self):
        mode = self.cfg.walk_mode or "metapath"
        if mode != "metapath" and self.graph is not None:
            # deepwalk/node2vec start from every node (a typed graph
            # without a metapath has no first node type to start from)
            if not self.cfg.first_node_type:
                return np.arange(self.num_nodes)
        first = self.cfg.first_node_type
        if first is None:
            if not self.cfg.metapath:
                raise ValueError(
                    "need first_node_type or a metapath to pick walk "
                    "start nodes on a typed graph")
            first = str(self.cfg.metapath).split("-")[0].split("2")[0]
        if self.graph is not None and \
                getattr(self.graph, "node_types", None) is not None:
            return self.graph.nodes_by_type(first)
        if self.client is not None:
            return np.asarray(self.client.random_sample_nodes(
                node_type=first, size=int(self.cfg.walk_nodes or 512)))
        return np.arange(self.num_nodes)

    def batches(self, epoch: int):
        """Epoch ``epoch``'s batches ``(src, dst, valid)`` (numpy, each
        ``batch_pairs`` long; the tail zero-padded, ``valid`` masking the
        pads out of the loss): walks from the start nodes, then skip-gram
        pairs, on the host."""
        walks_per_node = int(self.cfg.walks_per_node or 2)
        win = int(self.cfg.win_size or 3)
        bp = int(self.cfg.batch_pairs or 1024)
        starts = np.tile(self._start_nodes(), walks_per_node)
        walks = self._walks(starts, epoch)
        src, dst = skip_gram_gen_pair(walks, win, seed=self._seed + epoch)
        for lo in range(0, max(len(src), 1), bp):
            bs, bd = src[lo:lo + bp], dst[lo:lo + bp]
            if len(bs) == 0:
                break
            valid = np.ones(len(bs), np.float32)
            if len(bs) < bp:
                pad = bp - len(bs)
                bs, bd = np.pad(bs, (0, pad)), np.pad(bd, (0, pad))
                valid = np.pad(valid, (0, pad))
            yield bs, bd, valid

    # -- training -----------------------------------------------------------

    def train(self, epochs: Optional[int] = None) -> float:
        epochs = epochs or int(self.cfg.epochs or 10)
        last = 0.0
        for epoch in range(epochs):
            total, steps = 0.0, 0
            for bs, bd, valid in self.batches(epoch):
                total += float(self.step(bs, bd, valid))
                steps += 1
            last = total / max(steps, 1)
            log.info("graph4rec epoch %d: loss %.4f (%d steps)", epoch,
                     last, steps)
        return last

    def embeddings(self) -> np.ndarray:
        if self.ps is not None:
            self.ps["emb"].flush()
            return self.ps["emb"].dump()
        return self.params["emb"].detach().cpu().numpy()
