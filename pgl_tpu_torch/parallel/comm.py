"""Process groups and the collectives of the parallel layer, on
``torch.distributed``.

Port of ``_exchange_halo`` (``pgl_tpu/parallel/halo_graph.py:65-82``) and
of ``multihost.initialize`` (``pgl_tpu/parallel/multihost.py:34-52``). The
reference is one program over a device mesh; the port is one process a
rank, each holding its own shard, and a process group takes the place of
the mesh axis.

* :func:`init` joins (or reuses) the default process group: NCCL for a
  CUDA device, gloo for the CPU, unless ``backend=`` says otherwise.
* :func:`rank_device` is a rank's device: ``cuda:{LOCAL_RANK %
  device_count()}`` by default, raising without a card.
* :func:`halo_exchange` is the boundary exchange every halo op shares, an
  autograd ``Function``: forward gathers this rank's send rows and moves
  them by one ``all_to_all_single`` with equal splits (in the optional wire
  dtype, cast back after); backward moves the cotangents back by the same
  all-to-all and sums each owned row's returned slots with K1 over a
  layout built once per graph (``ops/kernels/segment_kernels.py``): a
  fixed order, so two runs give the same gradient bits (``index_add_``'s
  atomics would not).
* :func:`all_reduce_sum` and :func:`all_reduce_extreme` are the
  differentiable all-reduces of ``ShardedGraph``. Their backward all-reduces
  the cotangents (sum): the global loss is the sum of the ranks' losses, so
  a loss that every rank computes whole on replicated values is divided by
  the world size by the caller.

Every collective is the ``torch.distributed`` call on the tensors as they
are: gloo takes CUDA tensors itself (it copies them through host memory),
so several ranks can share one card. A failed call raises, naming the
backend and the call.

Under ``torch.export`` or ``torch.compile`` (``dispatch.traced``) the
equal-split all-to-all (the halo exchange's) and the all-reduces are the
custom ops ``torch.ops.pgl_tpu_torch.all_to_all`` and ``::all_reduce``
(functional: an in-place all-reduce copies the op's result back), so an
exported ``HaloGraph`` or ``ShardedGraph`` function records its
collectives (``utils/export.py``). Each op takes the world size it was
traced in and raises when run in a world of another size; its
implementation is the eager call on the default (world) group, which a
fresh serving process joins by ``init``, and its fake one returns the
shape. These are the port's own ops, not PyTorch's functional collectives:
those name their group by a string that a fresh process must register
again, where the world group is found by ``init`` alone, and the eager
call keeps ``STATS`` and ``TIMING``. A collective on a group other than
the world raises under a trace, as do ``all_to_all_v`` and
``all_gather``, which no inference path runs. ``STATS`` counts the
exchanges (``calls``, ``bytes`` sent by this rank) and the all-reduces
(``allreduce_calls``, ``allreduce_bytes``); with ``TIMING`` set, each
all-to-all and all-reduce of a CUDA tensor is timed on the host clock
between two ``torch.cuda.synchronize()`` calls (``seconds``,
``allreduce_seconds``).
"""

from __future__ import annotations

import datetime
import os
import time
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.dispatch import traced

__all__ = ["init", "rank_device", "world", "halo_exchange",
           "all_to_all", "all_to_all_v", "all_reduce_sum",
           "all_reduce_extreme", "all_reduce_", "all_gather", "STATS",
           "TIMING", "DEFAULT_TIMEOUT"]

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)
STATS: Counter = Counter()
# time every all-to-all on the host clock, synchronized (off: no syncs)
TIMING = False


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` if given, else the card
    ``cuda:{LOCAL_RANK % device_count()}``; raises when a card is asked for
    and there is none (no silent CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run a rank on the CPU")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        return torch.device(f"cuda:{local % torch.cuda.device_count()}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def init(backend: Optional[str] = None, device=None,
         init_method: str = "env://", world_size: Optional[int] = None,
         rank: Optional[int] = None, timeout=DEFAULT_TIMEOUT):
    """Join the default process group and return it; a no-op that returns
    it when one exists. ``backend`` defaults to ``"nccl"`` when this rank's
    device (:func:`rank_device`) is a card and ``"gloo"`` otherwise; the
    rendezvous is ``init_method`` (``env://`` reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets
    them), and every collective waits at most ``timeout``."""
    if dist.is_initialized():
        return dist.group.WORLD
    if backend is None:
        backend = "nccl" if rank_device(device).type == "cuda" else "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timeout, **kwargs)
    return dist.group.WORLD


def world(group=None):
    """``(group, size, rank)`` for ``group`` (default: the world); raises
    when no process group has been initialised."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "pgl_tpu_torch.parallel.comm.init() first")
    group = group if group is not None else dist.group.WORLD
    return group, dist.get_world_size(group), dist.get_rank(group)


def _untraced(x: torch.Tensor, what: str):
    """Raise where ``x`` is a tracer's stand-in: ``all_to_all_v`` and
    ``all_gather`` have no op (no inference path runs them)."""
    if traced(x):
        raise NotImplementedError(
            f"{what} under torch.export / torch.compile: only the "
            "equal-split all_to_all (the halo exchange) and the all-reduces "
            "are traceable collectives")


def _traced_world(group, what: str) -> int:
    """The world size a traced collective records; raises for a group
    other than the world, which a serving process could not find again."""
    if group is not dist.group.WORLD:
        raise NotImplementedError(
            f"{what} on a process group other than the world under "
            "torch.export / torch.compile: an exported program runs its "
            "collectives on the world group of the serving processes")
    return dist.get_world_size()


def _check_world(world_size: int, what: str):
    """Raise unless this process's world has ``world_size`` ranks (an
    exported collective run in another world)."""
    _, size, _ = world()
    if size != world_size:
        raise RuntimeError(f"{what} traced in a world of {world_size} ranks "
                           f"runs in one of {size}")


@torch.library.custom_op("pgl_tpu_torch::all_to_all", mutates_args=())
def _all_to_all_op(x: torch.Tensor, world_size: int) -> torch.Tensor:
    """The equal-split ``all_to_all`` on the world group as an operator."""
    _check_world(world_size, "all_to_all")
    return all_to_all(x)


@_all_to_all_op.register_fake
def _all_to_all_op_fake(x, world_size):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


@torch.library.custom_op("pgl_tpu_torch::all_reduce", mutates_args=())
def _all_reduce_op(x: torch.Tensor, op: str, world_size: int) -> torch.Tensor:
    """A functional all-reduce (``op`` "sum", "max" or "min") on the world
    group as an operator: the reduced copy of ``x``."""
    _check_world(world_size, "all_reduce")
    return all_reduce_(x.clone(), _REDUCE_OPS[op])


@_all_reduce_op.register_fake
def _all_reduce_op_fake(x, op, world_size):
    return torch.empty_like(x)


def _op_name(op) -> str:
    for name, value in _REDUCE_OPS.items():
        if op == value:
            return name
    raise NotImplementedError(f"all_reduce {op} under torch.export / "
                              "torch.compile: sum, max and min are traceable")


def _call(op, group, what: str):
    """``op()``, a collective on ``group``; the error names the backend and
    the call."""
    try:
        op()
    except Exception as err:   # re-raised with the backend and the call
        raise RuntimeError(f"{what} on a {dist.get_backend(group)} group "
                           f"of {dist.get_world_size(group)} ranks failed: "
                           f"{err}") from err


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_to_all_single`` with equal splits of ``x``'s rows: block j of
    ``x`` goes to rank j, block j of the result came from rank j."""
    group, size, _ = world(group)
    if traced(x):
        return _all_to_all_op(x, _traced_world(group, "all_to_all"))
    x = x.contiguous()
    out = torch.empty_like(x)
    timed = TIMING and x.device.type == "cuda"
    if timed:
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
    _call(lambda: dist.all_to_all_single(out, x, group=group), group,
          "all_to_all_single")
    if timed:
        torch.cuda.synchronize(x.device)
        STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes"] += x.numel() * x.element_size()
    return out


def all_to_all_v(x: torch.Tensor, send_counts, recv_counts,
                 group=None) -> torch.Tensor:
    """``all_to_all_single`` with uneven splits: ``send_counts[j]`` rows of
    ``x`` (in rank order) go to rank j, ``recv_counts[j]`` come from it."""
    group, _, _ = world(group)
    _untraced(x, "all_to_all_single")
    x = x.contiguous()
    send_counts = [int(c) for c in send_counts]
    recv_counts = [int(c) for c in recv_counts]
    out = x.new_empty((sum(recv_counts),) + tuple(x.shape[1:]))
    _call(lambda: dist.all_to_all_single(out, x, recv_counts, send_counts,
                                         group=group), group,
          "all_to_all_single")
    return out


def all_reduce_(x: torch.Tensor, op=dist.ReduceOp.SUM,
                group=None) -> torch.Tensor:
    """In-place all-reduce of ``x`` (no gradient)."""
    group, _, _ = world(group)
    if traced(x):
        return x.copy_(_all_reduce(x, op, group))
    timed = TIMING and x.device.type == "cuda"
    if timed:
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
    _call(lambda: dist.all_reduce(x, op=op, group=group), group,
          "all_reduce")
    if timed:
        torch.cuda.synchronize(x.device)
        STATS["allreduce_seconds"] += time.perf_counter() - t0
    STATS["allreduce_calls"] += 1
    STATS["allreduce_bytes"] += x.numel() * x.element_size()
    return x


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``[size, *x.shape]``: every rank's ``x``, stacked in rank order (no
    gradient). Every rank's ``x`` has the same shape."""
    group, size, _ = world(group)
    _untraced(x, "all_gather")
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    _call(lambda: dist.all_gather(parts, x, group=group), group,
          "all_gather")
    return torch.stack(parts)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, owned, send_idx, back_layout, group, wire_dtype):
        ctx.meta = (back_layout, group, wire_dtype, owned.shape[0])
        send = owned.index_select(0, send_idx)
        return _wire(send, group, wire_dtype)

    @staticmethod
    def backward(ctx, g):
        from ..ops.kernels.segment_kernels import _spmm_one
        back_layout, group, wire_dtype, n_owned = ctx.meta
        back = _wire(g.contiguous(), group, wire_dtype)
        flat = back.reshape(back.shape[0], -1).contiguous()
        # owned row <- its real send slots, in a fixed order (K1)
        out = _spmm_one(flat, back_layout)
        return (out.reshape((n_owned,) + tuple(g.shape[1:])), None, None,
                None, None)


def _wire(x: torch.Tensor, group, wire_dtype) -> torch.Tensor:
    """``all_to_all`` of ``x`` in ``wire_dtype`` (a floating ``x`` only),
    cast back to ``x``'s dtype."""
    if (wire_dtype is not None and x.is_floating_point()
            and x.dtype != wire_dtype):
        return all_to_all(x.to(wire_dtype), group).to(x.dtype)
    return all_to_all(x, group)


def halo_exchange(owned: torch.Tensor, send_idx: torch.Tensor, back_layout,
                  group=None, wire_dtype=None) -> torch.Tensor:
    """``[S·H_pad, ...]``: rank p's rows ``owned[send_idx_p[r]]`` land in
    block p of rank r's result (``send_idx`` is this rank's ``[S·H_pad]``
    send table). The gradient returns each block to its sender and sums the
    slots into the owned rows over ``back_layout`` (rows: this rank's owned
    rows; gathers: the real slots of the returned buffer)."""
    group, _, _ = world(group)
    return _HaloExchange.apply(owned, send_idx, back_layout, group,
                               wire_dtype)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """The all-reduced copy of ``x``: the op under a trace, else an
    in-place all-reduce of a clone."""
    if traced(x):
        return _all_reduce_op(x, _op_name(op),
                              _traced_world(group, "all_reduce"))
    return all_reduce_(x.clone(), op=op, group=group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), group=ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` summed, on every rank; the cotangents are summed
    the same way in the backward."""
    group, _, _ = world(group)
    return _AllReduceSum.apply(x, group)


class _AllReduceExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, counts, op, group):
        out = _all_reduce(x, op, group)
        mine = torch.where(x == out, counts.to(x.dtype),
                           torch.zeros_like(x))
        total = _all_reduce(mine, dist.ReduceOp.SUM, group)
        ctx.group = group
        ctx.save_for_backward(torch.where(
            total > 0, mine / total.clamp(min=1), torch.zeros_like(mine)))
        return out

    @staticmethod
    def backward(ctx, g):
        (share,) = ctx.saved_tensors
        g = all_reduce_(g.clone(), group=ctx.group)
        return g * share, None, None, None


def all_reduce_extreme(x: torch.Tensor, reduce_op: str,
                       counts: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max (``"max"``) or min (``"min"``) of the ranks' ``x``.

    The gradient (the summed cotangents) is shared over the ranks whose
    ``x`` holds the extreme, in proportion to ``counts`` (``x``'s shape:
    how many tied terms each rank's ``x`` stands for, e.g. its in-edges
    whose message equals the extreme). An element whose ranks all count 0
    gets no gradient. A max with no gradient is ``all_reduce_`` alone."""
    group, _, _ = world(group)
    op = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[reduce_op]
    return _AllReduceExtreme.apply(x, counts, op, group)
