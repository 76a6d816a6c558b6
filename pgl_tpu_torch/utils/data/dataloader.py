"""Multiprocess Dataloader (port of ``pgl_tpu/utils/data/dataloader.py``).

Map-style datasets are batched by a :class:`Sampler` and collated by
``collate_fn``; stream datasets are sharded across workers through
``_worker_info``. Worker processes produce collated batches, so the host
work (sampling, subgraph extraction, padding, layouts) runs off the main
process; batches merge unordered through one queue. With no workers the
batches come in the sampler's order, the reference's for a ``seed``.

Workers fork after the parent may have set up CUDA: each takes one torch
thread and refuses a tensor off the CPU, in its items and in its batches
(``utils.mp_reader.check_host``).
"""

from __future__ import annotations

import traceback
from typing import Callable, Iterator, Optional

from .dataset import StreamDataset, WorkerInfo
from .sampler import Sampler, StreamSampler

__all__ = ["Dataloader"]

from ..mp_reader import (_Sentinel, _WorkerError, _mp_context, check_host,
                         merge_worker_queue, worker_setup)


def _default_collate(batch):
    return batch


def _map_worker_loop(dataset, indices_chunks, collate_fn, out_q, fid):
    try:
        worker_setup()
        where = f"Dataloader worker {fid}"
        for chunk in indices_chunks:
            items = check_host([dataset[i] for i in chunk], where)
            out_q.put(check_host(collate_fn(items), where))
    except BaseException:
        out_q.put(_WorkerError(
            f"Dataloader worker {fid} failed:\n{traceback.format_exc()}"))
    finally:
        out_q.put(_Sentinel())


def _stream_worker_loop(dataset, batch_size, drop_last, collate_fn, out_q,
                        fid, num_workers):
    try:
        worker_setup()
        where = f"Dataloader worker {fid}"
        dataset._worker_info = WorkerInfo(fid=fid, num_workers=num_workers)
        sampler = StreamSampler(batch_size, drop_last)
        for batch in sampler.batch_stream(iter(dataset)):
            out_q.put(check_host(collate_fn(check_host(batch, where)),
                                 where))
    except BaseException:
        out_q.put(_WorkerError(
            f"Dataloader worker {fid} failed:\n{traceback.format_exc()}"))
    finally:
        out_q.put(_Sentinel())


class Dataloader:
    """
    Args:
      dataset: a :class:`Dataset` (map-style) or :class:`StreamDataset`.
      batch_size: items per collated batch.
      num_workers: 0 = synchronous in-process; >0 = that many worker
        processes.
      shuffle / drop_last: map-style batching options.
      collate_fn: maps a list of items to a batch object.
      buf_size: bound on TOTAL in-flight batches (one queue shared by
        all workers, not per worker).
      drop_last: stream datasets shard per worker, so with workers each
        worker drops its own partial tail — up to ``num_workers`` partial
        batches vs one in sync mode.
    """

    def __init__(self, dataset, batch_size: int = 1, drop_last: bool = False,
                 shuffle: bool = False, num_workers: int = 0,
                 collate_fn: Optional[Callable] = None, buf_size: int = 64,
                 seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.num_workers = max(int(num_workers), 0)
        self.collate_fn = collate_fn or _default_collate
        self.buf_size = buf_size
        self.seed = seed
        self.is_stream = isinstance(dataset, StreamDataset)
        if self.is_stream and shuffle:
            raise ValueError("shuffle is not supported for StreamDataset")

    # -- synchronous paths --------------------------------------------------

    def _iter_sync_map(self):
        sampler = Sampler(self.dataset, self.batch_size, self.drop_last,
                          self.shuffle, self.seed)
        for chunk in sampler:
            yield self.collate_fn([self.dataset[i] for i in chunk])

    def _iter_sync_stream(self):
        self.dataset._worker_info = WorkerInfo(0, 1)
        sampler = StreamSampler(self.batch_size, self.drop_last)
        for batch in sampler.batch_stream(iter(self.dataset)):
            yield self.collate_fn(batch)

    # -- multiprocess path --------------------------------------------------

    def _iter_workers(self):
        ctx = _mp_context()
        out_q = ctx.Queue(maxsize=max(self.buf_size, 1))
        procs = []
        if self.is_stream:
            for fid in range(self.num_workers):
                p = ctx.Process(
                    target=_stream_worker_loop,
                    args=(self.dataset, self.batch_size, self.drop_last,
                          self.collate_fn, out_q, fid, self.num_workers),
                    daemon=True)
                p.start()
                procs.append(p)
        else:
            sampler = Sampler(self.dataset, self.batch_size, self.drop_last,
                              self.shuffle, self.seed)
            chunks = list(sampler)
            for fid in range(self.num_workers):
                p = ctx.Process(
                    target=_map_worker_loop,
                    args=(self.dataset, chunks[fid::self.num_workers],
                          self.collate_fn, out_q, fid),
                    daemon=True)
                p.start()
                procs.append(p)
        yield from merge_worker_queue(out_q, procs)

    def __iter__(self) -> Iterator:
        if self.num_workers == 0:
            return (self._iter_sync_stream() if self.is_stream
                    else self._iter_sync_map())
        return self._iter_workers()

    def __len__(self):
        if self.is_stream:
            raise TypeError("StreamDataset has no length")
        return len(Sampler(self.dataset, self.batch_size, self.drop_last))
