"""Dataset abstractions (port of ``pgl_tpu/utils/data/dataset.py``).

``Dataset`` (map-style), ``StreamDataset`` (iterable, sharded across
workers through ``_worker_info``), ``HadoopDataset`` (the lines of an HDFS
path, through the ``hadoop`` client; a clear error when there is none).
"""

from __future__ import annotations

import subprocess
from typing import Iterator, Optional

__all__ = ["Dataset", "StreamDataset", "HadoopDataset", "WorkerInfo"]


class WorkerInfo:
    """Identifies a dataloader worker: ``fid`` in ``[0, num_workers)``."""

    def __init__(self, fid: int = 0, num_workers: int = 1):
        self.fid = int(fid)
        self.num_workers = int(num_workers)

    def __repr__(self):
        return f"WorkerInfo(fid={self.fid}, num_workers={self.num_workers})"


class Dataset:
    """Map-style dataset: implement ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class StreamDataset:
    """Iterable dataset; implement ``__iter__``.

    Inside a multi-worker Dataloader each worker receives a ``_worker_info``
    attribute; use it to shard the stream (every ``num_workers``-th element
    starting at ``fid``), exactly the reference contract
    (``dataset.py:109-112``).
    """

    _worker_info: WorkerInfo = WorkerInfo()

    def __iter__(self) -> Iterator:
        raise NotImplementedError

    def _shard_iter(self, iterable) -> Iterator:
        """Helper: yield this worker's share of an iterable."""
        info = self._worker_info
        for i, item in enumerate(iterable):
            if i % info.num_workers == info.fid:
                yield item


class HadoopDataset(StreamDataset):
    """Stream lines of HDFS files, sharded across workers
    (reference ``dataset.py:115``)."""

    def __init__(self, path: str, hadoop_bin: str = "hadoop"):
        self.path = path
        self.hadoop_bin = hadoop_bin

    def _line_stream(self):
        try:
            proc = subprocess.Popen(
                [self.hadoop_bin, "fs", "-cat", self.path],
                stdout=subprocess.PIPE)
        except FileNotFoundError as e:
            raise RuntimeError(
                f"hadoop client {self.hadoop_bin!r} not found; "
                "HadoopDataset requires an hdfs client on PATH") from e
        assert proc.stdout is not None
        try:
            for line in proc.stdout:
                yield line
            rc = proc.wait()
            if rc != 0:
                # an empty stream with a nonzero exit would otherwise
                # look like an empty dataset
                raise RuntimeError(
                    f"{self.hadoop_bin} fs -cat {self.path} exited "
                    f"with code {rc}")
        finally:
            # abandoned generator (early break): kill the client so it
            # doesn't linger blocked on a full pipe
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def __iter__(self):
        yield from self._shard_iter(self._line_stream())
