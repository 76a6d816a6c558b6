"""Index batching (port of ``pgl_tpu/utils/data/sampler.py``): the same
numpy shuffle, so a ``seed`` gives the reference's batches."""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

__all__ = ["Sampler", "StreamSampler"]


class Sampler:
    """Yields index batches over a map-style dataset."""

    def __init__(self, dataset, batch_size: int = 1, drop_last: bool = False,
                 shuffle: bool = False, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[List[int]]:
        n = len(self.dataset)
        perm = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(perm)
        batch = []
        for idx in perm:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else (n + self.batch_size - 1) // self.batch_size


class StreamSampler:
    """Groups a stream dataset's items into batches of ``batch_size``."""

    def __init__(self, batch_size: int = 1, drop_last: bool = False):
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def batch_stream(self, iterator) -> Iterator[List]:
        batch = []
        for item in iterator:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch
