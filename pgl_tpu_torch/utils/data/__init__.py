"""Data pipeline: datasets, samplers, multiprocess dataloader (port of
``pgl_tpu/utils/data/``)."""

from .dataset import Dataset, StreamDataset, HadoopDataset, WorkerInfo
from .sampler import Sampler, StreamSampler
from .dataloader import Dataloader

__all__ = ["Dataset", "StreamDataset", "HadoopDataset", "WorkerInfo",
           "Sampler", "StreamSampler", "Dataloader"]
