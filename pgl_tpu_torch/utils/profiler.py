"""Profiling helpers (port of ``pgl_tpu/utils/profiler.py``): a
``torch.profiler`` trace written as a Chrome trace, and a stage timer whose
report prints per-stage totals in the reference's format.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

from .logger import log

__all__ = ["StageTimer", "trace", "annotate"]


def _synchronize(value):
    """Wait for the CUDA devices that hold ``value`` (a tensor, or nested
    dicts, lists and tuples of them) to finish their queued work."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _synchronize(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _synchronize(v)


class StageTimer:
    """Accumulating wall-clock stage timer.

    with timer.stage("sample"): ...
    with timer.stage("train", sync_value=loss):  ...
    timer.report()
    """

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        """Time the block as stage ``name``; with ``sync`` and a
        ``sync_value``, after waiting for its CUDA device."""
        t0 = time.perf_counter()
        yield
        if self.sync and sync_value is not None:
            _synchronize(sync_value)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self, reset: bool = False) -> Dict[str, float]:
        """Log each stage's total seconds, calls and mean ms; returns the
        totals."""
        out = dict(self.totals)
        for name in sorted(out):
            n = self.counts[name]
            log.info("stage %-16s total %8.3fs  calls %6d  avg %8.3fms",
                     name, out[name], n, out[name] / max(n, 1) * 1000)
        if reset:
            self.totals.clear()
            self.counts.clear()
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` over the CPU and, where
    there is one, the CUDA card, and write a Chrome trace (``chrome://
    tracing``, Perfetto) into ``log_dir``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


annotate = torch.profiler.record_function
