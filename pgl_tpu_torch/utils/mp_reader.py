"""Multiprocess reader merge (port of ``pgl_tpu/utils/mp_reader.py``).

``multiprocess_reader`` fans a list of generator factories out to worker
processes and merges their outputs unordered through one queue; the
sentinel, merge and clean-up machinery here is shared with
``utils.data.Dataloader``. ``merge_worker_queue`` detects a worker that
died without finishing (killed, or crashed in native code) instead of
blocking for ever.

Workers fork. The parent may already hold a CUDA context and torch's
thread pools, so a worker sets torch to one intra-op thread when torch is
loaded, and refuses any tensor that is not on the CPU, in what it reads
and in what it sends (:func:`check_host`): a forked child cannot use the
parent's CUDA context, and a clear error beats a hang.
"""

from __future__ import annotations

import multiprocessing as mp
import sys
import traceback
from typing import Callable, Iterator, List

__all__ = ["multiprocess_reader", "merge_worker_queue", "check_host"]


class _Sentinel:
    """End-of-stream marker. A dedicated type (not a magic string) so a
    reader legitimately yielding strings can never terminate the merge
    early."""


class _WorkerError(RuntimeError):
    """Wrapper for a worker's own failure — distinguishes it from a
    reader that legitimately yields Exception objects as data items."""


def _mp_context():
    """fork where available (readers are usually closures the spawn
    pickler can't ship); spawn as the fallback on platforms without it."""
    try:
        return mp.get_context("fork")
    except ValueError:
        return mp.get_context("spawn")


def check_host(obj, where: str = "a worker"):
    """Raise on a torch tensor off the CPU anywhere in ``obj`` (through
    tuples, lists and dict values); returns ``obj``."""
    torch = sys.modules.get("torch")
    if torch is None:
        return obj
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                raise RuntimeError(
                    f"{where} got a tensor on {x.device}: a forked worker "
                    "cannot use the parent's device; build numpy arrays "
                    "(or CPU tensors) in the dataset and collate, and move "
                    "the batch to the device in the main process")
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return obj


def worker_setup():
    """What a forked worker does first: one intra-op thread for torch
    (the parent's pool does not survive the fork)."""
    torch = sys.modules.get("torch")
    if torch is not None:
        torch.set_num_threads(1)


def _worker(reader, out_q, idx):
    try:
        worker_setup()
        for item in reader():
            out_q.put(check_host(item, f"reader {idx}"))
    except BaseException:
        out_q.put(_WorkerError(
            f"reader {idx} failed:\n{traceback.format_exc()}"))
    finally:
        out_q.put(_Sentinel())


def merge_worker_queue(out_q, procs, poll_s: float = 1.0) -> Iterator:
    """Yield items from ``out_q`` until every process has posted its
    sentinel. Detects abnormal worker death (OOM-kill, segfault — a dead
    process that never reached its finally) instead of blocking forever,
    and cleans up terminate-then-join so no zombies remain."""
    import queue as queue_mod

    done = 0
    try:
        while done < len(procs):
            try:
                item = out_q.get(timeout=poll_s)
            except queue_mod.Empty:
                dead = [p for p in procs
                        if not p.is_alive() and p.exitcode not in (0, None)]
                if dead and out_q.empty():
                    raise RuntimeError(
                        f"{len(dead)} worker(s) died abnormally "
                        f"(exitcodes {[p.exitcode for p in dead]}) "
                        "without finishing — likely OOM-killed or "
                        "crashed in native code")
                continue
            if isinstance(item, _Sentinel):
                done += 1
                continue
            if isinstance(item, _WorkerError):
                raise item
            yield item
    finally:
        # workers may be blocked on a full queue: terminate first, then
        # join (join-first guaranteed a 5 s timeout per blocked worker)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5)


def multiprocess_reader(readers: List[Callable[[], Iterator]],
                        queue_size: int = 1000) -> Iterator:
    """Run each no-arg generator factory in its own process; yield merged
    results as they arrive (unordered, like the reference)."""
    ctx = _mp_context()
    out_q = ctx.Queue(maxsize=queue_size)
    procs = [ctx.Process(target=_worker, args=(r, out_q, i), daemon=True)
             for i, r in enumerate(readers)]
    for p in procs:
        p.start()
    yield from merge_worker_queue(out_q, procs)
