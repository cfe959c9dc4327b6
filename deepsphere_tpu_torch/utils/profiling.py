"""Profiling helpers.

`trace` wraps ``torch.profiler`` so a training loop can be profiled with
one line; every model layer runs under a ``torch.profiler`` scope named
``{class}_{key}`` while a profiler records (``HealpyGCNN.forward``), so
per-layer host and device time show in the trace (a Chrome / Perfetto
JSON, viewable at ui.perfetto.dev or chrome://tracing).

    from deepsphere_tpu_torch.utils.profiling import trace
    with trace("/tmp/ds_trace") as prof:
        trainer.train_on_batch(x, y)
    print(prof.trace_path)
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .._logger import logger

__all__ = ["trace", "timed_block"]


@contextlib.contextmanager
def trace(log_dir):
    """Record the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write a Chrome / Perfetto trace
    into ``log_dir``.  Yields the profiler; its ``trace_path`` names the
    file once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
    logger.info(f"Profiler trace written to {path}")


def _sync(target):
    """Synchronise the CUDA card of ``target`` (a tensor, a device, or a
    callable returning either); nothing for a CPU one."""
    if callable(target):
        target = target()
    dev = target.device if isinstance(target, torch.Tensor) else \
        torch.device(target)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed_block(name, sync=None):
    """Wall-clock a block; pass a tensor or a device (or a callable that
    returns one) as ``sync`` to wait for its card to finish before the
    clock stops."""
    t0 = time.time()
    try:
        yield
    finally:
        if sync is not None:
            _sync(sync)
        logger.info(f"[timed] {name}: {(time.time() - t0) * 1e3:.2f} ms")
