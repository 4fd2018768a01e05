"""Timing and profiling helpers (counterpart of
``sg2im_tpu/utils/timing.py``, upstream ``sg2im/utils.py:46-92``).

``timeit`` fences with ``torch.cuda.synchronize`` as upstream does
(``utils.py:63-73``); ``get_device_memory`` reads the caching allocator's
``torch.cuda.memory_stats``; ``profile_trace`` writes a ``torch.profiler``
Chrome trace where the JAX package wrote a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timeit(msg: str, should_time: bool = True):
    """Print the elapsed ms of a block, the card synchronised on entry and
    exit (reference ``timeit``).  Yields a dict whose ``'ms'`` holds the
    time once the block is done."""
    box = {}
    if not should_time:
        yield box
        return
    _sync()
    t0 = time.perf_counter()
    yield box
    _sync()
    box["ms"] = (time.perf_counter() - t0) * 1000.0
    print(f"{msg}: {box['ms']:.2f}ms")


def get_device_memory(device=None) -> dict:
    """The card's allocator statistics in MB (``torch.cuda.memory_stats``,
    the counterpart of the reference's ``get_gpu_memory``); {} without a
    card."""
    if not torch.cuda.is_available():
        return {}
    scale = 1.0 / (1024 * 1024)
    return {k: v * scale
            for k, v in torch.cuda.memory_stats(device).items()
            if k.endswith("bytes.all.current") or k.endswith("bytes.all.peak")}


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` over the block (the host and, when there is a
    card, its kernels), written as a Chrome trace to
    ``<log_dir>/trace.json``; a no-op when ``log_dir`` is None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class LossManager:
    """Weighted loss accumulator (reference ``sg2im/utils.py:76-92``)."""

    def __init__(self):
        self.total_loss = None
        self.all_losses = {}

    def add_loss(self, loss, name, weight: float = 1.0):
        cur = loss * weight
        self.total_loss = cur if self.total_loss is None \
            else self.total_loss + cur
        self.all_losses[name] = float(cur)

    def items(self):
        return self.all_losses.items()
