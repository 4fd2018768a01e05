"""Timing and profiling helpers (counterpart of
``sg2im_tpu/utils/timing.py``, upstream ``sg2im/utils.py:46-92``).

``timeit`` fences with ``torch.cuda.synchronize`` as upstream does
(``utils.py:63-73``); ``get_device_memory`` reads the caching allocator's
``torch.cuda.memory_stats``; ``profile_trace`` writes a ``torch.profiler``
Chrome trace where the JAX package wrote a ``jax.profiler`` one.

Spans (:func:`span`, :func:`record_span`) time the host's parts of the
engine and the server's batcher.  They record only while a
``torch.profiler`` session is active (torch's own flag,
``torch.autograd.profiler._is_profiler_enabled``, which every session
sets, whatever its activities): off, a span is one check of that flag.
On, each span appends a :class:`Span` (name, id, parent id, start and
end in ns, attrs) to a bounded store in memory, read by
:func:`recorded_spans`.  Start and end are ``time.time_ns()``, the clock
that the profiler stamps its host events with (``trace_start_ns()`` plus
an event's ``time_range``), so spans can be laid against a trace.  They
stay out of the profiler's own trace: a ``record_function`` range would
also stand on the device's timeline, over the gaps between kernels.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler


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


# In a process that has run for a while, torch.profiler (Kineto over CUPTI)
# can lose the first device records of a session: all three launches of a
# short window, or a generate's first kernels.  Throwaway launches of the
# spin kernel at the window's start, synchronized before the block, take
# that loss; the window's records leave them out.
PROFILE_WARMUP_LAUNCHES = 1024
_WARMUP_KERNEL = "spin_kernel"
_BLOCK = "profile_window.block"


class ProfileWindow:
    """What :func:`profile_window` saw: ``prof`` (the ``torch.profiler``
    session), and once the block is done ``device_events`` and
    ``host_events`` (the block's records, the warm-up left out) and
    ``warmup_lost`` (the warm-up launches the profiler lost)."""

    def __init__(self, prof):
        self.prof = prof
        self.device_events: list = []
        self.host_events: list = []
        self.warmup_lost = 0


@contextlib.contextmanager
def profile_window(device=None, strict: bool = True):
    """``torch.profiler`` over the block: the host, and the card's kernels
    when ``device`` is a card, where the window opens with
    PROFILE_WARMUP_LAUNCHES synchronized spin launches that take the
    records a long-running process loses.  Yields a
    :class:`ProfileWindow`; raises RuntimeError after the block when the
    profiler lost every warm-up launch (the block's own records may then
    be missing), or with ``strict`` False warns."""
    import warnings

    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        window = ProfileWindow(prof)
        if on_card:
            with torch.cuda.device(device):
                for _ in range(PROFILE_WARMUP_LAUNCHES):
                    torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
        with record_function(_BLOCK):
            yield window
        if on_card:
            torch.cuda.synchronize(device)
    if not on_card:
        window.host_events = [e for e in prof.events() if e.name != _BLOCK]
        return
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    marks = [e.time_range.start for e in events if e.name == _BLOCK]
    start = marks[0] if marks else float("-inf")
    # The block's marker also stands on the card's timeline, as a range.
    device_events = [e for e in events
                     if e.device_type == cuda and e.name != _BLOCK]
    window.device_events = [e for e in device_events
                            if _WARMUP_KERNEL not in e.name]
    window.host_events = [e for e in events if e.device_type != cuda
                          and e.name != _BLOCK
                          and e.time_range.start >= start]
    window.warmup_lost = PROFILE_WARMUP_LAUNCHES - (
        len(device_events) - len(window.device_events))
    if window.warmup_lost >= PROFILE_WARMUP_LAUNCHES:
        msg = ("torch.profiler lost every warm-up launch of the window: "
               "its records may miss the block's first kernels")
        if strict:
            raise RuntimeError(msg)
        warnings.warn(msg)


@contextlib.contextmanager
def profile_trace(log_dir: str | None, device=None):
    """``torch.profiler`` over the block (the host and, on a card
    ``device``, its kernels, through :func:`profile_window`), written as a
    Chrome trace to ``<log_dir>/trace.json``; a no-op when ``log_dir`` is
    None."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    with profile_window(device, strict=False) as window:
        yield window.prof
    window.prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


SPAN_STORE = 65536  # spans kept; the oldest go first


class Span(collections.namedtuple(
        "Span", "name id parent start_ns end_ns attrs")):
    """One recorded span: ``parent`` is the id of the span open around it
    on its thread (None at the top), ``attrs`` its counters."""

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_spans: collections.deque = collections.deque(maxlen=SPAN_STORE)
_span_ids = itertools.count()
_open = threading.local()


def spans_on() -> bool:
    """Whether spans record: a ``torch.profiler`` session is active."""
    return _profiler._is_profiler_enabled


_OFF = contextlib.nullcontext()  # what span() returns while spans are off


class _On:
    """An open span: ``attrs`` takes its counters until it ends."""

    __slots__ = ("name", "id", "parent", "start_ns", "attrs")

    def __init__(self, name: str):
        self.name, self.attrs = name, {}

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_span_ids)
        stack.append(self.id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.stack.pop()
        _spans.append(Span(self.name, self.id, self.parent, self.start_ns,
                           end, self.attrs))
        return False


def span(name: str):
    """A span over the block, recorded only while spans are on (see the
    module docstring).  Yields None when off, else the open span, whose
    ``attrs`` dict the block may fill::

        with span("sg2im.engine.generate") as s:
            ...
            if s:
                s.attrs["objects"] = n
    """
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def record_span(name: str, start_ns: int, end_ns: int) -> None:
    """Record a span whose ends were stamped elsewhere (``time.time_ns()``
    while spans were on), such as a request's wait that starts on one
    thread and ends on another; a top-level span with no attrs, and only
    while spans are on."""
    if _profiler._is_profiler_enabled:
        _spans.append(Span(name, next(_span_ids), None, start_ns, end_ns,
                           {}))


def recorded_spans() -> list[Span]:
    """A copy of the store, in the order the spans ended."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()


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
