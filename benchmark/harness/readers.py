"""Arithmetic that several metric readers share.  A reader takes the run's
record (:class:`benchmark.run.Record`) and returns a number, or None where
the run gives it nothing to read: the harness then leaves the metric out.
"""

from __future__ import annotations

import math

from benchmark.harness import files


def rate(record) -> float:
    """Images of the window over its seconds."""
    return record.window["images"] / record.window["seconds"]


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of every value."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def idle_pct(record):
    s = record.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu_pct(record):
    """The window's matmul and convolution FLOPs, counted on the
    reference, at each type's published peak, as a share of the window."""
    if record.peak_s is None:
        return None
    return 100.0 * record.peak_s / record.window["seconds"]


def kernel_roofline_pct(record):
    """Sum over the hand kernels launched in the traced slice of their
    least time for the slice's work, over the sum of their device time.
    A kernel with no device event in the slice adds neither."""
    s = record.slice
    if s is None:
        return None
    bound = spent = 0.0
    for k in files.kernels(record.bench_dir):
        t = sum(d for name, d in s.kernels if k.NAME in name)
        if t <= 0:
            continue
        b = [k.bound_s(u, record.cfg) for u in s.units]
        if any(x is None for x in b):
            continue
        bound += sum(b)
        spent += t
    return 100.0 * bound / spent if spent > 0 else None


def launches_per_unit(record):
    """Kernels (copies and fills left out) in the slice per unit."""
    s = record.slice
    if s is None or not s.units:
        return None
    n = sum(1 for name, _ in s.kernels
            if not name.startswith(("Memcpy", "Memset")))
    return n / len(s.units)
