"""The traced slice: ``torch.profiler`` over a stretch of the cell's own
traffic, reduced to the device's busy time (the union of the intervals in
which an operation ran), the slice's length, the device time of each
operation, and the longest idle gaps named by what the host was doing.

The profiler records the device's activity alone, so that the cost of
recording every host operation does not show as idle device time.  The
slice is bounded on the device's own clock by two marker launches of the
profiler's spin kernel, one just before the traffic and one after it has
been synchronised.  Naming the idle gaps needs the host's operations: a
second slice of the same traffic, recorded with them (``host=True``),
gives the names and nothing else.

Each slice opens with throwaway launches of the spin kernel, synchronised,
which take the first records that a profiler session in a long-running
process can lose (``sg2im_tpu_torch/utils/timing.py``'s warm-up, copied).
"""

from __future__ import annotations

import bisect
import contextlib

import torch

WARMUP_LAUNCHES = 1024
_SPIN_KERNEL = "spin_kernel"
SPAN_PREFIX = "benchmark."


class Slice:
    """What a traced slice saw: ``window_s`` (device seconds from the
    marker before the traffic to the marker after it), ``busy_s``,
    ``device_ops`` ([(name, seconds)] summed by name), ``kernels`` ([(name,
    seconds)] each device event), ``gaps`` ([(host activity, seconds)] the
    longest idle gaps), ``units`` (the work units that the cell's
    ``drivers/<driver>.py`` ran inside it)."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.device_ops: list = []
        self.kernels: list = []
        self.gaps: list = []
        self.units: list = []


def union_s(intervals) -> tuple[float, list]:
    """(length of the union of [start, end] intervals, the union's
    segments in order); times in microseconds, length in seconds."""
    segs = []
    for a, b in sorted(intervals):
        if segs and a <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], b)
        else:
            segs.append([a, b])
    return sum(b - a for a, b in segs) / 1e6, segs


def _innermost(host, starts, t):
    """The host event running at time t that started last."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 4000, 0) - 1, -1):
        if host[j][1] >= t:
            return host[j][2]
    return "idle host"


def reduce(events, top: int = 10) -> Slice:
    """A :class:`Slice` from a profiler's events: the slice runs from the
    start of the last spin launch but one to the start of the last."""
    cuda = torch.autograd.DeviceType.CUDA
    spins = sorted(e.time_range.start for e in events
                   if e.device_type == cuda and _SPIN_KERNEL in e.name)
    if len(spins) < 2:
        raise RuntimeError("the profiler kept no marker of the traced slice")
    t0, t1 = spins[-2], spins[-1]
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if b < t0 or a > t1:
            continue
        if e.device_type == cuda:
            # The benchmark's own spans also stand on the card's timeline,
            # as ranges over their work: they are no operation.
            if _SPIN_KERNEL not in e.name and not e.name.startswith(
                    SPAN_PREFIX):
                dev.append((max(a, t0), min(b, t1), e.name))
        else:
            host.append((a, b, e.name))
    s = Slice()
    s.window_s = (t1 - t0) / 1e6
    s.busy_s, segs = union_s([(a, b) for a, b, _ in dev])
    s.kernels = [(n, (b - a) / 1e6) for a, b, n in dev]
    by_name: dict[str, float] = {}
    for n, d in s.kernels:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + d
    s.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [t0] + [x for seg in segs for x in seg] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host.sort()
    starts = [h[0] for h in host]
    s.gaps = [(_innermost(host, starts, (a + b) / 2), (b - a) / 1e6)
              for a, b in gaps]
    return s


@contextlib.contextmanager
def traced(device, host: bool = False):
    """Yields a :class:`Slice` that is filled once the block has ended.
    The device's activity alone is recorded, and with ``host`` the host's
    operations too; the block's device work is synchronised before the
    slice closes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize(device)
    s = Slice()
    with profile(activities=activities) as prof:
        with torch.cuda.device(device):
            for _ in range(WARMUP_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
            torch.cuda._sleep(1)
            yield s
            torch.cuda.synchronize(device)
            torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
    done = reduce(prof.events())
    units = s.units
    s.__dict__.update(done.__dict__)
    s.units = units
