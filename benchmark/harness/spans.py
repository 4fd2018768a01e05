"""The program's own spans of a traced run (``sg2im_tpu_torch.utils.timing``:
recorded in memory while a ``torch.profiler`` session is active), for the
readers of the engine's and the server's host time and counts.

``run.py`` traces the slice that records the device alone first and the
slice with the host's operations second, on the same traffic; the window
runs with the spans off.  So the store ends with the two slices' spans, in
the order they ended, and the first slice's are read: the second's host
times are inflated by the recording of every host operation.  A program
without the store, or a store without the spans, gives None.
"""

from __future__ import annotations

import statistics

GENERATE = "sg2im.engine.generate"
PARTS = {"encode": "sg2im.engine.encode", "forward": "sg2im.model.forward",
         "fetch": "sg2im.engine.fetch"}
QUEUE = "sg2im.serve.queue"


def store() -> list:
    """Every span the program has recorded in this process, or []."""
    from sg2im_tpu_torch.utils import timing

    read = getattr(timing, "recorded_spans", None)
    return read() if read is not None else []


def generate_calls(record, spans=None) -> list[dict] | None:
    """The two traced slices' engine calls, in order, each {'ms': the
    call, 'encode', 'forward', 'fetch': its parts, 'self': the call less
    its parts (ms), 'objects', 'obj_slots'}: the store's last 2n calls,
    n the traffic's ``trace_units`` (earlier runs in the process come
    before them); None with fewer."""
    n = record.traffic.get("trace_units")
    spans = store() if spans is None else spans
    gens = [s for s in spans if s.name == GENERATE]
    if not n or len(gens) < 2 * n:
        return None
    both = gens[-2 * n:]
    parts = {g.id: dict.fromkeys(PARTS, 0.0) for g in both}
    names = {v: k for k, v in PARTS.items()}
    for s in spans:
        if s.parent in parts and s.name in names:
            parts[s.parent][names[s.name]] += s.ms
    calls = []
    for g in both:
        c = dict(parts[g.id], ms=g.ms, objects=g.attrs["objects"],
                 obj_slots=g.attrs["obj_slots"])
        c["self"] = g.ms - sum(c[k] for k in PARTS)
        calls.append(c)
    return calls


def first_slice(record) -> list[dict] | None:
    """:func:`generate_calls` of the first slice alone."""
    calls = generate_calls(record)
    return calls[:len(calls) // 2] if calls else None


def median_part(record, part: str):
    """The median over the first slice's calls of one part's ms."""
    calls = first_slice(record)
    return None if not calls else statistics.median(c[part] for c in calls)


def queue_waits_ms() -> list[float] | None:
    """The first traced slice's request waits in the server's queue (ms).
    The serve driver's two slices offer the same arrivals, so each queues
    as many requests: the first is the store's first half.  The store must
    hold this run's spans alone, as it does where a process runs one
    cell."""
    q = [s for s in store() if s.name == QUEUE]
    return [s.ms for s in q[:len(q) // 2]] or None
