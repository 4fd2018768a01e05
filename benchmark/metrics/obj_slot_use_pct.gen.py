"""obj_slot_use_pct.gen: the real objects (with '__image__') of the first
traced slice's engine calls over the object slots their forwards ran on
(padded rows x padded objects), in percent: the share of the GCN's and
heads' work that is not padding.  A count, not a time."""

from benchmark.harness import spans


def read(record):
    calls = spans.first_slice(record)
    if not calls:
        return None
    return (100.0 * sum(c["objects"] for c in calls)
            / sum(c["obj_slots"] for c in calls))
