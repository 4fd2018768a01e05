"""idle_pct.serve: the share of the traced slice in which no operation ran on
the device: 100 (1 - the union of the device intervals / the slice)."""

from benchmark.harness import readers


def read(record):
    return readers.idle_pct(record)
