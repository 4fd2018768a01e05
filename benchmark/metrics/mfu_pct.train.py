"""mfu_pct.train: the window's matmul and convolution FLOPs, counted on the
reference at the cell's shapes, each at its type's published peak, as a
share of the window's wall time."""

from benchmark.harness import readers


def read(record):
    return readers.mfu_pct(record)
