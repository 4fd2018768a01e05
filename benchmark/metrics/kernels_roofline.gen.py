"""kernels_roofline.gen: the least time of the hand kernels' work in the
traced slice (``kernels/*.py``) over their device time."""

from benchmark.harness import readers


def read(record):
    return readers.kernel_roofline_pct(record)
