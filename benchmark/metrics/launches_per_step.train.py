"""launches_per_step.train: device kernels (copies and fills left out) per
train step in the traced slice."""

from benchmark.harness import readers


def read(record):
    return readers.launches_per_unit(record)
