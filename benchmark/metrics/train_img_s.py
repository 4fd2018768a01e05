"""train_img_s: training images of every step of the window (steps times
the batch), over the whole window up to the synchronise that ends it."""

from benchmark.harness import readers


def read(record):
    return readers.rate(record)
