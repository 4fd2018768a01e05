"""gen_img_s: images that the window's calls of
``InferenceEngine.generate`` returned, over the whole window."""

from benchmark.harness import readers


def read(record):
    return readers.rate(record)
