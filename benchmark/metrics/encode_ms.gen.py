"""encode_ms.gen: the median, over the first traced slice's engine calls,
of ``sg2im.engine.encode``: the host encoding the call's scene graphs and
padding the batch, while the device has nothing of the call yet."""

from benchmark.harness import spans


def read(record):
    return spans.median_part(record, "encode")
