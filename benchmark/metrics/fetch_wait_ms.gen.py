"""fetch_wait_ms.gen: the median, over the first traced slice's engine
calls, of ``sg2im.engine.fetch``: everything after the forward's issue,
that is deprocess's issue, the host's wait for the device to finish the
call (wherever its first synchronisation falls: today deprocess's copy of
its mean and std to the card) and the copy of the uint8 images back."""

from benchmark.harness import spans


def read(record):
    return spans.median_part(record, "fetch")
