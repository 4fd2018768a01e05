"""queue_wait_ms.serve: the nearest-rank 95th percentile of the first
traced slice's ``sg2im.serve.queue`` spans: each request's wait in the
server's batcher from its queueing to the drain that takes it into an
engine call."""

from benchmark.harness import readers, spans


def read(record):
    waits = spans.queue_waits_ms()
    return readers.percentile(waits, 95) if waits else None
