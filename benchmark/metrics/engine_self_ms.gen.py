"""engine_self_ms.gen: the median, over the first traced slice's engine
calls, of ``sg2im.engine.generate`` less its encode, forward and fetch
spans: the noise draw's issue and the four host-to-device copies of the
batch before the forward (pageable copies, each waiting for the stream,
which holds only the noise draw then)."""

from benchmark.harness import spans


def read(record):
    return spans.median_part(record, "self")
