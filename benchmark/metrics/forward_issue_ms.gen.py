"""forward_issue_ms.gen: the median, over the first traced slice's engine
calls, of ``sg2im.model.forward``: the host issuing the generator's
forward (its launches; the device runs behind it)."""

from benchmark.harness import spans


def read(record):
    return spans.median_part(record, "forward")
