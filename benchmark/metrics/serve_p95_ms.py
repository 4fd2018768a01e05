"""serve_p95_ms: the nearest-rank 95th percentile, over every request due
in the window, of the time from its due time to its reply; a request that
failed or never came back counts at the time the run gave up on it."""

from benchmark.harness import readers


def read(record):
    return readers.percentile(record.window["latencies_ms"], 95)
