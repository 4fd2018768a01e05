"""graphs_per_call.serve: graphs served in the window per engine call of the
server's batcher (its ``engine_calls`` counter): how much the coalescing
merges."""


def read(record):
    calls = record.window.get("engine_calls")
    return record.window["images"] / calls if calls else None
