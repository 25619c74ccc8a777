"""batch_occupancy (micro-batcher): queries per device dispatch of the
micro-batcher, from the program's counters' deltas over the window;
nothing where the batcher dispatched nothing."""


def read(ctx):
    c = ctx["counters"]
    batches = c.get("filodb_batcher_batches_total", 0.0)
    if batches <= 0:
        return None
    return c.get("filodb_batcher_queries_total", 0.0) / batches
