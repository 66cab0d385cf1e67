"""batcher.mean_batch: the MicroBatcher's requests per launch over the
window (the change in ``BatcherStats.requests / launches``)."""


def read(rec):
    c = rec.window.counters
    return c["batcher_requests"] / c["batcher_launches"] if c.get("batcher_launches") else None
