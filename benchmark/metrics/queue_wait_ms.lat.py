"""The 95th percentile of a request's wait in the server's queue, ms: the
program's serve.queue spans (from its arrival at Batcher.submit to the
start of the batch that takes it) over every request of the open loop but
those that waited across the profiler's start or stop."""

from benchmark import harness
from benchmark.metrics._program import arm, window_queue_ms

arm()


def read(rec: dict):
    q = window_queue_ms(rec, closed=False)
    return harness.percentile(q, 95) if q else None
