"""The mean wait of a request in the server's queue, ms: the program's
serve.queue spans over the requests whose batch ended in the closed loop's
window, but those that waited across the profiler's start or stop."""

import statistics

from benchmark.metrics._program import arm, window_queue_ms

arm()


def read(rec: dict):
    q = window_queue_ms(rec, closed=True)
    return statistics.fmean(q) if q else None
