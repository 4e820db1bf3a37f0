"""The share of the profiled stretch in which the device was idle while the
working thread (the batcher's, or the trainer's) was in one of the
program's spans other than its waits for input (serve.collect,
train.loader_wait), %: idle the host caused, not the lack of input."""

from benchmark.metrics._program import arm, host_idle_share

arm()


def read(rec: dict):
    return host_idle_share(rec)
