"""Milliseconds per launched batch of the vocode through K1 and K2, to host memory (MAA3System.vocode):
CUDA events around each call, averaged over the window."""

from benchmark.metrics._span import mean_span


def read(rec: dict):
    return mean_span(rec, "vocode")
