"""Milliseconds per launched batch of the fp32 VAE decode (MAA3System.decode_first_stage):
CUDA events around each call, averaged over the window."""

from benchmark.metrics._span import mean_span


def read(rec: dict):
    return mean_span(rec, "decode")
