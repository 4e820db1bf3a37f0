"""Milliseconds per launched batch of the conditioner's encode of a batch's captions (MAA3System.get_learned_conditioning):
CUDA events around each call, averaged over the window."""

from benchmark.metrics._span import mean_span


def read(rec: dict):
    return mean_span(rec, "encode")
