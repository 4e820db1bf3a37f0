"""Milliseconds per launched batch of the batched CFG ODE over the DiT (MAA3System.sample_cfg):
CUDA events around each call, averaged over the window."""

from benchmark.metrics._span import mean_span


def read(rec: dict):
    return mean_span(rec, "ode")
