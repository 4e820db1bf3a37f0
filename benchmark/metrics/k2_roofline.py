"""K2's share of its roofline bound over the served vocodes in the
profiled stretch, %."""

from benchmark.metrics._roofline import vocode_share


def read(rec: dict):
    return vocode_share(rec, "k2")
