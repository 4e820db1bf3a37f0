"""K4A's share of its roofline bound over the training steps in the
profiled stretch, %."""

from benchmark.metrics._roofline import flash_share


def read(rec: dict):
    return flash_share(rec, "k4a")
