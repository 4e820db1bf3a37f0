"""Device ms per step of the backward (and a data-parallel gradient average):
the CUDA events of the program's train.backward spans over the window's
steps."""

from benchmark.metrics._program import arm, step_device_ms

arm()


def read(rec: dict):
    return step_device_ms(rec, "train.backward")
