"""Device ms per step of the trainable conditioner's encode of the captions:
the CUDA events of the program's train.cond spans over the window's steps."""

from benchmark.metrics._program import arm, step_device_ms

arm()


def read(rec: dict):
    return step_device_ms(rec, "train.cond")
