"""Device ms per step of the clip, the optimizer's update and the EMA: the CUDA
events of the program's train.optimizer spans over the window's steps."""

from benchmark.metrics._program import arm, step_device_ms

arm()


def read(rec: dict):
    return step_device_ms(rec, "train.optimizer")
