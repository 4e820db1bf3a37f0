"""Device ms per step of the CFM loss through the DiT's forward: the CUDA
events of the program's train.forward spans over the window's steps."""

from benchmark.metrics._program import arm, step_device_ms

arm()


def read(rec: dict):
    return step_device_ms(rec, "train.forward")
