"""Device ms per step of the frozen VAE's encode and posterior sample: the CUDA
events of the program's train.vae_encode spans over the window's steps."""

from benchmark.metrics._program import arm, step_device_ms

arm()


def read(rec: dict):
    return step_device_ms(rec, "train.vae_encode")
