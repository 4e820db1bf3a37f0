"""Model FLOPs of the window's steps (the VAE encode, then the trainable
conditioner and the DiT forward and backward, counted from shapes, nothing
recomputed) over the window's wall time (less the profiler's own start and stop) x
the H100's 989 TFLOP/s dense
bf16, %."""

from benchmark.metrics._window import work_seconds
from benchmark.yardstick import PEAK_BF16


def read(rec: dict):
    w = work_seconds(rec)
    if not rec.get("model_flops") or w is None:
        return None
    return 100.0 * rec["model_flops"] / (w * PEAK_BF16)
