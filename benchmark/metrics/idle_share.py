"""The share of wall time in which no operation ran on the device, %.

Serving: over the profiled stretch. Training: the device's busy time per
profiled step over the wall time per step of the window's other steps,
less the profiler's own start and stop (recording every launch slows the
host's side of a step, so the profiled stretch's own wall time would
overstate the idle share)."""


def read(rec: dict):
    p = rec.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    if rec.get("kind") == "train":
        n = rec["profiled_steps"]
        rest = rec["steps"] - n
        if rest <= 0:
            return None
        per_step = (rec["window_s"] - p["window_s"] - p.get("stall_s", 0.0)) / rest
        return 100.0 * (1.0 - p["busy_s"] / n / per_step)
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
