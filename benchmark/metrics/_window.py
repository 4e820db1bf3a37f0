"""The wall time of a traced run's window without the profiler's own start
and stop, which stall the thread that launches the work."""


def work_seconds(rec: dict):
    p = rec.get("profile") or {}
    w = rec.get("window_s", 0.0) - p.get("stall_s", 0.0)
    return w if w > 0 else None
