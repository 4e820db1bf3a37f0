"""The mean of one CUDA-event span over the window's batches (ms)."""


def mean_span(rec: dict, name: str):
    v = rec.get("spans", {}).get(name)
    return sum(v) / len(v) if v else None
