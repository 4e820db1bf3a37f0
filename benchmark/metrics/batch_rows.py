"""Requests per launched batch: the Batcher's batch histogram over the
window (its real rows, before padding to a bucket)."""


def read(rec: dict):
    sizes = rec.get("batch_sizes")
    return sum(sizes) / len(sizes) if sizes else None
