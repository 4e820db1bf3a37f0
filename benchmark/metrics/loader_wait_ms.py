"""The host's wait for the next batch from the loader, ms per step over the
window (the feed's next() as Trainer.fit calls it)."""


def read(rec: dict):
    w = rec.get("loader_wait_ms")
    return sum(w) / len(w) if w else None
