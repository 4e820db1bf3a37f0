"""The device's peak allocated memory over the window, GiB
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(rec: dict):
    b = rec.get("peak_bytes")
    return b / 2 ** 30 if b else None
