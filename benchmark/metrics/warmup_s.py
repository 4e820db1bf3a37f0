"""The server's warm-up at set-up, s: the program's serve.warmup spans (one
batch per warmed bucket, Batcher.warmup), summed."""

from benchmark.metrics._program import arm, duration_ms, named, program

arm()


def read(rec: dict):
    prog = program(rec)
    w = named(prog, "serve.warmup") if prog else []
    return sum(duration_ms(s) for s in w) / 1e3 if w else None
