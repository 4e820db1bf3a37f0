"""The padding rows' share of the rows the server launched, %: each served
batch's bucket - rows (the program's serve.batch spans, as Batcher.stats()
counts them in padded_rows) over its bucket, summed over the batches the
requests filled (warm-ups left out)."""

from benchmark.metrics._program import arm, program, served_batches

arm()


def read(rec: dict):
    prog = program(rec)
    batches = served_batches(prog) if prog else []
    launched = sum(b["attrs"]["bucket"] for b in batches)
    return 100.0 * sum(b["attrs"]["padded"] for b in batches) / launched if launched else None
