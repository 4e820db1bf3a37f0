"""The share of the DiT's attention calls that ran on the flash forward
(K3a), %: the `attn_flash` and `attn_dense` counts on the program's
serve.ode spans (ops/attention.py `calls`, self- and cross-attention),
summed over the batches that ended in the closed loop's window (from the
first batch's end, for window_s). None where the spans carry no counts (a
program before them)."""

from benchmark.metrics._program import arm, program, served_batches

arm()


def read(rec: dict):
    prog = program(rec)
    batches = served_batches(prog) if prog else []
    if not batches:
        return None
    t0 = min(b["end_ns"] for b in batches)
    t1 = t0 + rec["window_s"] * 1e9
    ids = {b["id"] for b in batches if t0 < b["end_ns"] <= t1}
    odes = [s["attrs"] for s in prog["spans"] if s["name"] == "serve.ode" and s["parent"] in ids]
    flash = sum(a.get("attn_flash", 0) for a in odes)
    total = flash + sum(a.get("attn_dense", 0) for a in odes)
    return 100.0 * flash / total if total else None
