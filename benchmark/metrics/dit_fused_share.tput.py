"""The share of the DiT's planned block-steps that ran as the fused block
(K5 / K6, models/dit.py `fused_block_route`), %: the `dit_fused` and
`dit_plain` counts on the program's serve.ode spans (models/dit.py
`block_steps`), summed over the batches that ended in the closed loop's
window (from the first batch's end, for window_s). None where the spans
carry no counts (a program before them)."""

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
    fused = sum(a.get("dit_fused", 0) for a in odes)
    total = fused + sum(a.get("dit_plain", 0) for a in odes)
    return 100.0 * fused / total if total else None
