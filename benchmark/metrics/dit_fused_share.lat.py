"""The share of the DiT's planned block-steps that ran as the fused block
(K5 / K6, models/dit.py `fused_block_route`), %: the `dit_fused` and
`dit_plain` counts on the program's serve.ode spans (models/dit.py
`block_steps`), summed over every batch the open loop's requests filled.
None where the spans carry no counts (a program before them)."""

from benchmark.metrics._program import arm, program, served_batches

arm()


def read(rec: dict):
    prog = program(rec)
    if prog is None:
        return None
    batches = {b["id"] for b in served_batches(prog)}
    odes = [s["attrs"] for s in prog["spans"]
            if s["name"] == "serve.ode" and s["parent"] in batches]
    fused = sum(a.get("dit_fused", 0) for a in odes)
    total = fused + sum(a.get("dit_plain", 0) for a in odes)
    return 100.0 * fused / total if total else None
