"""The share of the DiT's attention calls that ran on the flash forward
(K3a), %: the `attn_flash` and `attn_dense` counts on the program's
serve.ode spans (ops/attention.py `calls`, self- and cross-attention),
summed over every batch the open loop's requests filled. None where the
spans carry no counts (a program before them)."""

from benchmark.metrics._program import arm, program, served_batches

arm()


def read(rec: dict):
    prog = program(rec)
    if prog is None:
        return None
    batches = {b["id"] for b in served_batches(prog)}
    odes = [s["attrs"] for s in prog["spans"]
            if s["name"] == "serve.ode" and s["parent"] in batches]
    flash = sum(a.get("attn_flash", 0) for a in odes)
    total = flash + sum(a.get("attn_dense", 0) for a in odes)
    return 100.0 * flash / total if total else None
