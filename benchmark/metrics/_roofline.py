"""Kernel shares of their roofline bound from the profiled stretch: the
least time the H100 could take for the launches seen (benchmark/
yardstick.py: max(bytes / 3.35 TB/s, operations / peak) per launch at the
shapes they ran) over the time the profiler gave those launches."""

import re

from benchmark import yardstick

KERNELS = {"k1": r"aa_snake_kernel", "k2": r"conv_snake(_tc)?_kernel",
           "k3a": r"flash_fwd_tc_direct_kernel",
           "k4a": r"flash_bwd_tc_fused_kernel|flash_bwd_scale_q_kernel"}


def vocode_share(rec: dict, which: str):
    """K1 or K2 over the vocodes of the profiled stretch: its launches in
    time order, a vocode's worth at a time, each at that vocode's rows."""
    p = rec.get("profile")
    rows = rec.get("vocode_rows", [])
    if not p or not rows:
        return None
    cfg = rec["config"]
    voc = cfg["vocoder"]
    mel = rec["latent_len"] * 2 ** len(cfg["model"]["vae"]["down_layers"])
    rx = re.compile(KERNELS[which])
    mine = [k for k in p["kernels"] if rx.search(k[0])]
    if len(mine) != yardstick.vocode_launches(voc)[which] * len(rows):
        return None
    spent = sum(k[2] - k[1] for k in mine) / 1e6
    bound = sum(yardstick.vocode_bounds(r, mel, voc, rec["item"])[which] for r in rows)
    return 100.0 * bound / spent if spent > 0 else None


def flash_share(rec: dict, which: str):
    """K3a or K4a (its prologue included) over every launch in the stretch,
    at the training step's (batch, heads, latent length, head dim)."""
    p = rec.get("profile")
    if not p:
        return None
    dit = rec["config"]["model"]["dit"]
    rx = re.compile(KERNELS[which])
    ks = [k for k in p["kernels"] if rx.search(k[0])]
    launches = sum("scale_q" not in k[0] for k in ks)
    spent = sum(k[2] - k[1] for k in ks) / 1e6
    if not launches or spent <= 0:
        return None
    b = yardstick.flash_bounds_s(rec["batch"], dit["num_heads"], rec["latent_len"],
                                 dit["hidden_size"] // dit["num_heads"])[which]
    return 100.0 * launches * b / spent
