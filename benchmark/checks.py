"""The numbers that decide `correct`, each compared with its limit.

Serving: the widest relative L2 gap between a served wav and the plain
reference's wav of the same request, over a sample of the window's
requests, and the count of requests that never got a wav.
Training: the relative gap of the first step's loss (the later steps'
losses are reported beside it: each Adam update turns gradients at rounding
level into whole +-lr steps, which moves the later losses by more than the
arithmetic does); the widest gap of a leaf's clipped first gradient, by
norm; and of a leaf's change over the three steps, by norm. A leaf's gap
is taken against the larger of its reference norm and the median leaf's; leaves whose reference gradient
is under a thousandth of the median leaf's (rounding noise, as a key's bias
under softmax) are left out of both."""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np

NEGLIGIBLE = 1e-3  # of the median leaf's gradient norm


def wav_gap(served: List[np.ndarray], ref: List[np.ndarray]) -> float:
    worst = 0.0
    for w, r in zip(served, ref):
        r = np.asarray(r, np.float64)
        w = np.asarray(w, np.float64)[: len(r)]
        worst = max(worst, float(np.linalg.norm(w - r) / max(np.linalg.norm(r), 1e-12)))
    return worst


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keep) -> float:
    vals = [want[k] for k in keep]
    med = statistics.median(vals) if vals else 0.0
    return max((abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keep), default=0.0)


def kept_leaves(ref_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= NEGLIGIBLE * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    keep = kept_leaves(ref["grad_norms"])
    steps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"])]
    return {"loss_gap": steps[0], "loss_gap_steps": steps,
            "loss_program": list(prog["loss"]), "loss_reference": list(ref["loss"]),
            "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"], keep),
            "change_gap": leaf_gap(prog["change_norms"], ref["change_norms"], keep),
            "leaves_left_out": sorted(set(ref["grad_norms"]) - set(keep))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {value, limit}} for every number that has a limit, and whether
    each is within it (a NaN never is)."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and bool(good)
        out[name] = {"value": v, "limit": limit}
    return {"correct": ok, "checks": out}
