"""The readings the limits of `correct` are set from, on the chip at a
cell's own size and load (never run by the benchmark's own runs):

    python3 benchmark/control.py --workload <cell> --seeds 11,12 \
        --controls fp8,half_batch --control-seeds 21,22,23 --seconds 15 \
        [--out chiprun_out/control.jsonl]

Every reading is one whole run of the cell through run.run, judged by the
cell's own limits as every benchmark run is judged:
- the program, per --seeds seed: the lower readings;
- per --control-seeds seed, each of --controls planted in the program that
  the window drives: the upper readings, each of which has to come out as
  not correct.
  fp8: every dense product of the program (ops.basic.dense: the DiT's
  projections and feed-forward, forward and backward) with both operands
  rounded to float8_e4m3fn with one scale per tensor (reference.core.
  fp8_round): the precision below the configuration's bf16, where a change
  to the program's GEMMs would go next.
  half_batch (training cells): half of each batch left out, the mean taken
  over the rest.
One JSON line per reading is appended to --out and printed."""

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from benchmark import harness, run  # noqa: E402
from benchmark.reference.core import fp8_round  # noqa: E402


class _Fp8Functional:
    """torch.nn.functional, with linear's operands rounded to fp8."""

    def __init__(self, functional):
        self._f = functional

    def linear(self, x, w, b=None):
        return self._f.linear(fp8_round(x), fp8_round(w), b)

    def __getattr__(self, name):
        return getattr(self._f, name)


def half_batch(trainer):
    fn = trainer.prepare_batch

    def prepare(raw):
        return {k: v[: len(v) // 2] for k, v in fn(raw).items()}

    trainer.prepare_batch = prepare


@contextlib.contextmanager
def planted(control):
    """The hooks of run.run that plant `control` (None: the program as it is)."""
    if control == "fp8":
        from maa3_tpu_torch.ops import basic
        functional = basic.F
        basic.F = _Fp8Functional(functional)
        try:
            yield {}
        finally:
            basic.F = functional
    elif control == "half_batch":
        yield {"trainer": half_batch}
    elif control is None:
        yield {}
    else:
        raise ValueError(f"unknown control {control!r}")


def reading(cell: str, seed: int, seconds: float, control=None, root=None, device=None) -> dict:
    """One run of the cell with `control` planted: its verdict, the compared
    numbers beside their limits, and its end-to-end metrics."""
    with planted(control) as hooks:
        r = run.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)],
                    root=root, device=device, hooks=hooks, t_start=time.perf_counter())
    return {"correct": r["correct"], "checks": r["_checks"], "numbers": r["numbers"],
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "failed": r["failed"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="fp8")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)

    def one(kind, seed, control):
        t = time.perf_counter()
        try:
            rec = reading(a.workload, seed, a.seconds, control)
        except Exception as e:  # a control that crashed gives no number
            traceback.print_exc()
            rec = {"error": repr(e)[:300]}
        line = json.dumps({"workload": a.workload, "kind": kind, "seed": seed, **rec,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")
        harness.free_device()

    for s in filter(None, a.seeds.split(",")):
        one("program", int(s), None)
    for s in filter(None, a.control_seeds.split(",")):
        for c in filter(None, a.controls.split(",")):
            one(c, int(s), c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
