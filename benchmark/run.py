"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. --trace 0 reports the cell's end-to-end
metrics, --trace 1 its per-layer ones (spans, counters and a short
profiler stretch, read by benchmark/metrics/). Either way the run checks
what its timed path produced against the plain reference and prints each
compared number beside its limit. Exits non-zero, with no result line,
without the cards the cell asks for, outside a checkout of the program, or
when JAX or the JAX package is loaded in the process."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout, not this directory, on the path

from benchmark import checks, harness  # noqa: E402


@dataclasses.dataclass
class Ctx:
    """What a traffic driver is given for one run."""
    seed: int
    seconds: float
    trace: bool
    cell: dict
    cfg: dict
    device: object
    t_start: float
    hooks: dict

    @property
    def params(self) -> dict:
        return self.cell["params"]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv=None, root=None, device=None, hooks=None, t_start=None) -> dict:
    """One run; returns the result (printed by main). `device` skips the
    look for cards (tests give "cpu"); `hooks` plant a fault or the control
    in the program built for the window (the tests, benchmark/control.py)."""
    args = parse(argv)
    harness.cache_env(Path(root or ROOT))
    bench = harness.Bench(Path(root or ROOT))
    cell = bench.cell(args.workload)
    chips = bench.cells[args.workload]["chips"]
    cfg = bench.config(cell["config"])
    driver = bench.driver(cell["driver"])
    wanted = bench.metrics_of(args.workload, bool(args.trace))
    for name in wanted:  # every reader exists before anything runs
        if args.trace:
            bench.reader(name)
    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise harness.Refused(f"the cell asks for {chips} CUDA device(s); "
                                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                                  " available")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        kind, platform = torch.cuda.get_device_name(device), "gpu"
    else:
        device = torch.device(device)
        kind, platform = str(device), device.type
    ctx = Ctx(args.seed, args.seconds, bool(args.trace), cell, cfg, device,
              T_START if t_start is None else t_start, hooks or {})
    out = driver.run(ctx)
    found = harness.forbidden_loaded()
    if found:
        raise harness.Refused(f"forbidden modules loaded in the process: {found}")
    metrics = {}
    for name, m in wanted.items():
        if args.trace:
            value = bench.reader(name)(out["record"])
        else:
            value = out["setup_s"] if name == "setup_s" else out["e2e"].get(name)
        if harness.finite(value):
            metrics[name] = {"value": value, "unit": m["unit"]}
    verdict = checks.judge(out["numbers"], cell["limits"])
    result = {"correct": verdict["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": platform, "kind": kind, "count": chips,
                         "memory_peak_bytes": int(out["memory_peak_bytes"])}}
    prof = out["record"].get("profile")
    if args.trace and prof is not None:
        result["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    for key in ("client", "launches"):
        if key in out:
            result[key] = out[key]
    result["numbers"] = out["numbers"]
    result["_checks"] = verdict["checks"]
    return result


def main(argv=None) -> int:
    try:
        result = run(argv)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    except Exception:  # the run gives no result
        traceback.print_exc()
        return 1
    harness.emit({k: v for k, v in result.items() if k != "_checks"}, result["_checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
