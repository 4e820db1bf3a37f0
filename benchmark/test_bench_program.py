"""The program's own spans (maa3_tpu_torch/trace.py) against the benchmark's
outside timings on tiny cells on the CPU, the readers of those spans, and
the same readers on a program without a tracer (they return None)."""

import statistics
import sys
import time

import pytest
import torch

from benchmark import harness, run
from benchmark.conftest import CELLS, write_root
from benchmark.metrics import _program

SEED = 3300000007
NEW_READERS = ("queue_wait_ms.lat", "queue_wait_ms.tput", "pad_share.lat", "warmup_s.lat",
               "host_idle_share.lat", "vae_encode_ms.train", "cond_ms.train",
               "dit_fwd_ms.train", "bwd_ms.train", "optim_ms.train")


def _traced_record(root, cell_name):
    """The driver's record of one traced run of a tiny cell, with the
    program's spans drained into it."""
    from maa3_tpu_torch import trace
    bench = harness.Bench(root)
    cell = bench.cell(cell_name)
    ctx = run.Ctx(SEED, 2.0, True, cell, bench.config(cell["config"]), torch.device("cpu"),
                  time.perf_counter(), {})
    trace.enable("cpu")
    try:
        rec = bench.driver(cell["driver"]).run(ctx)["record"]
        _program.program(rec)
    finally:
        trace.disable()
    return bench, rec


def _agree(mine, theirs):
    """The program's span holds the benchmark's timing of the same call
    (ms), and exceeds it by at most 5 % or 1 ms at the median: another
    thread can hold the interpreter for a switch interval (5 ms) in any one
    call."""
    gaps = [m - t for m, t in zip(mine, theirs)]
    return (len(mine) == len(theirs) and min(gaps) >= -0.01
            and statistics.median(gaps) <= max(0.05 * statistics.median(theirs), 1.0))


@pytest.fixture
def warm_root(tmp_path):
    """The tiny cells with every bucket warmed: a bucket first met in the
    window adds its unconditional encode to the benchmark's `encode` list as
    a call of its own, where the program's serve.encode holds both."""
    cells = dict(CELLS)
    driver, params, limits = cells["tiny-t2a.closed"]
    cells["tiny-t2a.closed"] = (driver, dict(params, warm_buckets=[1, 2, 4]), limits)
    return write_root(tmp_path / "checkout", cells)


@pytest.mark.parametrize("cell", ["tiny-t2a.poisson", "tiny-t2a.closed"])
def test_serving_spans_agree_with_the_benchmarks_wrappers(warm_root, cell):
    bench, rec = _traced_record(warm_root, cell)
    prog = rec["program"]
    batches = _program.served_batches(prog)
    kids = {}
    for s in prog["spans"]:
        kids.setdefault(s["parent"], {})[s["name"]] = s
    for name in ("encode", "ode", "decode", "vocode"):
        theirs = rec["spans"][name]
        mine = [_program.duration_ms(kids[b["id"]][f"serve.{name}"]) for b in batches]
        assert len(theirs) >= 2 and _agree(mine, theirs), (name, mine, theirs)
    rows = [b["attrs"]["rows"] for b in batches]
    assert sum(rows) == sum(rec["batch_sizes"])
    wanted = {"tiny-t2a.poisson": ("queue_wait_ms.lat", "pad_share.lat", "warmup_s.lat"),
              "tiny-t2a.closed": ("queue_wait_ms.tput",)}[cell]
    for name in wanted:
        value = bench.reader(name)(rec)
        assert harness.finite(value) and value >= 0, (name, value)


def test_the_loader_wait_agrees_with_the_windows(tiny_root):
    bench, rec = _traced_record(tiny_root, "tiny-t2a.train")
    steps = _program.window_steps(rec["program"], rec)
    assert len(steps) == rec["steps"] == len(rec["loader_wait_ms"])
    waits = {s["parent"]: _program.duration_ms(s) for s in _program.named(rec["program"],
                                                                          "train.loader_wait")}
    at, n = 1, 1  # the tiny cell's profile_at, profile_steps: those steps open and close it
    keep = [i for i in range(len(steps)) if i not in (at, at + n)]
    mine = [waits[steps[i]["id"]] for i in keep]
    theirs = [rec["loader_wait_ms"][i] for i in keep]
    assert _agree(mine, theirs), (mine, theirs)
    # no device time on the CPU: the step's device ms read nothing
    assert bench.reader("dit_fwd_ms.train")(rec) is None


def test_the_readers_read_nothing_from_a_program_without_a_tracer(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "maa3_tpu_torch.trace", None)  # import fails
    bench = harness.Bench(harness.ROOT)
    for kind in ("serve", "train"):
        rec = {"kind": kind, "window_s": 1.0, "steps": 3,
               "profile": {"kernels": [("a", 0.0, 1.0), ("b", 2.0, 3.0)], "window_s": 1.0}}
        for name in NEW_READERS:
            assert bench.reader(name)(rec) is None, name
