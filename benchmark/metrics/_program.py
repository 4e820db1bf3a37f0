"""The program's own spans (maa3_tpu_torch/trace.py) in a --trace 1 run, and
the device's idle time credited to them.

run.py loads every reader of a traced run before the run starts, and each
reader of the program's spans calls `arm()` when it is loaded, which turns
the program's tracer on: its spans then cover set-up and the window. The
first such reader after the run drains the tracer into the run's record
(`program(rec)`, kept as rec["program"]). A --trace 0 run loads no reader
and so leaves the tracer off. A program without the tracer (a commit
before it) gives no spans, and every reader built on them returns None.
One traced run per process, as run.py's main makes: the tracer stays on
after it, and a later run in the same process drains its spans too.

Idle credit: each gap between the device operations of the profiled
stretch (rec["profile"]["kernels"], on the Unix-epoch clock of
torch.profiler's events) is split where the working thread's spans begin
and end (the batcher thread's, or the trainer's), and each piece goes to
the innermost span open on that thread over it, or to "untraced"."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

WORKER = {"serve": "serve.collect", "train": "train.step"}  # a span only the working thread has
INPUT_WAIT = {"serve.collect", "train.loader_wait"}  # the host waits for input, not for itself
UNTRACED = "untraced"


def arm() -> None:
    """Turn the program's tracer on, unless it is on or absent."""
    try:
        from maa3_tpu_torch import trace
    except ImportError:  # the program before its tracer
        return
    if not trace.enabled():
        import torch
        trace.enable("cuda" if torch.cuda.is_available() else "cpu")


def program(rec: dict) -> Optional[dict]:
    """{"clock", "spans"} drained from the program's tracer once per record,
    or None without a tracer or spans."""
    if "program" not in rec:
        rec["program"] = None
        try:
            from maa3_tpu_torch import trace
        except ImportError:
            return None
        d = trace.drain()
        if d["clock"] is not None and d["spans"]:
            rec["program"] = d
    return rec["program"]


def epoch_us(prog: dict, t_ns: int) -> float:
    """A span's perf_counter_ns time on the profiler's clock, microseconds."""
    c = prog["clock"]
    return (t_ns - c["perf_ns"] + c["unix_ns"]) / 1e3


def named(prog: dict, name: str) -> List[dict]:
    return [s for s in prog["spans"] if s["name"] == name]


def duration_ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def working_thread(prog: dict, kind: str) -> Optional[str]:
    threads = Counter(s["thread"] for s in named(prog, WORKER[kind]))
    return threads.most_common(1)[0][0] if threads else None


def served_batches(prog: dict) -> List[dict]:
    """The batches the batcher thread launched for requests (not warm-ups),
    in order."""
    th = working_thread(prog, "serve")
    return sorted((s for s in named(prog, "serve.batch") if s["thread"] == th),
                  key=lambda s: s["start_ns"])


def holes(prog: dict, thread: str, min_ns: float = 1e6) -> List[tuple]:
    """(start_ns, end_ns) of each stretch of over 1 ms on `thread` outside
    its outermost spans: on the batcher thread only the benchmark's profiler
    starts and stops there (between serve.collect and serve.batch)."""
    top = sorted((s for s in prog["spans"] if s["thread"] == thread and s["parent"] is None),
                 key=lambda s: s["start_ns"])
    out, end = [], None
    for s in top:
        if end is not None and s["start_ns"] - end > min_ns:
            out.append((end, s["start_ns"]))
        end = s["end_ns"] if end is None else max(end, s["end_ns"])
    return out


def window_queue_ms(rec: dict, closed: bool) -> Optional[List[float]]:
    """Each request's serve.queue (ms), over the window's requests: every
    request of an open loop; in a closed loop those whose batch ended in the
    window the driver timed, from the first batch's end for window_s. A
    request that waited over the profiler's start or stop (a hole on the
    batcher thread) is left out: that wait is the benchmark's own."""
    prog = program(rec)
    if prog is None:
        return None
    batches = {s["id"]: s for s in served_batches(prog)}
    pauses = holes(prog, working_thread(prog, "serve")) if batches else []
    queued = [q for q in named(prog, "serve.queue") if q["attrs"].get("batch") in batches
              and not any(q["start_ns"] < b and a < q["end_ns"] for a, b in pauses)]
    if closed and batches:
        t0 = min(b["end_ns"] for b in batches.values())
        t1 = t0 + rec["window_s"] * 1e9
        queued = [q for q in queued if t0 < batches[q["attrs"]["batch"]]["end_ns"] <= t1]
    return [duration_ms(q) for q in queued] or None


def gaps_us(kernels) -> List[tuple]:
    """(start, end) of each interval between the device operations, us."""
    out, cur_e = [], None
    for _, s, e in kernels:
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def innermost(prog: dict, thread: str) -> List[tuple]:
    """(start_us, end_us, name) pieces of time on `thread`, each named by
    the innermost span open over it; spans of one thread nest."""
    mine = [s for s in prog["spans"] if s["thread"] == thread]
    edges = sorted([(s["start_ns"], 1, -s["end_ns"], i) for i, s in enumerate(mine)]
                   + [(s["end_ns"], 0, 0, i) for i, s in enumerate(mine)])
    out, stack, last = [], [], None
    for t, opening, _, i in edges:
        if stack and last is not None and t > last:
            out.append((epoch_us(prog, last), epoch_us(prog, t), mine[stack[-1]]["name"]))
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        last = t
    return out


def idle_by_span(rec: dict) -> Optional[Dict[str, float]]:
    """ms of device idle in the profiled stretch under each innermost span
    of the working thread, "untraced" where none was open."""
    prog, prof = program(rec), rec.get("profile")
    if prog is None or not prof:
        return None
    thread = working_thread(prog, rec["kind"]) if rec.get("kind") in WORKER else None
    if thread is None:
        return None
    pieces = innermost(prog, thread)
    out: Dict[str, float] = {}
    j = 0
    for a, b in gaps_us(prof["kernels"]):
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + (hi - lo) / 1e3
                covered += hi - lo
            k += 1
        out[UNTRACED] = out.get(UNTRACED, 0.0) + (b - a - covered) / 1e3
    return out


def host_idle_share(rec: dict) -> Optional[float]:
    """% of the profiled stretch with the device idle while the working
    thread was in a span other than its waits for input."""
    idle = idle_by_span(rec)
    if idle is None or rec["profile"]["window_s"] <= 0:
        return None
    host = sum(v for k, v in idle.items() if k not in INPUT_WAIT and k != UNTRACED)
    return 100.0 * host / 1e3 / rec["profile"]["window_s"]


def window_steps(prog: dict, rec: dict) -> List[dict]:
    """The window's train.step spans (the last rec["steps"] that ran a step)."""
    th = working_thread(prog, "train")
    ran = {s["parent"] for s in named(prog, "train.prepare")}
    steps = sorted((s for s in named(prog, "train.step") if s["thread"] == th and s["id"] in ran),
                   key=lambda s: s["start_ns"])
    return steps[-rec["steps"]:] if rec.get("steps") else []


def step_device_ms(rec: dict, name: str) -> Optional[float]:
    """Device ms per window step of the span `name` inside the step (0 for
    a step without it), or None without device times."""
    prog = program(rec)
    if prog is None or rec.get("kind") != "train":
        return None
    steps = window_steps(prog, rec)
    if not steps:
        return None
    parent = {s["id"]: s["parent"] for s in prog["spans"]}
    ids = {s["id"] for s in steps}

    def in_window(s):
        p = s["parent"]
        while p is not None and p not in ids:
            p = parent.get(p)
        return p is not None

    mine = [s for s in named(prog, name) if in_window(s)]
    if not mine or any("device_ms" not in s for s in mine):
        return None
    return sum(s["device_ms"] for s in mine) / len(steps)
