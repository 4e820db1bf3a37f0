"""Spans: named, timed stretches of the program's work, kept in memory.

Off by default. `enable(device)` turns tracing on for the process; then

    with trace.span("serve.ode", device_time=True, rows=9) as sid:
        ...

records the span's name, its id, the id of the span open around it on the
same thread (its parent), the thread's name, its start and end on the
host's `time.perf_counter_ns()` clock and its attributes (request and batch
ids, rows, bucket, step; `annotate(**attrs)` adds more to the innermost open
span, such as counts known only at its end). With `device_time=True` on a
CUDA device it also records a CUDA event pair on the current stream, read
only at `drain()`: the device time between the two points of the stream.

Spans go to a bounded deque (the newest CAPACITY are kept) and nothing is
written while the program runs. `drain()` returns and forgets them, with
the clock pair taken at `enable`: one `(time.time_ns(), time.perf_counter_ns())`
reading, which puts a span on the Unix-epoch clock of `torch.profiler`'s
events (`unix_ns = t - clock["perf_ns"] + clock["unix_ns"]`). `dump(path)`
writes `drain()` as JSON lines (the clock first, then one span per line):
the one exporter, behind the CLIs' `--trace_out`.

When tracing is off, `span` tests one module-level flag and returns a
shared no-op context manager: no event is made, nothing is stored and
nothing is synchronized.

`counts` counts the DiT's work by kernel route, where it runs and whether
tracing is on or off: attention calls, self and cross, on the flash forward
or dense (ops/attention.py), and the planned step's block-steps as the fused
block or plain (models/dit.py). The server puts a batch's
`counts_since` on its `serve.ode` span (serving.py).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Optional

import torch

CAPACITY = 1 << 16
_on = False
_cuda = False
_clock: Optional[dict] = None
_spans: deque = deque(maxlen=CAPACITY)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
counts = {"attn_flash": 0, "attn_dense": 0, "dit_fused": 0, "dit_plain": 0}


def counts_since(since: dict) -> dict:
    """`counts` less `since`, an earlier copy of it."""
    return {k: n - since[k] for k, n in counts.items()}


def enable(device) -> None:
    """Turn tracing on (device: where `device_time` spans put their events),
    forgetting any span not yet drained."""
    global _on, _cuda, _clock, _spans
    with _lock:
        _cuda = torch.device(device).type == "cuda"
        _spans = deque(maxlen=CAPACITY)
        _clock = {"unix_ns": time.time_ns(), "perf_ns": time.perf_counter_ns()}
        _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _store(rec: dict) -> None:
    with _lock:
        _spans.append(rec)


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "device_time", "id", "parent", "t0", "events")

    def __init__(self, name: str, device_time: bool, attrs: dict):
        self.name, self.device_time, self.attrs = name, device_time, attrs
        self.events = None

    def __enter__(self) -> int:
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        if self.device_time and _cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self.id

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _store({"id": self.id, "parent": self.parent, "name": self.name,
                "thread": threading.current_thread().name, "start_ns": self.t0,
                "end_ns": t1, "attrs": self.attrs, "events": self.events})
        return False


def span(name: str, device_time: bool = False, **attrs):
    """A context manager recording one span; it yields the span's id (None
    when tracing is off)."""
    if not _on:
        return _OFF
    return _Span(name, device_time, attrs)


def annotate(**attrs) -> None:
    """Add attributes to the innermost span open on this thread (nothing
    when tracing is off or no span is open)."""
    stack = _stack() if _on else None
    if stack:
        stack[-1].attrs.update(attrs)


def add(name: str, start_ns: int, thread: Optional[str] = None, **attrs) -> Optional[int]:
    """Record a span that ends now, whose start was stamped earlier
    (`time.perf_counter_ns()`), possibly on another thread (`thread`, default
    the caller's). It has no parent. Returns its id (None when tracing is off)."""
    if not _on:
        return None
    sid = next(_ids)
    _store({"id": sid, "parent": None, "name": name,
            "thread": thread or threading.current_thread().name, "start_ns": start_ns,
            "end_ns": time.perf_counter_ns(), "attrs": attrs, "events": None})
    return sid


def drain() -> dict:
    """{"clock": {"unix_ns", "perf_ns"} (None if never enabled), "spans":
    [{"id", "parent", "name", "thread", "start_ns", "end_ns", "attrs",
    "device_ms"?}]} of every span recorded since the last drain, in the
    order they ended; waits for their CUDA events."""
    global _spans
    with _lock:
        taken, _spans = _spans, deque(maxlen=CAPACITY)
        clock = dict(_clock) if _clock is not None else None
    out = []
    for rec in taken:
        rec = dict(rec)
        ev = rec.pop("events")
        if ev is not None:
            ev[1].synchronize()
            rec["device_ms"] = ev[0].elapsed_time(ev[1])
        out.append(rec)
    return {"clock": clock, "spans": out}


def dump(path: str) -> int:
    """Write drain() to `path` (`path`.rank<k> on rank k > 0 of a
    torch.distributed group) as JSON lines: {"clock": ...}, then one span
    per line. Returns the number of spans written."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and dist.get_rank() > 0:
        path = f"{path}.rank{dist.get_rank()}"
    d = drain()
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps({"clock": d["clock"]}) + "\n")
        for rec in d["spans"]:
            f.write(json.dumps(rec) + "\n")
    return len(d["spans"])
