"""Tracing in the benchmark's own files (the --trace 1 run): CUDA-event spans
around calls into the program's layers, and torch.profiler over a short
steady stretch of the window, reduced to device busy time, the kernels in
time order, the device operations that took most time and the longest idle
gaps, each named by what the host launched next."""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, Optional

import torch

class _HostEvent:
    """A CUDA event's interface on the host clock (CPU runs of the tests)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """Named spans, read once the window has closed: CUDA events on the card
    (host clocks on the CPU). wrap(obj, attr, name, rows) replaces a bound
    method on the instance by one that records an event pair around each
    call, inside a profiler range named bench.<name>:<rows(args)>."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.events: Dict[str, List[tuple]] = {}

    def _event(self):
        return torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()

    def wrap(self, obj, attr: str, name: str, rows: Callable) -> None:
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            s, e = self._event(), self._event()
            t = time.perf_counter()
            s.record()
            out = fn(*a, **kw)
            e.record()
            self.events.setdefault(name, []).append((s, e, t, rows(*a, **kw)))
            return out

        setattr(obj, attr, wrapped)

    def ms(self) -> Dict[str, List[float]]:
        if self.cuda:
            torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e, _, _ in v] for k, v in self.events.items()}

    def rows_between(self, name: str, t0: float, t1: float) -> List[int]:
        """The rows of each call to `name` that began in [t0, t1] (host
        clock), in order."""
        return [r for _, _, t, r in self.events.get(name, []) if t0 <= t <= t1]


class Stretch:
    """torch.profiler over a stretch the caller opens and closes, recording
    the device's operations only (no host op recording, which would slow
    the host that the idle share is about)."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.stall_s = 0.0  # the profiler's own start and stop, on the host

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        s = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.stall_s += self.t0 - s

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stall_s += time.perf_counter() - self.t1

    @property
    def open(self) -> bool:
        return self.prof is not None and self.t1 is None

    def _device_ops(self):
        """(name, start_us, end_us) of every device operation recorded."""
        try:
            evs = self.prof.profiler.kineto_results.events()
            return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3) for e in evs
                    if e.device_type().name == "CUDA" and not e.is_user_annotation()]
        except AttributeError:  # an older profiler: its parsed events
            return [(e.name, e.time_range.start, e.time_range.end) for e in self.prof.events()
                    if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]

    def reduce(self) -> Optional[dict]:
        """{window_s, busy_s, stall_s, kernels: [(name, start_us, end_us)] in
        time order, device_ops: the ten names that took most time, idle_gaps: the
        ten longest gaps, each named by the operation the host launched
        next}, or None when the profiler saw no device operation."""
        if self.prof is None or self.t1 is None:
            return None
        kernels = sorted(self._device_ops(), key=lambda k: k[1])
        if not kernels:
            return None
        busy, cur_s, cur_e, gaps = 0.0, None, None, []
        for name, s, e in kernels:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((s - cur_e, name))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        by_name: Dict[str, float] = {}
        for n, s, e in kernels:
            by_name[_short(n)] = by_name.get(_short(n), 0.0) + (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps.sort(key=lambda g: -g[0])
        return {"window_s": self.t1 - self.t0, "busy_s": busy / 1e6, "kernels": kernels,
                "stall_s": self.stall_s,
                "device_ops": [[n, v] for n, v in top],
                "idle_gaps": [[f"host, before {_short(n)}", g / 1e6] for g, n in gaps[:10]]}


def _short(name: str) -> str:
    """A kernel's name without its template arguments and return type."""
    m = re.search(r"([A-Za-z_][A-Za-z0-9_:]*)(?:<|\()", name)
    return (m.group(1) if m else name)[:120]

