# Counterpart of dmsa_lidar_slam_tpu/pipeline/metrics.py: nested spans and counters, profiler ranges via torch.profiler.
"""Realtime ratio, host spans and counters.

The reference's only performance metric is the realtime ratio printed every
10 clouds (DmsaSlam.h:240-262); both pipelines log it likewise.  Beside it:

  - stage(name): a host span.  Spans nest; each name accumulates its total
    seconds, its self seconds (the part that no span opened inside it
    covers), its calls and the name of the span that encloses it.  While a
    torch.profiler profile records, the span also enters
    torch.profiler.record_function(name), so it sits in the trace on the
    profiler's clock, nested as it ran, beside the kernels launched inside
    it.  With no profile recording it costs two clock reads and a few dict
    updates: a span reads nothing from the device, launches nothing and
    syncs nothing;
  - count(name, n): a host counter;
  - device_counter(name, device): an int64 scalar on the device that
    kernels add to while the host goes on (no launch, no sync per add).

summary() lists all three under their names, and reads the device
counters in one transfer.
"""

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional

import torch
from torch.autograd import profiler as autograd_profiler


class Metrics:
    def __init__(self):
        self.t0_data = None
        self.t0_wall = None
        self.stage_time = defaultdict(float)
        self.stage_self = defaultdict(float)
        self.stage_calls = defaultdict(int)
        self.stage_parent = {}
        self.counters = defaultdict(int)
        self.device_counters = {}
        self._open = []  # per open span: [name, seconds of the spans closed inside it]

    def start_clock(self, data_stamp: float):
        if self.t0_data is None:
            self.t0_data = data_stamp
            self.t0_wall = time.perf_counter()

    def reset_stages(self):
        """Zero the spans and counters (a bench calls this after its warm-up
        so that the summary covers the timed region only)."""
        for d in (self.stage_time, self.stage_self, self.stage_calls, self.stage_parent, self.counters,
                  self.device_counters):
            d.clear()

    def realtime_ratio(self, data_stamp: float) -> float:
        """data seconds processed per wall second (>1 = faster than realtime;
        the reference runs at 0.33-0.5, README.md:54)."""
        if self.t0_data is None:
            return 0.0
        wall = time.perf_counter() - self.t0_wall
        return (data_stamp - self.t0_data) / max(wall, 1e-9)

    @contextmanager
    def stage(self, name: str, args: Optional[str] = None):
        """Time the enclosed host code as span `name`, a child of the
        innermost open span; `args` labels the profiler range."""
        parent = self._open[-1][0] if self._open else None
        frame = [name, 0.0]
        self._open.append(frame)
        rec = None
        if autograd_profiler._is_profiler_enabled:
            rec = torch.profiler.record_function(name, args)
            rec.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            if rec is not None:
                rec.__exit__(None, None, None)
            self._open.pop()
            self.stage_time[name] += dt
            self.stage_self[name] += dt - frame[1]
            self.stage_calls[name] += 1
            self.stage_parent.setdefault(name, parent)
            if self._open:
                self._open[-1][1] += dt

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def device_counter(self, name: str, device) -> torch.Tensor:
        """The int64 scalar on `device` that counter `name` sums (made at
        its first use, one fill)."""
        t = self.device_counters.get(name)
        if t is None:
            t = self.device_counters[name] = torch.zeros((), dtype=torch.int64, device=device)
        return t

    def summary(self) -> dict:
        """{span: {total_s, calls, self_s, parent}, counter: {count}}."""
        out = {
            name: {"total_s": self.stage_time[name], "calls": self.stage_calls[name],
                   "self_s": self.stage_self[name], "parent": self.stage_parent[name]}
            for name in self.stage_time
        }
        out.update({name: {"count": n} for name, n in self.counters.items()})
        if self.device_counters:
            values = torch.stack(list(self.device_counters.values())).tolist()  # one sync
            out.update({name: {"count": n} for name, n in zip(self.device_counters, values)})
        return dict(sorted(out.items()))
