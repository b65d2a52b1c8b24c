# Copy of dmsa_lidar_slam_tpu/pipeline/metrics.py; the stage annotation uses torch.profiler in place of jax.profiler.
"""Realtime-ratio and per-stage timing metrics.

The reference's only performance metric is the realtime ratio printed every
10 clouds (DmsaSlam.h:240-262); here it is first-class, alongside optional
per-stage wall-clock accumulation and profiler hooks.
"""

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext


def _trace_annotation(name: str):
    """torch.profiler.record_function for the stage — cheap when no trace is
    active; names host stages in captured profiles."""
    try:
        import torch

        return torch.profiler.record_function(name)
    except Exception:  # pragma: no cover - profiler unavailable
        return nullcontext()


class Metrics:
    def __init__(self):
        self.t0_data = None
        self.t0_wall = None
        self.num_scans = 0
        self.stage_time = defaultdict(float)
        self.stage_calls = defaultdict(int)

    def start_clock(self, data_stamp: float):
        if self.t0_data is None:
            self.t0_data = data_stamp
            self.t0_wall = time.perf_counter()

    def reset_stages(self):
        """Zero the per-stage accumulators (bench.py calls this after
        warmup so stage_times describe the timed region only — r4's
        stage_times folded jit compile into 'dispatch', VERDICT r4 #8)."""
        self.stage_time.clear()
        self.stage_calls.clear()

    def update(self, data_stamp: float):
        self.num_scans += 1

    @property
    def elapsed_data(self) -> float:
        return 0.0 if self.t0_data is None else self._last_data - self.t0_data

    def realtime_ratio(self, data_stamp: float) -> float:
        """data seconds processed per wall second (>1 = faster than realtime;
        the reference runs at 0.33-0.5, README.md:54)."""
        if self.t0_data is None:
            return 0.0
        wall = time.perf_counter() - self.t0_wall
        self._last_data = data_stamp
        return (data_stamp - self.t0_data) / max(wall, 1e-9)

    @contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        ann = _trace_annotation(name)
        ann.__enter__()
        try:
            yield
        finally:
            ann.__exit__(None, None, None)
            self.stage_time[name] += time.perf_counter() - t
            self.stage_calls[name] += 1

    def summary(self) -> dict:
        return {
            name: {"total_s": self.stage_time[name], "calls": self.stage_calls[name]}
            for name in sorted(self.stage_time)
        }
