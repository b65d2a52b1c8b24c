"""Shared torch.profiler trace capture and parsing (counterpart of
dmsa_lidar_slam_tpu/pipeline/traceutil.py).

One definition of "device-busy ms" for every instrument that reads a trace
(tools/torch_profile.py, chip_smoke.py, a bench), so that they cannot
disagree about what they measure.

Method: torch.profiler writes a Chrome trace (export_chrome_trace).  The
card's work shows up there as complete ("X") events in three categories:
"kernel" (every CUDA kernel, the port's own csrc kernels and PyTorch's),
"gpu_memcpy" and "gpu_memset".  Device-busy time is the sum of their
durations.  It excludes host gaps, the host-side op and runtime events and
the card-side mirrors of host annotations ("gpu_user_annotation"), which
span kernels rather than add to them.
"""

import collections
import glob
import gzip
import json
import os
import re
import tempfile
import time
from typing import Dict, Optional, Tuple

# Copies and memsets occupy the card as kernels do (the reference's
# "XLA Modules" spans hold a module's transfers too), and chip_smoke.py's
# per-call profile counts them in its busy time, so they count here.  The
# port runs on one stream, so the spans do not overlap and their sum is the
# busy time.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Capture:
    """The context manager that capture() returns: entering starts
    torch.profiler (host activity and, where a card is present, the card's)
    and gives the trace directory; leaving waits for the card, stops the
    profiler and writes the Chrome trace there.  The stopped profiler stays
    in `profile`, for a second reader of the same session."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.dir = trace_dir or tempfile.mkdtemp(prefix="dmsa_trace_")
        self.profile = None

    def __enter__(self) -> str:
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.dir, exist_ok=True)
        self._cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self.profile = profile(activities=activities)
        self.profile.__enter__()
        return self.dir

    def __exit__(self, *exc):
        import torch

        if self._cuda:
            torch.cuda.synchronize()  # the enqueued kernels finish inside the trace
        self.profile.__exit__(*exc)
        if exc[0] is None:
            name = f"dmsa_{os.getpid()}_{time.monotonic_ns()}.pt.trace.json.gz"
            self.profile.export_chrome_trace(os.path.join(self.dir, name))
        return False


def capture(trace_dir: Optional[str] = None) -> Capture:
    """Context manager: profile the host and, where a card is present, the
    card, and write a Chrome trace into `trace_dir` (a fresh private temp
    dir when None).  `with capture() as d:` yields the directory path."""
    return Capture(trace_dir)


def load_events(trace_dir: str):
    """Load the newest *.trace.json(.gz) under trace_dir.

    Returns (x_events, pids, tids): the complete "X" (span) events plus the
    pid -> process-name and (pid, tid) -> thread-name maps."""
    paths = [
        p
        for pattern in ("*.trace.json.gz", "*.trace.json")
        for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)
    ]
    if not paths:
        raise FileNotFoundError(f"no trace.json(.gz) under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    with open(path, "rb") as f:
        raw = f.read()
    d = json.loads(gzip.decompress(raw) if path.endswith(".gz") else raw)
    events = d.get("traceEvents", [])
    pids = {
        e["pid"]: e["args"].get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    tids = {
        (e["pid"], e["tid"]): e["args"].get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    xs = [e for e in events if e.get("ph") == "X"]
    return xs, pids, tids


def _device_spans(xs):
    return [e for e in xs if e.get("cat") in DEVICE_CATEGORIES]


def device_busy_ms(trace_dir: str) -> float:
    """Total device-busy time (ms) in the trace: the sum of the kernel,
    memcpy and memset span durations."""
    xs, _, _ = load_events(trace_dir)
    return sum(e.get("dur", 0) for e in _device_spans(xs)) / 1e3


def op_totals(trace_dir: str) -> Tuple[float, Dict[str, float], Dict[str, int]]:
    """(device-busy ms, per-name total us, per-name count) over the device
    spans of the trace (kernels, copies and memsets by name)."""
    xs, _, _ = load_events(trace_dir)
    ops: Dict[str, float] = collections.Counter()
    opn: Dict[str, int] = collections.Counter()
    for e in _device_spans(xs):
        ops[e["name"]] += e.get("dur", 0)
        opn[e["name"]] += 1
    return sum(ops.values()) / 1e3, ops, opn


def category_totals(ops: Dict[str, float], opn: Dict[str, int], mod_total_ms: float):
    """Group per-op totals by op base name (trailing digits and dots
    stripped).  The reference also drops structural while / conditional ops
    that nest most of the module time; a torch trace has no such spans (a
    kernel span never contains another), so nothing is dropped and
    mod_total_ms is unused, kept for the reference's signature."""
    cat = collections.Counter()
    catn = collections.Counter()
    for k, v in ops.items():
        base = re.sub(r"[.\d]+$", "", k)
        cat[base] += v
        catn[base] += opn[k]
    return cat, catn


_CSRC_KERNEL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")


def csrc_kernel_name(name: str) -> Optional[str]:
    """The function name of one of the port's own kernels in a trace's
    kernel name, else None.  The csrc/*.cu kernels all live in a top-level
    anonymous namespace (PyTorch's own anonymous-namespace kernels sit
    inside at::native)."""
    m = _CSRC_KERNEL.match(name)
    return m.group(1) if m else None


def host_call_counts(trace_dir: str) -> Dict[str, int]:
    """How often each CUDA runtime / driver call (cudaLaunchKernel,
    cudaStreamSynchronize, cudaMemcpyAsync, ...) ran on the host."""
    xs, _, _ = load_events(trace_dir)
    return collections.Counter(e["name"] for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver"))
