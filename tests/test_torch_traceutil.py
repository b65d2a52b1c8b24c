"""The port's trace reader (pipeline/traceutil.py over torch.profiler).

  - a hand-written Chrome trace in torch.profiler's format (host op and
    runtime spans, kernel / memcpy / memset spans on the card, a card-side
    annotation span that covers kernels, metadata events): device_busy_ms,
    op_totals and category_totals give the numbers worked out by hand,
    exactly (tolerance 1e-12, float sums of a few terms);
  - category_totals of both packages on the same dicts are equal (no op
    name of a torch trace is a while / conditional, which only the
    reference drops);
  - a capture() on the CPU writes a trace that load_events reads back, and
    keeps the profiler's events of the same session;
  - csrc_kernel_name picks the port's own kernels out of kernel names.
"""

import gzip
import json

import pytest
import torch

from dmsa_lidar_slam_tpu.pipeline import traceutil as jtu
from dmsa_lidar_slam_tpu_torch.pipeline import traceutil as ttu

KERNEL_A = "void (anonymous namespace)::build_fwd<32>(float const*, int)"
KERNEL_B = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int, at::native::FillFunctor<float>)"


def _trace_events():
    def x(name, cat, ts, dur, pid=0, tid=7):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": {}}

    return [
        {"ph": "M", "name": "process_name", "pid": 123, "tid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "CUDA GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 123, "tid": 123, "args": {"name": "thread 123 (python3)"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
        x("aten::add", "cpu_op", 0, 50.0, 123, 123),
        x("cudaLaunchKernel", "cuda_runtime", 5, 4.0, 123, 123),
        x("step", "user_annotation", 0, 500.0, 123, 123),
        x("step", "gpu_user_annotation", 10, 400.0),
        x(KERNEL_A, "kernel", 10, 120.5),
        x(KERNEL_A, "kernel", 140, 79.5),
        x(KERNEL_B, "kernel", 230, 3.25),
        x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 240, 16.0),
        x("Memset (Device)", "gpu_memset", 260, 1.25),
        {"ph": "i", "name": "marker", "pid": 123, "tid": 123, "ts": 3, "s": "t"},
    ]


@pytest.fixture
def trace_dir(tmp_path):
    d = tmp_path / "trace" / "plugins"
    d.mkdir(parents=True)
    with gzip.open(d / "host_1.pt.trace.json.gz", "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": _trace_events()}, f)
    return str(tmp_path / "trace")


def test_busy_and_op_totals_of_a_known_trace(trace_dir):
    xs, pids, tids = ttu.load_events(trace_dir)
    assert len(xs) == 9
    assert pids == {123: "python3", 0: "CUDA GPU 0"}
    assert tids[(0, 7)] == "stream 7"
    busy = (120.5 + 79.5 + 3.25 + 16.0 + 1.25) / 1e3  # kernels, memcpy, memset; not the annotation
    assert ttu.device_busy_ms(trace_dir) == pytest.approx(busy, abs=1e-12)
    total, ops, opn = ttu.op_totals(trace_dir)
    assert total == pytest.approx(busy, abs=1e-12)
    assert ops[KERNEL_A] == 200.0 and opn[KERNEL_A] == 2
    assert ops[KERNEL_B] == 3.25 and opn[KERNEL_B] == 1
    assert set(ops) == {KERNEL_A, KERNEL_B, "Memcpy HtoD (Pageable -> Device)", "Memset (Device)"}
    cat, catn = ttu.category_totals(ops, opn, total)
    assert cat == {KERNEL_A: 200.0, KERNEL_B: 3.25,
                   "Memcpy HtoD (Pageable -> Device)": 16.0, "Memset (Device)": 1.25}
    assert sum(catn.values()) == 5
    assert ttu.host_call_counts(trace_dir) == {"cudaLaunchKernel": 1}


def test_plain_json_trace_is_read_too(tmp_path):
    with open(tmp_path / "worker0.1.pt.trace.json", "w") as f:
        json.dump({"traceEvents": _trace_events()}, f)
    assert ttu.device_busy_ms(str(tmp_path)) == pytest.approx(0.2205, abs=1e-12)
    with pytest.raises(FileNotFoundError):
        ttu.load_events(str(tmp_path / "empty"))


def test_category_totals_match_reference():
    """Names with trailing digits group by base name in both packages."""
    ops = {"fusion.12": 10.0, "fusion.3": 5.5, "copy": 1.0, "add_7": 2.0, "dot.1.2": 4.0, "Memset (Device)": 0.5}
    opn = {"fusion.12": 2, "fusion.3": 1, "copy": 4, "add_7": 1, "dot.1.2": 3, "Memset (Device)": 1}
    got = ttu.category_totals(ops, opn, 23.0)
    want = jtu.category_totals(ops, opn, 23.0)
    assert got == want
    assert got[0]["fusion"] == 15.5 and got[1]["fusion"] == 3 and got[0]["add_"] == 2.0


def test_capture_on_the_cpu_reads_back(tmp_path):
    """The trace and the profiler's own events are one session: the same
    matmuls in both."""
    cap = ttu.capture(str(tmp_path / "t"))
    with cap as d:
        x = torch.ones(64, 64)
        for _ in range(3):
            x = x @ x / 64.0
    xs, pids, _ = ttu.load_events(d)
    assert sum(e["name"] == "aten::mm" for e in xs) == 3 and pids
    assert sum(e.name == "aten::mm" for e in cap.profile.events()) == 3
    assert ttu.device_busy_ms(d) == 0.0  # no card: no device spans
    with ttu.capture() as d2:
        torch.ones(3).sum()
    assert d2 != d and ttu.load_events(d2)[0]


def test_csrc_kernel_names():
    """Only the port's kernels (a top-level anonymous namespace) count as
    csrc kernels, not PyTorch's anonymous-namespace kernels."""
    assert ttu.csrc_kernel_name(KERNEL_A) == "build_fwd"
    assert ttu.csrc_kernel_name("(anonymous namespace)::gn_pieces(float const*, int)") == "gn_pieces"
    assert ttu.csrc_kernel_name("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(int)") is None
    assert ttu.csrc_kernel_name(KERNEL_B) is None
