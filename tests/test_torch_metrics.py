"""The port's host spans and counters (pipeline/metrics.py) and where the
fused step records them.

  - Metrics alone: nested spans keep their total and self seconds and their
    enclosing span, counters sum, reset_stages clears both, and a span
    enters torch.profiler.record_function only while a profiler records;
  - a short CPU FusedDmsaSlam run (tests/test_torch_fused.py's small
    configuration, copied here so that this file imports no jax, at fewer
    iterations) fills every span and counter of the fused step and its
    Gauss-Newton loops, nested as the step runs them;
  - a step replayed without Metrics gives the recorded step's state bit for
    bit: the spans change nothing the step computes.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmsa_lidar_slam_tpu_torch.config import Config
from dmsa_lidar_slam_tpu_torch.io.synthetic import SyntheticSequence
from dmsa_lidar_slam_tpu_torch.pipeline import fused as tfused
from dmsa_lidar_slam_tpu_torch.pipeline import metrics as pm

N_SCANS, PTS = 10, 500

STEP_CHILDREN = ("step.preprocess", "window.assemble", "map.init", "window.static", "window.optimize",
                 "window.decide", "keyframe.cloud", "keyframe.submap")
GN_PARTS = ("tables", "cells", "stop")
SUBMAP_CHILDREN = ("submap.view", "submap.optimize", "submap.write_back")


def _config():
    return Config(
        n_clouds=3, num_control_poses=6, max_num_points_per_scan=700, min_dist_ds=3.0, min_dist=0.05,
        num_iter_sliding_window_optim=3, num_iter_keyframe_optim=2, min_num_points_gauss=5,
        min_num_points_gauss_key=5, closest_k_keyframes_as_static_points=3, last_n_keyframes_for_optim=3,
        dist_new_keyframe=0.05, n_dense=101, static_points_cap=4096, keyframe_points_cap=2048, raw_scan_cap=4096,
        use_imu=True, imu_factor_weight_submap=0.001,
    )


class _Clock:
    """perf_counter stand-in: each read advances one second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_nested_stages_keep_self_time_and_parent(monkeypatch):
    monkeypatch.setattr(pm.time, "perf_counter", _Clock())
    m = pm.Metrics()
    with m.stage("outer"):  # reads the clock at 1 and 8
        with m.stage("inner"):  # 2 and 3
            pass
        with m.stage("inner"):  # 4 and 7
            with m.stage("leaf"):  # 5 and 6
                pass
    s = m.summary()
    assert s["leaf"] == dict(total_s=1.0, calls=1, self_s=1.0, parent="inner")
    assert s["inner"] == dict(total_s=4.0, calls=2, self_s=3.0, parent="outer")
    assert s["outer"] == dict(total_s=7.0, calls=1, self_s=3.0, parent=None)


def test_counters_sum_and_reset_clears_them():
    m = pm.Metrics()
    m.count("a")
    m.count("a", 4)
    m.count("b", 0)
    with m.stage("s"):
        pass
    s = m.summary()
    assert s["a"] == {"count": 5} and s["b"] == {"count": 0}
    assert list(s) == sorted(s)
    m.reset_stages()
    assert m.summary() == {}
    m.count("a")
    assert m.summary() == {"a": {"count": 1}}


def test_existing_keys_keep_their_shape():
    """Readers of `total_s` and `calls` (the bench's wrapper.pack_upload_ms)
    read what they read before."""
    m = pm.Metrics()
    for _ in range(3):
        with m.stage("pack_fill"):
            pass
    s = m.summary()["pack_fill"]
    assert s["calls"] == 3 and isinstance(s["calls"], int)
    assert s["total_s"] == pytest.approx(s["self_s"])
    assert 0.0 <= s["total_s"] < 1.0


def test_record_function_only_while_a_profiler_records(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        entered.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    m = pm.Metrics()
    with m.stage("off"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.stage("step", args="7"):
            with m.stage("window.optimize"):
                torch.ones(3).sum()
    with m.stage("off"):
        pass
    assert entered == [("step", "7"), ("window.optimize", None)]
    names = {e.name for e in prof.events()}
    assert {"step", "window.optimize"} <= names
    inner = next(e for e in prof.events() if e.name == "window.optimize")
    outer = next(e for e in prof.events() if e.name == "step")
    assert outer.time_range.start <= inner.time_range.start <= inner.time_range.end <= outer.time_range.end
    assert m.summary()["off"]["calls"] == 2


@pytest.fixture(scope="module")
def fused_run():
    """A short CPU run; records the last dispatched step's inputs and
    output, and the iterations each solve's optimize returned, by name."""
    from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as topt

    slam = tfused.FusedDmsaSlam(_config(), flush_every=8, device="cpu")
    step = slam.step
    last = {}
    returned = {"window": [], "submap": []}
    optimize = topt.optimize

    def recording_optimize(*args, **kwargs):
        out = optimize(*args, **kwargs)
        returned[kwargs["name"]].append(int(out.num_iters))
        return out

    def recording_step(state, pack, aux, prio):
        out = step(state, pack, aux, prio)
        last.update(before=state, pack=pack, aux=aux, prio=prio, after=out)
        return out

    slam.step = recording_step
    seq = SyntheticSequence(rng=np.random.default_rng(11), noise_std=0.01, room_scale=0.45)
    cursor = seq.t_start - 0.2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(topt, "optimize", recording_optimize)
        for i in range(N_SCANS):
            t_end = seq.t_start + (i + 1) * seq.sweep
            ts, acc, gyr = seq.imu_samples(cursor, t_end)
            slam.process_imu_batch(acc, gyr, ts)
            cursor = t_end
            slam.process_scan(*seq.scan(i, PTS))
    slam.returned_iters = returned
    return slam, slam.metrics.summary(), last


def test_run_fills_every_span_and_counter(fused_run):
    slam, s, _ = fused_run
    c = slam.config
    for name in ("pack_fill", "upload", "step"):
        assert s[name]["calls"] == slam.scan_counter and s[name]["parent"] is None
    assert "dispatch" not in s
    for name in STEP_CHILDREN:
        assert s[name]["calls"] > 0 and s[name]["parent"] == "step", name
    for opt_name, parent, n_iter in (("window", "window.optimize", c.num_iter_sliding_window_optim),
                                     ("submap", "submap.optimize", c.num_iter_keyframe_optim)):
        for part in GN_PARTS:
            assert s[f"{opt_name}.gn.{part}"]["parent"] == parent
        solves = s[parent]["calls"]
        iters = s[f"{opt_name}.gn.iters"]["count"]
        assert solves <= iters <= n_iter * solves, (opt_name, iters, solves)
        assert s[f"{opt_name}.gn.stop"]["calls"] == iters
        assert s[f"{opt_name}.gn.tables"]["calls"] == s[f"{opt_name}.gn.cells"]["calls"] == 2 * iters
    solves = s["keyframe.submap"]["calls"]
    s_sub = tfused.submap_keyframes(c, slam.shapes)
    assert 2 * solves <= s["submap.span"]["count"] <= s_sub * solves
    assert s["submap.params"]["count"] == 6 * (s_sub - 1) * solves
    # the event rows' submap spans (column 7 of the keyframe rows) sum to the counter
    ev = slam.state.events[: int(slam.state.ev_index)]
    assert int(ev[ev[:, 0] == tfused.EV_KEYFRAME, 7].sum()) == s["submap.span"]["count"]


def test_submap_solve_spans_nest_under_keyframe_submap(fused_run):
    """The submap solve's three child spans run once a solve, inside
    keyframe.submap (the optimizer's submap.gn.* spans nest under
    submap.optimize: test_run_fills_every_span_and_counter); the children
    and keyframe.submap's self time make up its total."""
    _, s, _ = fused_run
    solves = s["keyframe.submap"]["calls"]
    assert solves > 0
    for name in SUBMAP_CHILDREN:
        assert s[name]["calls"] == solves and s[name]["parent"] == "keyframe.submap", name
    kids = sum(s[name]["total_s"] for name in SUBMAP_CHILDREN)
    assert s["keyframe.submap"]["total_s"] == pytest.approx(kids + s["keyframe.submap"]["self_s"], abs=1e-9)


@pytest.mark.parametrize("name", ["window", "submap"])
def test_iteration_counter_is_the_iterations_returned(fused_run, name):
    """<name>.gn.iters sums the num_iters that each solve's optimize
    returned; the submap's solves are the calls of submap.optimize."""
    slam, s, _ = fused_run
    returned = slam.returned_iters[name]
    parent = "window.optimize" if name == "window" else "submap.optimize"
    assert len(returned) == s[parent]["calls"] > 0
    assert s[f"{name}.gn.iters"]["count"] == sum(returned)


def test_window_tables_kernel_counter_reads_zero_on_the_cpu(fused_run):
    """window.gn.tables_kernel counts the table calls served by K6: none on
    CPU tensors, where the window's tables take torch.func; the submap
    supplies no kernel entry and records no such counter."""
    _, s, _ = fused_run
    assert s["window.gn.iters"]["count"] > 0
    assert s["window.gn.tables_kernel"]["count"] == 0
    assert "submap.gn.tables_kernel" not in s


def test_spans_partition_the_step(fused_run):
    """Each span's self time is its total less its children's; the step's
    children together stay within it."""
    _, s, _ = fused_run
    spans = {k: v for k, v in s.items() if "total_s" in v}
    for name, v in spans.items():
        kids = sum(w["total_s"] for w in spans.values() if w["parent"] == name)
        assert v["self_s"] == pytest.approx(v["total_s"] - kids, abs=1e-9), name
        assert 0.0 <= v["self_s"] <= v["total_s"], name
    assert s["window.optimize"]["total_s"] >= sum(s[f"window.gn.{p}"]["total_s"] for p in GN_PARTS)


def test_step_without_metrics_repeats_the_recorded_step(fused_run):
    slam, _, last = fused_run
    step = tfused.make_step(slam.config, slam.shapes, "cpu")
    out = step(last["before"], last["pack"], last["aux"], last["prio"])
    for a, b in zip(torch.utils._pytree.tree_leaves(out), torch.utils._pytree.tree_leaves(last["after"])):
        assert torch.equal(a, b)
