"""The readers of the fused step's spans and counters (window.static_ms,
window.optimize_ms, window.gn_iters, window.gn_tables_ms,
keyframe.cloud_ms, keyframe.submap_ms) on a short CPU run's
Metrics.summary(), at a small configuration whose window solve, keyframes
and submap solve all run within ten scans; and on a program that records
none of these keys (before they existed), where each finds nothing."""

import numpy as np
import pytest

from bench_port import harness

READS = {
    "window.static_ms": lambda s: 1e3 * s["window.static"]["total_s"] / s["window.static"]["calls"],
    "window.optimize_ms": lambda s: 1e3 * s["window.optimize"]["total_s"] / s["window.optimize"]["calls"],
    "window.gn_iters": lambda s: s["window.gn.iters"]["count"] / s["window.optimize"]["calls"],
    "window.gn_tables_ms": lambda s: 1e3 * s["window.gn.tables"]["total_s"] / s["window.gn.iters"]["count"],
    "keyframe.cloud_ms": lambda s: 1e3 * s["keyframe.cloud"]["total_s"] / s["keyframe.cloud"]["calls"],
    "keyframe.submap_ms": lambda s: 1e3 * s["keyframe.submap"]["total_s"] / s["keyframe.submap"]["calls"],
}


@pytest.fixture(scope="module")
def stages():
    from dmsa_lidar_slam_tpu_torch.config import Config
    from dmsa_lidar_slam_tpu_torch.io.synthetic import SyntheticSequence
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    cfg = Config(
        n_clouds=3, num_control_poses=6, max_num_points_per_scan=700, min_dist_ds=3.0, min_dist=0.05,
        num_iter_sliding_window_optim=3, num_iter_keyframe_optim=2, min_num_points_gauss=5,
        min_num_points_gauss_key=5, closest_k_keyframes_as_static_points=3, last_n_keyframes_for_optim=3,
        dist_new_keyframe=0.05, n_dense=101, static_points_cap=4096, keyframe_points_cap=2048, raw_scan_cap=4096,
        use_imu=True, imu_factor_weight_submap=0.001,
    )
    slam = FusedDmsaSlam(cfg, flush_every=8, device="cpu")
    seq = SyntheticSequence(rng=np.random.default_rng(11), noise_std=0.01, room_scale=0.45)
    cursor = seq.t_start - 0.2
    for i in range(10):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(cursor, t_end)
        slam.process_imu_batch(acc, gyr, ts)
        cursor = t_end
        slam.process_scan(*seq.scan(i, 500))
    return slam.metrics.summary(), cfg


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_the_summary(stages, name):
    s, cfg = stages
    run = dict(scan_s=[0.5], is_kf=[False], stages=s, profile=None, rooflines=None)
    v = harness.read_metric(name, run)
    assert v is not None and np.isfinite(v) and v > 0
    assert v == pytest.approx(READS[name](s), rel=1e-12)
    if name == "window.gn_iters":
        assert 1 <= v <= cfg.num_iter_sliding_window_optim


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_finds_nothing_in_a_parent_summary(stages, name):
    """The keys a program without these spans records: the wrapper's."""
    s, _ = stages
    parent = {k: dict(total_s=v["total_s"], calls=v["calls"]) for k, v in s.items()
              if k in ("pack_fill", "upload", "step", "flush")}
    run = dict(scan_s=[0.5], is_kf=[False], stages=parent, profile=None, rooflines=None)
    assert harness.read_metric(name, run) is None
