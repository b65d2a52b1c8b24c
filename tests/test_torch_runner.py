"""The port's CLI runner end to end on the CPU: a crafted ouster-layout
rosbag (tests/torch_bag.py, written without jax) -> pipeline.runner.run ->
Poses.txt and PointCloud.pcd, for the host-orchestrated and the fused
pipelines, checked as tests/test_runner_e2e.py checks the reference's
runner: at least 3 TUM poses in stamp order, ATE < 0.15 m, a map of more
than 500 points.  The full-size cases are slow-marked, as the reference's
are; a smaller case of each runs in tier 1.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.io.synthetic import SyntheticSequence
from dmsa_lidar_slam_tpu_torch.pipeline import runner
from tests import test_runner_e2e as ref_e2e
from tests.torch_bag import bag_overrides, serialize_ouster_scan, write_sequence_bag


def _sequence(seed=7):
    return SyntheticSequence(rng=np.random.default_rng(seed), noise_std=0.01, room_scale=0.45)


def _run(tmp_path, pipeline, n_scans, pts, use_imu):
    bag = str(tmp_path / "synthetic.bag")
    seq = write_sequence_bag(bag, _sequence(), n_scans, pts)
    over = ref_e2e._overrides(bag, str(tmp_path), use_imu=use_imu)
    slam = runner.run([], overrides=over, pipeline=pipeline, device="cpu")
    ref_e2e.check_outputs(tmp_path, seq, slam)
    return slam


def test_bag_writer_matches_reference_test_bag():
    """The vectorized writer gives the reference test's bytes."""
    pts, stamps, rings = _sequence().scan(2, 300)
    assert serialize_ouster_scan(pts, stamps, rings) == ref_e2e.serialize_ouster_scan(pts, stamps, rings)


@pytest.mark.parametrize("pipeline,use_imu", [("host", False), ("fused", True)])
def test_runner_small_bag(tmp_path, pipeline, use_imu):
    slam = _run(tmp_path, pipeline, n_scans=8, pts=700, use_imu=use_imu)
    assert (slam.kf_map.count if pipeline == "host" else slam.kf_count) >= 1


@pytest.mark.slow
@pytest.mark.parametrize("pipeline,use_imu", [("host", False), ("fused", True)])
def test_runner_on_bag(tmp_path, pipeline, use_imu):
    """tests/test_runner_e2e.py's bag and settings, through the port."""
    slam = _run(tmp_path, pipeline, n_scans=12, pts=900, use_imu=use_imu)
    assert (slam.kf_map.count if pipeline == "host" else slam.kf_count) >= 2


def test_runner_refuses_what_it_cannot_run(tmp_path):
    """--distributed-keyframe-opt is not ported and says so, before any bag
    is read; without a card the default device raises rather than running
    on the CPU."""
    settings = str(Path(__file__).resolve().parents[1] / "configs" / "slam_settings.yaml")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 12"):
        runner.main([settings, "--distributed-keyframe-opt", "--pipeline", "host"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runner.run([], overrides=bag_overrides(str(tmp_path / "none.bag"), str(tmp_path)), pipeline="host")
