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


def _run(tmp_path, pipeline, n_scans, pts, use_imu, **overrides):
    bag = str(tmp_path / "synthetic.bag")
    seq = write_sequence_bag(bag, _sequence(), n_scans, pts)
    over = dict(ref_e2e._overrides(bag, str(tmp_path), use_imu=use_imu), **overrides)
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
    """Without a card the default device raises rather than running on the
    CPU.  --distributed-keyframe-opt, which the runner refused before the
    distributed backends were ported, now runs: without torchrun's
    environment on this one process, the keyframe optimization on a
    one-rank mesh (parallel.spatial), and the outputs are written."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runner.run([], overrides=bag_overrides(str(tmp_path / "none.bag"), str(tmp_path)), pipeline="host")
    slam = _run(tmp_path, "host", n_scans=8, pts=700, use_imu=False, distributed_keyframe_opt=True,
                dist_new_keyframe=0.08)
    mesh = slam._dist_kf_mesh
    assert mesh is not None and mesh.size == 1 and mesh.group is None, "the keyframe optimization did not run"
