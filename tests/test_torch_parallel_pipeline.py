"""The distributed keyframe optimization in the port's pipelines and CLI
runner, on 2 gloo ranks (tests/torch_dist.py) against one rank.

Every rank runs FusedDmsaSlam and DmsaSlam with distributed_keyframe_opt
over the same 12 scans of 800 points (tests/test_torch_fused.py's scale
and sequence: keyframes every 0.08 m, a 3-keyframe map, so the submap
optimization runs and keyframes retire), then the CLI runner with the
flag.  The same runs on one rank (this process, no process group) are
the reference: the fused pipeline warns and optimizes its submaps on one
card, the host pipeline on a one-rank mesh.  Tolerances, with their
reasons:
  - the ranks end with the same keyframes bit for bit (every collective
    gives every rank the same bits, and each rank's window optimization is
    the same computation);
  - keyframe positions within 0.05 m of the one-rank run, the reference's
    own bound (tests/test_fused_dist.py:49): the submap's cell sums reduce
    in another order, and each window's start follows the submap;
  - only rank 0 writes the runner's outputs.
"""

import os

import numpy as np
import pytest

from dmsa_lidar_slam_tpu_torch.config import Config
from dmsa_lidar_slam_tpu_torch.io.synthetic import SyntheticSequence
from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam
from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam
from tests import test_runner_e2e as ref_e2e
from tests import torch_dist
from tests.test_pipeline import small_config
from tests.torch_bag import write_sequence_bag

N_SCANS, PTS = 12, 800
KF_POS_TOL_M = 0.05


def _config(**overrides):
    cfg = small_config(use_imu=True, imu_factor_weight_submap=0.001, dist_new_keyframe=0.08,
                       last_n_keyframes_for_optim=3, distributed_keyframe_opt=True, **overrides)
    return torch_dist.config_dict(cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 2 ranks' results, the one-rank keyframes of each pipeline, the
    runner's directories)."""
    tmp = tmp_path_factory.mktemp("pipelines")
    bag = str(tmp / "synthetic.bag")
    write_sequence_bag(bag, SyntheticSequence(rng=np.random.default_rng(7), noise_std=0.01, room_scale=0.45), 6, 700)
    over = dict(ref_e2e._overrides(bag, "", use_imu=False), distributed_keyframe_opt=True, dist_new_keyframe=0.08)
    dirs = [str(tmp / f"out{r}") for r in range(2)]
    for d in dirs:
        os.makedirs(d)
    ranks = torch_dist.Ranks(torch_dist.pipeline_runs, 2, tmp, _config(), N_SCANS, PTS, over, dirs)
    one = {}  # meanwhile, the same runs on this one process
    for name, cls in (("fused", FusedDmsaSlam), ("host", DmsaSlam)):
        slam = cls(Config(**_config()), device="cpu")
        torch_dist.drive(slam, N_SCANS, PTS)
        one[name] = (torch_dist.keyframes(slam), slam)
    return ranks.results(), one, dirs


@pytest.mark.parametrize("name", ["fused", "host"])
def test_two_ranks_match_one_rank(runs, name):
    two, one, _ = runs
    (pos1, ori1), slam1 = one[name]
    pos2, ori2 = two[0][name]["keyframes"]
    assert two[0][name]["mesh_size"] == 2
    assert len(pos2) == len(pos1) >= 3
    gap = float(np.max(np.linalg.norm(pos2 - pos1, axis=1)))
    assert gap < KF_POS_TOL_M, f"2-rank vs 1-rank keyframe positions {gap:.4f} m"
    if name == "fused":
        assert slam1.mesh is None  # one rank: the single-card submap, with a warning
        assert two[0][name]["max_submap_span"] > 0
        assert two[0][name]["shuffle_overflow"] == 0
    else:
        assert slam1._dist_kf_mesh.size == 1


@pytest.mark.parametrize("name", ["fused", "host"])
def test_ranks_bit_identical(runs, name):
    two, _, _ = runs
    for a, b in zip(two[0][name]["keyframes"], two[1][name]["keyframes"]):
        np.testing.assert_array_equal(a, b)


def test_runner_only_rank_zero_writes(runs):
    two, _, dirs = runs
    assert {"Poses.txt", "PointCloud.pcd"} <= set(two[0]["files"])
    assert two[1]["files"] == []
