"""Port vs reference: the host-orchestrated pipeline DmsaSlam as a whole.

Both pipelines run the same synthetic sequence at tests/test_pipeline.py's
small_config, with IMU, keyframes every 0.08 m (so that the keyframe
submap optimization runs) and a 3-keyframe map (so that keyframes retire
into the output ledger), as tests/test_torch_fused.py drives the fused
pipeline.  The port's downsamplings take the reference's own jax PRNG bits
(tests/torch_parity.jax_counter_priorities), so both keep the same points.

Tolerances, with their reasons:
  - discrete outcomes (keyframes added, keyframe stamps, the number of
    random draws, which poses are keyframes in the output) are equal, and
    the points kept per keyframe agree within 1%;
  - each window's Gauss-Newton run differs by the 2% cell-build rounding
    that tests/test_torch_structured.py states, and the difference feeds
    the next window's initial guess, so keyframe and output positions
    agree within 1 cm and orientations within 10 mrad; both pipelines meet
    the reference's own ATE gate (tests/test_pipeline.py: 0.15 m).
"""

import numpy as np
import pytest

from dmsa_lidar_slam_tpu.io.synthetic import SyntheticSequence, ate_rmse
from dmsa_lidar_slam_tpu.pipeline.slam import DmsaSlam as JaxDmsaSlam
from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam
from tests.test_pipeline import small_config
from tests.torch_parity import jax_counter_priorities

N_SCANS, PTS = 12, 800
POS_ATOL = 1e-2
ORIENT_ATOL = 1e-2
ATE_GATE = 0.15


def _config():
    return small_config(use_imu=True, imu_factor_weight_submap=0.001, dist_new_keyframe=0.08, last_n_keyframes_for_optim=3)


def _drive(slam):
    seq = SyntheticSequence(rng=np.random.default_rng(11), noise_std=0.01, room_scale=0.45)
    imu_cursor = seq.t_start - 0.2
    for i in range(N_SCANS):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(imu_cursor, t_end)
        slam.process_imu_batch(acc, gyr, ts)
        imu_cursor = t_end
        slam.process_scan(*seq.scan(i, PTS))
    return seq


@pytest.fixture(scope="module")
def runs():
    jslam = JaxDmsaSlam(_config())
    seq = _drive(jslam)
    tslam = DmsaSlam(_config(), device="cpu")
    tslam.priorities = jax_counter_priorities
    _drive(tslam)
    return jslam, tslam, seq


def test_same_keyframes_and_draws(runs):
    jslam, tslam, _ = runs
    assert tslam.kf_map.count == jslam.kf_map.count
    assert tslam.kf_map.num_updates == jslam.kf_map.num_updates >= 4  # the 3-keyframe map retired some
    assert tslam._prng_counter == jslam._prng_counter
    n = jslam.kf_map.count
    np.testing.assert_allclose(tslam.kf_map.stamps[:n], jslam.kf_map.stamps[:n], atol=1e-9)
    # keyframe clouds: the window's world points differ by the mm of the
    # pose difference, so a point near a voxel boundary of the keyframe
    # downsampling may change voxels: the kept counts agree within 1%
    np.testing.assert_allclose(tslam.kf_map.pt_mask[:n].sum(1), jslam.kf_map.pt_mask[:n].sum(1), rtol=0.01)
    assert tslam.output.order_is_key == jslam.output.order_is_key


def test_keyframe_poses_match(runs):
    jslam, tslam, seq = runs
    n = jslam.kf_map.count
    np.testing.assert_allclose(tslam.kf_map.transl_w[:n], jslam.kf_map.transl_w[:n], atol=POS_ATOL)
    np.testing.assert_allclose(tslam.kf_map.orient_w[:n], jslam.kf_map.orient_w[:n], atol=ORIENT_ATOL)
    for slam in (jslam, tslam):
        assert ate_rmse(slam.kf_map.stamps[:n], slam.kf_map.transl_w[:n], seq) < ATE_GATE


def test_output_trajectory_matches(runs, tmp_path):
    jslam, tslam, seq = runs
    jlines = open(jslam.save_poses(str(tmp_path / "jax"))).read().split("\n")
    tlines = open(tslam.save_poses(str(tmp_path / "torch"))).read().split("\n")
    assert len(tlines) == len(jlines) > 4
    j = np.array([[float(v) for v in l.split()] for l in jlines if l])
    t = np.array([[float(v) for v in l.split()] for l in tlines if l])
    np.testing.assert_allclose(t[:, 0], j[:, 0], atol=1e-6)
    np.testing.assert_allclose(t[:, 1:4], j[:, 1:4], atol=POS_ATOL)
    assert ate_rmse(t[:, 0], t[:, 1:4], seq) < ATE_GATE


def test_map_points_match(runs):
    jslam, tslam, _ = runs
    jp, tp = jslam.map_points(), tslam.map_points()
    assert abs(len(tp) - len(jp)) <= 0.01 * len(jp)
    # same room surfaces: each port map point lies near a reference map point
    d = np.sqrt(((tp[::7, None, :] - jp[None, :, :]) ** 2).sum(-1)).min(1)
    assert np.quantile(d, 0.99) < 0.1, np.quantile(d, 0.99)
    assert tslam.current_pose() is not None
    assert tslam.submap_points(span=1).shape[0] == tslam.kf_map.pt_mask[tslam.kf_map.count - 1].sum()


def test_entry_points_refuse_cpu_fallback_and_distributed():
    """Without a card the default device raises instead of running on the
    CPU; the distributed keyframe optimization is not ported and says so."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DmsaSlam(_config())
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 12"):
        DmsaSlam(small_config(distributed_keyframe_opt=True), device="cpu")
