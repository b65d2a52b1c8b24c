"""The port on a Hilti-rigged stream: the sensor rig of
bench_port/configs/hilti_xt32.json (a Hesai PandarXT-32 on its 32-ring
table, mounted on the IMU through configs/hilti_2022.yaml's 180-degree turn
and lever arm) carried as bench_port/traffic/handheld.json carries it (the
LiDAR upright, so the body rolled by pi, swaying in roll and pitch), drawn
by bench_port.generator without noise or bias at 1,000 points a scan, run
through FusedDmsaSlam at tests/test_torch_fused.py's small widths with a
6-keyframe ring.

  (a) the port against the JAX package, both fed the same inputs and the
      JAX package's random bits: the same keyframes and event types, and
      positions within test_torch_fused.py's tolerance; with Hilti's turn,
      and with a turn about a skew axis (Hilti's is its own transpose, so
      only a turn that is not shows a transposed or inverted extrinsic);
  (b) the port's relative orientations between keyframes, R_i^T R_j,
      against the truth's, with no rotational alignment (a relative
      orientation does not depend on the estimator's world frame);
  (c) the skew turn's stream run with its extrinsic transposed fails (b);
  (d) every keyframe's gravity estimate passes the plausibility gate, in
      both packages.

The benchmark's check follows the plain reference, which reads the same
Config convention as the program, and its trajectory error aligns the turn
away; this test holds the convention instead.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from bench_port import generator
from dmsa_lidar_slam_tpu.pipeline import fused as jfused
from dmsa_lidar_slam_tpu_torch.pipeline import fused as tfused
from tests.test_pipeline import small_config
from tests.test_torch_fused import KF_POS_ATOL
from tests.torch_parity import jax_step_priorities

BENCH = Path(__file__).resolve().parents[1] / "bench_port"
RIG = json.loads((BENCH / "configs" / "hilti_xt32.json").read_text())
SEQUENCE = json.loads((BENCH / "traffic" / "handheld.json").read_text())["sequence"]
QUIET = dict(noise_std=0.0, imu_noise_acc=0.0, imu_noise_gyr=0.0, imu_bias_acc=[0.0, 0.0, 0.0],
             imu_bias_gyr=[0.0, 0.0, 0.0])
HILTI_QUAT = RIG["pipeline"]["lidar_to_imu_quat"]
# w, x, y, z of a 2.94 rad turn about a skew axis: its transpose is another turn
SKEW_QUAT = [float(v) for v in Rotation.from_rotvec([2.9, -0.4, 0.3]).as_quat()[[3, 0, 1, 2]]]
TURNS = {"hilti": HILTI_QUAT, "skew": SKEW_QUAT}
SEED = 2**31 + 1707
# a still start of 3 scans (the static start that the map's initialisation
# needs) and a 0.5 s ramp in place of the mix's 6 scans and 1.5 s; 12 scans
# are the fewest that reach the 5 keyframes (a) asks for
START = dict(t_still=0.3, t_ramp=0.5)
N_SCANS, PTS = 12, 1000
# (b): the port reads 1.9e-3 rad with either turn on this noise-free stream
# (the window's and the submap's solves stop at their iteration caps on
# scans of 700 kept points); the skew turn's stream run with the transposed
# turn, a frame wrong by 0.4 rad, reads 0.093 rad.  0.01 rad lies between,
# 5x above the one and 9x below the other
REL_ROT_TOL = 1e-2


def _transposed(quat):
    w, x, y, z = quat
    return [w, -x, -y, -z]


def _stream(quat):
    cfg = json.loads(json.dumps(RIG))
    cfg["pipeline"]["lidar_to_imu_quat"] = quat
    rig = generator.rig(cfg)
    seq = dict(SEQUENCE, **QUIET, **START)
    data = generator.stream(SEED, seq, N_SCANS, PTS, RIG["stream"]["rings"], RIG["stream"]["imu_rate_hz"], {},
                            rig=rig)
    return data, generator.truth(seq, rig)


def _config(quat):
    return small_config(use_imu=True, imu_factor_weight_submap=0.001, dist_new_keyframe=0.1,
                        last_n_keyframes_for_optim=6, lidar_to_imu_quat=tuple(quat),
                        lidar_to_imu_transl=tuple(RIG["pipeline"]["lidar_to_imu_transl"]))


def _drive(slam, data):
    for pts, stamps, rings, ts, acc, gyr in data:
        slam.process_imu_batch(acc, gyr, ts)
        slam.process_scan(pts, stamps, rings)
    slam._flush_events()
    return slam


def _port(data, quat):
    slam = tfused.FusedDmsaSlam(_config(quat), flush_every=8, device="cpu")
    slam.priorities = lambda seed: jax_step_priorities(seed, slam.shapes)
    return _drive(slam, data)


@pytest.fixture(scope="module")
def streams():
    return {name: _stream(quat) for name, quat in TURNS.items()}


@pytest.fixture(scope="module")
def runs(streams):
    """{turn: (JAX package's slam, port's slam)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMSA_FUSED_TABULAR", "1")
        for name, quat in TURNS.items():
            data, _ = streams[name]
            out[name] = (_drive(jfused.FusedDmsaSlam(_config(quat), flush_every=8), data), _port(data, quat))
    return out


def _events(slam):
    ev = np.asarray(slam.state.events)
    return ev[: min(slam.scan_counter, len(ev))]


def relative_rotation_error(slam, truth):
    """The largest angle, rad, between the slam's R_i^T R_j and the truth's,
    over every pair of its active keyframes (at their stamps)."""
    stamps, _, orient = slam.keyframe_poses()
    R = Rotation.from_rotvec(np.asarray(orient, dtype=np.float64))
    Q = Rotation.from_rotvec(np.stack([truth.pose(float(s)).rotvec for s in stamps]))
    n = len(stamps)
    return max(((R[i].inv() * R[j]).inv() * (Q[i].inv() * Q[j])).magnitude()
               for i in range(n) for j in range(i + 1, n))


@pytest.mark.parametrize("turn", sorted(TURNS))
def test_port_matches_the_jax_package(runs, turn):
    """(a) the same keyframes and event types; keyframe and output
    positions within test_torch_fused.py's 1 cm."""
    jslam, tslam = runs[turn]
    assert tslam.kf_count == jslam.kf_count >= 5
    assert tslam.max_submap_span == jslam.max_submap_span >= 3
    np.testing.assert_array_equal(_events(tslam)[:, 0], _events(jslam)[:, 0])
    js, jt, _ = jslam.keyframe_poses()
    ts, tt_, _ = tslam.keyframe_poses()
    np.testing.assert_allclose(ts, js, atol=1e-9)
    np.testing.assert_allclose(tt_, jt, atol=KF_POS_ATOL)
    jst, jtr, _ = jslam.all_poses()
    tst, ttr, _ = tslam.all_poses()
    np.testing.assert_allclose(tst, jst, atol=1e-9)
    np.testing.assert_allclose(ttr, jtr, atol=KF_POS_ATOL)


@pytest.mark.parametrize("turn", sorted(TURNS))
def test_relative_orientations_match_the_truth(streams, runs, turn):
    """(b) with no rotational alignment."""
    _, truth = streams[turn]
    _, tslam = runs[turn]
    assert relative_rotation_error(tslam, truth) <= REL_ROT_TOL


def test_a_transposed_extrinsic_fails_the_orientation_check(streams):
    """(c) the skew turn's stream, the program given the transposed turn."""
    data, truth = streams["skew"]
    slam = _port(data, _transposed(SKEW_QUAT))
    assert slam.kf_count >= 5
    assert relative_rotation_error(slam, truth) > REL_ROT_TOL


@pytest.mark.parametrize("turn", sorted(TURNS))
def test_gravity_estimates_pass_the_gate(runs, turn):
    """(d) every keyframe's gravity estimate is plausible (the map's first
    keyframe and each added one, the event rows' column 22), in both
    packages."""
    for slam in runs[turn]:
        n = slam.kf_count
        assert np.all(np.asarray(slam.state.kf.grav_plausible)[:n]), type(slam).__module__
        ev = _events(slam)
        rows = ev[ev[:, 0] == tfused.EV_KEYFRAME]
        assert len(rows) >= 4 and np.all(rows[:, 22] == 1.0), type(slam).__module__
