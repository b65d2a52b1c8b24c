"""The generator's sensor rig (generator.rig, from a configuration file's
keys) with the Hilti-Oxford 2022 rig of configs/hilti_2022.yaml: a Hesai
PandarXT-32 (32 rings 1 degree apart from -16 to +15 degrees) mounted on
the IMU through a 180-degree turn and a lever arm, carried with the LiDAR
upright, swaying in roll and pitch; and a cell with that rig that the
harness runs from files alone."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from bench_port import compare, generator, harness
from bench_port.reference.config import Config
from bench_port.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
# configs/hilti_2022.yaml: q_w, q_x, q_y, q_z and t_x, t_y, t_z
HILTI_QUAT = [0.0, 0.7071068, -0.7071068, 0.0]
HILTI_TRANSL = [-0.001, -0.00855, 0.055]
XT32_RINGS = [float(e) for e in range(-16, 16)]  # deg, ring id 0 lowest
# the Hilti turn is its own transpose, so a transposed or inverted rotation
# shows only under a turn that is not: this one, about a skew axis
SKEW_QUAT = [float(v) for v in Rotation.from_rotvec([2.9, -0.4, 0.3]).as_quat()[[3, 0, 1, 2]]]
# the loop mix without noise or bias, carried upright: the extrinsic turns
# the LiDAR's z into the IMU's -z, so the body is rolled by pi; plus sway
SWAY = dict(roll0=np.pi, roll_wobble=[0.12, 1.7], pitch_wobble=[0.08, 2.3, 0.6])
QUIET = dict(noise_std=0.0, imu_noise_acc=0.0, imu_noise_gyr=0.0, imu_bias_acc=[0.0, 0.0, 0.0],
             imu_bias_gyr=[0.0, 0.0, 0.0])
SEED = 2**31 + 4242
POINTS = 2048


def hilti_cfg(acceleration_in_g=False, quat=HILTI_QUAT):
    """nc_os128's file with the Hilti rig: the XT32's rings and field, the
    extrinsic, the IMU's units."""
    cfg = json.loads((BENCH / "configs" / "nc_os128.json").read_text())
    cfg["stream"].update(points_per_scan=64000, rings=32, ring_elevations_deg=XT32_RINGS)
    cfg["pipeline"].update(sensor="hesai", lidar_to_imu_quat=quat, lidar_to_imu_transl=HILTI_TRANSL,
                           acceleration_in_g=acceleration_in_g, raw_scan_cap=64000)
    return cfg


def sequence():
    seq = json.loads((BENCH / "traffic" / "loop.json").read_text())["sequence"]
    return dict(seq, **QUIET, **SWAY)


def hilti_stream(n_scans=3, acceleration_in_g=False, quat=HILTI_QUAT):
    cfg = hilti_cfg(acceleration_in_g, quat)
    rig = generator.rig(cfg)
    data = generator.stream(SEED, sequence(), n_scans, POINTS, 32, 400, {}, rig=rig)
    return data, generator.truth(sequence(), rig)


def world_rotation(truth, t):
    pose = truth.pose(float(t))
    return Rotation.from_rotvec(pose.rotvec), pose.position


def test_imu_agrees_with_the_truths_finite_differences():
    """(a) gyr and acc against central differences of truth().pose(t),
    past the ramp, where the pose is smooth."""
    data, truth = hilti_stream(n_scans=40)
    ts = np.concatenate([rec[3] for rec in data])
    acc = np.concatenate([rec[4] for rec in data])
    gyr = np.concatenate([rec[5] for rec in data])
    past_ramp = ts > truth.t_start + truth.t_still + truth.t_ramp + 0.05
    assert past_ramp.sum() > 400
    h = 1e-3
    for t, a, w in zip(ts[past_ramp][::7], acc[past_ramp][::7], gyr[past_ramp][::7]):
        R0, p0 = world_rotation(truth, t)
        Rm, pm = world_rotation(truth, t - h)
        Rp, pp = world_rotation(truth, t + h)
        w_fd = (Rm.inv() * Rp).as_rotvec() / (2 * h)
        a_fd = R0.inv().apply((pp - 2 * p0 + pm) / (h * h) - generator.GRAVITY)
        # truncation ~h^2/6 |w''| ~ 2e-7 rad/s at this sway; rounding of the
        # stamps (~2e-13 s at t ~ 1000 s) over 2h ~ 2e-10
        np.testing.assert_allclose(w, w_fd, rtol=0, atol=1e-5, err_msg=f"gyr at {t}")
        # truncation ~h^2/12 |p''''| ~ 5e-8 m/s^2; the positions' rounding
        # (~1e-15 m) and the stamps' over h^2 ~ 1e-6 s^2 ~ 1e-9 and 3e-7
        np.testing.assert_allclose(a, a_fd, rtol=0, atol=1e-4, err_msg=f"acc at {t}")


@pytest.mark.parametrize("quat", [HILTI_QUAT, SKEW_QUAT], ids=["hilti", "skew"])
def test_points_lie_on_the_scene_through_truth_and_extrinsic(quat):
    """(b) each point, taken to the IMU frame by the extrinsic as the
    program takes it (Config.lidar_to_imu_tform: p_imu = R p + t) and to the
    world by the truth pose at its stamp, lies on a plane of the room."""
    data, truth = hilti_stream(quat=quat)
    T = Config(lidar_to_imu_quat=tuple(quat), lidar_to_imu_transl=tuple(HILTI_TRANSL)).lidar_to_imu_tform
    planes = truth.planes
    for pts, stamps, *_ in data:
        body = pts.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
        world = np.stack([R.apply(b) + p for b, (R, p) in
                          zip(body, (world_rotation(truth, t) for t in stamps))])
        best = np.full(len(world), np.inf)
        for p0, nrm, eu, ev in planes:
            u, v = generator._plane_frame(nrm)
            d = world - np.asarray(p0, float)
            off = np.abs(d @ (np.asarray(nrm, float) / np.linalg.norm(nrm)))
            inside = (np.abs(d @ u) <= eu + 1e-4) & (np.abs(d @ v) <= ev + 1e-4)
            best = np.where(inside, np.minimum(best, off), best)
        # the points are float32: ~2e-6 m of rounding at a 25 m range
        assert best.max() <= 1e-4, best.max()


def os1_64_stream():
    """nc_os64's file with the OS1-64's own field, +-16.6 degrees over its
    64 rings, carried upright (no extrinsic) with the sway."""
    cfg = json.loads((BENCH / "configs" / "nc_os64.json").read_text())
    cfg["stream"].update(vertical_fov_deg=[-16.6, 16.6])
    seq = dict(sequence(), roll0=0.0)
    return generator.stream(SEED, seq, 3, POINTS, 64, 400, {}, rig=generator.rig(cfg))


@pytest.mark.parametrize("sensor", ["xt32", "os1_64"])
def test_rings_and_field(sensor):
    """(c) every point inside the field, each ring the table's nearest,
    all ids present, ordered as their elevations; every scan holds its
    points_per_scan.  The XT32 by its table of 32 elevations; the OS1-64 by
    its field alone, its 64 rings spread evenly over it."""
    if sensor == "xt32":
        data, table = hilti_stream()[0], np.deg2rad(np.asarray(XT32_RINGS))
    else:
        data, table = os1_64_stream(), np.deg2rad(np.linspace(-16.6, 16.6, 64))
    lo, hi, half = table[0], table[-1], (table[1] - table[0]) / 2
    for pts, stamps, rings, *_ in data:
        assert len(pts) == len(stamps) == len(rings) == POINTS
        assert np.all(np.diff(stamps) >= 0)
        elev = generator.elevation(pts.astype(np.float64))
        # float32 points move an elevation by ~1e-7 rad
        assert elev.min() >= lo - 1e-6 and elev.max() <= hi + 1e-6
        assert np.all(np.abs(elev - table[rings]) <= half + 1e-6)
        assert sorted(set(rings.tolist())) == list(range(len(table)))
        means = [elev[rings == r].mean() for r in range(len(table))]
        assert np.all(np.diff(means) > 0)


def test_acceleration_in_g():
    """(d) with acceleration_in_g the same stream, its acceleration over
    G_UNIT."""
    ms2, _ = hilti_stream()
    in_g, _ = hilti_stream(acceleration_in_g=True)
    for a, b in zip(ms2, in_g):
        for i in (0, 1, 2, 3, 5):
            np.testing.assert_array_equal(a[i], b[i])
        # one division and one multiplication by 9.81: within 1 ulp
        assert np.all(np.abs(b[4] * 9.81 - a[4]) <= np.spacing(np.abs(a[4])))


@pytest.mark.parametrize("acceleration_in_g", [False, True], ids=["m_s2", "in_g"])
def test_a_rig_cell_runs_from_files_alone(root, tmp_path, acceleration_in_g):
    """A Hilti-rigged configuration and cell that only add files and
    entries: a temporary root with BENCHMARK.json plus the entries and the
    configuration's file (at the tiny size), the loop mix with the sway,
    run by run_cell on the CPU, where the reference agrees bit for bit; the
    IMU in m/s^2 as the Hilti's, and in g (configs/livox.yaml's units)."""
    manifest = json.loads((Path(root) / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(name="hilti_xt32", source="configs/hilti_2022.yaml",
                                    file="bench_port/configs/hilti_xt32.json", reduced=[], why="a rig"))
    manifest["workloads"].append(dict(name="hilti_xt32.loop", config="hilti_xt32", traffic="loop", chips=1,
                                      why="a rig"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cfg = hilti_cfg(acceleration_in_g)
    cfg["pipeline"].update(tiny.OVERRIDES)
    cfg["stream"].update(points_per_scan=1000)
    (tmp_path / "bench_port" / "configs").mkdir(parents=True)
    (tmp_path / "bench_port" / "configs" / "hilti_xt32.json").write_text(json.dumps(cfg))
    cell, cfg, traffic, manifest = tiny.loaded(str(tmp_path), segment=(8, 10), name="hilti_xt32.loop")
    assert cfg["stream"]["ring_elevations_deg"] == XT32_RINGS
    traffic = copy.deepcopy(traffic)
    traffic["sequence"].update(SWAY)
    result, extras = harness.run_cell(str(tmp_path), "hilti_xt32.loop", SEED, 1e-3, 0, device="cpu",
                                      loaded=(cell, cfg, traffic, manifest))
    assert result["correct"], (result["checks"], extras["numbers"])
    steps = {k: v for k, v in extras["numbers"].items() if k != "ate_m"}
    assert all(v == 0.0 for v in steps.values()), extras["numbers"]
    assert set(compare.COMPARED) <= set(extras["numbers"])
