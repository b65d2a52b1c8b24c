"""Port vs reference: the fused per-scan SLAM step as a whole.

Both pipelines run the same synthetic sequence at tests/test_pipeline.py's
small_config (12 scans of 800 points, IMU on, keyframes every 0.08 m so
that the submap optimization runs, a 3-keyframe ring so that keyframes
retire into the output ledger).  The reference runs its tabular
optimizer path, as it does on the TPU (DMSA_FUSED_TABULAR=1, kernels as
their plain XLA versions on the CPU); the port runs its kernels' plain
PyTorch versions.  The port's step takes the reference's own jax PRNG bits
(tests/torch_parity.jax_step_priorities), so both downsample the same
points.

Tolerances, with their reasons:
  - the int16 wire pack and the f32 aux block are the same host code on
    both sides: equal bit for bit;
  - one step from a shared state: the two cell builds agree only to the 2%
    (lamw6, cell residuals) that the reference grants its own kernel against
    its plain build (valid cell counts differ by up to 2%), so the window
    that a Gauss-Newton run moves by centimetres lands within 5 mm / 5 mrad
    of the reference's at its least constrained (last) control pose, and
    the event's overlap fraction within 0.02 (a static point within
    rounding of the overlap radius may flip); discrete outcomes (event
    type, stop reason, submap span, points kept) are equal;
  - over the run these differences feed the next window's initial guess,
    so keyframe positions (and the merged output trajectory) agree within
    1 cm, and each pipeline's ATE meets
    the reference's own gate (tests/test_fused.py: 0.15 m).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from dmsa_lidar_slam_tpu.io.synthetic import SyntheticSequence, ate_rmse
from dmsa_lidar_slam_tpu.pipeline import fused as jfused
from dmsa_lidar_slam_tpu_torch import convert
from dmsa_lidar_slam_tpu_torch.pipeline import fused as tfused
from tests.test_pipeline import small_config
from tests.torch_parity import jax_step_priorities, nn

N_SCANS, PTS = 12, 800
STEP_POSE_ATOL = 5e-3
OVERLAP_ATOL = 0.02
KF_POS_ATOL = 1e-2
ATE_GATE = 0.15


def _config():
    return small_config(use_imu=True, imu_factor_weight_submap=0.001, dist_new_keyframe=0.08, last_n_keyframes_for_optim=3)


def _drive(slam, seq):
    imu_cursor = seq.t_start - 0.2
    for i in range(N_SCANS):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(imu_cursor, t_end)
        slam.process_imu_batch(acc, gyr, ts)
        imu_cursor = t_end
        slam.process_scan(*seq.scan(i, PTS))
    slam._flush_events()


def _sequence():
    return SyntheticSequence(rng=np.random.default_rng(11), noise_std=0.01, room_scale=0.45)


def _numpy_tree(state):
    return jax.tree_util.tree_map(np.array, state)


@pytest.fixture(scope="module")
def reference_run():
    """The reference's run, with every step's (state before, pack, aux,
    state after) recorded as numpy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMSA_FUSED_TABULAR", "1")
        slam = jfused.FusedDmsaSlam(_config(), flush_every=8)
    steps = []
    step = slam.step

    def recording_step(state, pack, aux):
        before = _numpy_tree(state)
        out = step(state, pack, aux)
        steps.append((before, np.array(pack), np.array(aux), _numpy_tree(out)))
        return out

    slam.step = recording_step
    seq = _sequence()
    _drive(slam, seq)
    return slam, seq, steps


@pytest.fixture(scope="module")
def port_run(reference_run):
    """The port's run on the same sequence, fed the reference's PRNG bits;
    records its packs."""
    slam = tfused.FusedDmsaSlam(_config(), flush_every=8, device="cpu")
    slam.priorities = lambda seed: jax_step_priorities(seed, slam.shapes)
    packs = []
    step = slam.step

    def recording_step(state, pack, aux, prio):
        packs.append((nn(pack), nn(aux)))
        return step(state, pack, aux, prio)

    slam.step = recording_step
    seq = _sequence()
    _drive(slam, seq)
    return slam, seq, packs


def test_empty_state_layout_matches_reference():
    """Same fields, shapes and dtypes as the reference's FusedState."""
    cfg = _config()
    jslam = jfused.FusedDmsaSlam(cfg, flush_every=8)
    tshapes = tfused.shapes_from_config(cfg, 8)
    assert dataclasses.asdict(jslam.shapes) == dataclasses.asdict(tshapes)
    want = _numpy_tree(jfused.empty_state(jslam.shapes))
    got = convert.state_to_numpy(tfused.empty_state(tshapes, "cpu"))
    for name, w, g in _leaves(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _leaves(a, b):
    for f in a._fields:
        if f == "kf":
            for g in a.kf._fields:
                yield f"kf.{g}", getattr(a.kf, g), getattr(b.kf, g)
        else:
            yield f, getattr(a, f), getattr(b, f)


def _map_state(rng, K=6, P=64, count=6):
    """A reference DeviceMapState with `count` random keyframes, as numpy."""
    from dmsa_lidar_slam_tpu.map import device_map as jdmap
    from dmsa_lidar_slam_tpu.map.keyframes import MapShapes

    f64 = np.float64
    st = _numpy_tree(jdmap.empty_state(MapShapes(K, P), jax.numpy.float64))
    return st._replace(
        local_pts=rng.standard_normal((K, P, 3)).astype(np.float32),
        local_normals=rng.standard_normal((K, P, 3)).astype(np.float32),
        pt_mask=rng.uniform(size=(K, P)) > 0.2,
        pt_ring=rng.integers(0, 16, (K, P)).astype(np.int32),
        grid_size=np.where(np.arange(K) < count, rng.uniform(0.2, 0.6, K), np.inf).astype(np.float32),
        orient_w=0.3 * rng.standard_normal((K, 3)).astype(f64),
        transl_w=np.cumsum(rng.uniform(0.1, 0.4, (K, 3)), axis=0),
        stamps=np.arange(K, dtype=f64),
        grav_meas=rng.standard_normal((K, 3)) + [0.0, 0.0, 9.8],
        grav_plausible=rng.uniform(size=K) > 0.3,
        odom_rel_orient=0.01 * rng.standard_normal((K, 3)),
        odom_rel_transl=0.01 * rng.standard_normal((K, 3)),
        count=np.int32(count),
        num_updates=np.int32(count + 2),
    )


@pytest.mark.parametrize("count", [4, 6])
def test_device_map_matches_reference(count):
    """The keyframe ring off the run's path too: add with shift-out-oldest
    (ring full at count 6), closest candidates, candidate clouds, and the
    capped submap view and write-back where the span is cut to the newest
    S = 3 keyframes (from_id = count - S).  f64 pose math on both sides:
    1e-12; f32 clouds: 1e-6."""
    from dmsa_lidar_slam_tpu.map import device_map as jdmap
    from dmsa_lidar_slam_tpu_torch.map import device_map as tdmap

    rng = np.random.default_rng(count)
    jst = _map_state(rng, count=count)
    tst = tdmap.DeviceMapState(**{f: torch.as_tensor(np.array(getattr(jst, f))) for f in tdmap.DeviceMapState._fields})
    jnp_ = jax.numpy

    def close(a, b, tol=1e-12):
        np.testing.assert_allclose(nn(a), np.asarray(b), rtol=tol, atol=tol)

    P = jst.local_pts.shape[1]
    new = (rng.uniform(size=3), 0.2 * rng.standard_normal(3), 7.5, rng.standard_normal((P, 3)).astype(np.float32),
           rng.standard_normal((P, 3)).astype(np.float32), rng.integers(0, 16, P).astype(np.int32),
           rng.uniform(size=P) > 0.5, np.float32(0.3), rng.standard_normal(3), True)
    jout = jdmap.add_keyframe(jax.tree_util.tree_map(jnp_.asarray, jst), *(jnp_.asarray(v) for v in new))
    tout = tdmap.add_keyframe(tst, *(torch.as_tensor(np.asarray(v)) for v in new))
    for f in tdmap.DeviceMapState._fields:
        close(getattr(tout[0], f), getattr(jout[0], f))
    for a, b in zip(tout[1:], jout[1:]):
        close(a, b)

    pos = np.asarray(jst.transl_w[2]) + 0.05
    jids, jvalid = jdmap.closest_candidates(jst, jnp_.asarray(pos), 3, 0.5)
    tids, tvalid = tdmap.closest_candidates(tst, torch.as_tensor(pos), 3, 0.5)
    np.testing.assert_array_equal(nn(tids), np.asarray(jids))
    np.testing.assert_array_equal(nn(tvalid), np.asarray(jvalid))
    for a, b in zip(tdmap.candidate_clouds(tst, tids, tvalid), jdmap.candidate_clouds(jst, jids, jvalid)):
        close(a, b, 1e-6)

    S, from_id = 3, count - 3
    consts = (1.0, 1e-3, np.eye(3) / 0.09, np.eye(3) * 1e4, np.eye(3) * 1e4, np.array([0.0, 0.0, -9.805]))
    jdata, jp0 = jdmap.submap_view_capped(jst, from_id, S, *(jnp_.asarray(v) for v in consts))
    tdata, tp0 = tdmap.submap_view_capped(tst, from_id, S, *(torch.as_tensor(np.asarray(v)) for v in consts))
    close(tp0, jp0)
    for f in jdata._fields:
        close(getattr(tdata, f), getattr(jdata, f))
    params = np.asarray(jp0) + 0.01 * rng.standard_normal(jp0.shape)
    jback = jdmap.write_back_capped(jst, from_id, jnp_.asarray(params))
    tback = tdmap.write_back_capped(tst, from_id, torch.as_tensor(params))
    close(tback.orient_w, jback.orient_w)
    close(tback.transl_w, jback.transl_w)
    close(tdmap.min_grid_from(tst, from_id), jdmap.min_grid_from(jst, from_id))


def test_state_roundtrip(reference_run):
    """state_from_numpy / state_to_numpy keep every leaf, dtype included,
    on a mid-run reference state with keyframes in its map."""
    _, _, steps = reference_run
    state = steps[-1][3]
    assert int(state.kf.count) >= 2
    port = convert.state_from_numpy(state, device="cpu")
    assert port.kf.transl_w.dtype == torch.float64 and port.scan_pts.dtype == torch.float32
    back = convert.state_to_numpy(port)
    for name, w, g in _leaves(state, back):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_wire_pack_matches_reference(reference_run, port_run):
    _, _, steps = reference_run
    _, _, packs = port_run
    assert len(packs) == len(steps)
    for (_, jpack, jaux, _), (tpack, taux) in zip(steps, packs):
        np.testing.assert_array_equal(tpack, jpack)
        np.testing.assert_array_equal(taux, jaux)


def test_one_step_from_shared_state(reference_run):
    """Every window step of the reference's run, replayed by the port from
    the reference's own state before it, with the reference's bits."""
    jslam, _, steps = reference_run
    shapes = tfused.shapes_from_config(_config(), 8)
    port_step = tfused.make_step(jslam.config, shapes, "cpu")
    n_window = 0
    for before, pack, aux, after in steps:
        seed = int(aux[shapes.n_dense + 2, 1])
        out = port_step(
            convert.state_from_numpy(before, device="cpu"), torch.as_tensor(pack), torch.as_tensor(aux),
            jax_step_priorities(seed, shapes),
        )
        out = convert.state_to_numpy(out)
        row = int(before.ev_index) % shapes.ev_cap
        ev_j, ev_t = after.events[row], out.events[row]
        assert ev_t[0] == ev_j[0], (seed, ev_t[0], ev_j[0])
        assert int(out.kf.count) == int(after.kf.count)
        np.testing.assert_array_equal(out.scan_mask, after.scan_mask)
        np.testing.assert_array_equal(out.scan_pts, after.scan_pts)
        if ev_j[0] == 0:
            continue
        n_window += 1
        np.testing.assert_allclose(ev_t[1:7], ev_j[1:7], atol=STEP_POSE_ATOL)
        np.testing.assert_allclose(out.ow_transl, after.ow_transl, atol=STEP_POSE_ATOL)
        np.testing.assert_allclose(out.ow_orient, after.ow_orient, atol=STEP_POSE_ATOL)
        np.testing.assert_allclose(ev_t[15], ev_j[15], atol=OVERLAP_ATOL)
        assert ev_t[16] == ev_j[16]  # stop reason
        assert abs(ev_t[17] - ev_j[17]) <= 0.02 * ev_j[17]  # valid cells
        assert ev_t[7] == ev_j[7] and ev_t[18] == ev_j[18]  # span or related kf; static points kept
        n = int(after.kf.count)
        np.testing.assert_allclose(out.kf.transl_w[:n], after.kf.transl_w[:n], atol=STEP_POSE_ATOL)
    assert n_window >= 8


def test_run_matches_reference(reference_run, port_run):
    jslam, seq, _ = reference_run
    tslam, _, _ = port_run
    assert tslam.kf_count == jslam.kf_count >= 3
    assert tslam.max_submap_span == jslam.max_submap_span > 0
    js, jt, _ = jslam.keyframe_poses()
    ts, tt_, _ = tslam.keyframe_poses()
    np.testing.assert_allclose(ts, js, atol=1e-9)
    np.testing.assert_allclose(tt_, jt, atol=KF_POS_ATOL)
    assert ate_rmse(js, jt, seq) < ATE_GATE
    assert ate_rmse(ts, tt_, seq) < ATE_GATE
    jev = np.array(jslam.state.events)
    tev = tslam.state.events.numpy()
    np.testing.assert_array_equal(tev[:, 0], jev[:, 0])
    # the 3-keyframe ring is full: keyframes retire into the output ledger
    retired = jev[:, 8] > 0.5
    assert retired.any()
    np.testing.assert_array_equal(tev[:, 8] > 0.5, retired)
    jst, jtr, jor = jslam.all_poses()
    tst, ttr, tor = tslam.all_poses()
    assert tslam.output.order_is_key == jslam.output.order_is_key
    np.testing.assert_allclose(tst, jst, atol=1e-9)
    np.testing.assert_allclose(ttr, jtr, atol=KF_POS_ATOL)
