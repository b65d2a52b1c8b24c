"""Port vs reference: the tabular Gauss-Newton optimizer on the window and the
keyframe problems, the table builders and their Jacobians, and the stop-code
probes of tests/test_fused_residuals.py:349-387 on the port.

The reference runs its tabular path as it runs on the CPU, under jit
(build_packed_ref, gn_system_ref, cand_errors_ref); the port runs its
kernels' plain versions.  The two builds agree only to the tolerance the
reference grants its own kernel against its plain build (lamw6 to 2% of its
scale, cell residuals to 2%, tests/test_fused_residuals.py): the floored
3x3 inverse amplifies f32 covariance rounding, and XLA's fused f32 pose
transform rounds world points differently, so a point within an ulp of a
voxel boundary can change cells.  Hence:

  - the table builders and their Jacobians agree to f32/f64 rounding;
  - stop reason and iteration count match exactly;
  - the valid cell count agrees to 2%, the final error to 2%;
  - after one iteration the parameters agree to 2e-3 (a fraction of the
    first step, which moves them by up to 1e-2 here), and after six to 5e-3:
    the line search is an argmin over candidates 0.1 of a step apart whose
    errors agree only to those 2%, so a neighbouring fraction may win.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.core import poses as jcp
from dmsa_lidar_slam_tpu.dmsa import optimizer as jopt
from dmsa_lidar_slam_tpu.map import keyframes as jkfm
from dmsa_lidar_slam_tpu.trajectory import builder
from dmsa_lidar_slam_tpu.trajectory import continuous as jct
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as topt
from dmsa_lidar_slam_tpu_torch.map import keyframes as tkfm
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as tct
from tests import test_window as tw
from dmsa_lidar_slam_tpu.io.synthetic import room_scene, sample_scene_points
from tests.torch_parity import nn, tt

PARAM_ATOL = {1: 2e-3, 6: 5e-3}  # by iteration count, see the module docstring


def _to_port(jdata, cls):
    return cls(**{f: tt(getattr(jdata, f)) for f in cls._fields})


def _make_scans(rng, n_scans, pts_per_scan, sweep=0.1):
    """tests/test_window.py make_scans in a room scaled by 0.45: enough
    cells per window that the normal equations are well conditioned (with
    the full-size room, 600 points per scan give ~20 cells for 30
    parameters, and the Gauss-Newton step then amplifies f32 rounding)."""
    from scipy.spatial.transform import Rotation

    world = sample_scene_points(rng, pts_per_scan * n_scans, planes=room_scene(0.45))
    scans = []
    for s in range(n_scans):
        w = world[s * pts_per_scan : (s + 1) * pts_per_scan]
        stamps = np.sort(s * sweep + rng.uniform(0, sweep, size=pts_per_scan))
        local = np.zeros((pts_per_scan, 3), dtype=np.float32)
        for i in range(pts_per_scan):
            pos, rv = tw.true_pose(stamps[i])
            local[i] = Rotation.from_rotvec(rv).as_matrix().T @ (w[i] - pos)
        rings = (np.arange(pts_per_scan) % 16).astype(np.int32)
        scans.append(builder.HostScan(points=local, stamps=stamps + 1000.0, rings=rings, grid_size=0.2))
    return scans


@functools.lru_cache(maxsize=None)
def _window_problem(seed, use_imu):
    rng = np.random.default_rng(seed)
    scans = _make_scans(rng, n_scans=3, pts_per_scan=597)
    shapes = jct.WindowShapes(n_window_pts=1792, n_static=256, n_ctrl=6, n_dense=251)
    buf = None
    if use_imu:
        from dmsa_lidar_slam_tpu.imu.buffer import ImuBuffer

        buf = ImuBuffer()
        imu_t = np.arange(-0.05, 0.45, 0.002)
        acc, gyr = tw.simulate_imu(imu_t)
        for i in range(len(imu_t)):
            buf.add_measurement(acc[i], gyr[i], imu_t[i] + 1000.0)
        buf.bias_gyr[:] = 0.0
        buf.gyr[: len(imu_t)] = gyr
    data, _, min_grid, _ = builder.build_window(
        scans, shapes, buf, 1e-4 * np.eye(3), 1e-2 * np.eye(3), 0.01 if use_imu else 0.0, use_imu=use_imu
    )
    # static map points on the identity row: a slice of the true scene
    stat = sample_scene_points(rng, 256, planes=room_scene(0.45)).astype(np.float32)
    data = data._replace(
        static_pts=jnp.asarray(stat), static_mask=jnp.asarray(rng.uniform(size=256) > 0.3),
        static_ring=jnp.asarray(rng.integers(0, 16, 256).astype(np.int32)),
    )
    chain = tw.true_params_for_window(data, shapes)
    data = data._replace(anchor_orient=chain.orient[0], anchor_transl=chain.transl[0])
    true_params = np.asarray(jcp.params_from_chain(chain))
    init = true_params + rng.normal(scale=0.01, size=true_params.shape)
    return shapes, data, init, float(min_grid)


def _keyframe_problem(seed=5, n_kf=4, ppk=512):
    rng = np.random.default_rng(seed)
    pts = sample_scene_points(rng, ppk, planes=room_scene(0.45)).astype(np.float32)
    rings = rng.integers(0, 8, size=ppk).astype(np.int32)
    true_o = 0.05 * rng.standard_normal((n_kf, 3))
    true_t = np.array([[0, 0, 0], [0.5, 0, 0], [1.0, 0.1, 0], [1.5, 0.1, 0.05]])[:n_kf]
    from scipy.spatial.transform import Rotation

    local = np.stack([(pts - true_t[k]) @ Rotation.from_rotvec(true_o[k]).as_matrix() for k in range(n_kf)])
    normals = rng.standard_normal((n_kf, ppk, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    f64 = jnp.float64
    data = jkfm.KeyframeMapData(
        local_pts=jnp.asarray(local, jnp.float32),
        local_normals=jnp.asarray(normals),
        pt_mask=jnp.ones((n_kf, ppk), bool),
        pt_ring=jnp.asarray(np.stack([rings] * n_kf)),
        grid_size=jnp.full((n_kf,), 0.25, jnp.float32),
        kf_mask=jnp.ones((n_kf,), bool),
        anchor_orient=jnp.asarray(true_o[0], f64),
        anchor_transl=jnp.asarray(true_t[0], f64),
        stamps=jnp.arange(n_kf, dtype=f64),
        grav_meas=jnp.asarray(rng.standard_normal((n_kf, 3)) + [0, 0, -9.8], f64),
        grav_plausible=jnp.asarray([True, True, False, True][:n_kf]),
        odom_rel_transl=jnp.asarray(0.01 * rng.standard_normal((n_kf, 3)), f64),
        odom_rel_orient=jnp.asarray(0.01 * rng.standard_normal((n_kf, 3)), f64),
        gravity=jnp.asarray([0.0, 0.0, -9.805], f64),
        cov_grav_inv=jnp.eye(3, dtype=f64) / 0.09,
        odom_transl_cov_inv=jnp.eye(3, dtype=f64) * 1e4,
        odom_orient_cov_inv=jnp.eye(3, dtype=f64) * 1e4,
        balancing_grav=jnp.asarray(1.0, f64),
        balancing_odom=jnp.asarray(1e-3, f64),
    )
    gp = jcp.GlobalPoses(orient=jnp.asarray(true_o, f64), transl=jnp.asarray(true_t, f64))
    params_true = np.asarray(jcp.params_from_chain(jcp.global2relative(gp)))
    params0 = params_true + 0.03 * rng.standard_normal(params_true.shape)
    return jkfm.MapShapes(n_keyframes=n_kf, n_pts_per_kf=ppk), data, params0


def _jax_tables_and_jacobian(tabular, data, params):
    """The reference optimizer's table Jacobian (jax.linearize + vmap), jitted."""

    @jax.jit
    def run(p, data):
        out, lin = jax.linearize(lambda q: tabular.tables(q, data), p)
        return out, jax.vmap(lin)(jnp.eye(p.shape[0], dtype=p.dtype))

    return run(jnp.asarray(params), data)


def _check_same(jr, tr, num_iter):
    assert int(tr.stop_reason) == int(jr.stop_reason)
    assert int(tr.num_iters) == int(jr.num_iters)
    assert abs(int(tr.num_gaussians) - int(jr.num_gaussians)) <= 0.02 * int(jr.num_gaussians)
    np.testing.assert_allclose(float(tr.final_error), float(jr.final_error), rtol=0.02)
    err = float(np.abs(nn(tr.params) - np.asarray(jr.params)).max())
    assert err <= PARAM_ATOL[num_iter], err


@pytest.mark.parametrize("use_imu", [False, True])
def test_window_tables_and_jacobian(use_imu):
    """The window table builder and its parameter Jacobian (jax.linearize +
    vmap there, torch.func.jacfwd here): f32 tables to 1e-6, f64 IMU
    residuals and Jacobians to 1e-6 relative of their scale."""
    shapes, data, init, _ = _window_problem(11, use_imu)
    jtab = jct.make_tabular(shapes, use_imu)
    ttab = tct.make_tabular(_port_shapes(shapes), use_imu)
    tdata = _to_port(data, tct.WindowData)
    (jt, je), (jdt, jde) = _jax_tables_and_jacobian(jtab, data, init)
    tt_, te = ttab.tables(tt(init), tdata)
    tdt, tde = torch.func.jacfwd(lambda p: ttab.tables(p, tdata))(tt(init))
    np.testing.assert_allclose(nn(tt_), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(nn(te), np.asarray(je), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(nn(tdt.permute(2, 0, 1)), np.asarray(jdt), atol=1e-6 * max(1.0, np.abs(jdt).max()))
    if use_imu:
        np.testing.assert_allclose(nn(tde.T), np.asarray(jde), atol=1e-6 * np.abs(jde).max())
    jx, jti = jtab.point_arrays(data)
    tx, tti = ttab.point_arrays(tdata)
    np.testing.assert_array_equal(nn(tx), np.asarray(jx))
    np.testing.assert_array_equal(nn(tti), np.asarray(jti))


def _port_shapes(shapes):
    return tct.WindowShapes(
        n_window_pts=shapes.n_window_pts, n_static=shapes.n_static, n_ctrl=shapes.n_ctrl, n_dense=shapes.n_dense
    )


@pytest.mark.parametrize("num_iter", [1, 6])
@pytest.mark.parametrize("use_imu", [False, True])
def test_window_optimize(use_imu, num_iter):
    shapes, data, init, min_grid = _window_problem(12, use_imu)
    settings = dict(num_iter=num_iter, step_length_optim=0.2, max_step=0.3, min_num_points_per_set=6,
                    min_num_gaussians=10, epsilon=1e-6)
    jr = jopt.optimize(
        jct.make_forward(shapes, use_imu), jnp.asarray(init), data, jopt.OptimSettings(**settings), min_grid,
        tabular_fn=jct.make_tabular(shapes, use_imu),
    )
    ps = _port_shapes(shapes)
    tr = topt.optimize(
        tct.make_forward(ps, use_imu), tt(init), _to_port(data, tct.WindowData), topt.OptimSettings(**settings),
        min_grid, tabular_fn=tct.make_tabular(ps, use_imu),
    )
    _check_same(jr, tr, num_iter)


@pytest.mark.parametrize("grav_odom", [False, True])
def test_keyframe_tables_and_jacobian(grav_odom):
    """The keyframe table builder and its Jacobian: f32 tables to 1e-6, the
    f64 gravity / odometry residuals and Jacobians to 1e-9 relative."""
    shapes, data, params0 = _keyframe_problem()
    tshapes = tkfm.MapShapes(n_keyframes=shapes.n_keyframes, n_pts_per_kf=shapes.n_pts_per_kf)
    jtab = jkfm.make_tabular(shapes, grav_odom, grav_odom)
    ttab = tkfm.make_tabular(tshapes, grav_odom, grav_odom)
    tdata = _to_port(data, tkfm.KeyframeMapData)
    (jt, je), (jdt, jde) = _jax_tables_and_jacobian(jtab, data, params0)
    tt_, te = ttab.tables(tt(params0), tdata)
    tdt, tde = torch.func.jacfwd(lambda p: ttab.tables(p, tdata))(tt(params0))
    np.testing.assert_allclose(nn(tt_), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(nn(tdt.permute(2, 0, 1)), np.asarray(jdt), atol=1e-6 * max(1.0, np.abs(jdt).max()))
    assert te.shape == je.shape
    if je.size:
        np.testing.assert_allclose(nn(te), np.asarray(je), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(nn(tde.T), np.asarray(jde), atol=1e-9 * np.abs(jde).max())
    jx, jti = jtab.point_arrays(data)
    tx, tti = ttab.point_arrays(tdata)
    np.testing.assert_array_equal(nn(tx), np.asarray(jx))
    np.testing.assert_array_equal(nn(tti), np.asarray(jti))


@pytest.mark.parametrize("num_iter", [1, 6])
@pytest.mark.parametrize("grav_odom", [False, True])
def test_keyframe_optimize(grav_odom, num_iter):
    shapes, data, params0 = _keyframe_problem()
    settings = dict(num_iter=num_iter, min_num_points_per_set=4, min_num_gaussians=5, step_length_optim=0.3,
                    epsilon=1e-4)
    tshapes = tkfm.MapShapes(n_keyframes=shapes.n_keyframes, n_pts_per_kf=shapes.n_pts_per_kf)
    jr = jopt.optimize(
        jkfm.make_forward(shapes, grav_odom, grav_odom, True), jnp.asarray(params0), data,
        jopt.OptimSettings(**settings), 0.25, tabular_fn=jkfm.make_tabular(shapes, grav_odom, grav_odom),
    )
    tr = topt.optimize(
        tkfm.make_forward(tshapes, grav_odom, grav_odom, True), tt(params0), _to_port(data, tkfm.KeyframeMapData),
        topt.OptimSettings(**settings), 0.25, tabular_fn=tkfm.make_tabular(tshapes, grav_odom, grav_odom),
    )
    _check_same(jr, tr, num_iter)


def test_tabular_stop_criteria_probes():
    """The port's optimizer honours the reference's abort semantics
    (DmsaOptimizer.h:89-143), as tests/test_fused_residuals.py:349-387
    checks for the reference: too few gaussians and NaN inputs leave the
    params unchanged with the matching stop reason; num_iter=0 is a no-op."""
    rng = np.random.default_rng(21)
    s, ppk = 3, 256
    pts = sample_scene_points(rng, ppk).astype(np.float32)
    shapes = tkfm.MapShapes(n_keyframes=s, n_pts_per_kf=ppk)
    f64 = torch.float64
    data = tkfm.KeyframeMapData(
        local_pts=tt(np.stack([pts] * s)),
        local_normals=torch.zeros(s, ppk, 3),
        pt_mask=torch.ones(s, ppk, dtype=torch.bool),
        pt_ring=tt(rng.integers(0, 8, size=(s, ppk)).astype(np.int32)),
        grid_size=torch.full((s,), 0.25),
        kf_mask=torch.ones(s, dtype=torch.bool),
        anchor_orient=torch.zeros(3, dtype=f64),
        anchor_transl=torch.zeros(3, dtype=f64),
        stamps=torch.arange(s, dtype=f64),
        grav_meas=torch.zeros(s, 3, dtype=f64),
        grav_plausible=torch.zeros(s, dtype=torch.bool),
        odom_rel_transl=torch.zeros(s, 3, dtype=f64),
        odom_rel_orient=torch.zeros(s, 3, dtype=f64),
        gravity=torch.tensor([0.0, 0.0, -9.805], dtype=f64),
        cov_grav_inv=torch.eye(3, dtype=f64),
        odom_transl_cov_inv=torch.eye(3, dtype=f64),
        odom_orient_cov_inv=torch.eye(3, dtype=f64),
        balancing_grav=torch.tensor(0.0, dtype=f64),
        balancing_odom=torch.tensor(0.0, dtype=f64),
    )
    params0 = torch.full((6 * (s - 1),), 0.01, dtype=f64)
    fwd = tkfm.make_forward(shapes, False, False, False)
    tab = tkfm.make_tabular(shapes, False, False)
    settings = topt.OptimSettings(num_iter=4, min_num_points_per_set=4, min_num_gaussians=5)

    r = topt.optimize(fwd, params0, data._replace(pt_mask=torch.zeros_like(data.pt_mask)), settings, 0.25, tabular_fn=tab)
    assert int(r.stop_reason) == topt.STOP_TOO_FEW_GAUSSIANS
    assert torch.equal(r.params, params0)

    r = topt.optimize(fwd, params0, data._replace(pt_ring=torch.zeros_like(data.pt_ring)), settings, 0.25, tabular_fn=tab)
    assert int(r.stop_reason) == topt.STOP_TOO_FEW_GAUSSIANS
    assert torch.equal(r.params, params0)

    bad = data.local_pts.clone()
    bad[0, :8] = float("nan")
    r = topt.optimize(fwd, params0, data._replace(local_pts=bad), settings, 0.25, tabular_fn=tab)
    assert int(r.stop_reason) in (topt.STOP_NAN, topt.STOP_NO_IMPROVEMENT, topt.STOP_TOO_FEW_GAUSSIANS)
    assert torch.equal(r.params, params0)

    r = topt.optimize(fwd, params0, data, topt.OptimSettings(num_iter=0, min_num_points_per_set=4), 0.25, tabular_fn=tab)
    assert int(r.num_iters) == 0
    assert torch.equal(r.params, params0)
