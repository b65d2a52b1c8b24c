"""Port vs reference: the structured Gauss-Newton path (dmsa.optimizer with
`structured_fn`), which the host pipeline (DmsaSlam) runs on both problems.

The problems are tests/test_torch_optimizer.py's small window and keyframe
problems.  The reference runs its structured path on the CPU under jit, as
its own tests run it; the port runs the same steps eagerly.

Tolerances, with their reasons:
  - the pieces on the same inputs (the reference's own cells, the same
    per-point cotangents): the contraction against the pose-table Jacobian
    is the same f32 formula, to 1e-5 of its scale, and the f64 extra-
    residual Jacobian to 1e-9 of its scale.  The cell residuals and their
    closed-form gradient too, except where a cell's moment difference
    <L, M2> - n <L, s s^T> nearly cancels: XLA fuses and reassociates the
    f32 sums, the sqrt halves the exponent and the gradient carries 1/r
    (tests/test_structured_jac.py grants the reference's own two paths the
    same).  So 99% of entries agree to 1e-5 of the scale and all to 1e-3;
  - whole iterations: each side builds its own cells, which agree only to
    f32 rounding amplified by the floored 3x3 inverse (the 2% that
    tests/test_torch_optimizer.py states for the tabular path), so after
    one iteration the parameters agree to 2e-3 and after six to 5e-3, with
    the same stop reason and iteration count, valid cells within 2% and the
    final error within 2%.

test_structured_reads_the_problems_table_builder holds the port alone:
make_structured takes its tables and their Jacobian from window_tables /
keyframe_tables (K6 / K7 on the card), and on the CPU gives, bit for bit,
what torch.func's jacfwd over the pose-table graph gives, written out here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.dmsa import optimizer as jopt
from dmsa_lidar_slam_tpu.map import keyframes as jkfm
from dmsa_lidar_slam_tpu.ops import gaussians as jgauss
from dmsa_lidar_slam_tpu.trajectory import continuous as jct
from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as topt
from dmsa_lidar_slam_tpu_torch.map import keyframes as tkfm
from dmsa_lidar_slam_tpu_torch.ops import gaussians as tgauss
from dmsa_lidar_slam_tpu_torch.ops import voxel
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as tct
from tests import torch_keyframes as tk
from tests import torch_window as tw
from tests.test_torch_optimizer import _check_same, _keyframe_problem, _port_shapes, _to_port, _window_problem
from tests.torch_parity import nn, tt


def _close(a, b, rel):
    b = np.asarray(b)
    np.testing.assert_allclose(nn(a), b, atol=rel * max(float(np.abs(b).max()), 1e-12))


def _close_mostly(a, b):
    a, b = nn(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-12)
    np.testing.assert_allclose(a, b, atol=1e-3 * scale)
    assert np.mean(np.abs(a - b) <= 1e-5 * scale) >= 0.99


def _problems(kind, flag):
    """(reference structured fn, forward, data), (port ...), params, min_grid."""
    if kind == "window":
        shapes, data, init, min_grid = _window_problem(12, flag)
        ps = _port_shapes(shapes)
        ref = (jct.make_structured(shapes, flag), jct.make_forward(shapes, flag), data)
        port = (tct.make_structured(ps, flag), tct.make_forward(ps, flag), _to_port(data, tct.WindowData))
        return ref, port, init, min_grid
    shapes, data, params0 = _keyframe_problem()
    ts = tkfm.MapShapes(n_keyframes=shapes.n_keyframes, n_pts_per_kf=shapes.n_pts_per_kf)
    ref = (jkfm.make_structured(shapes, flag, flag, True), jkfm.make_forward(shapes, flag, flag, True), data)
    port = (tkfm.make_structured(ts, flag, flag, True), tkfm.make_forward(ts, flag, flag, True),
            _to_port(data, tkfm.KeyframeMapData))
    return ref, port, params0, 0.25


@pytest.mark.parametrize("kind,flag", [("window", False), ("window", True), ("keyframe", True)])
def test_structured_pieces_match_reference(kind, flag):
    """Forward points, extra residuals and their Jacobian, and the per-point
    contraction of the same cotangents; then the closed-form residual
    gradient over the reference's own cells."""
    (jst, _, jdata), (tst, _, tdata), params, min_grid = _problems(kind, flag)
    n_pts = tdata.local_pts.reshape(-1, 3).shape[0] + (tdata.static_pts.shape[0] if kind == "window" else 0)
    g = np.random.default_rng(1).standard_normal((n_pts, 3)).astype(np.float32)

    @jax.jit
    def reference(p, g):
        out, contract, je = jst(p, jdata)
        return out, je, contract(g)

    jout, jje, jjp = reference(jnp.asarray(params), jnp.asarray(g))
    tout, tcontract, tje = tst(tt(params), tdata)
    _close(tout.points, jout.points, 1e-6)
    np.testing.assert_array_equal(nn(tout.mask), np.asarray(jout.mask))
    assert tout.extra.shape == jout.extra.shape and tje.shape == jje.shape
    if jje.size:
        _close(tout.extra, jout.extra, 1e-9)
        _close(tje, jje, 1e-9)
    _close(tcontract(tt(g)), jjp, 1e-5)

    @jax.jit
    def reference_cells(out):
        cells = jgauss.build_cells(out.points, out.mask, out.ring_ids, 5.0 * min_grid, 4, split_ids=out.split_ids)
        merged = jgauss.concat_cells([cells, cells], out.points.shape[0])
        return cells, jgauss.cell_residuals_and_grad(out.points, out.mask, cells), jgauss.cell_residuals(
            out.points, out.mask, merged
        )

    jcells, (jres, jg), jmerged_res = reference_cells(jout)
    assert int(jcells.num_valid) > 10
    tcells = tgauss.CellSet(runs=voxel.sorted_runs(tt(jcells.start), torch.tensor(jcells.start.shape[0])),
                            **{f: tt(getattr(jcells, f)) for f in tgauss.CellSet._fields if f != "runs"})
    tres, tg = tgauss.cell_residuals_and_grad(tout.points, tout.mask, tcells)
    _close_mostly(tres, jres)
    _close_mostly(tg, jg)
    merged_t = tgauss.concat_cells([tcells, tcells], tout.points.shape[0])
    _close_mostly(tgauss.cell_residuals(tout.points, tout.mask, merged_t), jmerged_res)


@pytest.mark.parametrize("num_iter", [1, 6])
@pytest.mark.parametrize("kind,flag", [("window", True), ("keyframe", True)])
def test_structured_optimize_matches_reference(kind, flag, num_iter):
    (jst, jfwd, jdata), (tst, tfwd, tdata), params, min_grid = _problems(kind, flag)
    if kind == "window":
        settings = dict(num_iter=num_iter, step_length_optim=0.2, max_step=0.3, min_num_points_per_set=6,
                        min_num_gaussians=10, epsilon=1e-6)
    else:
        settings = dict(num_iter=num_iter, min_num_points_per_set=4, min_num_gaussians=5, step_length_optim=0.3,
                        epsilon=1e-4)
    jr = jopt.optimize(jfwd, jnp.asarray(params), jdata, jopt.OptimSettings(**settings), min_grid, structured_fn=jst)
    tr = topt.optimize(tfwd, tt(params), tdata, topt.OptimSettings(**settings), min_grid, structured_fn=tst)
    assert int(jr.num_iters) == num_iter or int(jr.stop_reason) != jopt.STOP_NONE
    _check_same(jr, tr, num_iter)


def test_window_and_map_helpers_match_reference():
    """dense_times and register_tform_indices on the window problem (f64
    closed forms, to 1e-12, and integer indices exactly), min_grid_size and
    global_points on the keyframe problem (f32 transforms of the same points
    and normals, to 1e-6 of their scale)."""
    (_, _, jdata), (_, _, tdata), _, _ = _problems("window", True)
    shapes, _, _, _ = _window_problem(12, True)
    ps = _port_shapes(shapes)
    _close(tct.dense_times(tdata, ps), jct.dense_times(jdata, shapes), 1e-12)
    rel = np.random.default_rng(2).uniform(-0.01, 0.26, 400)
    rel[:3] = [0.0, float(jdata.dt), 3 * float(jdata.dt)]  # on grid points
    np.testing.assert_array_equal(
        nn(tct.register_tform_indices(tt(rel), tdata.dt, ps.n_dense)),
        np.asarray(jct.register_tform_indices(jnp.asarray(rel), jdata.dt, shapes.n_dense)),
    )

    (_, _, jdata), (_, _, tdata), params, _ = _problems("keyframe", True)
    jshapes, _, _ = _keyframe_problem()
    tshapes = tkfm.MapShapes(n_keyframes=jshapes.n_keyframes, n_pts_per_kf=jshapes.n_pts_per_kf)
    assert float(tkfm.min_grid_size(tdata)) == float(jkfm.min_grid_size(jdata))
    jout = jkfm.global_points(jnp.asarray(params), jdata, jshapes)
    tout = tkfm.global_points(tt(params), tdata, tshapes)
    for t, j in zip(tout[:2], jout[:2]):
        _close(t, j, 1e-6)
    for t, j in zip(tout[2:], jout[2:]):
        np.testing.assert_array_equal(nn(t), np.asarray(j))


def test_optimize_needs_a_jacobian_path():
    """Given neither structured_fn nor tabular_fn, optimize takes its
    autodiff Jacobian path (tests/test_torch_problems.py): on the same
    cells, one iteration lands where the structured path's does, to 1e-6
    (the two Jacobians agree to f32 rounding)."""
    (_, _, _), (tst, tfwd, tdata), params, min_grid = _problems("window", False)
    settings = topt.OptimSettings(num_iter=1, step_length_optim=0.2, max_step=0.3, min_num_points_per_set=6,
                                  min_num_gaussians=10)
    ra = topt.optimize(tfwd, tt(params), tdata, settings, min_grid)
    rs = topt.optimize(tfwd, tt(params), tdata, settings, min_grid, structured_fn=tst)
    assert int(ra.num_iters) == int(rs.num_iters) == 1
    assert int(ra.stop_reason) == int(rs.stop_reason) and int(ra.num_gaussians) == int(rs.num_gaussians)
    assert float(torch.linalg.norm(rs.params - tt(params))) > 1e-3
    np.testing.assert_allclose(nn(ra.params), nn(rs.params), atol=1e-6)


def _window_by_jacfwd(shapes, use_imu, params, data):
    """The window's (out, contract, j_extra) from torch.func.jacfwd over
    the dense pose tables and the IMU residuals."""

    def tables(p):
        chain, gp, q_dense, d_transl = tct.dense_pose_tables(p, data, shapes)
        extra = tct.imu_residuals(chain, gp, d_transl, data, shapes) if use_imu else torch.zeros(0, dtype=p.dtype)
        return q_dense, d_transl, extra

    q, t, extra = tables(params)
    dq, dt_, j_extra = torch.func.jacfwd(tables)(params)  # [D, 4, P], [D, 3, P], [E, P]
    idx = data.pt_tform_idx.to(torch.int64)
    qp, gq, gt = q.to(torch.float32)[idx], dq.to(torch.float32)[idx], dt_.to(torch.float32)[idx]
    out = topt.ForwardOut(
        points=torch.cat([rot.quat_rotate(qp, data.local_pts) + t.to(torch.float32)[idx], data.static_pts]),
        mask=torch.cat([data.pt_mask, data.static_mask]), ring_ids=torch.cat([data.pt_ring, data.static_ring]),
        extra=extra)

    def contract(g):
        g = g[:shapes.n_window_pts]
        aq = rot.quat_rotate_vjp_q(qp, data.local_pts, g)
        jp = torch.einsum("nc,ncp->np", aq, gq) + torch.einsum("nc,ncp->np", g, gt)
        return torch.cat([jp, torch.zeros(shapes.n_static, params.shape[0], dtype=jp.dtype)])

    return out, contract, j_extra


def _keyframes_by_jacfwd(shapes, flag, params, data):
    """The submap's (out, contract, j_extra) from torch.func.jacfwd over the
    keyframes' global poses and the gravity and odometry residuals, with
    the split channel."""

    def tables(p):
        chain, gp = tkfm.global_chain(p, data, shapes)
        return rot.axang2quat(gp.orient), gp.transl, tkfm._extras(chain, gp, data, flag, flag, p)

    q, t, extra = tables(params)
    dq, dt_, j_extra = torch.func.jacfwd(tables)(params)  # [K, 4, P], [K, 3, P], [E, P]
    q32, gq, gt = q.to(torch.float32)[:, None, :], dq.to(torch.float32), dt_.to(torch.float32)
    out = topt.ForwardOut(
        points=(rot.quat_rotate(q32, data.local_pts) + t.to(torch.float32)[:, None, :]).reshape(-1, 3),
        mask=(data.pt_mask & data.kf_mask[:, None]).reshape(-1), ring_ids=data.pt_ring.reshape(-1), extra=extra,
        split_ids=tkfm.normal_split_ids(rot.quat_rotate(q32, data.local_normals).reshape(-1, 3)))

    def contract(g):
        g = g.reshape(shapes.n_keyframes, shapes.n_pts_per_kf, 3)
        aq = rot.quat_rotate_vjp_q(q32, data.local_pts, g)
        jp = torch.einsum("kpc,kcq->kpq", aq, gq) + torch.einsum("kpc,kcq->kpq", g, gt)
        return jp.reshape(-1, params.shape[0])

    return out, contract, j_extra


@pytest.mark.parametrize("kind,flag", [("window", True), ("window", False), ("keyframe", True), ("keyframe", False)])
def test_structured_reads_the_problems_table_builder(monkeypatch, kind, flag):
    """make_structured calls the problem's table builder once a call, and
    its forward, contraction and extra Jacobian are torch.func's bit for
    bit."""
    if kind == "window":
        shapes, data, params = tw.window_problem(3)
        mod, builder, structured = tct, "window_tables", tct.make_structured(shapes, flag)
        by_jacfwd = _window_by_jacfwd(shapes, flag, params, data)
    else:
        shapes, data, params = tk.keyframe_problem(3, "inactive", s=7, ppk=50)
        mod, builder, structured = tkfm, "keyframe_tables", tkfm.make_structured(shapes, flag, flag, True)
        by_jacfwd = _keyframes_by_jacfwd(shapes, flag, params, data)
    calls = []
    real = getattr(mod, builder)
    monkeypatch.setattr(mod, builder, lambda *a: calls.append(1) or real(*a))
    out, contract, j_extra = structured(params, data)
    assert len(calls) == 1
    want_out, want_contract, want_j_extra = by_jacfwd
    for a, b in zip(out, want_out):
        assert (a is None and b is None) or torch.equal(a, b)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(tuple(out.points.shape)), dtype=torch.float32)
    assert torch.equal(contract(g), want_contract(g))
    assert torch.equal(j_extra, want_j_extra)
