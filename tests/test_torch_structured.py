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
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as topt
from dmsa_lidar_slam_tpu_torch.map import keyframes as tkfm
from dmsa_lidar_slam_tpu_torch.ops import gaussians as tgauss
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as tct
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
    tcells = tgauss.CellSet(**{f: tt(getattr(jcells, f)) for f in tgauss.CellSet._fields})
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
    (_, _, _), (tst, tfwd, tdata), params, min_grid = _problems("window", False)
    with pytest.raises(ValueError):
        topt.optimize(tfwd, tt(params), tdata, topt.OptimSettings(num_iter=1), min_grid)
