"""Port vs reference: dmsa/problems.py (the rigid two-scan alignment) and
the optimizer's autodiff path (value_and_jacfwd over the merged cells, the
batched line search), which optimize() takes when it is given neither a
structured nor a tabular problem.

Tolerances, with their reasons:
  - value_and_jacfwd on the same two-scan problem over the reference's own
    cells: the residuals are the same f32 formula, so 99% of them agree to
    1e-5 of their scale and all to 1e-3, the slack of
    tests/test_torch_structured.py for cells whose moment difference nearly
    cancels (XLA fuses and reassociates the f32 sums, the sqrt halves the
    exponent).  Jacobian rows carry 1/r, so they are compared scaled by
    each row's magnitude, as tests/test_structured_jac.py compares the
    reference's two paths: 99.9% of the entries to 1e-3, all to 1e-2.  The
    scale is floored at 1e-3 of the Jacobian's largest entry, where that
    test floors it at 1e-4: the two-scan problem has rows of ~1e-4 against
    a largest entry of ~550 (cells of the anchored scan's points with a few
    of the other's, residuals the parameters barely move), which are f32
    rounding in either package and weigh nothing in J^T J;
  - the port's structured Jacobian against its own autodiff Jacobian on the
    window and keyframe problems: tests/test_structured_jac.py's tolerances
    for the reference's pair, its 1e-4 floor included: the same f32 point
    math in two graphs;
  - two-scan alignment from a ~20 cm / ~40 mrad perturbation: each package
    recovers the true relative pose within 1 cm and 1 mrad, and the two
    land within 5 mm / 1 mrad of each other (each builds its own cells,
    which agree only to the 2% f32 rounding that
    tests/test_torch_optimizer.py states, and the line search then picks
    neighbouring fractions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.dmsa import optimizer as jopt
from dmsa_lidar_slam_tpu.dmsa import problems as jproblems
from dmsa_lidar_slam_tpu.ops import gaussians as jgauss
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as topt
from dmsa_lidar_slam_tpu_torch.dmsa import problems as tproblems
from dmsa_lidar_slam_tpu_torch.ops import gaussians as tgauss
from dmsa_lidar_slam_tpu_torch.ops import voxel
from tests.test_torch_structured import _problems
from tests.torch_parity import nn, tt
from tests.torch_scenes import TWO_SCAN_PERTURBATION as PERTURBATION
from tests.torch_scenes import pose_errors, two_scan_problem

POSE_TOL_M, POSE_TOL_RAD = 1e-2, 1e-3


def _two_scan(seed=42, n_pts=3000):
    """(reference shapes and data, port shapes and data, true params)."""
    arrays, true = two_scan_problem(seed, n_pts)
    return (
        jproblems.ScanAlignShapes(2, n_pts), jproblems.ScanAlignData(*(jnp.asarray(a) for a in arrays)),
        tproblems.ScanAlignShapes(2, n_pts), tproblems.ScanAlignData(*(tt(a) for a in arrays)),
        true,
    )


def _rows_close(J_t, J_r, floor):
    """Jacobian rows scaled by their magnitude (1/r rows), floored at
    `floor`."""
    J_t, J_r = nn(J_t), np.asarray(J_r)
    scale = np.maximum(np.abs(J_r).max(axis=1, keepdims=True), floor)
    np.testing.assert_allclose(J_t / scale, J_r / scale, atol=1e-2)
    assert np.isclose(J_t / scale, J_r / scale, atol=1e-3).mean() > 0.999


def _res_close(e_t, e_r):
    e_t, e_r = nn(e_t), np.asarray(e_r)
    scale = max(float(np.abs(e_r).max()), 1e-12)
    np.testing.assert_allclose(e_t, e_r, atol=1e-3 * scale)
    assert np.mean(np.abs(e_t - e_r) <= 1e-5 * scale) >= 0.99


def test_forward_matches_reference():
    """The rigid chain puts the same f32 world points (to 1e-6 m)."""
    js, jd, ts, td, true = _two_scan(n_pts=500)
    p = true + PERTURBATION
    jout = jax.jit(jproblems.make_forward(js))(jnp.asarray(p), jd)
    tout = tproblems.make_forward(ts)(tt(p), td)
    np.testing.assert_allclose(nn(tout.points), np.asarray(jout.points), atol=1e-6)
    np.testing.assert_array_equal(nn(tout.mask), np.asarray(jout.mask))
    np.testing.assert_array_equal(nn(tout.ring_ids), np.asarray(jout.ring_ids))
    assert tout.extra.shape == (0,) and tout.extra.dtype == torch.float64


@pytest.mark.parametrize("chunk", [128, 4])
def test_value_and_jacfwd_matches_reference(chunk):
    """e0 and J on the two-scan problem over the reference's own merged
    cells; chunk 4 splits the 6 tangents into two blocks."""
    js, jd, ts, td, true = _two_scan()
    p = true + PERTURBATION
    jfwd, tfwd = jproblems.make_forward(js), tproblems.make_forward(ts)

    @jax.jit
    def reference(p):
        out = jfwd(p, jd)
        cells = [jgauss.build_cells(out.points, out.mask, out.ring_ids, f * 0.3, 6) for f in (2.0, 5.0)]
        merged = jgauss.concat_cells(cells, out.points.shape[0])

        def res(q):
            o = jfwd(q, jd)
            return jnp.concatenate([jgauss.cell_residuals(o.points, o.mask, merged), o.extra])

        return cells, jopt.value_and_jacfwd(res, p, 128)

    jcells, (je, jJ) = reference(jnp.asarray(p))
    tcells = [tgauss.CellSet(runs=voxel.sorted_runs(tt(c.start), torch.tensor(c.start.shape[0])),
                             **{f: tt(getattr(c, f)) for f in tgauss.CellSet._fields if f != "runs"}) for c in jcells]
    merged = tgauss.concat_cells(tcells, 2 * ts.n_pts)
    te, tJ = topt.value_and_jacfwd(lambda q: topt.residuals(tfwd, q, merged, td), tt(p), chunk)
    assert te.shape == je.shape and tJ.shape == jJ.shape == (je.shape[0], 6)
    assert int(sum(c.num_valid for c in jcells)) > 50
    _res_close(te, je)
    # floor: 1e-3 of the largest entry (module docstring)
    _rows_close(tJ, jJ, 1e-3 * float(np.abs(np.asarray(jJ)).max()))
    assert float(np.abs(np.asarray(jJ)).max()) > 1e-3
    # the value is the primal of the first block: the plain residuals
    np.testing.assert_array_equal(nn(te), nn(topt.residuals(tfwd, tt(p), merged, td)))
    np.testing.assert_array_equal(nn(topt.chunked_jacfwd(lambda q: topt.residuals(tfwd, q, merged, td), tt(p), chunk)),
                                  nn(tJ))


@pytest.mark.parametrize("kind", ["window", "keyframe"])
def test_structured_jacobian_matches_autodiff(kind):
    """The port's structured e0 / J against its own autodiff ones, on
    tests/test_torch_optimizer.py's window and keyframe problems, over the
    same cells (tests/test_structured_jac.py holds the reference so)."""
    _, (tst, tfwd, tdata), params, min_grid = _problems(kind, True)
    rng = np.random.default_rng(3)
    p = tt(np.asarray(params) + 0.004 * rng.standard_normal(np.asarray(params).shape))
    out, contract, j_extra = tst(p, tdata)
    cells = [tgauss.build_cells(out.points, out.mask, out.ring_ids, f * min_grid, 6, split_ids=out.split_ids)
             for f in (2.0, 5.0)]
    e_parts, j_parts = [], []
    for c in cells:
        res, g_sorted = tgauss.cell_residuals_and_grad(out.points, out.mask, c)
        g_orig = torch.zeros_like(out.points).index_copy_(0, c.order, g_sorted)
        jp = contract(g_orig)
        jc = torch.zeros_like(jp).index_add_(0, c.start, jp[c.order])
        e_parts.append(res)
        j_parts.append(torch.where(c.valid[:, None], jc, torch.zeros_like(jc)))
    rdt = torch.promote_types(e_parts[0].dtype, out.extra.dtype)
    e_s = torch.cat([e.to(rdt) for e in e_parts] + [out.extra.to(rdt)])
    J_s = torch.cat([j.to(rdt) for j in j_parts + [j_extra]], dim=0)
    merged = tgauss.concat_cells(cells, out.points.shape[0])
    e_a, J_a = topt.value_and_jacfwd(lambda q: topt.residuals(tfwd, q, merged, tdata), p, 128)
    assert e_a.shape == e_s.shape and J_a.shape == J_s.shape
    e_s, e_a = nn(e_s), nn(e_a)
    np.testing.assert_allclose(e_s, e_a, rtol=1e-2, atol=1e-4)
    assert np.isclose(e_s, e_a, rtol=1e-4, atol=1e-5).mean() > 0.99
    _rows_close(J_s, J_a, 1e-4)
    assert float(np.abs(nn(J_a)).max()) > 1e-3


def test_two_scan_alignment_matches_reference():
    """Both packages recover the relative pose from the same perturbed
    start; the port runs its autodiff path (no structured_fn, no
    tabular_fn)."""
    js, jd, ts, td, true = _two_scan()
    init = true + PERTURBATION
    kw = dict(num_iter=40, step_length_optim=0.3, max_step=0.3, min_num_points_per_set=6, min_num_gaussians=10,
              epsilon=1e-7)
    jr = jopt.optimize(jproblems.make_forward(js), jnp.asarray(init), jd, jopt.OptimSettings(**kw), 0.3)
    tr = topt.optimize(tproblems.make_forward(ts), tt(init), td, topt.OptimSettings(**kw), 0.3)
    jgot, tgot = np.asarray(jr.params), nn(tr.params)
    for got in (jgot, tgot):
        dt, dr = pose_errors(got, true)
        assert dt < POSE_TOL_M and dr < POSE_TOL_RAD, (dt, dr)
    dt, dr = pose_errors(tgot, jgot)
    assert dt < 5e-3 and dr < 1e-3, (dt, dr)
    assert int(tr.stop_reason) == int(jr.stop_reason) == topt.STOP_NO_IMPROVEMENT
    assert int(tr.num_gaussians) > 50


def test_two_scan_noop_at_truth():
    """Started at the truth, the autodiff path stays there (as
    tests/test_two_scan_alignment.py asks of the reference)."""
    _, _, ts, td, true = _two_scan(n_pts=2000)
    settings = topt.OptimSettings(num_iter=5, step_length_optim=0.3, max_step=0.3, min_num_gaussians=10)
    r = topt.optimize(tproblems.make_forward(ts), tt(true), td, settings, 0.3)
    dt, dr = pose_errors(nn(r.params), true)
    assert dt < 0.02 and dr < 0.005
