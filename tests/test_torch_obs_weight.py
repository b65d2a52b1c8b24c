"""Port vs reference: per-point observation weights (ForwardOut.obs_weight,
getWeightOfPointSet) through the cell build and the three optimizer paths,
and K1's 12-row layout, which the weights (or a build without a pose
table) select.

The reference's build kernel runs here as its own tests run it on the CPU:
Pallas in interpret mode (fused_residuals.py:81-89), in its dpad = 0
layout; the port's build_packed takes its plain version on CPU tensors.
Inputs are made with numpy from fixed seeds: weights uniform in [0.5, 2].
Tolerances, with their reasons:
  - the build against the reference's kernel: tests/test_torch_fused_
    residuals.py's (structural rows exact, xs and 1/count to 1e-6, cell
    means to 2e-4 m, lamw6 to 2% of its scale, the candidate errors the
    rows induce to 2%): f32 moments in another order, amplified by the
    floored 3x3 inverse;
  - the plain builds against each other: means to 1e-4 m, lamw6 to 3e-3 of
    its scale (the same two-pass formula; the reference takes run sums as
    differences of a global f32 cumsum, which on the giant-cell problem
    here loses 1.9e-3 of lamw6's scale with and without weights alike,
    against 2.9e-4 at tests/test_torch_fused_residuals.py's seed);
  - the rebalancing weights of build_cells: 1e-4 relative (the same f32
    per-cell mean of obs, the reference's from cumsum differences);
  - the all-ones weight against None: the same bits (obs = 1 * w = w);
  - the optimizer: tests/test_torch_optimizer.py's (the same stop reason
    and iteration count, cells and final error within 2%, parameters
    within 2e-3 after one iteration and 5e-3 after six).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmsa_lidar_slam_tpu.dmsa import optimizer as jopt
from dmsa_lidar_slam_tpu.map import keyframes as jkfm
from dmsa_lidar_slam_tpu.ops import fused_residuals as jfr
from dmsa_lidar_slam_tpu.ops import gaussians as jg
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as topt
from dmsa_lidar_slam_tpu_torch.map import keyframes as tkfm
from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as tfr
from dmsa_lidar_slam_tpu_torch.ops import gaussians as tg
from tests.test_torch_fused_residuals import _cmp_packed, _problem
from tests.test_torch_optimizer import _check_same, _keyframe_problem, _to_port
from tests.torch_parity import nn, tt


def _weighted(seed=5, giant_cell=False):
    """tests/test_torch_fused_residuals.py's problem with observation
    weights and a split channel; the world points are offset from the
    table's, so a build that read the table instead would differ."""
    rng, xs, mask, rings, tidx, tab0, world, _, _ = _problem(seed=seed, giant_cell=giant_cell)
    obs = rng.uniform(0.5, 2.0, size=len(xs)).astype(np.float32)
    split = rng.integers(0, 4, size=len(xs)).astype(np.int32)
    world = (world + 0.01 * rng.standard_normal(world.shape)).astype(np.float32)
    return xs, mask, rings, tidx, tab0, world, obs, split


@pytest.mark.parametrize("with_tab", [False, True])
@pytest.mark.parametrize("giant_cell", [False, True])
def test_build_packed_rows12_vs_reference_kernel(giant_cell, with_tab):
    """The port's build with observation weights and the split channel
    against the reference's build kernel in its 12-row layout, with the
    pose table given (the weights still select the 12-row layout, whose
    statistics use the world points as given) and without it."""
    xs, mask, rings, tidx, tab0, world, obs, split = _weighted(seed=8, giant_cell=giant_cell)
    jtab = jnp.asarray(tab0) if with_tab else None
    jpk, jnv, jnr = jfr.build_packed(
        jnp.asarray(world), jnp.asarray(mask), jnp.asarray(rings), jnp.asarray(xs), jnp.asarray(tidx), 1.0, 4,
        obs_weight=jnp.asarray(obs), split_ids=jnp.asarray(split), tab=jtab,
    )
    tpk, tnv, tnr = tfr.build_packed(tt(world), tt(mask), tt(rings), tt(xs), tt(tidx, torch.int64), 1.0, 4,
                                     tt(tab0) if with_tab else None, split_ids=tt(split), obs_weight=tt(obs))
    assert int(tnv) == int(jnv) and int(tnr) == int(jnr)
    _cmp_packed(nn(tpk), np.asarray(jpk), mu_atol=2e-4, lam_rel=0.02)
    e_t = jfr.cand_errors_ref(jnp.asarray(tab0[None]), jnp.asarray(nn(tpk)))
    e_j = jfr.cand_errors_ref(jnp.asarray(tab0[None]), jpk)
    np.testing.assert_allclose(np.asarray(e_t), np.asarray(e_j), rtol=0.02)


@pytest.mark.parametrize("giant_cell", [False, True])
def test_build_packed_rows12_without_weights_vs_reference_kernel(giant_cell):
    """No pose table and no weights: the 12-row layout with obs = w."""
    xs, mask, rings, tidx, tab0, world, _, _ = _weighted(seed=9, giant_cell=giant_cell)
    jpk, jnv, jnr = jfr.build_packed(
        jnp.asarray(world), jnp.asarray(mask), jnp.asarray(rings), jnp.asarray(xs), jnp.asarray(tidx), 1.0, 4
    )
    tpk, tnv, tnr = tfr.build_packed(tt(world), tt(mask), tt(rings), tt(xs), tt(tidx, torch.int64), 1.0, 4)
    assert int(tnv) == int(jnv) and int(tnr) == int(jnr)
    _cmp_packed(nn(tpk), np.asarray(jpk), mu_atol=2e-4, lam_rel=0.02)


@pytest.mark.parametrize("giant_cell", [False, True])
def test_build_packed_ref_with_weights_vs_reference_ref(giant_cell):
    """The two plain builds (build_cells + pack_rows) with weights."""
    xs, mask, rings, tidx, tab0, world, obs, split = _weighted(seed=10, giant_cell=giant_cell)
    jpk, jnv, jnr = jfr.build_packed_ref(
        jnp.asarray(world), jnp.asarray(mask), jnp.asarray(rings), jnp.asarray(xs), jnp.asarray(tidx), 1.0, 4,
        obs_weight=jnp.asarray(obs), split_ids=jnp.asarray(split),
    )
    tpk, tnv, tnr = tfr.build_packed_ref(tt(world), tt(mask), tt(rings), tt(xs), tt(tidx), 1.0, 4,
                                         split_ids=tt(split), obs_weight=tt(obs))
    assert int(tnv) == int(jnv) and int(tnr) == int(jnr)
    _cmp_packed(nn(tpk), np.asarray(jpk), mu_atol=1e-4, lam_rel=3e-3)


def test_build_cells_with_weights_vs_reference():
    """build_cells(obs_weight=): the same cells, the same rebalancing
    weights (1e-4 relative); the weights move them away from the
    unweighted ones."""
    xs, mask, rings, tidx, tab0, world, obs, split = _weighted(seed=11)
    jc = jg.build_cells(jnp.asarray(world), jnp.asarray(mask), jnp.asarray(rings), 0.8, 4,
                        obs_weight=jnp.asarray(obs), split_ids=jnp.asarray(split))
    tc = tg.build_cells(tt(world), tt(mask), tt(rings), 0.8, 4, split_ids=tt(split), obs_weight=tt(obs))
    plain = tg.build_cells(tt(world), tt(mask), tt(rings), 0.8, 4, split_ids=tt(split))
    assert int(tc.num_valid) == int(jc.num_valid) > 10
    np.testing.assert_array_equal(nn(tc.order), np.asarray(jc.order))
    np.testing.assert_array_equal(nn(tc.valid), np.asarray(jc.valid))
    np.testing.assert_allclose(nn(tc.weight), np.asarray(jc.weight), rtol=1e-4, atol=1e-6)
    assert float((tc.weight - plain.weight).abs().max()) > 0.05


def test_all_ones_weight_gives_the_bits_of_none():
    """On the 12-row layout (no pose table, and a pose table with weights)
    and in build_cells, a weight of 1 everywhere is the unweighted build bit
    for bit; with a pose table and no weights the compact layout differs
    (its statistics come from the table)."""
    xs, mask, rings, tidx, tab0, world, _, split = _weighted(seed=12)
    args = (tt(world), tt(mask), tt(rings), tt(xs), tt(tidx, torch.int64), 1.0, 4)
    ones = torch.ones(len(xs), dtype=torch.float32)
    none12 = tfr.build_packed(*args, split_ids=tt(split))
    for tab in (None, tt(tab0)):
        ones12 = tfr.build_packed(*args, tab, split_ids=tt(split), obs_weight=ones)
        assert all(torch.equal(a, b) for a, b in zip(none12, ones12))
    compact = tfr.build_packed(*args, tt(tab0), split_ids=tt(split))
    assert not torch.equal(compact[0][3:6], none12[0][3:6])
    c_none = tg.build_cells(tt(world), tt(mask), tt(rings), 0.8, 4)
    c_ones = tg.build_cells(tt(world), tt(mask), tt(rings), 0.8, 4, obs_weight=ones)
    assert all(torch.equal(a, b) for a, b in zip(c_none, c_ones) if torch.is_tensor(a))
    assert all(torch.equal(a, b) for a, b in zip(c_none.runs, c_ones.runs))


def _with_weights(fwd, obs):
    return lambda p, d: fwd(p, d)._replace(obs_weight=obs)


def _with_weights_structured(st, obs):
    def structured(p, d):
        out, contract, je = st(p, d)
        return out._replace(obs_weight=obs), contract, je

    return structured


@pytest.mark.parametrize("num_iter", [1, 6])
@pytest.mark.parametrize("path", ["tabular", "structured", "autodiff"])
def test_weighted_keyframe_optimize_vs_reference(path, num_iter):
    """A keyframe problem (4 x 512) whose forward returns per-point
    observation weights, through each optimizer path of both packages."""
    shapes, data, params0 = _keyframe_problem()
    obs = np.random.default_rng(13).uniform(0.5, 2.0, size=shapes.n_keyframes * shapes.n_pts_per_kf)
    obs = obs.astype(np.float32)
    settings = dict(num_iter=num_iter, min_num_points_per_set=4, min_num_gaussians=5, step_length_optim=0.3,
                    epsilon=1e-4)
    ts = tkfm.MapShapes(n_keyframes=shapes.n_keyframes, n_pts_per_kf=shapes.n_pts_per_kf)
    jfwd = _with_weights(jkfm.make_forward(shapes, True, True, True), jnp.asarray(obs))
    tfwd = _with_weights(tkfm.make_forward(ts, True, True, True), tt(obs))
    jkw, tkw, plain_kw = {}, {}, {}
    if path == "tabular":
        jkw["tabular_fn"] = jkfm.make_tabular(shapes, True, True)
        tkw["tabular_fn"] = plain_kw["tabular_fn"] = tkfm.make_tabular(ts, True, True)
    elif path == "structured":
        jkw["structured_fn"] = _with_weights_structured(jkfm.make_structured(shapes, True, True, True),
                                                        jnp.asarray(obs))
        plain_kw["structured_fn"] = tkfm.make_structured(ts, True, True, True)
        tkw["structured_fn"] = _with_weights_structured(plain_kw["structured_fn"], tt(obs))
    jr = jopt.optimize(jfwd, jnp.asarray(params0), data, jopt.OptimSettings(**settings), 0.25, **jkw)
    tdata = _to_port(data, tkfm.KeyframeMapData)
    tr = topt.optimize(tfwd, tt(params0), tdata, topt.OptimSettings(**settings), 0.25, **tkw)
    _check_same(jr, tr, num_iter)
    # the weights are not ignored: the unweighted run lands elsewhere
    plain = topt.optimize(tkfm.make_forward(ts, True, True, True), tt(params0), tdata,
                          topt.OptimSettings(**settings), 0.25, **plain_kw)
    assert float((plain.params - tr.params).abs().max()) > 1e-7
