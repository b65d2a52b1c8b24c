"""Port vs reference: the spatially-owned distributed keyframe adjustment
(parallel/spatial.py), the default backend of distributed_keyframe_opt.

The problem is tests/test_spatial_dist.py's _make_problem (4 keyframes of
512 points seeing one room scene, poses perturbed by 0.03), made in numpy
(tests/torch_dist.keyframe_problem) and carried into both packages; the
port runs on 4 gloo ranks (tests/torch_dist.py), the reference on a
4-device CPU mesh.  Tolerances, with their reasons:
  - port vs reference, 6 iterations: parameters within 5e-3, the bound of
    ROADMAP.md Queue 3 ("Not faults"): the two packages' cell builds agree
    to f32 rounding (the floored inverse amplifies it), and the line search
    may then pick a neighbouring step fraction;
  - port distributed vs the port's single-card tabular optimizer, and one
    rank vs four: keyframe positions within 0.02 m, the reference's own
    bound (tests/test_spatial_dist.py:105): the cells are the same exact
    cells, only the psum's order of the block sums differs; at one rank
    the spatial backend is the single-card optimizer bit for bit;
  - the ranks' parameters are bit-identical (a ring all-reduce gives every
    rank the same bits, and the solve is replicated);
  - no cell is split across ranks (the owner hash and K1's keys see the
    same floor(world / grid) of the same world points);
  - each iteration takes its tables, their Jacobian and the candidate
    tables from the submap's builders, keyframe_tables and
    keyframe_tables_batch (K7 on the card), one call each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dmsa_lidar_slam_tpu.map import keyframes as jkfm
from dmsa_lidar_slam_tpu.parallel import keyframe_dist as jkd
from dmsa_lidar_slam_tpu.parallel import spatial as jsp
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist, spatial
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
from tests import torch_dist

PARAM_ATOL = 5e-3
POSITION_TOL_M = 0.02
GRIDS = (0.5, 1.25)
KW = dict(num_iter=6, min_points=4, step_length=0.2)
# name: (seed, keyframes, points per keyframe, use_split, settings)
CASES = {
    "plain": (9, 4, 512, False, KW),
    "split": (11, 4, 512, True, KW),
    # P = 138: P + 1 > K2's small-system bound, its dense-J path on the card
    "dense": (5, 24, 256, True, dict(KW, num_iter=3)),
}


def _problem(name):
    seed, s, ppk, use_split, kw = CASES[name]
    data, params0, params_true = torch_dist.keyframe_problem(seed, s=s, ppk=ppk, with_normals=use_split)
    return data, params0, params_true, use_split, kw


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    cases = {}
    for name in CASES:
        data, params0, _, use_split, kw = _problem(name)
        cases[name] = (data, params0, use_split, kw)
    return torch_dist.run_ranks(torch_dist.spatial_cases, 4, tmp_path_factory.mktemp("spatial"), cases)


def _port(name, mesh=pmesh.ONE_RANK, start="perturbed", **settings):
    """The port's spatial optimizer on one rank; `settings` override the
    case's; start "perturbed" (params0), "truth", or the given params."""
    data, params0, params_true, use_split, kw = _problem(name)
    d = torch_dist.as_port(data)
    sopt = spatial.make_spatial_dist_optimize(mesh, kfm.MapShapes(*d.local_pts.shape[:2]), use_split=use_split,
                                              **dict(kw, **settings))
    fp, fm, frs, aux = keyframe_dist.flatten_problem(d)
    p = {"perturbed": params0, "truth": params_true}[start] if isinstance(start, str) else start
    return sopt(torch.as_tensor(p), fp, fm, frs, aux, torch.tensor(GRIDS), flat_normals=d.local_normals.reshape(-1, 3))


def _single_card(name):
    data, params0, _, use_split, kw = _problem(name)
    d = torch_dist.as_port(data)
    shapes = kfm.MapShapes(*d.local_pts.shape[:2])
    settings = opt.OptimSettings(num_iter=kw["num_iter"], min_num_points_per_set=kw["min_points"],
                                 step_length_optim=kw["step_length"], grid_size_1_factor=2.0,
                                 grid_size_2_factor=5.0)
    fwd = kfm.make_forward(shapes, False, False, use_split)
    return opt.optimize(fwd, torch.as_tensor(params0), d, settings, 0.25,
                        tabular_fn=kfm.make_tabular(shapes, False, False)).params


def _positions(name, params):
    d = torch_dist.as_port(_problem(name)[0])
    _, gp = kfm.global_chain(torch.as_tensor(params), d, kfm.MapShapes(*d.local_pts.shape[:2]))
    return gp.transl.numpy()


def _position_gap(name, a, b):
    return float(np.max(np.linalg.norm(_positions(name, a) - _positions(name, b), axis=1)))


@pytest.mark.parametrize("name", ["plain", "split"])
def test_spatial_matches_reference_on_four_ranks(ranks4, name):
    data, params0, params_true, use_split, kw = _problem(name)
    jd = jkfm.KeyframeMapData(**{k: jnp.asarray(v) for k, v in data.items()})
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    sopt = jsp.make_spatial_dist_optimize(mesh, jkfm.MapShapes(*data["local_pts"].shape[:2]), use_split=use_split,
                                          **kw)
    fp, fm, frs, aux = jkd.flatten_problem(jd)
    j_params, _, j_cells, j_ov = sopt(jnp.asarray(params0), fp, fm, frs, aux, jnp.asarray(GRIDS, jnp.float32),
                                      flat_normals=jd.local_normals.reshape(-1, 3))
    params, err, cells, ov = ranks4[0][name]
    assert int(ov) == int(j_ov) == 0, "bucket overflow"
    assert int(cells) > 20
    np.testing.assert_allclose(params.numpy(), np.asarray(j_params), rtol=0, atol=PARAM_ATOL)
    d0 = np.linalg.norm(params0 - params_true)
    assert np.linalg.norm(params.numpy() - params_true) < 0.7 * d0


@pytest.mark.parametrize("name", list(CASES))
def test_spatial_matches_single_card(ranks4, name):
    """4 ranks against the port's single-card tabular optimizer on the same
    problem; "dense" is the P + 1 > 128 case."""
    params = ranks4[0][name][0]
    if name == "dense":
        assert params.shape[0] + 1 > fr.K2_SMALL_P1
    gap = _position_gap(name, params, _single_card(name))
    assert gap < POSITION_TOL_M, f"distributed vs single-card keyframe positions {gap:.4f} m"


@pytest.mark.parametrize("name", ["plain", "split"])
def test_world_size_one_matches_four(ranks4, name):
    """One rank (no process group) against four; one rank is the
    single-card optimizer bit for bit (the same cells in the same order)."""
    one = _port(name)
    assert torch.equal(one[0], _single_card(name))
    assert _position_gap(name, one[0], ranks4[0][name][0]) < POSITION_TOL_M
    np.testing.assert_allclose(one[0].numpy(), ranks4[0][name][0].numpy(), rtol=0, atol=PARAM_ATOL)


def test_ranks_bit_identical(ranks4):
    for name in CASES:
        for r in ranks4[1:]:
            assert all(torch.equal(a, b) for a, b in zip(r[name], ranks4[0][name])), name


def test_no_cell_split_across_ranks(ranks4):
    """Every exact voxel key (as K1 keys the received points) is built on
    one rank only, at both grid resolutions."""
    for g in range(len(GRIDS)):
        keys = torch.cat([r["keys"][g] for r in ranks4])
        assert all(len(r["keys"][g]) > 0 for r in ranks4)
        assert len(keys) == len(torch.unique(keys)), "a cell's members on two ranks"


@pytest.mark.parametrize("name", ["plain", "split"])
@pytest.mark.parametrize("start,settings", [("perturbed", dict(epsilon=1.0)), ("truth", {})])
def test_host_stop_returns_the_reference_tuple(name, start, settings):
    """The host loop stops at the first frozen iteration, where the
    reference's lax.scan runs on to num_iter with the params frozen.  Each
    of those later iterations is the same iteration again: one more
    iteration from the returned params repeats the returned error, cell
    count and overflow bit for bit, so the tuple is the reference's.  (Had
    the loop run all 20 iterations unfrozen, the error would be the last
    step's, at the params before it.)  Both ways to stop: a step below
    epsilon that was taken (the next iteration runs frozen), and no
    improvement near the truth (params kept)."""
    _, params0, _, _, _ = _problem(name)
    params, err, cells, overflow = _port(name, start=start, num_iter=20, **settings)
    again = _port(name, start=params, num_iter=1, **settings)
    assert torch.equal(again[1], err) and torch.equal(again[2], cells) and torch.equal(again[3], overflow)
    if start == "perturbed":  # the epsilon stop took its step, then froze
        assert not torch.equal(params, torch.as_tensor(params0))


@pytest.mark.parametrize("name", ["plain", "split"])
def test_spatial_reads_the_submaps_table_builders(monkeypatch, name):
    """One call of keyframe_tables and one of keyframe_tables_batch an
    iteration, at world size 1 (no process group)."""
    calls = {"keyframe_tables": 0, "keyframe_tables_batch": 0}
    for fn in calls:
        real = getattr(kfm, fn)

        def counted(*a, _real=real, _fn=fn):
            calls[_fn] += 1
            return _real(*a)

        monkeypatch.setattr(kfm, fn, counted)
    pmesh.reset_collectives()
    _port(name)
    iterations = pmesh.SCOPES["iteration"]
    assert iterations >= 2 and calls == {"keyframe_tables": iterations, "keyframe_tables_batch": iterations}
