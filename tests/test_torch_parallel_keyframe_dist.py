"""Port vs reference: the distributed keyframe adjustment with the hash
backend (parallel/keyframe_dist.py, parallel/sharded.py), and the
conversions that carry its problem between the packages (convert.py).

The problem is 8 keyframes of 256 points (tests/torch_dist.keyframe_problem)
with gravity and odometry terms, made in numpy; the port runs on 4 and 3
gloo ranks (tests/torch_dist.py), the reference on CPU meshes.  Both
packages get f32 grids, passed as an argument (as the pipelines pass
them).  Both transform the points in f32, each rounding its own way, so a
point within an ulp of a voxel boundary can fall in different cells in
the two packages.  The synthetic room's planes lie on the grid, and the
anchor keyframe's points land on them, so such points are common here:
the problem leaves out every point within BOUNDARY_M of a boundary at
params0.  Tolerances, with their reasons:
  - one Gauss-Newton step on a one-rank mesh: the same valid cell count
    as the reference's, parameters within 1e-4 of its (the same cells, the
    residuals' f32 sums in another order);
  - two steps, port on 4 ranks vs reference on 4 devices, and port on 1
    rank vs 4: rtol 5e-3, atol 2e-3, the reference's own mesh-size
    tolerance (tests/test_keyframe_dist.py:77): f32 per-cell partial sums
    reduce in a rank-count-dependent order;
  - 14 steps: the parameter error falls below 0.65 of the start, the
    reference's own bound (tests/test_keyframe_dist.py:60);
  - the extra residuals equal the single-card terms to 1e-12 (the same
    functions on the same chain).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dmsa_lidar_slam_tpu.map import keyframes as jkfm
from dmsa_lidar_slam_tpu.parallel import keyframe_dist as jkd
from dmsa_lidar_slam_tpu_torch import convert
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
from tests import torch_dist

S, PPK, TABLE = 8, 256, 4096
MIN_GRID, GRID_FACTORS = 0.2, (2.0, 5.0)
BOUNDARY_M = 1e-5  # ~20 f32 ulps at the map's few-metre coordinates
KW = dict(min_points=4, step_length=0.3, max_step=0.1, table_size=TABLE, use_gravity=True, use_odometry=True)


def _problem(seed=9):
    """The problem with the points that lie within BOUNDARY_M of a voxel
    boundary at params0 left out (pt_mask False)."""
    data, params0, params_true = torch_dist.keyframe_problem(seed, s=S, ppk=PPK, extras=True)
    pts = kfm.global_points(torch.as_tensor(params0), torch_dist.as_port(data), kfm.MapShapes(S, PPK))[0]
    pts = pts.double().numpy()
    near = np.zeros(len(pts), bool)
    for f in GRID_FACTORS:
        r = pts / (f * MIN_GRID)
        near |= np.any(np.abs(r - np.round(r)) * (f * MIN_GRID) < BOUNDARY_M, axis=1)
    data["pt_mask"] = data["pt_mask"] & ~near.reshape(S, PPK)
    return data, params0, params_true


def _reference(n_dev, num_iter, seed=9):
    data, params0, _ = _problem(seed)
    jd = jkfm.KeyframeMapData(**{k: jnp.asarray(v) for k, v in data.items()})
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    f = jkd.make_keyframe_dist_optimize(mesh, jkfm.MapShapes(S, PPK), num_iter=num_iter, **KW)
    fp, fm, frs, aux = jkd.flatten_problem(jd)
    grids = jnp.asarray([g * MIN_GRID for g in GRID_FACTORS], jnp.float32)
    return np.asarray(f(jnp.asarray(params0), fp, fm, frs, aux, grids)[0])


def _port_one_rank(num_iter, seed=9):
    data, params0, _ = _problem(seed)
    params, _ = keyframe_dist.distributed_keyframe_optimize(
        pmesh.ONE_RANK, torch_dist.as_port(data), kfm.MapShapes(S, PPK), torch.as_tensor(params0),
        num_iter=num_iter, min_grid=MIN_GRID, grid_factors=GRID_FACTORS, **KW)
    return params.numpy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port on 4 ranks (2 and 14 steps) and on 3 ranks (2 steps; the
    2,048 points do not divide by 3)."""
    data, params0, _ = _problem()
    kw = dict(KW, min_grid=MIN_GRID, grid_factors=GRID_FACTORS)
    tmp = tmp_path_factory.mktemp("hash_backend")
    four = torch_dist.Ranks(torch_dist.hash_optimize, 4, tmp, data, params0, [dict(kw, num_iter=2),
                                                                             dict(kw, num_iter=14)])
    three = torch_dist.Ranks(torch_dist.hash_optimize, 3, tmp, data, params0, [dict(kw, num_iter=2)])
    return four.results(), three.results()


def test_hash_backend_matches_reference_on_four_ranks(ranks):
    four, _ = ranks
    np.testing.assert_allclose(four[0][1][0].numpy(), _reference(4, 2), rtol=5e-3, atol=2e-3)
    for r in four[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r[1], four[0][1])), "ranks differ"


def test_hash_backend_converges(ranks):
    four, _ = ranks
    _, params0, params_true = _problem()
    e0 = np.linalg.norm(params_true - params0)
    e1 = np.linalg.norm(params_true - four[0][1][1].numpy())
    assert e1 < 0.65 * e0, f"param err {e0} -> {e1}"


def test_mesh_size_one_matches_single_card_step_and_four_ranks(ranks):
    """One step on a one-rank mesh against the reference's step on one
    device; two steps on one rank against four."""
    data, params0, _ = _problem()
    step = keyframe_dist.make_keyframe_dist_step(pmesh.ONE_RANK, S, PPK, min_grid=MIN_GRID,
                                                 grid_factors=GRID_FACTORS, **KW)
    fp, fm, frs, aux = keyframe_dist.flatten_problem(torch_dist.as_port(data))
    got, err, cells = step(torch.as_tensor(params0), fp, fm, frs, aux)

    jd = jkfm.KeyframeMapData(**{k: jnp.asarray(v) for k, v in data.items()})
    jstep = jkd.make_keyframe_dist_step(Mesh(np.array(jax.devices()[:1]), ("data",)), S, PPK, min_grid=MIN_GRID,
                                        grid_factors=GRID_FACTORS, **KW)
    want, j_err, j_cells = jstep(jnp.asarray(params0), *jkd.flatten_problem(jd))
    assert int(cells) == int(j_cells)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(err), float(j_err), rtol=1e-4)
    np.testing.assert_allclose(_port_one_rank(2), ranks[0][0][1][0].numpy(), rtol=5e-3, atol=2e-3)


def test_world_size_three_drops_to_two_ranks(ranks):
    """2,048 points over 3 ranks: the mesh keeps ranks 0 and 1, rank 2
    takes the result by broadcast; all three hold the same bits, which
    agree with the reference on 2 devices."""
    _, three = ranks
    assert [r[0] for r in three] == [2, 2, 2]
    for r in three[1:]:
        assert torch.equal(r[1][0], three[0][1][0])
    np.testing.assert_allclose(three[0][1][0].numpy(), _reference(2, 2), rtol=5e-3, atol=2e-3)


def test_extra_fn_matches_single_card_residuals():
    """The replicated gravity + odometry residuals equal the single-card
    terms (kfm.gravity_residuals / odometry_residuals) and the
    reference's."""
    data, params0, _ = _problem()
    d = torch_dist.as_port(data)
    params = torch.as_tensor(params0)
    got = keyframe_dist.make_extra_fn(S, True, True)(params, keyframe_dist.aux_from_data(d))
    chain, gp = kfm.global_chain(params, d, kfm.MapShapes(S, PPK))
    want = torch.cat([kfm.gravity_residuals(gp, d), kfm.odometry_residuals(chain, d)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=0)
    jd = jkfm.KeyframeMapData(**{k: jnp.asarray(v) for k, v in data.items()})
    j_got = jkd.make_extra_fn(S, True, True)(jnp.asarray(params0), jkd.aux_from_data(jd))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_got), rtol=1e-9, atol=1e-12)
    assert keyframe_dist.make_extra_fn(S, False, False) is None


def test_once_built_optimize_reused_across_submaps():
    """make_keyframe_dist_optimize returns the same built loop for the same
    mesh, shapes and settings, and it serves two problem instances."""
    shapes = kfm.MapShapes(S, PPK)
    f1 = keyframe_dist.make_keyframe_dist_optimize(pmesh.ONE_RANK, shapes, num_iter=2, table_size=TABLE)
    f2 = keyframe_dist.make_keyframe_dist_optimize(pmesh.ONE_RANK, shapes, num_iter=2, table_size=TABLE)
    assert f1 is f2
    grids = torch.tensor([0.4, 1.0])
    for seed in (9, 10):
        data, params0, _ = _problem(seed)
        fp, fm, frs, aux = keyframe_dist.flatten_problem(torch_dist.as_port(data))
        p, iters, err, cells = f1(torch.as_tensor(params0), fp, fm, frs, aux, grids)
        assert torch.isfinite(p).all() and 1 <= int(iters) <= 2 and int(cells) > 0


def test_map_data_and_aux_round_trip():
    """convert.map_data_from_numpy / kf_aux_from_numpy: the reference's
    KeyframeMapData and KfAux (as numpy arrays) -> the port's, every field
    with the same values, shape and dtype."""
    data, _, _ = _problem()
    jd = jkfm.KeyframeMapData(**{k: jnp.asarray(v) for k, v in data.items()})
    port = convert.map_data_from_numpy(jax.tree.map(np.asarray, jd), device="cpu")
    assert port._fields == jd._fields
    for f in jd._fields:
        want = np.asarray(getattr(jd, f))
        got = getattr(port, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want)
    jaux = jkd.aux_from_data(jd)
    aux = convert.kf_aux_from_numpy(jax.tree.map(np.asarray, jaux), device="cpu")
    assert aux._fields == jaux._fields
    for f in jaux._fields:
        np.testing.assert_array_equal(getattr(aux, f).numpy(), np.asarray(getattr(jaux, f)))
        assert getattr(aux, f).numpy().dtype == np.asarray(getattr(jaux, f)).dtype
    for a, b in zip(keyframe_dist.aux_from_data(port), aux):
        assert torch.equal(a, b)
