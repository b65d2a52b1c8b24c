"""The fixed-order segment sums on a CUDA card: the same call twice gives
the same bits, for the library call they rest on (torch.segment_reduce,
whose determinism on the card no document promises), for voxel.run_sums,
gaussians.build_cells, one structured Gauss-Newton iteration
(dmsa.optimizer._iteration_structured, the host pipeline's) and one build
of the hash backend's cells (parallel.sharded.build_cells_sharded).  The
float atomics these replace (index_add_) summed in whatever order the
card's threads arrived.  Against the same functions on CPU tensors: every
segment sums its members one after another on both (a 1-D value is
summed as a column of a 2-D one, since the library sums 1-D segments on
the card by a tree reduction), so equal bit for bit.

This file imports neither jax nor the reference package:

    python -m pytest --noconftest -m gpu tests/test_torch_fixed_sums_card.py

Every test is marked `gpu` and skips without a card.
"""

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.ops import gaussians, voxel
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
from dmsa_lidar_slam_tpu_torch.parallel import sharded
from tests.torch_parity import nn, require_cuda


def _same_bits(x, y):
    if isinstance(x, tuple):
        for u, v in zip(x, y):
            _same_bits(u, v)
    elif torch.is_tensor(x):
        np.testing.assert_array_equal(nn(x), nn(y))


def _equal_twice(fn):
    """fn() twice on the card: the same bits (every tensor, in nested tuples
    too)."""
    a, b = fn(), fn()
    _same_bits(a, b)
    return a if isinstance(a, tuple) else (a,)


def _long_runs(n, n_keys, seed):
    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, n_keys, size=n))
    new = np.ones(n, bool)
    new[1:] = key[1:] != key[:-1]
    return np.maximum.accumulate(np.where(new, np.arange(n), 0)), rng


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [1, 6])
def test_segment_reduce_repeats_on_card(dims):
    """The library call itself, on runs of ~2,000 members (many threads
    would share a run if it summed in parallel), 1-D and 2-D."""
    require_cuda()
    start, rng = _long_runs(400_000, 200, 0)
    values = (rng.standard_normal((400_000, dims)) * 3.0 + 20.0).astype(np.float32).squeeze()
    ordinal = torch.as_tensor(np.cumsum(start == np.arange(len(start))) - 1)
    seg = voxel.segments(ordinal.cuda(), 200)
    v = torch.as_tensor(values).cuda()
    (got,) = _equal_twice(lambda: voxel.segment_sum(seg, v))
    np.testing.assert_array_equal(nn(got), nn(voxel.segment_sum(voxel.segments(ordinal, 200), torch.as_tensor(values))))


@pytest.mark.gpu
def test_run_sums_and_segment_mean_cov_repeat_on_card():
    require_cuda()
    start, rng = _long_runs(200_000, 20_000, 1)
    values = (rng.standard_normal((200_000, 4)) * 3.0 + 20.0).astype(np.float32)
    start_b, _ = _long_runs(200_000, 5_000, 5)
    v, vb = torch.as_tensor(values), torch.as_tensor(values[::-1].copy())

    def runs(device):
        a = voxel.sorted_runs(torch.as_tensor(start, device=device), torch.tensor(int(start[190_000]), device=device))
        b = voxel.sorted_runs(torch.as_tensor(start_b, device=device), torch.tensor(200_000, device=device))
        return a, voxel.Runs(offsets=torch.stack([a.offsets, b.offsets]),
                             ordinal=torch.cat([a.ordinal, b.ordinal + 200_000]))

    (ra, rs), (ca, cs) = runs("cuda"), runs("cpu")
    (got,) = _equal_twice(lambda: voxel.run_sums(v.cuda(), ra))
    np.testing.assert_array_equal(nn(got), nn(voxel.run_sums(v, ca)))
    (both,) = _equal_twice(lambda: voxel.run_sums(torch.cat([v, vb]).cuda(), rs))
    np.testing.assert_array_equal(nn(both), nn(voxel.run_sums(torch.cat([v, vb]), cs)))
    pts = (rng.standard_normal((50_000, 3)) * np.array([2.0, 1.0, 0.05]) + 30.0).astype(np.float32)
    cell = rng.integers(0, 300, size=50_000)
    w = (rng.uniform(size=50_000) > 0.2).astype(np.float32)
    args = [torch.as_tensor(a) for a in (pts, cell, w)]
    card = _equal_twice(lambda: gaussians.segment_mean_cov(*[a.cuda() for a in args], 300))
    for a, b in zip(card, gaussians.segment_mean_cov(*args, 300)):
        np.testing.assert_array_equal(nn(a), nn(b))


def _room_cloud(n, seed):
    from dmsa_lidar_slam_tpu_torch.io.synthetic import room_scene, sample_scene_points

    rng = np.random.default_rng(seed)
    pts = sample_scene_points(rng, n, planes=room_scene(1.0)).astype(np.float32)
    return pts, rng.uniform(size=n) > 0.05, rng.integers(0, 32, size=n).astype(np.int32)


@pytest.mark.gpu
def test_build_cells_repeats_on_card():
    require_cuda()
    pts, mask, rings = (torch.as_tensor(a).cuda() for a in _room_cloud(60_000, 2))
    for grid in (0.4, 1.0):
        cells = _equal_twice(lambda: tuple(gaussians.build_cells(pts, mask, rings, grid, 6)))
        assert int(cells[10]) > 100  # num_valid


def _window_problem(device):
    """A bench-shaped window problem (tools/torch_micro_opt.py's, at 5
    scans x 2,048 points + 4,096 static points, no IMU)."""
    from dmsa_lidar_slam_tpu_torch.io.synthetic import SyntheticSequence, room_scene, sample_scene_points
    from dmsa_lidar_slam_tpu_torch.trajectory import builder
    from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
    from dmsa_lidar_slam_tpu_torch.utils.dtypes import POSE_DTYPE

    seq = SyntheticSequence(rng=np.random.default_rng(0), noise_std=0.01)
    scans = []
    for i in range(5):
        p, stamps, rings = seq.scan(i, 2048)
        scans.append(builder.HostScan(points=p, stamps=stamps, rings=rings, grid_size=0.2))
    shapes = ct.WindowShapes(n_window_pts=5 * 2048, n_static=4096, n_ctrl=6, n_dense=501)
    data, _, min_grid, _ = builder.build_window(scans, shapes, None, np.eye(3) * 1e-4, np.eye(3) * 1e-2, 1e-3,
                                                False, device)
    rng = np.random.default_rng(1)
    st = sample_scene_points(rng, shapes.n_static, planes=room_scene(1.0)).astype(np.float32)
    data = data._replace(
        static_pts=torch.as_tensor(st, device=device),
        static_mask=torch.ones(shapes.n_static, dtype=torch.bool, device=device),
        static_ring=torch.as_tensor(rng.integers(0, 32, shapes.n_static).astype(np.int32), device=device),
    )
    params = torch.full((6 * (shapes.n_ctrl - 1),), 1e-3, dtype=POSE_DTYPE, device=device)
    return ct.make_forward(shapes, use_imu=False), ct.make_structured(shapes, use_imu=False), data, params, min_grid


@pytest.mark.gpu
def test_structured_iteration_repeats_on_card():
    require_cuda()
    fwd, structured, data, params, min_grid = _window_problem(torch.device("cuda", 0))
    settings = opt.OptimSettings(min_num_points_per_set=10)
    out = _equal_twice(lambda: opt._iteration_structured(fwd, structured, params, data, settings, float(min_grid),
                                                         settings.step_length_optim, settings.max_step))
    assert int(out[4]) > 100 and bool(torch.isfinite(out[3]))  # cells, error


@pytest.mark.gpu
def test_hash_build_repeats_on_card():
    require_cuda()
    pts, mask, rings = (torch.as_tensor(a).cuda() for a in _room_cloud(200_000, 3))
    grid = torch.tensor(0.5, dtype=torch.float32, device="cuda")

    def build():
        cells, (cid, keep) = sharded.build_cells_sharded(pts, mask, rings, grid, 6, 65536, pmesh.ONE_RANK)
        res = sharded.cell_residuals_sharded(pts + 0.01, keep, cid, cells, 65536, pmesh.ONE_RANK)
        return (*cells[:6], cid, keep, res)

    out = _equal_twice(build)
    assert int(out[3]) > 1000  # num_valid
