"""Port vs reference: voxel keys, random-grid downsampling, compaction, the
hashed grid-ladder counts and scan preprocessing.

Tolerance: none — fed the reference's own random priorities, the port must
give exactly the same indices, masks, counts and chosen grid.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.ops import voxel as jvoxel
from dmsa_lidar_slam_tpu.pipeline import preprocess as jpp
from dmsa_lidar_slam_tpu_torch.ops import voxel as tvoxel
from dmsa_lidar_slam_tpu_torch.pipeline import preprocess as tpp
from tests.torch_parity import jax_bits, nn, tt


def _cloud(seed, n, extent=8.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    pts[: n // 4] = pts[n // 4 : n // 2] + 0.01  # crowded voxels
    mask = rng.uniform(size=n) > 0.1
    return pts, mask


@pytest.mark.parametrize("seed,grid", [(0, 2.0), (1, 0.5), (2, 0.15)])
def test_random_downsample_mask(seed, grid):
    pts, mask = _cloud(seed, 3000)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jvoxel.random_downsample_mask(jnp.asarray(pts), jnp.asarray(mask), grid, key))
    got = tvoxel.random_downsample_mask(tt(pts), tt(mask), grid, tt(jax_bits(key, len(pts))))
    np.testing.assert_array_equal(nn(got), want)


@pytest.mark.parametrize("cap", [64, 1000, 4096])
def test_compact(cap):
    rng = np.random.default_rng(cap)
    mask = rng.uniform(size=2000) > 0.6
    ji, jm = jvoxel.compact(jnp.asarray(mask), cap)
    ti, tm = tvoxel.compact(tt(mask), cap)
    np.testing.assert_array_equal(nn(tm), np.asarray(jm))
    # indices past the valid count are padding: compare the valid prefix
    k = int(np.asarray(jm).sum())
    np.testing.assert_array_equal(nn(ti)[:k], np.asarray(ji)[:k])


def test_voxel_keys_and_split_channel():
    pts, mask = _cloud(3, 1000, extent=40.0)
    ch = np.random.default_rng(3).integers(0, 6, size=1000).astype(np.int32)
    for channel in (None, ch):
        jh, jl = jvoxel.voxel_keys(jnp.asarray(pts), jnp.asarray(mask), 0.3,
                                   None if channel is None else jnp.asarray(channel))
        th, tl = tvoxel.voxel_keys(tt(pts), tt(mask), 0.3, None if channel is None else tt(channel))
        np.testing.assert_array_equal(nn(th), np.asarray(jh))
        np.testing.assert_array_equal(nn(tl), np.asarray(jl))


@pytest.mark.parametrize("seed", [4, 5])
def test_count_voxels_ladder(seed):
    pts, mask = _cloud(seed, 5000, extent=20.0)
    want = jvoxel.count_voxels_ladder(jnp.asarray(pts), jnp.asarray(mask), jpp.GRID_LADDER)
    got = tvoxel.count_voxels_ladder(tt(pts), tt(mask), tpp.GRID_LADDER)
    np.testing.assert_array_equal(nn(got), np.asarray(want))


@pytest.mark.parametrize("n,max_pts,extent", [(8000, 500, 3.0), (6000, 3000, 30.0), (3000, 700, 10.0)])
def test_preprocess_scan(n, max_pts, extent):
    rng = np.random.default_rng(n)
    pts = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    mask = np.arange(n) < n - 100
    key = jax.random.PRNGKey(n)
    cap = 4096
    jr = jpp.preprocess_scan(
        jnp.asarray(pts), jnp.asarray(mask), key, jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, dtype=jnp.float32), max_num_points=max_pts, min_dist_ds=2.0, min_dist=0.1, cap=cap,
    )
    tr = tpp.preprocess_scan(tt(pts), tt(mask), tt(jax_bits(key, n)), max_pts, 2.0, 0.1, cap)
    assert float(tr.grid_size) == float(jr.grid_size)
    assert int(tr.num_kept) == int(jr.num_kept)
    np.testing.assert_array_equal(nn(tr.mask), np.asarray(jr.mask))
    k = int(np.asarray(jr.mask).sum())
    np.testing.assert_array_equal(nn(tr.indices)[:k], np.asarray(jr.indices)[:k])
