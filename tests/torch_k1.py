"""K1's test problems where its runs outgrow one chunk (fused_residuals.K1_CHUNK
sorted positions), shared by the CPU tests of its host build
(tests/test_torch_k1_host.py) and the card tests (tests/test_torch_kernels.py);
imports no jax.

  - submap: the submap view's shape, keyframes of points on a pose table
    (one row each, a trailing identity row), all but the active ones
    masked, so the masked points form one long run; optionally a valid
    cell of `giant` static points in one voxel;
  - boundary: static points in cells laid along x so that runs start and
    end exactly on chunk bounds (a short run ending on one, a run of
    exactly one chunk, runs of 257, of three whole chunks, ending on a bound,
    and the masked tail starting on one);
  - short: every run within one chunk (the masked run too).

Each returns build_packed's (args, kw) in the compact layout ("compact": a
table, no weights) or the 12-row one ("rows12": observation weights, world
points off the table's by 1 cm, split ids where the case allows them).
"""

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
from dmsa_lidar_slam_tpu_torch.ops import voxel

# run lengths of the boundary case, in key order: bounds at multiples of 256
BOUNDARY_RUNS = (100, 156, 256, 257, 255, 768, 300, 500, 200, 280)


def _layout(rng, world, mask, rings, xs, tidx, tab, layout, split=True):
    n = world.shape[0]
    args = (world, mask, rings, xs, tidx, 1.0, 6, tab)
    if layout == "compact":
        return args, {}
    world = world + torch.as_tensor(0.01 * rng.standard_normal((n, 3)), dtype=torch.float32)
    obs = torch.as_tensor(rng.uniform(0.5, 2.0, size=n), dtype=torch.float32)
    kw = dict(obs_weight=obs)
    if split:
        kw["split_ids"] = torch.as_tensor(rng.integers(0, 4, size=n), dtype=torch.int32)
    return (world,) + args[1:], kw


def submap_case(seed, n_kf=48, ppk=4096, active=4, giant=0, extent=6.0, layout="compact"):
    """n_kf keyframes of ppk points in a box of half-width `extent` m (0.3 of
    it in z), the last `active` keyframes valid (5% of their points masked),
    the others masked; `giant` of the active points moved onto the identity
    row inside one voxel."""
    rng = np.random.default_rng(seed)
    n = n_kf * ppk
    tab = np.zeros((n_kf + 1, 8), np.float32)
    tab[:, 0] = 1.0
    tab[:n_kf, 0:4] = rot.axang2quat(torch.as_tensor(0.05 * rng.standard_normal((n_kf, 3)))).numpy()
    tab[:n_kf, 4:7] = np.cumsum(0.3 * rng.standard_normal((n_kf, 3)), axis=0)
    tidx = np.repeat(np.arange(n_kf), ppk)
    xs = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    xs[:, 2] *= 0.3
    mask = (tidx >= n_kf - active) & (rng.uniform(size=n) > 0.05)
    if giant:
        live = np.flatnonzero(mask)[:giant]
        tidx[live] = n_kf
        xs[live] = 0.5 + 0.15 * rng.uniform(-1, 1, size=(giant, 3)).astype(np.float32)
    rings = rng.integers(0, 32, size=n).astype(np.int32)
    tab_t, ti = torch.as_tensor(tab), torch.as_tensor(tidx)
    x = torch.as_tensor(xs)
    world = rot.quat_rotate(tab_t[ti, 0:4], x) + tab_t[ti, 4:7]
    return _layout(rng, world, torch.as_tensor(mask), torch.as_tensor(rings), x, ti, tab_t, layout,
                   split=not giant)  # split ids would cut the giant cell in four


def boundary_case(seed, masked=1024, layout="compact"):
    """Static points (the identity row) in cells of BOUNDARY_RUNS points,
    cell i inside voxel (i, 0, 0), then `masked` masked points."""
    rng = np.random.default_rng(seed)
    cell = np.repeat(np.arange(len(BOUNDARY_RUNS)), BOUNDARY_RUNS)
    nv = cell.shape[0]
    xs = np.concatenate([
        np.stack([cell + 0.5, np.full(nv, 0.5), np.full(nv, 0.5)], axis=1) + rng.uniform(-0.4, 0.4, (nv, 3)),
        rng.uniform(0, 4, (masked, 3)),
    ]).astype(np.float32)
    n = xs.shape[0]
    perm = rng.permutation(n)  # the sort, not the input order, lays the runs out
    xs = xs[perm]
    mask = (np.arange(n) < nv)[perm]
    tab = np.zeros((2, 8), np.float32)
    tab[:, 0] = 1.0
    tidx = torch.ones(n, dtype=torch.int64)
    x = torch.as_tensor(xs)
    rings = torch.as_tensor(rng.integers(0, 8, size=n).astype(np.int32))
    return _layout(rng, x.clone(), torch.as_tensor(mask), rings, x, tidx, torch.as_tensor(tab), layout, split=False)


def short_case(seed, n=4096, layout="compact"):
    """Points on a pose table in a 4 m box at a 1 m grid (~64 a cell) with
    4% masked: every run, the masked one too, within one chunk."""
    rng = np.random.default_rng(seed)
    dtab = 34
    tab = np.zeros((dtab, 8), np.float32)
    tab[:, 0] = 1.0
    tab[:-1, 0:4] = rot.axang2quat(torch.as_tensor(0.1 * rng.standard_normal((dtab - 1, 3)))).numpy()
    tab[:-1, 4:7] = 0.5 * rng.standard_normal((dtab - 1, 3))
    tidx = torch.as_tensor(rng.integers(0, dtab, size=n))
    x = torch.as_tensor(rng.uniform(0, 4, size=(n, 3)).astype(np.float32))
    tab_t = torch.as_tensor(tab)
    world = rot.quat_rotate(tab_t[tidx, 0:4], x) + tab_t[tidx, 4:7]
    mask = torch.as_tensor(rng.uniform(size=n) > 0.04)
    rings = torch.as_tensor(rng.integers(0, 8, size=n).astype(np.int32))
    return _layout(rng, world, mask, rings, x, tidx, tab_t, layout)


def sorted_keys(args, kw):
    """The sorted voxel keys of build_packed's arguments, as K1 sorts them."""
    world, mask, grid = args[0], args[1], args[5]
    key = voxel.combined_key(*voxel.voxel_keys(world, mask, grid, channel=kw.get("split_ids")))
    return torch.sort(key, stable=True)[0]


def long_positions(args, kw):
    """Positions in runs longer than one chunk, counted from the sorted keys."""
    _, counts = torch.unique_consecutive(sorted_keys(args, kw), return_counts=True)
    return int(counts[counts > fr.K1_CHUNK].sum())


def longest_valid_run(pk):
    """Members of the longest valid cell of packed rows pk (numpy)."""
    starts = np.flatnonzero(pk[14] > 0.5)
    lengths = np.append(starts[1:], pk.shape[1]) - starts
    return int(lengths[pk[15, starts + lengths - 1] > 0].max())


def cmp_packed(pk, pk_ref):
    """K1's tolerances: structural rows exact, means to 2e-4 m, lamw6 to 2%
    of its scale (numpy rows)."""
    np.testing.assert_array_equal(pk[12:15], pk_ref[12:15])  # w, tidx, run starts
    np.testing.assert_array_equal(pk[0:3], pk_ref[0:3])  # xs
    np.testing.assert_allclose(pk[15], pk_ref[15], atol=1e-6)  # 1/count at valid ends
    sel = np.abs(pk_ref[6:12]).sum(axis=0) > 0
    np.testing.assert_allclose(pk[3:6, sel], pk_ref[3:6, sel], atol=2e-4)
    scale = np.abs(pk_ref[6:12, sel]).max()
    np.testing.assert_allclose(pk[6:12, sel], pk_ref[6:12, sel], atol=0.02 * scale)
