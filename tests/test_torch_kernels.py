"""The port's kernel wrappers K1-K5 (csrc/*.cu) and their plain versions.

This file imports neither jax nor the reference package, so it also runs on
a machine that has a CUDA card and no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(--noconftest: tests/conftest.py pins jax to the CPU.)  The tests marked
`gpu` hold each kernel against its plain version on the same inputs on the
card, with chip_smoke.py's tolerances, and skip without a card.  The
others run on the CPU: a wrapper given CPU tensors returns its plain
version's result and launches nothing, and the plain statement of K2's
chunk/piece cut (fused_residuals.gn_system_pieces_ref) is held against the
plain per-cell normal equations.  On the card, K1's keys are checked bit for
bit against voxel.voxel_keys on voxel boundaries, and K1 and K2 against
themselves from one call to the next.

Tolerances: K1's structural rows (local points, validity, table index, run
starts, 1/count) are exact; cell means to 2e-4 m and lamw6 to 2% of its
scale (moments about the run's first member against the plain two-pass
moments, amplified by the floored inverse: the reference's own kernel test
grants the same); K2 to 1e-3 relative (f32 sums over cells in another
order); K3 to 2e-4 relative (f32-class sums, compared with each other by
the line search); K4 to 1e-6 relative (the same f32 formula); K5's counts
exactly (the same op-by-op d2), its means to 2e-6 m and its covariances to
1e-5 of their scale (f32 sums of the same offsets in another order).
"""

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
from dmsa_lidar_slam_tpu_torch.ops import nn_bruteforce as nb
from tests.torch_parity import nn, require_cuda


def _problem(seed, n=4096, dtab=34, giant_cell=False):
    """A random indexed-affine problem: points on a pose table, the last
    row the identity (static points), optionally half of them in one
    voxel."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 4, size=(n, 3)).astype(np.float32)
    if giant_cell:
        xs[: n // 2] = 0.5 + 0.2 * rng.standard_normal((n // 2, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    rings = rng.integers(0, 8, size=n).astype(np.int32)
    tidx = rng.integers(0, dtab - 1, size=n)
    tidx[n // 8 :: 7] = dtab - 1

    def rand_tab(scale):
        tab = np.zeros((dtab, 8), np.float32)
        tab[:-1, 0:4] = nn(rot.axang2quat(torch.as_tensor(scale * rng.standard_normal((dtab - 1, 3)))))
        tab[:-1, 4:7] = 0.5 * rng.standard_normal((dtab - 1, 3))
        tab[-1, 0] = 1.0
        return torch.as_tensor(tab)

    tab0 = rand_tab(0.1)
    ti = torch.as_tensor(tidx)
    x = torch.as_tensor(xs)
    world = rot.quat_rotate(tab0[ti, 0:4], x) + tab0[ti, 4:7]
    args = (world, torch.as_tensor(mask), torch.as_tensor(rings), x, ti, 1.0, 4, tab0)
    dtabs = torch.as_tensor(0.1 * rng.standard_normal((6, dtab, 8)), dtype=torch.float32)
    dtabs[:, -1] = 0.0
    tabs = torch.stack([tab0] + [rand_tab(0.1) for _ in range(14)])
    return args, dtabs, tabs


def _clouds(seed, n_ref, n_q, extent=10.0):
    rng = np.random.default_rng(seed)
    ref = torch.as_tensor(rng.uniform(-extent, extent, (n_ref, 3)), dtype=torch.float32)
    q = torch.as_tensor(rng.uniform(-extent, extent, (n_q, 3)), dtype=torch.float32)
    return ref, torch.as_tensor(rng.uniform(size=n_ref) > 0.2), q, torch.as_tensor(rng.uniform(size=n_q) > 0.2)


def _cmp_packed(pk, pk_ref):
    np.testing.assert_array_equal(pk[12:15], pk_ref[12:15])  # w, tidx, run starts
    np.testing.assert_array_equal(pk[0:3], pk_ref[0:3])  # xs
    np.testing.assert_allclose(pk[15], pk_ref[15], atol=1e-6)  # 1/count at valid ends
    sel = np.abs(pk_ref[6:12]).sum(axis=0) > 0
    np.testing.assert_allclose(pk[3:6, sel], pk_ref[3:6, sel], atol=2e-4)
    scale = np.abs(pk_ref[6:12, sel]).max()
    np.testing.assert_allclose(pk[6:12, sel], pk_ref[6:12, sel], atol=0.02 * scale)


@pytest.mark.parametrize("giant_cell", [False, True])
def test_wrappers_take_plain_versions_on_cpu(giant_cell):
    """For CPU tensors each wrapper returns exactly its plain version's
    result and counts no launch."""
    args, dtabs, tabs = _problem(1, n=1024, giant_cell=giant_cell)
    cuda_lib.reset_launches()
    pk, nv, nr = fr.build_packed(*args)
    pk_r, nv_r, nr_r = fr.build_packed_ref(*args)
    assert torch.equal(pk, pk_r) and int(nv) == int(nv_r) and int(nr) == int(nr_r)
    assert torch.equal(fr.gn_system(args[-1], dtabs, pk), fr.gn_system_ref(args[-1], dtabs, pk, include_mean_term=False))
    assert torch.equal(fr.cand_errors(tabs, pk), fr.cand_errors_ref(tabs, pk))
    ref, rv, q, qv = _clouds(2, 300, 200)
    assert torch.equal(nb.min_sq_dist(ref, rv, q, qv), nb.min_sq_dist_ref(ref, rv, q, qv))
    assert all(v == 0 for v in cuda_lib.LAUNCHES.values())


@pytest.mark.parametrize("chunk", [32, fr.K2_CHUNK])
@pytest.mark.parametrize("giant_cell", [False, True])
def test_k2_piece_cut_gives_cell_sums(giant_cell, chunk):
    """K2's chunk/piece cut, stated in plain torch: summing every cell's
    pieces in chunk order gives the normal equations of the plain per-cell
    sums, each chunk hands on at most two pieces, and with a giant cell one
    cell spreads over many chunks."""
    args, dtabs, _ = _problem(4, n=4096, giant_cell=giant_cell)
    pk = fr.build_packed(*args)[0]
    h, staged = fr.gn_system_pieces_ref(args[-1], dtabs, pk, chunk=chunk)
    h_r = nn(fr.gn_system_ref(args[-1], dtabs, pk, include_mean_term=False))
    # the same f32 terms, summed per piece first: f32-class differences
    np.testing.assert_allclose(nn(h), h_r, rtol=1e-4, atol=1e-5 * np.abs(h_r).max())
    assert staged.shape[0] == -(-pk.shape[1] // chunk) and int(staged.max()) <= 2
    p = nn(pk)
    starts = np.flatnonzero(p[14] > 0.5)
    ends = np.append(starts[1:], p.shape[1])
    assert int(staged.sum()) > 0
    if giant_cell:
        assert (ends - starts)[p[15, ends - 1] > 0].max() > 4 * chunk


@pytest.mark.gpu
@pytest.mark.parametrize("giant_cell", [False, True])
def test_k1_k3_match_plain_on_card(giant_cell):
    require_cuda()
    dev = torch.device("cuda")
    args, dtabs, tabs = _problem(3, giant_cell=giant_cell)
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)
    before = dict(cuda_lib.LAUNCHES)
    pk, nv, nr = fr.build_packed(*args)
    pk_r, nv_r, nr_r = fr.build_packed_ref(*args)
    assert int(nv) == int(nv_r) and int(nr) == int(nr_r)
    _cmp_packed(nn(pk), nn(pk_r))
    dtabs, tabs = dtabs.to(dev), tabs.to(dev)
    h = nn(fr.gn_system(args[-1], dtabs, pk))
    h_r = nn(fr.gn_system_ref(args[-1], dtabs, pk, include_mean_term=False))
    np.testing.assert_allclose(h, h_r, rtol=1e-3, atol=1e-4 * np.abs(h_r).max())
    np.testing.assert_allclose(nn(fr.cand_errors(tabs, pk)), nn(fr.cand_errors_ref(tabs, pk)), rtol=2e-4)
    for k in ("build_packed", "gn_system", "cand_errors"):
        assert cuda_lib.LAUNCHES[k] == before[k] + 1, k


@pytest.mark.gpu
def test_k4_matches_plain_on_card():
    require_cuda()
    dev = torch.device("cuda")
    ref, rv, q, qv = (a.to(dev) for a in _clouds(7, 5000, 3000))
    d = nn(nb.min_sq_dist(ref, rv, q, qv))
    d_r = nn(nb.min_sq_dist_ref(ref, rv, q, qv))
    fin = np.isfinite(d_r)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_allclose(d[fin], d_r[fin], rtol=1e-6, atol=1e-6)
    no_ref = nn(nb.min_sq_dist(ref, torch.zeros_like(rv), q, qv))
    assert np.all(np.isinf(no_ref))


@pytest.mark.gpu
def test_k5_matches_plain_on_card():
    require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    pts = torch.as_tensor(rng.uniform(-2, 2, (3000, 3)), dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.uniform(size=3000) > 0.2, device=dev)
    pts[~valid] = float("nan")
    before = cuda_lib.LAUNCHES["radius_neighbor_moments"]
    cnt, mean, cov = (nn(a) for a in nb.radius_neighbor_moments(pts, valid, 0.5))
    assert cuda_lib.LAUNCHES["radius_neighbor_moments"] == before + 1
    cnt_r, mean_r, cov_r = (nn(a) for a in nb.radius_neighbor_moments_ref(pts, valid, 0.5))
    np.testing.assert_array_equal(cnt, cnt_r)
    assert cnt_r.max() >= 10
    np.testing.assert_allclose(mean, mean_r, atol=2e-6)
    np.testing.assert_allclose(cov, cov_r, atol=1e-5 * np.abs(cov_r).max())


def _boundary_points(grid, n_cells=40):
    """f32 coordinates exactly on voxel boundaries k * grid (as f32) and one
    ulp either side, in all three axes, with and without a mask."""
    k = np.arange(-n_cells, n_cells, dtype=np.float32)
    on = (k * np.float32(grid)).astype(np.float32)
    c = np.concatenate([on, np.nextafter(on, np.float32(np.inf)), np.nextafter(on, np.float32(-np.inf))])
    rng = np.random.default_rng(11)
    pts = np.stack([c, rng.permutation(c), rng.permutation(c)], axis=1).astype(np.float32)
    mask = rng.uniform(size=len(c)) > 0.1
    split = rng.integers(0, 6, size=len(c)).astype(np.int32)
    return pts, mask, split


@pytest.mark.gpu
@pytest.mark.parametrize("grid_kind", ["host", "cuda_f32"])
def test_k1_keys_bitwise_on_voxel_boundaries(grid_kind):
    """K1's key kernel gives voxel.combined_key(*voxel.voxel_keys(...)) on
    the card bit for bit, for points on voxel boundaries and one ulp either
    side, whether the grid is a host number or an f32 device scalar (as the
    optimizer passes it); a device grid of another type is refused."""
    from dmsa_lidar_slam_tpu_torch.ops import voxel

    require_cuda()
    dev = torch.device("cuda")
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(dev)
    for grid in (0.6, 1.5, 0.3, 0.15 * 2.0, 2.5 * 0.6):
        pts, mask, split = _boundary_points(grid)
        pts, mask, split = (torch.as_tensor(a, device=dev) for a in (pts, mask, split))
        g = grid
        if grid_kind == "cuda_f32":
            g = 2.0 * torch.tensor(grid / 2.0, dtype=torch.float32, device=dev)
            with pytest.raises(ValueError):
                fr._k1_keys(pts, mask, g.double(), None, lib, stream)
        for ch in (None, split):
            key = fr._k1_keys(pts, mask, g, ch, lib, stream)
            want = voxel.combined_key(*voxel.voxel_keys(pts, mask, g, channel=ch))
            assert torch.equal(key, want), (grid, grid_kind, ch is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("giant_cell", [False, True])
def test_k1_k2_bitwise_repeatable_on_card(giant_cell):
    """Two calls with the same inputs give bit-identical packed rows, counts
    and Hext (no float atomics), at a small and a large P."""
    require_cuda()
    dev = torch.device("cuda")
    args, dtabs, _ = _problem(5, giant_cell=giant_cell)
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)
    a, b = fr.build_packed(*args), fr.build_packed(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    pk, tab = a[0], args[-1]
    for p_dim in (6, 200):
        dt = torch.as_tensor(np.random.default_rng(p_dim).standard_normal((p_dim,) + tuple(tab.shape)),
                             dtype=torch.float32, device=dev)
        assert torch.equal(fr.gn_system(tab, dt, pk), fr.gn_system(tab, dt, pk)), p_dim


@pytest.mark.gpu
def test_k2_large_p_matches_plain_on_card():
    """K2's large-P path (P + 1 > K2_SMALL_P1: dense J rows and the tiled
    J^T J) against the plain version, with a giant cell, at K2's tolerance."""
    require_cuda()
    dev = torch.device("cuda")
    args, _, _ = _problem(6, n=8192, giant_cell=True)
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)
    tab = args[-1]
    p_dim = 2 * fr.K2_SMALL_P1 + 10
    dtabs = 0.1 * torch.as_tensor(np.random.default_rng(9).standard_normal((p_dim,) + tuple(tab.shape)),
                                  dtype=torch.float32, device=dev)
    dtabs[:, -1] = 0.0
    pk = fr.build_packed(*args)[0]
    before = cuda_lib.LAUNCHES["gn_system"]
    h = nn(fr.gn_system(tab, dtabs, pk, max_cells=pk.shape[1] // 4 + 2))
    assert cuda_lib.LAUNCHES["gn_system"] == before + 1
    h_r = nn(fr.gn_system_ref(tab, dtabs, pk, include_mean_term=False))
    np.testing.assert_allclose(h, h_r, rtol=1e-3, atol=1e-4 * np.abs(h_r).max())
