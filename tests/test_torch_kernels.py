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
plain per-cell normal equations, as is K3's (cand_errors_pieces_ref)
against the plain candidate errors.  On the card, K1's keys are checked bit
for bit against voxel.voxel_keys on voxel boundaries, K1's 12-row layout
(observation weights, or no pose table) against its plain version, its
all-ones weight against no weight bit for bit, K1-K5 against
themselves from one call to the next, K3 at 1 and 16 candidates and each
candidate's error independent of their number, K4 at ragged counts, a
large masked share and with no valid reference, K5 at ragged counts, one
and no points, all masked, pairs exactly at the radius and with the radius
as a host number and as a card scalar, the library's chunk and scratch
layouts against what the plain statements and csrc state, and K4 and K5
with a host radius under torch's sync debug mode.

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


def _problem(seed, n=4096, dtab=34, giant_cell=False, masked=0.1):
    """A random indexed-affine problem: points on a pose table, the last
    row the identity (static points), optionally half of them in one
    voxel; a share `masked` of the points is masked (one run with no
    weight)."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 4, size=(n, 3)).astype(np.float32)
    if giant_cell:
        xs[: n // 2] = 0.5 + 0.2 * rng.standard_normal((n // 2, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > masked
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


def _clouds(seed, n_ref, n_q, extent=10.0, invalid=0.2):
    rng = np.random.default_rng(seed)
    ref = torch.as_tensor(rng.uniform(-extent, extent, (n_ref, 3)), dtype=torch.float32)
    q = torch.as_tensor(rng.uniform(-extent, extent, (n_q, 3)), dtype=torch.float32)
    return (ref, torch.as_tensor(rng.uniform(size=n_ref) > invalid), q,
            torch.as_tensor(rng.uniform(size=n_q) > invalid))


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
    assert all(v == 0 for v in cuda_lib.BRANCHES.values())


@pytest.mark.parametrize("chunk", [32, fr.CHUNK])
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


K3_CASES = {"cells": {}, "giant_cell": {"giant_cell": True}, "long_masked_run": {"masked": 0.4}}


@pytest.mark.parametrize("chunk", [32, fr.CHUNK])
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_piece_cut_gives_cell_errors(case, chunk):
    """K3's chunk/piece cut, stated in plain torch: summing every cell's
    pieces in chunk order gives the plain per-cell candidate errors (the
    same f32 terms, summed per piece first: rtol 1e-5), each chunk hands on
    at most two pieces, and cells that cross chunks are finished from
    them.  With a giant cell one valid cell spreads over many chunks; with
    a long masked run one run with no weight spreads over several."""
    args, _, tabs = _problem(4, n=4096, **K3_CASES[case])
    pk = fr.build_packed(*args)[0]
    err, staged, finished = fr.cand_errors_pieces_ref(tabs, pk, chunk=chunk)
    np.testing.assert_allclose(nn(err), nn(fr.cand_errors_ref(tabs, pk)), rtol=1e-5)
    n_chunks = -(-pk.shape[1] // chunk)
    assert staged.shape[0] == finished.shape[0] == n_chunks and int(staged.max()) <= 2
    assert int(finished.sum()) > 0 and int(finished.max()) <= 1
    p = nn(pk)
    starts = np.flatnonzero(p[14] > 0.5)
    lengths = np.append(starts[1:], p.shape[1]) - starts
    if case == "giant_cell":
        assert lengths[p[15, starts + lengths - 1] > 0].max() > 4 * chunk
    if case == "long_masked_run":
        assert lengths[p[12, starts] == 0].max() > 4 * chunk


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


def _rows12_args(seed, layout, giant_cell, dev=None):
    """build_packed's arguments and keywords for K1's 12-row layout: world
    points offset from the table's (so a build that read the table would
    differ), observation weights uniform in [0.5, 2] and a split channel;
    layout "weights+tab" (weights select the 12-row layout although a
    table is given), "weights" or "no_tab" (no table, no weights)."""
    args, _, _ = _problem(seed, giant_cell=giant_cell)
    rng = np.random.default_rng(seed + 100)
    n = args[0].shape[0]
    world = args[0] + torch.as_tensor(0.01 * rng.standard_normal((n, 3)), dtype=torch.float32)
    obs = torch.as_tensor(rng.uniform(0.5, 2.0, size=n), dtype=torch.float32)
    split = torch.as_tensor(rng.integers(0, 4, size=n), dtype=torch.int32)
    args = (world,) + args[1:7] + ((args[7],) if layout == "weights+tab" else (None,))
    kw = dict(split_ids=split, obs_weight=None if layout == "no_tab" else obs)
    if dev is not None:
        args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)
        kw = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    return args, kw


def test_rows12_wrapper_takes_plain_version_on_cpu():
    """K1's 12-row layout on CPU tensors: its plain version's result, no
    launch and no branch counted."""
    cuda_lib.reset_launches()
    for layout in ("weights+tab", "weights", "no_tab"):
        args, kw = _rows12_args(8, layout, giant_cell=True)
        a, b = fr.build_packed(*args, **kw), fr.build_packed_ref(*args, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), layout
    assert all(v == 0 for v in cuda_lib.LAUNCHES.values())
    assert all(v == 0 for v in cuda_lib.BRANCHES.values())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["weights+tab", "weights", "no_tab"])
@pytest.mark.parametrize("giant_cell", [False, True])
def test_k1_rows12_matches_plain_on_card(giant_cell, layout):
    """K1's 12-row layout against its plain version at K1's tolerances,
    bit for bit from one call to the next, counted as a launch of K1 and a
    12-row branch each; the rows it feeds give K3's errors within 2e-4."""
    require_cuda()
    dev = torch.device("cuda")
    args, kw = _rows12_args(9, layout, giant_cell, dev)
    before, b12 = cuda_lib.LAUNCHES["build_packed"], cuda_lib.BRANCHES["build_rows12"]
    a, again = fr.build_packed(*args, **kw), fr.build_packed(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    assert cuda_lib.LAUNCHES["build_packed"] == before + 2 and cuda_lib.BRANCHES["build_rows12"] == b12 + 2
    pk, nv, nr = a
    pk_r, nv_r, nr_r = fr.build_packed_ref(*args, **kw)
    assert int(nv) == int(nv_r) and int(nr) == int(nr_r)
    _cmp_packed(nn(pk), nn(pk_r))
    _, _, tabs = _problem(9, giant_cell=giant_cell)
    tabs = tabs.to(dev)
    np.testing.assert_allclose(nn(fr.cand_errors(tabs, pk)), nn(fr.cand_errors_ref(tabs, pk_r)), rtol=2e-4)


@pytest.mark.gpu
def test_k1_rows12_unit_weight_bits_on_card():
    """On the card, a weight of 1 everywhere gives the unweighted 12-row
    build's bits, with or without a table; the compact layout (a table, no
    weights) counts no 12-row branch."""
    require_cuda()
    dev = torch.device("cuda")
    args, kw = _rows12_args(10, "no_tab", True, dev)
    ones = torch.ones(args[0].shape[0], dtype=torch.float32, device=dev)
    none12 = fr.build_packed(*args, **kw)
    tab = _problem(10, giant_cell=True)[0][7].to(dev)
    for t in (None, tab):
        ones12 = fr.build_packed(*args[:7], t, split_ids=kw["split_ids"], obs_weight=ones)
        assert all(torch.equal(x, y) for x, y in zip(none12, ones12))
    b12 = cuda_lib.BRANCHES["build_rows12"]
    fr.build_packed(*args[:7], tab, split_ids=kw["split_ids"])
    assert cuda_lib.BRANCHES["build_rows12"] == b12


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


K5_CASES = {  # (points, invalid share): counts off the 256-query tile and the 32-reference split grain
    "ragged": (3001, 0.2),
    "one_point": (1, 0.0),
    "no_points": (0, 0.0),
    "all_invalid": (700, 1.0),
    "keyframe_cap": (4096, 0.1),
    "over_one_split_tile": (20011, 0.3),
}


def _k5_cloud(seed, n, invalid, extent=2.0):
    """Points in a cube, a share `invalid` of them masked with NaN
    coordinates (a masked slot must never enter a sum)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) >= invalid
    pts[~valid] = np.nan
    return torch.as_tensor(pts), torch.as_tensor(valid)


def _k5_vs_plain(out, pts, valid, radius):
    """K5's result against its plain version: counts exactly, means to 2e-6
    m, covariances to 1e-5 of their scale; all finite."""
    cnt, mean, cov = (nn(a) for a in out)
    cnt_r, mean_r, cov_r = (nn(a) for a in nb.radius_neighbor_moments_ref(pts, valid, radius))
    assert cnt.shape == cnt_r.shape and mean.shape == mean_r.shape and cov.shape == cov_r.shape
    np.testing.assert_array_equal(cnt, cnt_r)
    np.testing.assert_allclose(mean, mean_r, atol=2e-6)
    np.testing.assert_allclose(cov, cov_r, atol=1e-5 * max(float(np.abs(cov_r).max(initial=0.0)), 1e-30))
    assert all(np.all(np.isfinite(a)) for a in (cnt, mean, cov))
    return cnt_r


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_edges_on_card(case):
    """K5 against its plain version at counts off every tile and split size,
    at one and no points, with every point masked, and over more than one
    shared-memory tile per split; NaN in the masked slots.  One launch per
    call (none for no points), a second call bit for bit the same, and the
    radius as a host float and as an f32 card scalar giving the same bits;
    a radius of another type or device is refused."""
    require_cuda()
    dev = torch.device("cuda")
    n, invalid = K5_CASES[case]
    pts, valid = (a.to(dev) for a in _k5_cloud(17, n, invalid))
    before = cuda_lib.LAUNCHES["radius_neighbor_moments"]
    out = nb.radius_neighbor_moments(pts, valid, 0.5)
    assert cuda_lib.LAUNCHES["radius_neighbor_moments"] == before + (n > 0)
    for again in (nb.radius_neighbor_moments(pts, valid, 0.5),
                  nb.radius_neighbor_moments(pts, valid, torch.tensor(0.5, dtype=torch.float32, device=dev))):
        assert all(torch.equal(a, b) for a, b in zip(out, again))
    cnt_r = _k5_vs_plain(out, pts, valid, 0.5)
    if invalid == 1.0:
        assert not np.any(cnt_r)
    elif n > 1000:
        assert cnt_r.max() >= 10
    for bad in (torch.tensor(0.5, dtype=torch.float64, device=dev), torch.tensor(0.5), "0.5"):
        with pytest.raises(ValueError):
            nb.radius_neighbor_moments(pts, valid, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [0.5, 0.3])
def test_k5_pairs_at_the_radius_on_card(radius):
    """Pairs exactly at d2 == rho^2 (f32) count, as in the plain version:
    a lattice 0.5 apart where every axial pair lies at the radius 0.5, and
    chains of three points f32(radius) apart along x (exact for any radius:
    the differences and the square are exact)."""
    require_cuda()
    dev = torch.device("cuda")
    s = np.float32(radius)
    k = np.arange(6, dtype=np.float32) * np.float32(0.5)
    lattice = np.stack(np.meshgrid(k + 10.0, k - 3.0, k + 2.0, indexing="ij"), axis=-1).reshape(-1, 3)
    chains = np.zeros((3 * 50, 3), np.float32)
    chains[:, 0] = np.tile(np.array([0.0, s, 2 * s], np.float32), 50)
    chains[:, 1] = np.repeat(3.0 * np.arange(50, dtype=np.float32), 3)
    pts = np.concatenate([lattice if radius == 0.5 else np.zeros((0, 3), np.float32), chains]).astype(np.float32)
    pts_t = torch.as_tensor(pts, device=dev)
    valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
    for r in (radius, torch.tensor(radius, dtype=torch.float32, device=dev)):
        cnt_r = _k5_vs_plain(nb.radius_neighbor_moments(pts_t, valid, r), pts_t, valid, radius)
        np.testing.assert_array_equal(cnt_r[-150:], np.tile([2.0, 3.0, 2.0], 50))
        if radius == 0.5:
            assert cnt_r[:216].max() == 7 and cnt_r[:216].min() == 4


@pytest.mark.gpu
def test_k5_scratch_layout_from_library():
    """The K5 scratch the wrapper takes from the library is the layout
    k5_moments.cu states: [splits, 10, n] f32, with the split count from
    256-query tiles, 32-reference grains and 8 blocks per SM."""
    require_cuda()
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    for n in (1, 31, 32, 33, 257, 3001, 4096, 100000):
        qtiles, grains = -(-n // 256), -(-n // 32)
        want = min(grains, max(1, -(-(8 * sms) // qtiles)))
        per = -(-grains // want)
        splits = -(-grains // per)
        assert cuda_lib.scratch_bytes("k5_scratch_bytes", 1, n) == (4 * 10 * splits * n,), n


@pytest.mark.gpu
def test_k4_k5_host_radius_make_no_sync():
    """K5 and has_neighbor_within with a Python-float radius copy nothing to
    the card and never sync the stream (torch's sync debug mode raises on
    either)."""
    require_cuda()
    dev = torch.device("cuda")
    pts, valid = (a.to(dev) for a in _k5_cloud(18, 4096, 0.1))
    ref, rv, q, qv = (a.to(dev) for a in _clouds(19, 5000, 3000))
    warm = (nb.radius_neighbor_moments(pts, valid, 0.8), nb.has_neighbor_within(ref, rv, q, qv, 0.8))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = nb.radius_neighbor_moments(pts, valid, 0.8)
        near = nb.has_neighbor_within(ref, rv, q, qv, 0.8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(out, warm[0])) and torch.equal(near, warm[1])


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
    before, dense = cuda_lib.LAUNCHES["gn_system"], cuda_lib.BRANCHES["gn_system_dense_j"]
    h = nn(fr.gn_system(tab, dtabs, pk, max_cells=pk.shape[1] // 4 + 2))
    assert cuda_lib.LAUNCHES["gn_system"] == before + 1
    assert cuda_lib.BRANCHES["gn_system_dense_j"] == dense + 1
    h_r = nn(fr.gn_system_ref(tab, dtabs, pk, include_mean_term=False))
    np.testing.assert_allclose(h, h_r, rtol=1e-3, atol=1e-4 * np.abs(h_r).max())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_candidates_match_plain_on_card(case, k):
    """K3 at 1 and 16 candidates (the contract's ends) against its plain
    version, with cells that cross chunks and a masked run over several
    chunks, at K3's tolerance (2e-4 relative)."""
    require_cuda()
    dev = torch.device("cuda")
    args, _, tabs = _problem(12, n=6000, **K3_CASES[case])
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)
    pk = fr.build_packed(*args)[0]
    rng = np.random.default_rng(k)
    tk = tabs[rng.integers(0, tabs.shape[0], size=k)].to(dev)
    tk[:, :-1, 4:7] += torch.as_tensor(0.01 * rng.standard_normal((k, tk.shape[1] - 1, 3)), dtype=torch.float32,
                                       device=dev)
    before = cuda_lib.LAUNCHES["cand_errors"]
    e = nn(fr.cand_errors(tk, pk))
    assert cuda_lib.LAUNCHES["cand_errors"] == before + 1
    np.testing.assert_allclose(e, nn(fr.cand_errors_ref(tk, pk)), rtol=2e-4)
    with pytest.raises(ValueError):
        fr.cand_errors(torch.cat([tk] * (17 // k + 1))[:17], pk)


@pytest.mark.gpu
def test_k3_candidate_errors_independent_of_k_on_card():
    """Each candidate's error comes out bit for bit the same whatever the
    number of candidates in the call (the lanes past K sum nothing, and each
    candidate's sums run in the same order)."""
    require_cuda()
    dev = torch.device("cuda")
    args, _, tabs = _problem(16, n=6000, giant_cell=True, masked=0.3)
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)
    pk = fr.build_packed(*args)[0]
    t16 = torch.cat([tabs, tabs[:1]]).to(dev)
    t16[-1, :-1, 4:7] += 0.01
    e16 = fr.cand_errors(t16, pk)
    for k in (1, 5, 15):
        assert torch.equal(fr.cand_errors(t16[:k], pk), e16[:k]), k


@pytest.mark.gpu
def test_chunk_scratch_layout_from_library():
    """The plain statements' chunk is the library's, and the scratch sizes
    the wrappers take from the library are the layouts that k2_gn.cu and
    k3_cand.cu state."""
    require_cuda()
    assert cuda_lib.library().dmsa_chunk_positions() == fr.CHUNK
    for m in (0, 1, 128, 129, 57344):
        nch = -(-m // fr.CHUNK)
        blocks = -(-nch // 4)
        for p_dim in (6, 30):
            assert cuda_lib.scratch_bytes("k2_scratch_bytes", 5, m, p_dim) == (
                8 * nch * p_dim, 32 * nch, 4 * nch, 4 * blocks, 4 * blocks * (p_dim + 1) ** 2)
        for k in (1, 15):
            rows = max(1, blocks) + max(1, -(-nch // 8))
            assert cuda_lib.scratch_bytes("k3_scratch_bytes", 4, m, k) == (
                512 * nch, 4 * nch, 4 * nch, 4 * rows * k)


@pytest.mark.gpu
def test_k3_k4_bitwise_repeatable_on_card():
    """Two calls with the same inputs give bit-identical candidate errors
    (fixed-order sums, no float atomics) and nearest distances (atomicMin
    on the f32 bits is exact in any order)."""
    require_cuda()
    dev = torch.device("cuda")
    args, _, tabs = _problem(13, n=8192, giant_cell=True, masked=0.3)
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)
    pk, tabs = fr.build_packed(*args)[0], tabs.to(dev)
    assert torch.equal(fr.cand_errors(tabs, pk), fr.cand_errors(tabs, pk))
    ref, rv, q, qv = (a.to(dev) for a in _clouds(14, 20000, 9000))
    assert torch.equal(nb.min_sq_dist(ref, rv, q, qv), nb.min_sq_dist(ref, rv, q, qv))


K4_CASES = {  # (refs, queries, invalid share): counts off every tile size
    "ragged": (1237, 3001, 0.2),
    "one_reference": (1, 129, 0.2),
    "mostly_masked": (5003, 2049, 0.9),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_edges_on_card(case):
    """K4 against its plain version where the counts are not multiples of
    any tile, where most points are masked, and with no valid reference
    (every query +inf); one launch per call, masks passed as bool."""
    require_cuda()
    dev = torch.device("cuda")
    n_ref, n_q, invalid = K4_CASES[case]
    ref, rv, q, qv = (a.to(dev) for a in _clouds(15, n_ref, n_q, invalid=invalid))
    before = cuda_lib.LAUNCHES["min_sq_dist"]
    d = nn(nb.min_sq_dist(ref, rv, q, qv))
    assert cuda_lib.LAUNCHES["min_sq_dist"] == before + 1
    d_r = nn(nb.min_sq_dist_ref(ref, rv, q, qv))
    fin = np.isfinite(d_r)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_allclose(d[fin], d_r[fin], rtol=1e-6, atol=1e-6)
    assert np.all(d >= 0)
    assert np.all(np.isinf(nn(nb.min_sq_dist(ref, torch.zeros_like(rv), q, qv))))
