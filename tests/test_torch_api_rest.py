"""Port vs reference: the JAX package's remaining public functions.

ops/knn.py's hash-grid queries (min_sq_dist, has_neighbor_within,
overlap_fraction), ops/voxel.py's bin_points / count_voxels /
downsample_compact, ops/gaussians.py's segment_mean_cov / info_from_cov,
ops/eig3.py's unpack_sym6 / sym6_inner / matrix_function_sym6,
imu/preintegration.py's init_state / step / preintegrate_sequential and
map/device_map.py's uncapped submap_view / write_back, each on the same
seeded numpy inputs in both packages.

Tolerances, with their reasons:
  - integer and boolean results (flags, counts, masks, kept points,
    partitions) are equal: the same keys, sorts and comparisons;
  - f32 distances within rtol 1e-6 (a few f32 ulps: the same three squares
    summed, in either order); overlap fractions equal;
  - f32 segment moments within rtol 1e-5 / atol 1e-6 (the same scatter sums
    in another order); floored inverses as test_info_from_cov states;
  - f64 math (packed symmetrics, the spectral polynomial, IMU recursion,
    pose chains) within rtol 1e-10 / atol 1e-12, the covariance relative to
    its scale: the same closed forms, libm's last bits apart;
  - the sequential preintegration against the port's log-depth one within
    rtol 1e-9: equal up to reassociation (the reference's
    preintegration.py:106).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.imu import preintegration as jpre
from dmsa_lidar_slam_tpu.map import device_map as jdmap
from dmsa_lidar_slam_tpu.ops import eig3 as jeig
from dmsa_lidar_slam_tpu.ops import gaussians as jgauss
from dmsa_lidar_slam_tpu.ops import knn as jknn
from dmsa_lidar_slam_tpu.ops import voxel as jvoxel
from dmsa_lidar_slam_tpu_torch.imu import preintegration as tpre
from dmsa_lidar_slam_tpu_torch.map import device_map as tdmap
from dmsa_lidar_slam_tpu_torch.ops import eig3 as teig
from dmsa_lidar_slam_tpu_torch.ops import gaussians as tgauss
from dmsa_lidar_slam_tpu_torch.ops import knn as tknn
from dmsa_lidar_slam_tpu_torch.ops import voxel as tvoxel
from tests.torch_parity import jax_bits, nn, tt

F64 = dict(rtol=1e-10, atol=1e-12)


# ----------------------------------------------------------------- ops/knn


def _knn_case(name):
    """(ref, ref_mask, queries, query_mask, cell, cap) of one case."""
    rng = np.random.default_rng(len(name))
    cell = 0.5
    ref = rng.uniform(-4, 4, size=(600, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, size=(5000, 3)).astype(np.float32)  # two query chunks
    rm, qm, cap = np.ones(600, bool), np.ones(5000, bool), 16
    if name == "borders":  # points and queries on cell borders, neighbours one cell away
        ref = (cell * rng.integers(-8, 8, size=(600, 3))).astype(np.float32)
        q = (cell * rng.integers(-9, 9, size=(5000, 3))).astype(np.float32)
        q[::3] += np.float32(cell)  # exactly one cell over
    elif name == "masked":
        rm = rng.uniform(size=600) > 0.4
        qm = rng.uniform(size=5000) > 0.3
    elif name == "empty":
        rm = np.zeros(600, bool)
    elif name == "cap_overflow":  # cells hold up to ~60 points, over cap
        ref = (rng.uniform(-1, 1, size=(600, 3)) * np.array([1.0, 1.0, 0.05])).astype(np.float32)
        q = rng.uniform(-1.2, 1.2, size=(5000, 3)).astype(np.float32)
        cap = 4
    return ref, rm, q, qm, cell, cap


KNN_CASES = ["random", "borders", "masked", "empty", "cap_overflow"]


@pytest.mark.parametrize("name", KNN_CASES)
def test_knn_hash_grid_queries(name):
    ref, rm, q, qm, cell, cap = _knn_case(name)
    jg = jknn.build_grid(jnp.asarray(ref), jnp.asarray(rm), cell)
    tg = tknn.build_grid(tt(ref), tt(rm), cell)
    assert int(tg.max_occupancy) == int(jg.max_occupancy)
    if name == "cap_overflow":
        assert int(tg.max_occupancy) > cap
    jd = np.asarray(jknn.min_sq_dist(jg, jnp.asarray(q), jnp.asarray(qm), cap=cap))
    td = nn(tknn.min_sq_dist(tg, tt(q), tt(qm), cap=cap))
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=0)
    if name == "empty":
        assert np.isinf(td).all()
    for radius in (0.25, cell):
        jf = np.asarray(jknn.has_neighbor_within(jg, jnp.asarray(q), jnp.asarray(qm), radius, cap=cap))
        tf = nn(tknn.has_neighbor_within(tg, tt(q), tt(qm), radius, cap=cap))
        np.testing.assert_array_equal(tf, jf)
        if name == "borders":
            assert tf.any() and not tf.all()


@pytest.mark.parametrize("name", KNN_CASES)
def test_knn_overlap_fraction(name):
    ref, rm, q, qm, cell, cap = _knn_case(name)
    q = q[:800] + np.float32(0.05)
    qm = qm[:800]
    want = float(jknn.overlap_fraction(jnp.asarray(ref), jnp.asarray(rm), jnp.asarray(q), jnp.asarray(qm),
                                       0.3, cap=cap))
    got = tknn.overlap_fraction(tt(ref), tt(rm), tt(q), tt(qm), 0.3, cap=cap)
    assert got.dtype == torch.float64
    assert float(got) == want


# --------------------------------------------------------------- ops/voxel


def _cloud(seed, n=3000, extent=6.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    pts[: n // 4] = pts[n // 4 : n // 2] + 0.01  # crowded voxels
    mask = rng.uniform(size=n) > 0.1
    return pts, mask


def _same_partition(a, b):
    """a and b label the same items with the same groups (a bijection of
    labels)."""
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist())), "not the same partition"


@pytest.mark.parametrize("seed,grid,split", [(0, 1.0, False), (1, 0.3, False), (2, 0.5, True)])
def test_bin_points(seed, grid, split):
    pts, mask = _cloud(seed)
    ch = np.random.default_rng(seed).integers(0, 6, size=len(pts)).astype(np.int32) if split else None
    jb = jvoxel.bin_points(jnp.asarray(pts), jnp.asarray(mask), grid, None if ch is None else jnp.asarray(ch))
    tb = tvoxel.bin_points(tt(pts), tt(mask), grid, None if ch is None else tt(ch))
    assert int(tb.num_cells) == int(jb.num_cells) > 0
    # cells are the same sets of valid points (their numbers are free only
    # where the reference leaves ties free)
    _same_partition(nn(tb.point_cell)[mask], np.asarray(jb.point_cell)[mask])
    np.testing.assert_array_equal(nn(tb.point_cell)[~mask], len(pts) - 1)
    # in sorted order: the valid points, cell by cell, are the same points
    nv = int(mask.sum())
    jo, to = np.asarray(jb.order), nn(tb.order)
    assert mask[jo[:nv]].all() and mask[to[:nv]].all()
    _same_partition(nn(tb.seg_ids)[:nv], np.asarray(jb.seg_ids)[:nv])
    js, ts = np.asarray(jb.seg_ids)[:nv], nn(tb.seg_ids)[:nv]
    for c in np.unique(js)[:50]:
        assert set(jo[:nv][js == c]) == set(to[:nv][ts == ts[np.argmax(js == c)]])


@pytest.mark.parametrize("grid", [0.1, 0.4, 2.0])
def test_count_voxels(grid):
    pts, mask = _cloud(7, extent=10.0)
    assert int(tvoxel.count_voxels(tt(pts), tt(mask), grid)) == int(
        jvoxel.count_voxels(jnp.asarray(pts), jnp.asarray(mask), grid))


@pytest.mark.parametrize("seed,grid,cap", [(3, 0.5, 4096), (4, 0.2, 256), (5, 1.5, 64)])
def test_downsample_compact(seed, grid, cap):
    pts, mask = _cloud(seed)
    rings = np.random.default_rng(seed).integers(0, 16, size=len(pts)).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    jp, jr, jm, jn = jvoxel.downsample_compact(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(rings), grid,
                                               key, cap)
    tp, tr, tm, tn = tvoxel.downsample_compact(tt(pts), tt(mask), tt(rings), grid, tt(jax_bits(key, len(pts))),
                                               cap)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(nn(tm), np.asarray(jm))
    k = int(np.asarray(jm).sum())
    np.testing.assert_array_equal(nn(tp)[:k], np.asarray(jp)[:k])
    np.testing.assert_array_equal(nn(tr)[:k], np.asarray(jr)[:k])


# ----------------------------------------------------------- ops/gaussians


@pytest.mark.parametrize("seed,n_seg", [(0, 7), (1, 40)])
def test_segment_mean_cov(seed, n_seg):
    rng = np.random.default_rng(seed)
    n = 2000
    pts = (rng.standard_normal((n, 3)) * np.array([2.0, 1.0, 0.05]) + 30.0).astype(np.float32)
    cell = rng.integers(0, n_seg, size=n).astype(np.int32)
    w = (rng.uniform(size=n) > 0.2).astype(np.float32)
    jc, jm, jcov = jgauss.segment_mean_cov(jnp.asarray(pts), jnp.asarray(cell), jnp.asarray(w), n_seg)
    tc, tm, tcov = tgauss.segment_mean_cov(tt(pts), tt(cell).long(), tt(w), n_seg)
    np.testing.assert_array_equal(nn(tc), np.asarray(jc))
    np.testing.assert_allclose(nn(tm), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nn(tcov), np.asarray(jcov), rtol=1e-5, atol=1e-6)


def _covs(seed, n, dtype, resolved=False):
    """Covariances: full rank, planar (one tiny eigenvalue), linear (two)
    and isotropic, some below the eigenvalue floor; `resolved`: spectra
    within [0.01, 4], which f32 resolves."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    lam = np.exp(rng.uniform(np.log(1e-2 if resolved else 1e-6), np.log(4.0), size=(n, 3)))
    if not resolved:
        lam[n // 4 : n // 2, 2] = 1e-8
        lam[n // 2 : 3 * n // 4, 1:] = 1e-7
        lam[3 * n // 4 :] = lam[3 * n // 4 :, :1]
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(dtype)


def _planar_below_floor(seed, n):
    """f32 planar cells, the regime the pipelines run in: two eigenvalues in
    [0.01, 4], the third in [1e-8, 5e-5], below the 1e-4 floor."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    lam = np.exp(rng.uniform(np.log(1e-2), np.log(4.0), size=(n, 3)))
    lam[:, 2] = np.exp(rng.uniform(np.log(1e-8), np.log(5e-5), size=n))
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


def _linear_below_floor(seed, n):
    """f32 linear cells: one eigenvalue in [0.01, 4], two in [1e-8, 5e-5],
    below the 1e-4 floor."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    lam = np.exp(rng.uniform(np.log(1e-2), np.log(4.0), size=(n, 3)))
    lam[:, 1:] = np.exp(rng.uniform(np.log(1e-8), np.log(5e-5), size=(n, 2)))
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


@pytest.mark.parametrize("case", ["f64", "f32", "f32_planar_below_floor", "f32_linear_below_floor"])
def test_info_from_cov(case):
    """f64 on spectra down to 1e-8: within 1e-9 of the scale (the floored
    inverse divides by eigenvalue gaps near the floor, as
    tests/test_torch_fused_residuals.py's test_eig3 holds it).  f32 on
    spectra within [0.01, 4], all above the floor: the f32 closed form is
    off the exact inverse by up to ~2e-3 of the scale where two eigenvalues
    lie close (f32's 1.2e-7 over their gap), in either package; so each is
    held within 5e-3 of the scale to the exact f64 inverse, and the two to
    each other.  f32 planar cells below the floor: each package is within
    5.2e-3 of the scale of the exact floored inverse and of the other on
    these draws, so they are held within 2e-2 (the 2% cell-build rounding
    of ROADMAP.md's "Not faults"), and the floored direction carries the
    largest eigenvalue, 1 / 1e-4, within 1%.  Spectra below what f32
    resolves elsewhere are that same cell-build rounding.  f32 linear cells
    below the floor: the packed floored_inverse_sym6, which build_cells
    uses, is held between the packages within the same 2e-2 (1.5e-4 of the
    scale on these draws); each is off the exact floored inverse by up to
    61% of the scale there, and the 3x3 info_from_cov of the two packages
    by as much from each other (their f32 arccos near r = 1; PERF.md), so
    neither is held to the exact inverse, nor the 3x3 form on these cells
    (tools/linear_cells.py finds none in the pipelines' cell
    builds)."""
    if case == "f32_linear_below_floor":
        cov = _linear_below_floor(0, 400)
        a6 = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], -1)
        want = np.asarray(jeig.floored_inverse_sym6(jnp.asarray(a6), tgauss.COV_EIG_FLOOR))
        got = nn(teig.floored_inverse_sym6(tt(a6), tgauss.COV_EIG_FLOOR))
        assert np.all(np.abs(got - want) <= 2e-2 * np.abs(want).max(axis=1, keepdims=True))
        return
    if case == "f32_planar_below_floor":
        cov = _planar_below_floor(0, 400)
    else:
        cov = _covs(5, 400, np.float32 if case == "f32" else np.float64, resolved=case == "f32")
    want = np.asarray(jgauss.info_from_cov(jnp.asarray(cov)))
    got = nn(tgauss.info_from_cov(tt(cov)))
    w, v = np.linalg.eigh(cov.astype(np.float64))
    exact = np.einsum("nij,nj,nkj->nik", v, 1.0 / np.maximum(w, tgauss.COV_EIG_FLOOR), v)
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    tol = dict(f64=1e-9, f32=5e-3, f32_planar_below_floor=2e-2)[case] * scale
    assert np.all(np.abs(got - want) <= tol)
    if case != "f64":
        assert np.all(np.abs(got - exact) <= tol) and np.all(np.abs(want - exact) <= tol)
    if case == "f32_planar_below_floor":
        for info in (got, want):
            top = np.linalg.eigvalsh(info.astype(np.float64))[:, -1]
            np.testing.assert_allclose(top, 1.0 / tgauss.COV_EIG_FLOOR, rtol=1e-2)


# ---------------------------------------------------------------- ops/eig3


def test_unpack_sym6_and_inner():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((50, 6))
    b = rng.standard_normal((50, 6))
    np.testing.assert_array_equal(nn(teig.unpack_sym6(tt(a))), np.asarray(jeig.unpack_sym6(jnp.asarray(a))))
    np.testing.assert_allclose(nn(teig.sym6_inner(tt(a), tt(b))), np.asarray(jeig.sym6_inner(jnp.asarray(a),
                                                                                           jnp.asarray(b))), **F64)


def _square_fns():
    return (lambda x: x * x), (lambda x: 2.0 * x), (lambda x: 2.0 + 0.0 * x)


@pytest.mark.parametrize("fn", ["floor", "square"])
def test_matrix_function_sym6(fn):
    cov = _covs(9, 300, np.float64)
    a = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], axis=-1)
    jf = jeig._floor_fns(1e-4) if fn == "floor" else _square_fns()
    tf = teig._floor_fns(1e-4) if fn == "floor" else _square_fns()
    want = np.asarray(jeig.matrix_function_sym6(jnp.asarray(a), *jf))
    got = nn(teig.matrix_function_sym6(tt(a), *tf))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-10 * scale + 1e-12)


# ------------------------------------------------------ imu/preintegration


def _imu(seed, T=60):
    rng = np.random.default_rng(seed)
    omega = 0.5 * rng.standard_normal((T, 3))
    acc = rng.standard_normal((T, 3)) + np.array([0.0, 0.0, 9.8])
    return omega, acc, 0.002, 0.01**2 * np.eye(3), 0.3**2 * np.eye(3)


def _close_state(t, j, rtol=1e-10):
    for f in ("delta_rot", "delta_vel", "delta_pos"):
        np.testing.assert_allclose(nn(getattr(t, f)), np.asarray(getattr(j, f)), rtol=rtol, atol=1e-12)
    scale = float(np.abs(np.asarray(j.cov)).max())
    np.testing.assert_allclose(nn(t.cov), np.asarray(j.cov), rtol=rtol, atol=1e-12 * scale)


def test_preintegration_init_state_and_step():
    omega, acc, dt, cg, ca = _imu(1)
    j0, t0 = jpre.init_state(), tpre.init_state()
    for f in j0._fields:
        np.testing.assert_array_equal(nn(getattr(t0, f)), np.asarray(getattr(j0, f)))
        assert getattr(t0, f).dtype == tt(np.asarray(getattr(j0, f))).dtype
    js, ts = j0, t0
    for k in range(3):
        js = jpre.step(js, jnp.asarray(omega[k]), jnp.asarray(acc[k]), dt, jnp.asarray(cg), jnp.asarray(ca))
        ts = tpre.step(ts, tt(omega[k]), tt(acc[k]), dt, tt(cg), tt(ca))
        _close_state(ts, js)


@pytest.mark.parametrize("seed,T", [(2, 1), (3, 50), (4, 101)])
def test_preintegrate_sequential(seed, T):
    omega, acc, dt, cg, ca = _imu(seed, T)
    js = jpre.preintegrate_sequential(jnp.asarray(omega), jnp.asarray(acc), dt, jnp.asarray(cg), jnp.asarray(ca))
    ts = tpre.preintegrate_sequential(tt(omega), tt(acc), dt, tt(cg), tt(ca))
    _close_state(ts, js)
    # the log-depth reduction of the same recursion, as the pipelines run it
    tl = tpre.preintegrate_intervals(tt(omega[None]), tt(acc[None]), dt, tt(cg), tt(ca))
    _close_state(type(ts)(*(x[0] for x in tl)), js, rtol=1e-9)


# ------------------------------------------------------- map/device_map


def _map_state(seed, K=8, P=32, count=6):
    rng = np.random.default_rng(seed)
    return dict(
        local_pts=rng.standard_normal((K, P, 3)).astype(np.float32),
        local_normals=rng.standard_normal((K, P, 3)).astype(np.float32),
        pt_mask=rng.uniform(size=(K, P)) > 0.2,
        pt_ring=rng.integers(0, 16, size=(K, P)).astype(np.int32),
        grid_size=rng.uniform(0.2, 0.6, size=K).astype(np.float32),
        orient_w=0.3 * rng.standard_normal((K, 3)),
        transl_w=np.cumsum(rng.standard_normal((K, 3)), axis=0),
        stamps=np.arange(K, dtype=np.float64) * 0.5,
        grav_meas=rng.standard_normal((K, 3)),
        grav_plausible=rng.uniform(size=K) > 0.3,
        odom_rel_orient=0.1 * rng.standard_normal((K, 3)),
        odom_rel_transl=rng.standard_normal((K, 3)),
        count=np.int32(count),
        num_updates=np.int32(count + 3),
    )


def _view_args(rng):
    return (1.5, 0.7, rng.standard_normal((3, 3)), np.eye(3) * 4.0, np.eye(3) * 9.0, np.array([0.0, 0.0, -9.805]))


@pytest.mark.parametrize("count,from_id", [(6, 0), (6, 3), (8, 5)])
def test_submap_view_and_write_back(count, from_id):
    s = _map_state(count + from_id, count=count)
    js = jdmap.DeviceMapState(**{k: jnp.asarray(v) for k, v in s.items()})
    ts = tdmap.DeviceMapState(**{k: tt(v) for k, v in s.items()})
    args = _view_args(np.random.default_rng(from_id))
    jd, jp0 = jdmap.submap_view(js, from_id, *(jnp.asarray(a) for a in args))
    td, tp0 = tdmap.submap_view(ts, from_id, *(tt(a) for a in args))
    np.testing.assert_allclose(nn(tp0), np.asarray(jp0), **F64)
    for f in jd._fields:
        np.testing.assert_allclose(nn(getattr(td, f)), np.asarray(getattr(jd, f)), **F64, err_msg=f)
    params = np.asarray(jp0) + 0.01 * np.random.default_rng(count).standard_normal(jp0.shape)
    jw = jdmap.write_back(js, from_id, jnp.asarray(params))
    tw = tdmap.write_back(ts, from_id, tt(params))
    for f in ("orient_w", "transl_w"):
        np.testing.assert_allclose(nn(getattr(tw, f)), np.asarray(getattr(jw, f)), **F64)

    # where count - from_id fits the cap, the capped forms give the same;
    # params are [orientations (n-1, 3), translations (n-1, 3)] flattened
    K, S = ts.orient_w.shape[0], count - from_id + 1

    def head(p, n):
        p = np.asarray(p).reshape(2, n - 1, 3)[:, : S - 1]
        return p.reshape(-1)

    cd, cp0 = tdmap.submap_view_capped(ts, from_id, S, *(tt(a) for a in args))
    np.testing.assert_allclose(nn(cp0), head(nn(tp0), K), **F64)
    for f in ("local_pts", "pt_mask", "grid_size", "kf_mask", "stamps", "anchor_orient", "anchor_transl"):
        a, b = nn(getattr(cd, f)), nn(getattr(td, f))
        np.testing.assert_array_equal(a, b if a.ndim == 0 or f.startswith("anchor") else b[:S], err_msg=f)
    cw = tdmap.write_back_capped(ts, from_id, tt(head(params, K)))
    for f in ("orient_w", "transl_w"):
        np.testing.assert_allclose(nn(getattr(cw, f)), nn(getattr(tw, f)), **F64)
