"""The port's counterparts of the JAX package's remaining public functions
(tests/test_torch_api_rest.py holds them to the reference on the CPU) on
CUDA tensors, against the same functions on CPU tensors.

This file imports neither jax nor the reference package, so it runs on a
machine that has a CUDA card and no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py tests/test_torch_api_rest_card.py

Every test is marked `gpu` and skips without a card.  Tolerances: sorts,
keys, masks, counts and flags are equal (stable int64 sorts and the same
comparisons); f32 distances within rtol 1e-6 (the same three squares);
f32 segment sums equal bit for bit (each segment sums its members in
order on the card as on the CPU: ops/voxel.segment_sum, whose repeats
tests/test_torch_fixed_sums_card.py holds); the f64 floored inverses
within 1e-8 of their scale (f64's 2.2e-16 times the spectra's condition
number, up to 4e6 here, with the card's fused multiply-adds against the
CPU's separate rounding); the other f64 closed forms, IMU recursions and
pose chains within rtol 1e-10 / atol 1e-12.
"""

import numpy as np
import pytest
import torch

from dmsa_lidar_slam_tpu_torch.imu import preintegration as pre
from dmsa_lidar_slam_tpu_torch.map import device_map as dmap
from dmsa_lidar_slam_tpu_torch.ops import eig3, gaussians, knn, voxel
from tests.torch_parity import nn, require_cuda

F64 = dict(rtol=1e-10, atol=1e-12)


def _both(*arrays):
    """Each numpy array as a CPU tensor and as a tensor on the card."""
    cpu = [torch.as_tensor(a) for a in arrays]
    return cpu, [t.cuda() for t in cpu]


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_knn_queries_on_card(masked):
    require_cuda()
    rng = np.random.default_rng(1)
    ref = rng.uniform(-4, 4, size=(3000, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, size=(9000, 3)).astype(np.float32)
    rm = rng.uniform(size=3000) > (0.4 if masked else 0.0)
    qm = rng.uniform(size=9000) > (0.3 if masked else 0.0)
    (r, rmc, qc, qmc), (rg, rmg, qg, qmg) = _both(ref, rm, q, qm)
    gc, gg = knn.build_grid(r, rmc, 0.5), knn.build_grid(rg, rmg, 0.5)
    assert int(gc.max_occupancy) == int(gg.max_occupancy)
    dc, dg = knn.min_sq_dist(gc, qc, qmc), knn.min_sq_dist(gg, qg, qmg)
    np.testing.assert_allclose(nn(dg), nn(dc), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(nn(knn.has_neighbor_within(gg, qg, qmg, 0.3)),
                                  nn(knn.has_neighbor_within(gc, qc, qmc, 0.3)))
    assert float(knn.overlap_fraction(rg, rmg, qg, qmg, 0.3)) == float(knn.overlap_fraction(r, rmc, qc, qmc, 0.3))


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True])
def test_voxel_binning_and_downsample_on_card(split):
    require_cuda()
    rng = np.random.default_rng(2)
    pts = rng.uniform(-6, 6, size=(20000, 3)).astype(np.float32)
    pts[:5000] = pts[5000:10000] + 0.01
    mask = rng.uniform(size=20000) > 0.1
    ch = rng.integers(0, 6, size=20000).astype(np.int32)
    rings = rng.integers(0, 128, size=20000).astype(np.int32)
    prio = rng.integers(-(2**31), 2**31, size=20000).astype(np.int32)
    (p, m, c, r, pr), (pg, mg, cg, rg, prg) = _both(pts, mask, ch, rings, prio)
    bc = voxel.bin_points(p, m, 0.3, c if split else None)
    bg = voxel.bin_points(pg, mg, 0.3, cg if split else None)
    for f in bc._fields:
        np.testing.assert_array_equal(nn(getattr(bg, f)), nn(getattr(bc, f)), err_msg=f)
    assert int(voxel.count_voxels(pg, mg, 0.4)) == int(voxel.count_voxels(p, m, 0.4))
    for a, b in zip(voxel.downsample_compact(pg, mg, rg, 0.5, prg, 4096),
                    voxel.downsample_compact(p, m, r, 0.5, pr, 4096)):
        np.testing.assert_array_equal(nn(a), nn(b))


@pytest.mark.gpu
def test_gaussians_and_eig3_on_card():
    require_cuda()
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((50000, 3)) * np.array([2.0, 1.0, 0.05]) + 30.0).astype(np.float32)
    cell = rng.integers(0, 300, size=50000)
    w = (rng.uniform(size=50000) > 0.2).astype(np.float32)
    (p, c, wc), (pg, cg, wg) = _both(pts, cell, w)
    for a, b in zip(gaussians.segment_mean_cov(pg, cg, wg, 300), gaussians.segment_mean_cov(p, c, wc, 300)):
        np.testing.assert_array_equal(nn(a), nn(b))
    q, _ = np.linalg.qr(rng.standard_normal((500, 3, 3)))
    lam = np.exp(rng.uniform(np.log(1e-6), np.log(4.0), size=(500, 3)))
    # off the floor's neighbourhood: within 1e-6 of each other two
    # eigenvalues take the floor's derivative at their midpoint, which jumps
    # at the floor (0 below, -1e8 above), so a last-bit difference between
    # the card and the CPU could pick the other side
    lam = np.where((lam > 2e-5) & (lam < 5e-4), lam * 10.0, lam)
    cov = np.einsum("nij,nj,nkj->nik", q, lam, q)
    a6 = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], -1)
    (cc, ac, bc), (cgpu, ag, bg) = _both(cov, a6, a6[::-1].copy())
    want = nn(gaussians.info_from_cov(cc))
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(nn(gaussians.info_from_cov(cgpu)) - want) <= 1e-8 * scale)
    np.testing.assert_array_equal(nn(eig3.unpack_sym6(ag)), nn(eig3.unpack_sym6(ac)))
    np.testing.assert_allclose(nn(eig3.sym6_inner(ag, bg)), nn(eig3.sym6_inner(ac, bc)), **F64)
    want = nn(eig3.matrix_function_sym6(ac, *eig3._floor_fns(1e-4)))
    got = nn(eig3.matrix_function_sym6(ag, *eig3._floor_fns(1e-4)))
    assert np.all(np.abs(got - want) <= 1e-8 * np.abs(want).max(axis=1, keepdims=True))


@pytest.mark.gpu
def test_preintegrate_sequential_on_card():
    require_cuda()
    rng = np.random.default_rng(4)
    omega = 0.5 * rng.standard_normal((80, 3))
    acc = rng.standard_normal((80, 3)) + np.array([0.0, 0.0, 9.8])
    (o, a, cg_, ca_), (og, ag, cgg, cag) = _both(omega, acc, 1e-4 * np.eye(3), 0.09 * np.eye(3))
    sc = pre.preintegrate_sequential(o, a, 0.002, cg_, ca_)
    sg = pre.preintegrate_sequential(og, ag, 0.002, cgg, cag)
    for f in sc._fields:
        scale = float(np.abs(nn(getattr(sc, f))).max())
        np.testing.assert_allclose(nn(getattr(sg, f)), nn(getattr(sc, f)), rtol=1e-10, atol=1e-12 * scale)


@pytest.mark.gpu
def test_submap_view_and_write_back_on_card():
    require_cuda()
    rng = np.random.default_rng(5)
    K, P = 12, 64
    state = dict(
        local_pts=rng.standard_normal((K, P, 3)).astype(np.float32),
        local_normals=rng.standard_normal((K, P, 3)).astype(np.float32),
        pt_mask=rng.uniform(size=(K, P)) > 0.2, pt_ring=rng.integers(0, 16, size=(K, P)).astype(np.int32),
        grid_size=rng.uniform(0.2, 0.6, size=K).astype(np.float32), orient_w=0.3 * rng.standard_normal((K, 3)),
        transl_w=np.cumsum(rng.standard_normal((K, 3)), axis=0), stamps=np.arange(K) * 0.5,
        grav_meas=rng.standard_normal((K, 3)), grav_plausible=rng.uniform(size=K) > 0.3,
        odom_rel_orient=0.1 * rng.standard_normal((K, 3)), odom_rel_transl=rng.standard_normal((K, 3)),
        count=np.int32(10), num_updates=np.int32(13),
    )
    sc = dmap.DeviceMapState(**{k: torch.as_tensor(v) for k, v in state.items()})
    sg = dmap.DeviceMapState(**{k: torch.as_tensor(v).cuda() for k, v in state.items()})
    args = (1.5, 0.7, rng.standard_normal((3, 3)), np.eye(3) * 4.0, np.eye(3) * 9.0, np.array([0.0, 0.0, -9.805]))
    ac, ag = _both(*args)
    dc, pc = dmap.submap_view(sc, 4, *ac)
    dg, pg = dmap.submap_view(sg, 4, *ag)
    np.testing.assert_allclose(nn(pg), nn(pc), **F64)
    for f in dc._fields:
        np.testing.assert_allclose(nn(getattr(dg, f)), nn(getattr(dc, f)), **F64, err_msg=f)
    params = nn(pc) + 0.01 * rng.standard_normal(pc.shape)
    wc = dmap.write_back(sc, 4, torch.as_tensor(params))
    wg = dmap.write_back(sg, 4, torch.as_tensor(params).cuda())
    for f in ("orient_w", "transl_w"):
        np.testing.assert_allclose(nn(getattr(wg, f)), nn(getattr(wc, f)), **F64)
