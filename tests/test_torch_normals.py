"""Port vs reference: the radius-neighbour moments (K5's plain version) and
the radius-branch normals.

The reference's radius_neighbor_moments runs its Pallas kernel in interpret
mode on the CPU (nn_bruteforce.py:287), as its own tests run it; the port
runs radius_neighbor_moments_ref, the plain version that K5 is held
against on the card.  A float64 numpy oracle decides the ground truth.

Tolerances, with their reasons:
  - counts: the reference forms d2 from bf16 hi/lo products about the
    cloud mean, the port as (r - q)^2 directly, both f32-accurate but
    rounded differently, so a pair within rounding of rho^2 may be counted
    by one and not the other.  A query with any pair within BOUNDARY_M2 of
    rho^2 (in float64) is "ambiguous"; on every other valid query both
    counts equal the oracle's exactly, and ambiguous queries are a small
    share of the cloud;
  - mean: f32 sums of neighbourhood-scale offsets, 2e-6 m of the oracle;
    the reference 1e-5 m (its sums run about the cloud mean);
  - cov: the port accumulates about the query point, so it holds the
    oracle to 1e-5 of the covariance scale; the reference carries the f32
    cancellation of its second moments about the cloud mean, so it is held
    to 1e-3 of that scale;
  - normals: the same neighbour sets give the same covariance up to the
    above, so on well-conditioned points (eigenvalue gap > 10% of the
    largest) the normals agree to |dot| > 1 - 1e-6, and the degenerate
    (fewer than 3 neighbours) defaults are the same points.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmsa_lidar_slam_tpu.map import normals as jnormals
from dmsa_lidar_slam_tpu.ops import nn_bruteforce as jnb
from dmsa_lidar_slam_tpu_torch.map import normals as tnormals
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
from dmsa_lidar_slam_tpu_torch.ops import nn_bruteforce as tnb
from tests.test_normals_bruteforce import _plane_cloud
from tests.torch_parity import nn, tt

BOUNDARY_M2 = 1e-5


def _oracle(pts, mask, radius):
    """float64 counts, means, covariances and the ambiguous-query flags."""
    p = pts.astype(np.float64)
    rho2 = float(np.float32(radius) ** 2)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    inc = (d2 <= rho2) & mask[None, :] & mask[:, None]
    ambiguous = (np.abs(d2 - rho2) < BOUNDARY_M2)[:, mask].any(1) & mask
    cnt = inc.sum(1).astype(np.float64)
    safe = np.maximum(cnt, 1)[:, None]
    mean = (inc[:, :, None] * p[None]).sum(1) / safe
    d = (p[None, :, :] - mean[:, None, :]) * inc[:, :, None]
    cov = np.einsum("qni,qnj->qij", d, d) / np.maximum(cnt - 1, 1)[:, None, None]
    cov[cnt < 2] = 0.0
    return cnt, mean, cov, ambiguous


def _random_cloud(seed, n=256):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return pts, rng.uniform(size=n) > 0.2


def _clouds():
    three_planes, _, plane_mask = _plane_cloud(np.random.default_rng(42))
    return {
        "three_planes": (three_planes, plane_mask, 0.35),
        "random_masked": (*_random_cloud(3), 0.4),
    }


@pytest.mark.parametrize("cloud", ["three_planes", "random_masked"])
def test_moments_match_reference_and_oracle(cloud):
    pts, mask, radius = _clouds()[cloud]
    _check_against_reference_and_oracle(pts, mask, radius, tnb.radius_neighbor_moments_ref(tt(pts), tt(mask), radius))


def _check_against_reference_and_oracle(pts, mask, radius, port):
    """The port's (count, mean, cov) and the reference's against the
    float64 oracle, at the tolerances of the module docstring."""
    cnt_o, mean_o, cov_o, amb = _oracle(pts, mask, radius)
    cnt_t, mean_t, cov_t = (nn(a) for a in port)
    cnt_j, mean_j, cov_j = (np.asarray(a) for a in jnb.radius_neighbor_moments(jnp.asarray(pts), jnp.asarray(mask), radius))
    sure = mask & ~amb
    assert amb.sum() <= 0.02 * mask.sum(), amb.sum()
    np.testing.assert_array_equal(cnt_t[sure], cnt_o[sure])
    np.testing.assert_array_equal(cnt_j[sure], cnt_o[sure])
    np.testing.assert_allclose(mean_t[sure], mean_o[sure], atol=2e-6)
    np.testing.assert_allclose(mean_j[sure], mean_o[sure], atol=1e-5)
    scale = np.abs(cov_o[sure]).max()
    np.testing.assert_allclose(cov_t[sure], cov_o[sure], atol=1e-5 * scale)
    np.testing.assert_allclose(cov_j[sure], cov_t[sure], atol=1e-3 * scale)
    # invalid points: zeros in the port (the reference's rows there are unread)
    assert np.all(cnt_t[~mask] == 0) and np.all(mean_t[~mask] == 0) and np.all(cov_t[~mask] == 0)


def _lattice(spacing=0.5, side=6):
    """A cubic lattice `spacing` apart, away from the origin, a tenth of it
    masked with NaN coordinates: every axial pair lies at exactly
    d2 == spacing^2 in f32 (the differences and squares are exact), the
    diagonal ones beyond."""
    k = np.arange(side, dtype=np.float32) * np.float32(spacing)
    pts = np.stack(np.meshgrid(k + 10.0, k - 3.0, k + 2.0, indexing="ij"), axis=-1).reshape(-1, 3).astype(np.float32)
    mask = np.random.default_rng(5).uniform(size=len(pts)) > 0.1
    pts[~mask] = np.nan
    return pts, mask


@pytest.mark.parametrize("cloud", ["three_planes", "random_masked", "lattice_at_radius"])
def test_moments_radius_as_float_or_tensor(cloud):
    """The plain K5 (and the wrapper on CPU tensors) with the radius as a
    host float and as a 0-d f32 tensor: bit for bit the same.  On the two
    clouds it is held to the reference and the oracle as in
    test_moments_match_reference_and_oracle; on the lattice, where every
    axial pair lies exactly at d2 == rho^2 and so every point is ambiguous
    for the reference's hi/lo d2, the counts equal the oracle's exactly."""
    if cloud == "lattice_at_radius":
        (pts, mask), radius = _lattice(), 0.5
    else:
        pts, mask, radius = _clouds()[cloud]
    as_float = tnb.radius_neighbor_moments_ref(tt(pts), tt(mask), radius)
    for fn in (tnb.radius_neighbor_moments_ref, tnb.radius_neighbor_moments):
        for a, b in zip(as_float, fn(tt(pts), tt(mask), torch.tensor(radius, dtype=torch.float32))):
            assert torch.equal(a, b)
    if cloud != "lattice_at_radius":
        _check_against_reference_and_oracle(pts, mask, radius, as_float)
        return
    cnt_o, mean_o, cov_o, _ = _oracle(np.nan_to_num(pts), mask, radius)
    cnt_t, mean_t, cov_t = (nn(a) for a in as_float)
    np.testing.assert_array_equal(cnt_t, cnt_o)
    assert cnt_t.max() == 7 and np.all(cnt_t[mask] >= 1)  # self and six axial neighbours inside
    np.testing.assert_allclose(mean_t[mask], mean_o[mask], atol=2e-6)
    np.testing.assert_allclose(cov_t[mask], cov_o[mask], atol=1e-5 * np.abs(cov_o[mask]).max())


def test_nan_in_masked_slot_poisons_nothing():
    """A NaN (and an Inf) in masked slots: every valid row is finite, the
    same as without them, and agrees with the reference's."""
    pts, mask, radius = _clouds()["random_masked"]
    bad = pts.copy()
    masked = np.flatnonzero(~mask)
    bad[masked[0]] = np.nan
    bad[masked[1], 1] = np.inf
    clean = [nn(a) for a in tnb.radius_neighbor_moments_ref(tt(pts), tt(mask), radius)]
    got = [nn(a) for a in tnb.radius_neighbor_moments_ref(tt(bad), tt(mask), radius)]
    ref = [np.asarray(a) for a in jnb.radius_neighbor_moments(jnp.asarray(bad), jnp.asarray(mask), radius)]
    for g, c, r in zip(got, clean, ref):
        assert np.all(np.isfinite(g))
        np.testing.assert_array_equal(g[mask], c[mask])
        assert np.all(np.isfinite(r[mask]))
    np.testing.assert_array_equal(got[0][mask], ref[0][mask])


def test_wrapper_takes_plain_version_on_cpu():
    pts, mask, radius = _clouds()["random_masked"]
    cuda_lib.reset_launches()
    a = tnb.radius_neighbor_moments(tt(pts), tt(mask), torch.tensor(radius, dtype=torch.float32))
    b = tnb.radius_neighbor_moments_ref(tt(pts), tt(mask), radius)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert cuda_lib.LAUNCHES["radius_neighbor_moments"] == 0


def _jax_radius_normals(pts, mask, grid, monkeypatch):
    """The reference's estimate_normals down its accelerator branch: the
    branch test (normals.py:39) reads True, the interpret flag inside
    radius_neighbor_moments (nn_bruteforce.py:287) reads False."""
    answers = iter([True])
    monkeypatch.setattr(jnb, "_use_pallas", lambda: next(answers, False))
    out = np.asarray(jnormals.estimate_normals(jnp.asarray(pts), jnp.asarray(mask), grid))
    assert next(answers, None) is None, "the branch test was not taken"
    return out


@pytest.mark.parametrize("cloud", ["three_planes", "random_masked"])
def test_radius_normals_match_reference_branch(cloud, monkeypatch):
    pts, mask, radius = _clouds()[cloud]
    grid = radius / 2.0
    want = _jax_radius_normals(pts, mask, grid, monkeypatch)
    got = nn(tnormals.radius_normals(tt(pts), tt(mask), grid))
    cnt_o, _, cov_o, amb = _oracle(pts, mask, radius)
    ev = np.linalg.eigvalsh(cov_o)
    good = mask & ~amb & (cnt_o >= 3) & (ev[:, 1] - ev[:, 0] > 0.1 * np.maximum(ev[:, 2], 1e-12))
    assert good.sum() > 0.5 * mask.sum()
    dots = np.abs(np.sum(got[good] * want[good], axis=1))
    assert dots.min() > 1 - 1e-6, dots.min()
    default = np.all(got == [0.0, 0.0, 1.0], axis=1)
    sure = ~amb
    np.testing.assert_array_equal(default[sure], np.all(want == [0.0, 0.0, 1.0], axis=1)[sure])
    np.testing.assert_array_equal(got[~mask], np.broadcast_to([0.0, 0.0, 1.0], got[~mask].shape))
