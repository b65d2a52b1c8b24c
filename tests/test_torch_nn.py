"""Port vs reference: nearest-neighbour distances (K4's plain version on the
CPU), kNN normals and static-point selection.  K4 itself is held against
its plain version on the card by tests/test_torch_kernels.py.

Tolerances: the reference forms |q|^2 - 2 r.q + |r|^2 about the masked
reference mean in f32 (cancellation of a few ulp of |p|^2 <= 300 m^2 on
this 10 m scene, ~1e-7 x 300), the port |q - r|^2 directly, so squared
distances agree to 1e-4 m^2 + 1e-5 relative; has_neighbor_within may
differ only for pairs whose squared distance lies within that tolerance of
radius^2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmsa_lidar_slam_tpu.map import normals as jnormals
from dmsa_lidar_slam_tpu.map import static_points as jsp
from dmsa_lidar_slam_tpu.ops import nn_bruteforce as jnb
from dmsa_lidar_slam_tpu_torch.map import normals as tnormals
from dmsa_lidar_slam_tpu_torch.map import static_points as tsp
from dmsa_lidar_slam_tpu_torch.ops import nn_bruteforce as tnb
from tests.torch_parity import jax_bits, nn, tt

D2_ATOL, D2_RTOL = 1e-4, 1e-5


def _clouds(seed, n_ref, n_q, extent=10.0):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-extent, extent, (n_ref, 3)).astype(np.float32)
    q = rng.uniform(-extent, extent, (n_q, 3)).astype(np.float32)
    rv = rng.uniform(size=n_ref) > 0.2
    qv = rng.uniform(size=n_q) > 0.2
    return ref, rv, q, qv


@pytest.mark.parametrize("seed,n_ref,n_q", [(0, 2000, 1500), (1, 300, 2500), (2, 1, 64)])
def test_min_sq_dist_and_has_neighbor(seed, n_ref, n_q):
    ref, rv, q, qv = _clouds(seed, n_ref, n_q)
    want = np.asarray(jnb.min_sq_dist(jnp.asarray(ref), jnp.asarray(rv), jnp.asarray(q), jnp.asarray(qv)))
    got = nn(tnb.min_sq_dist(tt(ref), tt(rv), tt(q), tt(qv)))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=D2_RTOL, atol=D2_ATOL)
    radius = 0.8
    hw = np.asarray(jnb.has_neighbor_within(jnp.asarray(ref), jnp.asarray(rv), jnp.asarray(q), jnp.asarray(qv), radius))
    hg = nn(tnb.has_neighbor_within(tt(ref), tt(rv), tt(q), tt(qv), radius))
    edge = np.abs(want - radius**2) <= D2_ATOL + D2_RTOL * radius**2
    assert np.all((hw == hg) | edge)


def _at_the_radius(radius, n=40):
    """Queries 3 m apart along y, each with one reference at exactly
    (f32(radius), 0, 0) from it (d2 == rho^2 in f32: the difference and the
    square are exact) and, for the second half, that reference one ulp
    farther out (d2 > rho^2)."""
    s = np.float32(radius)
    q = np.zeros((n, 3), np.float32)
    q[:, 1] = 3.0 * np.arange(n, dtype=np.float32)
    ref = q.copy()
    ref[:, 0] = s
    ref[n // 2 :, 0] = np.nextafter(s, np.float32(np.inf))
    inside = np.arange(n) < n // 2
    return ref, q, inside


@pytest.mark.parametrize("radius", [0.5, 0.3, 0.8])
def test_has_neighbor_within_float_and_tensor_radius(radius):
    """has_neighbor_within with the radius as a host float (compared as the
    f32 radius squared in f32) and as an f32 tensor: the same booleans, with
    references exactly at d2 == rho^2 inside and one ulp farther outside,
    and with the reference away from the boundary (random clouds)."""
    ref, q, inside = _at_the_radius(radius)
    rv, qv = np.ones(len(ref), bool), np.ones(len(q), bool)
    as_float = tnb.has_neighbor_within(tt(ref), tt(rv), tt(q), tt(qv), radius)
    as_tensor = tnb.has_neighbor_within(tt(ref), tt(rv), tt(q), tt(qv), torch.tensor(radius, dtype=torch.float32))
    assert torch.equal(as_float, as_tensor)
    np.testing.assert_array_equal(nn(as_float), inside)
    ref, rv, q, qv = _clouds(7, 800, 600, extent=3.0)
    hf = nn(tnb.has_neighbor_within(tt(ref), tt(rv), tt(q), tt(qv), radius))
    ht = nn(tnb.has_neighbor_within(tt(ref), tt(rv), tt(q), tt(qv), torch.tensor(radius, dtype=torch.float64)))
    np.testing.assert_array_equal(hf, ht)
    want = np.asarray(jnb.min_sq_dist(jnp.asarray(ref), jnp.asarray(rv), jnp.asarray(q), jnp.asarray(qv)))
    hw = np.asarray(jnb.has_neighbor_within(jnp.asarray(ref), jnp.asarray(rv), jnp.asarray(q), jnp.asarray(qv), radius))
    edge = np.abs(want - radius**2) <= D2_ATOL + D2_RTOL * radius**2
    assert np.all((hw == hf) | edge) and hf.any() and not hf.all()


def test_min_sq_dist_no_valid_reference():
    ref, rv, q, qv = _clouds(3, 100, 50)
    got = nn(tnb.min_sq_dist(tt(ref), tt(np.zeros_like(rv)), tt(q), tt(qv)))
    assert np.all(np.isinf(got))


@pytest.mark.parametrize("seed", [4, 5])
def test_knn_normals(seed):
    """Same exact-kNN hash grid and closed-form eigenvector on both sides, in
    f32: normals agree to 1e-3 (the flip toward the viewpoint is the same
    sign test)."""
    from tests.synthetic import sample_scene_points

    rng = np.random.default_rng(seed)
    pts = (0.3 * sample_scene_points(rng, 1500) + 0.005 * rng.standard_normal((1500, 3))).astype(np.float32)
    mask = rng.uniform(size=1500) > 0.05
    want = np.asarray(jnormals.estimate_normals(jnp.asarray(pts), jnp.asarray(mask), 0.15))
    got = nn(tnormals.estimate_normals(tt(pts), tt(mask), 0.15))
    # a 6-point neighbourhood with a near-repeated smallest eigenvalue has
    # no stable direction: compare where the reference's own normal is
    # stable under a 1e-3 m jitter of the cloud
    jit = np.asarray(jnormals.estimate_normals(jnp.asarray(pts + 1e-3), jnp.asarray(mask), 0.15))
    stable = np.sum(want * jit, axis=1) > 0.999
    assert stable.mean() > 0.8
    np.testing.assert_allclose(got[stable], want[stable], atol=1e-3)


def test_select_static_points():
    """Fed the reference's priorities: the same selection, counts and
    overlap (exact on integers; the overlap fraction to 1e-6)."""
    from tests.synthetic import sample_scene_points

    rng = np.random.default_rng(6)
    S, P, NW = 3, 512, 1024
    world = sample_scene_points(rng, S * P + NW).astype(np.float32)
    kf_pts = world[: S * P].reshape(S, P, 3) + 0.01 * rng.standard_normal((S, P, 3)).astype(np.float32)
    kf_nrm = rng.standard_normal((S, P, 3)).astype(np.float32)
    kf_nrm /= np.linalg.norm(kf_nrm, axis=-1, keepdims=True)
    kf_rings = rng.integers(0, 16, (S, P)).astype(np.int32)
    kf_mask = rng.uniform(size=(S, P)) > 0.1
    win = world[S * P :]
    wmask = rng.uniform(size=NW) > 0.1
    pos = np.array([0.5, 0.2, 1.0], np.float32)
    key = jax.random.PRNGKey(6)
    grid = np.float32(0.3)
    js = jsp.select_static_points(
        jnp.asarray(win), jnp.asarray(wmask), jnp.asarray(kf_pts), jnp.asarray(kf_nrm), jnp.asarray(kf_rings),
        jnp.asarray(kf_mask), jnp.asarray(pos), jnp.asarray(grid), key, 1024,
    )
    ts = tsp.select_static_points(
        tt(win), tt(wmask), tt(kf_pts), tt(kf_nrm), tt(kf_rings), tt(kf_mask), tt(pos), tt(grid),
        tt(jax_bits(key, S * P)), 1024,
    )
    for f in ("overlap_counts", "num_selected", "num_active", "static_mask"):
        np.testing.assert_array_equal(nn(getattr(ts, f)), np.asarray(getattr(js, f)))
    k = int(np.asarray(js.static_mask).sum())
    np.testing.assert_array_equal(nn(ts.static_pts)[:k], np.asarray(js.static_pts)[:k])
    np.testing.assert_array_equal(nn(ts.static_ring)[:k], np.asarray(js.static_ring)[:k])
    np.testing.assert_allclose(float(ts.overlap_fraction), float(js.overlap_fraction), atol=1e-6)
