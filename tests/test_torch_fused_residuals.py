"""Port vs reference: the K1-K3 plain versions (cell build, Gauss-Newton
normal equations, line-search candidate errors) and the closed-form 3x3
spectral functions they rest on.  The kernels themselves are held against
these plain versions on the card by tests/test_torch_kernels.py.

The reference's kernels run here as its own tests run them on the CPU:
Pallas in interpret mode (fused_residuals.py:81-89).  Tolerances are the
reference kernel test's (tests/test_fused_residuals.py:74-78, 108-123,
251-311) where the two sides differ by the reference kernel's bf16 rounding
or its summation order, and tighter where both sides compute the same f32
formula.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dmsa_lidar_slam_tpu.core import rotations as jrot
from dmsa_lidar_slam_tpu.ops import eig3 as jeig
from dmsa_lidar_slam_tpu.ops import fused_residuals as jfr
from dmsa_lidar_slam_tpu.ops import gaussians as jg
from dmsa_lidar_slam_tpu_torch.ops import eig3 as teig
from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as tfr
from dmsa_lidar_slam_tpu_torch.ops import gaussians as tg
from tests.torch_parity import nn, tt


def _problem(seed=0, n=1024, dtab=34, grid=1.0, giant_cell=False, masked=0.1):
    """The reference test's random indexed-affine problem (cells built on
    the transformed world points), as numpy; a share `masked` of the points
    is masked."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 4, size=(n, 3)).astype(np.float32)
    if giant_cell:
        xs[: n // 2] = 0.5 + 0.2 * rng.standard_normal((n // 2, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > masked
    rings = rng.integers(0, 8, size=n).astype(np.int32)
    tidx = rng.integers(0, dtab - 1, size=n).astype(np.int32)
    tidx[n // 8 :: 7] = dtab - 1

    def rand_tab(scale):
        aa = scale * rng.standard_normal((dtab - 1, 3))
        q = np.asarray(jrot.axang2quat(jnp.asarray(aa)))
        t = 0.5 * rng.standard_normal((dtab - 1, 3))
        tab = np.concatenate([q, t, np.zeros((dtab - 1, 1))], axis=1).astype(np.float32)
        ident = np.zeros((1, 8), np.float32)
        ident[0, 0] = 1.0
        return np.concatenate([tab, ident], axis=0)

    tab0 = rand_tab(0.1)
    world = np.asarray(
        (jrot.quat_rotate(jnp.asarray(tab0[tidx, 0:4]), jnp.asarray(xs)) + jnp.asarray(tab0[tidx, 4:7])).astype(
            jnp.float32
        )
    )
    aux = np.concatenate([xs, tidx[:, None].astype(np.float32)], axis=1)
    cells, aux_s = jg.build_cells(jnp.asarray(world), jnp.asarray(mask), jnp.asarray(rings), grid, 4, aux=jnp.asarray(aux))
    packed = np.asarray(jfr.pack_rows(cells, aux_s[:, :3], aux_s[:, 3]))
    return rng, xs, mask, rings, tidx, tab0, world, packed, rand_tab


def _cmp_packed(pk, pk_ref, mu_atol, lam_rel):
    np.testing.assert_array_equal(pk[12:15], pk_ref[12:15])  # w, tidx, run starts
    np.testing.assert_allclose(pk[0:3], pk_ref[0:3], atol=1e-6)  # xs
    np.testing.assert_allclose(pk[15], pk_ref[15], atol=1e-6)  # 1/count at valid ends
    sel = np.abs(pk_ref[6:12]).sum(axis=0) > 0
    np.testing.assert_allclose(pk[3:6, sel], pk_ref[3:6, sel], atol=mu_atol)
    scale = np.abs(pk_ref[6:12, sel]).max()
    np.testing.assert_allclose(pk[6:12, sel], pk_ref[6:12, sel], atol=lam_rel * scale)


@pytest.mark.parametrize("giant_cell", [False, True])
def test_build_packed_vs_reference_kernel(giant_cell):
    """The port's build (its plain version on the CPU) against the
    reference's compact-path build kernel in interpret mode.  Tolerances of
    tests/test_fused_residuals.py:296-311: both sides accumulate moments
    in f32 in different orders, and the eigenvalue floor amplifies that."""
    _, xs, mask, rings, tidx, tab0, world, _, _ = _problem(seed=5, giant_cell=giant_cell)
    jpk, jnv, jnr = jfr.build_packed(
        jnp.asarray(world), jnp.asarray(mask), jnp.asarray(rings), jnp.asarray(xs), jnp.asarray(tidx),
        1.0, 4, tab=jnp.asarray(tab0),
    )
    tpk, tnv, tnr = tfr.build_packed(tt(world), tt(mask), tt(rings), tt(xs), tt(tidx), 1.0, 4, tt(tab0))
    assert int(tnv) == int(jnv) and int(tnr) == int(jnr)
    _cmp_packed(nn(tpk), np.asarray(jpk), mu_atol=2e-4, lam_rel=0.02)
    e_t = jfr.cand_errors_ref(jnp.asarray(tab0[None]), jnp.asarray(nn(tpk)))
    e_j = jfr.cand_errors_ref(jnp.asarray(tab0[None]), jpk)
    np.testing.assert_allclose(np.asarray(e_t), np.asarray(e_j), rtol=0.02)


@pytest.mark.parametrize("giant_cell", [False, True])
def test_build_packed_ref_vs_reference_ref(giant_cell):
    """Same f32 two-pass formula on both sides (build_cells + pack_rows).
    The reference takes run sums as differences of a global f32 cumsum
    (~1e-7 of a running total of ~2e3 m here, over ~8-point cells), the
    port as segment sums: means to 1e-4 m, lamw6 to 1e-3 of its scale."""
    _, xs, mask, rings, tidx, tab0, world, _, _ = _problem(seed=6, giant_cell=giant_cell)
    jpk, jnv, jnr = jfr.build_packed_ref(
        jnp.asarray(world), jnp.asarray(mask), jnp.asarray(rings), jnp.asarray(xs), jnp.asarray(tidx), 1.0, 4
    )
    tpk, tnv, tnr = tfr.build_packed_ref(tt(world), tt(mask), tt(rings), tt(xs), tt(tidx), 1.0, 4)
    assert int(tnv) == int(jnv) and int(tnr) == int(jnr)
    _cmp_packed(nn(tpk), np.asarray(jpk), mu_atol=1e-4, lam_rel=1e-3)


def test_cell_residuals_and_split_channel():
    """build_cells with a split channel and cell_residuals of moved points:
    same formula in f32 on both sides (rtol 1e-4 on the residuals)."""
    _, xs, mask, rings, tidx, tab0, world, _, _ = _problem(seed=7)
    split = np.random.default_rng(7).integers(0, 6, size=len(xs)).astype(np.int32)
    jc = jg.build_cells(jnp.asarray(world), jnp.asarray(mask), jnp.asarray(rings), 0.8, 4, split_ids=jnp.asarray(split))
    tc = tg.build_cells(tt(world), tt(mask), tt(rings), 0.8, 4, split_ids=tt(split))
    assert int(tc.num_valid) == int(jc.num_valid)
    np.testing.assert_array_equal(nn(tc.order), np.asarray(jc.order))
    moved = world + 0.02
    jr = jg.cell_residuals(jnp.asarray(moved), jnp.asarray(mask), jc)
    tr = tg.cell_residuals(tt(moved), tt(mask), tc)
    np.testing.assert_allclose(nn(tr), np.asarray(jr), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("giant_cell", [False, True])
def test_cand_errors(giant_cell):
    """Against the reference's interpreted kernel and its XLA reference,
    rtol 2e-4 (tests/test_fused_residuals.py:74-78)."""
    rng, xs, mask, rings, tidx, tab0, world, packed, rand_tab = _problem(seed=1, giant_cell=giant_cell)
    tabs = np.stack([tab0] + [rand_tab(0.1) for _ in range(4)])
    want_ref = np.asarray(jfr.cand_errors_ref(jnp.asarray(tabs), jnp.asarray(packed)))
    want_kernel = np.asarray(jfr.cand_errors(jnp.asarray(tabs), jnp.asarray(packed)))
    got = nn(tfr.cand_errors(tt(tabs), tt(packed)))
    np.testing.assert_allclose(got, want_ref, rtol=2e-4)
    np.testing.assert_allclose(got, want_kernel, rtol=2e-4)


@pytest.mark.parametrize("case", [{}, {"giant_cell": True}, {"masked": 0.6}], ids=["cells", "giant_cell", "long_masked_run"])
def test_cand_errors_pieces_ref(case):
    """The plain statement of K3's chunk/piece cut (the sums the card's
    kernels form, in their order) against the reference's XLA reference and
    its interpreted kernel, rtol 2e-4 as test_cand_errors; with a masked
    run longer than several chunks."""
    rng, xs, mask, rings, tidx, tab0, world, packed, rand_tab = _problem(seed=3, **case)
    tabs = np.stack([tab0] + [rand_tab(0.1) for _ in range(4)])
    if "masked" in case:
        starts = np.flatnonzero(packed[14] > 0.5)
        lengths = np.append(starts[1:], packed.shape[1]) - starts
        assert lengths[packed[12, starts] == 0].max() > 4 * tfr.CHUNK
    want_ref = np.asarray(jfr.cand_errors_ref(jnp.asarray(tabs), jnp.asarray(packed)))
    want_kernel = np.asarray(jfr.cand_errors(jnp.asarray(tabs), jnp.asarray(packed)))
    got = nn(tfr.cand_errors_pieces_ref(tt(tabs), tt(packed))[0])
    np.testing.assert_allclose(got, want_ref, rtol=2e-4)
    np.testing.assert_allclose(got, want_kernel, rtol=2e-4)


@pytest.mark.parametrize("giant_cell", [False, True])
def test_gn_system(giant_cell):
    """Tightly against the reference's f32 XLA version (rtol 1e-4, atol 1e-5
    of the matrix scale: summation order only), with and without the mean
    term; loosely against the reference's kernel, whose Jacobian gather and
    run sums round to bf16 (rtol 0.03, atol 0.01 of scale, as
    tests/test_fused_residuals.py:119-123)."""
    rng, xs, mask, rings, tidx, tab0, world, packed, _ = _problem(seed=2, giant_cell=giant_cell)
    p_dim = 6
    dtabs = (0.1 * rng.standard_normal((p_dim, tab0.shape[0], 8))).astype(np.float32)
    dtabs[:, -1, :] = 0.0
    args_j = (jnp.asarray(tab0), jnp.asarray(dtabs), jnp.asarray(packed))
    args_t = (tt(tab0), tt(dtabs), tt(packed))
    want_nomean = np.asarray(jfr.gn_system_ref(*args_j, include_mean_term=False))
    want_mean = np.asarray(jfr.gn_system_ref(*args_j))
    scale = float(np.abs(want_nomean).max())
    got = nn(tfr.gn_system(*args_t))
    np.testing.assert_allclose(got, want_nomean, rtol=1e-4, atol=1e-5 * scale)
    got_mean = nn(tfr.gn_system_ref(*args_t, include_mean_term=True))
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-4, atol=1e-5 * scale)
    want_kernel = np.asarray(jfr.gn_system(*args_j))
    np.testing.assert_allclose(got, want_kernel, rtol=0.03, atol=0.01 * scale)


EIG_CASES = {
    "floored_inverse_sym3": lambda m, A, a: m.floored_inverse_sym3(A, 1e-4),
    "floored_inverse_sym6": lambda m, A, a: m.floored_inverse_sym6(a, 1e-4),
    "sym_eigvals3": lambda m, A, a: m.sym_eigvals3(A),
    "smallest_eigvec_sym3": lambda m, A, a: m.smallest_eigvec_sym3(A),
}


@pytest.mark.parametrize("name", sorted(EIG_CASES))
def test_eig3(name):
    """f64 closed forms on both sides: rtol 1e-9 (the floored inverse of a
    near-floor spectrum divides by eigenvalue gaps, the eigenvector's sign
    is fixed by the same cross-product rule on both sides)."""
    rng = np.random.default_rng(9)
    B = rng.standard_normal((200, 3, 3))
    A = B @ np.swapaxes(B, 1, 2) * rng.uniform(1e-5, 1.0, size=(200, 1, 1))
    A[0] = np.eye(3) * 0.3  # isotropic
    A[1] = np.diag([1e-6, 1e-6, 0.5])  # floored pair
    a = np.asarray(jeig.pack_sym6(jnp.asarray(A)))
    fn = EIG_CASES[name]
    want = np.asarray(fn(jeig, jnp.asarray(A), jnp.asarray(a)))
    got = nn(fn(teig, tt(A), tt(a)))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
