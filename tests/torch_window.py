"""The window problem of K6's tests and chip_smoke.py's K6 rows (no jax):
window_problem builds a window's shapes, data and params in one of the
regimes whose branches K6 mirrors; candidates the line search's 15
parameter sets; check_tables / check_batch hold K6's outputs to the
torch.func reference's (tests/test_torch_window_tables_card.py states the
tolerances' reasons)."""

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
from tests.torch_parity import nn

REGIMES = ("random", "zero_rotation", "identity", "equal_orient", "negative_dot", "tiny_dt")
# f32 tables: the f64 values round to neighbouring floats at most
TAB_ATOL = 2.0 ** -22
# dtab: f32 of f64 tangents that differ by summation order
DTAB_REL = 1e-6
# f64 residuals and their tangents
EXTRA_REL = 1e-9


def window_problem(seed, regime="random", n_ctrl=6, n_dense=501, device="cpu"):
    """(shapes, data, params [P]) of a window in `regime`; params and data
    in f64 as the fused step holds them.  The IMU factors are random
    rotations near the identity, small velocities and positions, and an SPD
    inverse covariance."""
    rng = np.random.default_rng(seed)
    shapes = ct.WindowShapes(n_window_pts=64, n_static=16, n_ctrl=n_ctrl, n_dense=n_dense)
    c, e = n_ctrl, n_ctrl - 1
    dt = 1e-7 if regime == "tiny_dt" else 0.1 / (n_dense - 1)
    anchor_o = 0.4 * rng.standard_normal(3)
    orient = 0.03 * rng.standard_normal((e, 3))
    transl = 0.04 * rng.standard_normal((e, 3))
    if regime in ("zero_rotation", "identity"):
        orient[:] = 0.0
    if regime == "identity":
        anchor_o[:] = 0.0
    if regime == "equal_orient":
        orient[1] = orient[3] = 0.0
    if regime == "negative_dot":
        anchor_o = np.array([3.0, 0.0, 0.0])
        orient[:] = [0.06, 0.0, 0.0]
    params = np.concatenate([orient.ravel(), transl.ravel()])
    b = rng.standard_normal((e, 9, 9))
    cov_inv = np.einsum("kij,klj->kil", b, b) + 9.0 * np.eye(9)
    nw, ns = shapes.n_window_pts, shapes.n_static
    f64 = dict(dtype=torch.float64, device=device)

    def t64(x):
        return torch.as_tensor(np.asarray(x), **f64)

    data = ct.WindowData(
        local_pts=torch.as_tensor(rng.standard_normal((nw, 3)), dtype=torch.float32, device=device),
        pt_mask=torch.ones(nw, dtype=torch.bool, device=device),
        pt_ring=torch.zeros(nw, dtype=torch.int32, device=device),
        pt_tform_idx=torch.as_tensor(rng.integers(0, n_dense, nw), device=device),
        static_pts=torch.as_tensor(rng.standard_normal((ns, 3)), dtype=torch.float32, device=device),
        static_mask=torch.ones(ns, dtype=torch.bool, device=device),
        static_ring=torch.zeros(ns, dtype=torch.int32, device=device),
        anchor_orient=t64(anchor_o),
        anchor_transl=t64(rng.standard_normal(3)),
        ctrl_stamps=t64(np.asarray(shapes.param_indices) * dt),
        dt=t64(dt),
        horizon=t64((n_dense - 1) * dt),
        acc_dense=t64(np.zeros((n_dense, 3))),
        gyr_dense=t64(np.zeros((n_dense, 3))),
        gravity=t64(ct.GRAVITY_W),
        preint_rot=rot.axang2rotm(t64(0.02 * rng.standard_normal((e, 3)))),
        preint_vel=t64(0.05 * rng.standard_normal((e, 3))),
        preint_pos=t64(0.01 * rng.standard_normal((e, 3))),
        cov_inv=t64(cov_inv),
        preint_pos_full=t64(np.zeros(3)),
        balancing_imu=t64(0.01),
    )
    return shapes, data, t64(params)


def candidates(params, seed):
    """The line search's candidates: params and params + k step for the 14
    step fractions, the step at the window solve's clip (1e-2)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    step = 0.01 * (2 * torch.rand(params.shape[0], generator=g, dtype=torch.float64) - 1)
    ks = torch.tensor((0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.05, 0.02, 0.01, 0.005, 0.002),
                      dtype=torch.float64)
    return params[None, :] + (ks[:, None] * step[None, :]).to(params.device)


def check_tables(got, want):
    """(tab, extra, dtab, j_extra) against the reference's."""
    tab, extra, dtab, j_extra = (nn(x) for x in got)
    r_tab, r_extra, r_dtab, r_jextra = (nn(x) for x in want)
    assert tab.dtype == np.float32 and dtab.dtype == np.float32
    assert extra.dtype == np.float64 and j_extra.dtype == np.float64
    assert np.isfinite(tab).all() and np.isfinite(dtab).all() and np.isfinite(extra).all()
    assert np.isfinite(j_extra).all()
    np.testing.assert_allclose(tab, r_tab, rtol=0, atol=TAB_ATOL * max(1.0, np.abs(r_tab).max()))
    scale = np.abs(r_dtab).reshape(r_dtab.shape[0], -1).max(axis=1).clip(min=1e-30)
    err = np.abs(dtab - r_dtab).reshape(dtab.shape[0], -1).max(axis=1)
    assert (err <= DTAB_REL * scale + 1e-30).all(), (err / scale).max()
    if extra.size:
        np.testing.assert_allclose(extra, r_extra, rtol=EXTRA_REL, atol=EXTRA_REL * np.abs(r_extra).max())
        np.testing.assert_allclose(j_extra, r_jextra, rtol=0, atol=EXTRA_REL * np.abs(r_jextra).max())


def check_batch(got, want):
    tabs, extras = (nn(x) for x in got)
    r_tabs, r_extras = (nn(x) for x in want)
    assert tabs.dtype == np.float32 and extras.dtype == np.float64
    assert np.isfinite(tabs).all() and np.isfinite(extras).all()
    np.testing.assert_allclose(tabs, r_tabs, rtol=0, atol=TAB_ATOL * max(1.0, np.abs(r_tabs).max()))
    if extras.size:
        np.testing.assert_allclose(extras, r_extras, rtol=EXTRA_REL, atol=EXTRA_REL * np.abs(r_extras).max())
