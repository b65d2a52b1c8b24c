"""Barycentric-rational and slerp interpolation of pose trajectories
(counterpart of dmsa_lidar_slam_tpu/core/interpolation.py).

Floater-Hormann d=2 barycentric weights for translations, slerp between
bracketing control poses for orientations, both as dense weight matrices.
"""

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.core import rotations as rot


def floater_hormann_weights_np(t_knots: np.ndarray, d: int = 2) -> np.ndarray:
    n = len(t_knots)
    if n <= d:
        d = n - 1
    w = np.zeros(n)
    for k in range(n):
        s = 0.0
        for i in range(max(k - d, 0), min(k, n - 1 - d) + 1):
            prod = 1.0
            for j in range(i, i + d + 1):
                if j == k:
                    continue
                prod *= abs(t_knots[k] - t_knots[j])
            s += 1.0 / prod
        w[k] = s if (k - d) % 2 == 0 else -s
    return w


def barycentric_matrix_np(t_eval, t_knots, weights) -> np.ndarray:
    diff = t_eval[:, None] - t_knots[None, :]
    exact = np.abs(diff) < 1e-12
    any_exact = exact.any(axis=1, keepdims=True)
    safe_diff = np.where(exact, 1.0, diff)
    terms = weights[None, :] / safe_diff
    A_smooth = terms / terms.sum(axis=1, keepdims=True)
    A_exact = exact.astype(np.float64)
    A_exact = A_exact / np.maximum(A_exact.sum(axis=1, keepdims=True), 1.0)
    return np.where(any_exact, A_exact, A_smooth)


def uniform_grid_consts(n_eval: int, n_knots: int, interval_len: int, d: int = 2):
    """Constant interpolation operators for knots on a uniform grid (knot k
    at sample k * interval_len): (A [E, K] f64, left [E], right [E], u [E])
    as numpy arrays."""
    t_eval = np.arange(n_eval, dtype=np.float64)
    t_knots = np.arange(n_knots, dtype=np.float64) * float(interval_len)
    w = floater_hormann_weights_np(t_knots, d)
    A = barycentric_matrix_np(t_eval, t_knots, w)
    right = np.searchsorted(t_knots[:-1], t_eval, side="left").astype(np.int64)
    right = np.clip(right, 0, n_knots - 1)
    left = np.maximum(right - 1, 0)
    denom = t_knots[right] - t_knots[left]
    u = np.where(right > 0, (t_eval - t_knots[left]) / np.where(denom == 0, 1.0, denom), 1.0)
    return A, left, right, u


def floater_hormann_weights(t_knots: torch.Tensor, d: int = 2) -> torch.Tensor:
    """Floater-Hormann weights of traced knots (the knot count is static)."""
    n = t_knots.shape[0]
    if n <= d:
        d = n - 1
    ws = []
    for k in range(n):
        s = torch.zeros((), dtype=t_knots.dtype, device=t_knots.device)
        for i in range(max(k - d, 0), min(k, n - 1 - d) + 1):
            prod = torch.ones((), dtype=t_knots.dtype, device=t_knots.device)
            for j in range(i, i + d + 1):
                if j == k:
                    continue
                prod = prod * torch.abs(t_knots[k] - t_knots[j])
            s = s + 1.0 / prod
        ws.append(s if (k - d) % 2 == 0 else -s)
    return torch.stack(ws)


def barycentric_matrix(t_eval, t_knots, weights):
    diff = t_eval[:, None] - t_knots[None, :]
    exact = torch.abs(diff) < 1e-12
    any_exact = torch.any(exact, dim=1, keepdim=True)
    safe_diff = torch.where(exact, torch.ones_like(diff), diff)
    terms = weights[None, :] / safe_diff
    A_smooth = terms / torch.sum(terms, dim=1, keepdim=True)
    A_exact = exact.to(t_eval.dtype)
    A_exact = A_exact / torch.clamp(torch.sum(A_exact, dim=1, keepdim=True), min=1.0)
    return torch.where(any_exact, A_exact, A_smooth)


def barycentric_interp(t_eval, t_knots, y_knots, d: int = 2):
    w = floater_hormann_weights(t_knots, d)
    A = barycentric_matrix(t_eval, t_knots, w)
    return torch.tensordot(A, y_knots, dims=([1], [0]))


def barycentric_derivative(t_eval, t_knots, y_knots, d: int = 2):
    """Derivative of the barycentric rational interpolant at t_eval [E]
    (Schneider-Werner; knot-exact rows use the knot formula)."""
    w = floater_hormann_weights(t_knots, d)
    diff = t_eval[:, None] - t_knots[None, :]
    exact = torch.abs(diff) < 1e-12
    any_exact = torch.any(exact, dim=1)

    safe_diff = torch.where(exact, torch.ones_like(diff), diff)
    terms = w[None, :] / safe_diff
    c = terms / torch.sum(terms, dim=1, keepdim=True)
    r = c @ y_knots
    dr_smooth = torch.einsum("ek,ek...->e...", c / safe_diff, r[:, None] - y_knots[None, :])

    idx = torch.argmax(exact.to(torch.int32), dim=1)
    w_i = w[idx]
    y_i = y_knots[idx]
    t_i = t_knots[idx]
    dknot = t_i[:, None] - t_knots[None, :]
    mask = torch.abs(dknot) < 1e-12
    safe_dknot = torch.where(mask, torch.ones_like(dknot), dknot)
    coeff = torch.where(mask, torch.zeros_like(dknot), (w[None, :] / w_i[:, None]) / safe_dknot)
    dr_exact = -torch.einsum("ek,ek...->e...", coeff, y_i[:, None] - y_knots[None, :])

    sel = any_exact[:, None] if r.ndim > 1 else any_exact
    return torch.where(sel, dr_exact, dr_smooth)


def interp_rotations(t_eval, t_knots, orient_knots):
    """Slerp orientations [K, 3] onto t_eval [E] -> [E, 3] (bracket by
    lower_bound over knots[:-1], unclamped t_rel, as the reference)."""
    right = torch.searchsorted(t_knots[:-1].contiguous(), t_eval.contiguous(), right=False)
    right = torch.clamp(right, 0, t_knots.shape[0] - 1)
    left = torch.clamp(right - 1, min=0)
    denom = t_knots[right] - t_knots[left]
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    t_rel = torch.where(right > 0, (t_eval - t_knots[left]) / safe, torch.ones_like(denom))
    q = rot.axang2quat(orient_knots)
    return rot.quat2axang(rot.quat_slerp(q[left], q[right], t_rel))
