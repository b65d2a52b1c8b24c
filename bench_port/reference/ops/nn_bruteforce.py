"""Brute-force neighbour queries K4 and K5 as their plain PyTorch
versions: a frozen copy of dmsa_lidar_slam_tpu_torch/ops/nn_bruteforce.py
whose public functions run the plain versions on every device.

K4 (min_sq_dist, has_neighbor_within): the exact squared distance to the
nearest valid reference; invalid references never win, invalid queries
get +inf, as do all queries when no reference is valid.

K5 (radius_neighbor_moments): per valid point, the count, mean and
covariance of the valid points within a radius, self included, with the
moments taken about the query point.
"""


import numpy as np
import torch


_F32 = torch.float32


def min_sq_dist(ref_pts, ref_valid, queries, query_valid):
    """K4 as its plain version, on every device."""
    return min_sq_dist_ref(ref_pts, ref_valid, queries, query_valid)


def min_sq_dist_ref(ref_pts, ref_valid, queries, query_valid, pair_budget=1 << 24):
    """Plain version of min_sq_dist, over chunks of queries."""
    r = ref_pts.to(_F32)
    q = queries.to(_F32)
    inf = torch.tensor(float("inf"), dtype=_F32, device=q.device)
    pen = torch.where(ref_valid, torch.zeros((), dtype=_F32, device=q.device), inf)
    chunk = max(1, pair_budget // max(r.shape[0], 1))
    out = []
    for a in range(0, q.shape[0], chunk):
        qc = q[a : a + chunk]
        d2 = torch.sum((qc[:, None, :] - r[None, :, :]) ** 2, dim=-1) + pen[None, :]
        out.append(torch.amin(d2, dim=1) if r.shape[0] else torch.full((qc.shape[0],), float("inf"), device=q.device))
    best = torch.cat(out) if out else torch.zeros(0, dtype=_F32, device=q.device)
    return torch.where(query_valid, best, inf)


def has_neighbor_within(ref_pts, ref_valid, queries, query_valid, radius):
    """Boolean [Q]: a valid reference lies within `radius` of the query.

    radius: a host number (compared as the f32 radius squared in f32, a
    scalar argument of the comparison) or a tensor (squared where it lies)."""
    d2 = min_sq_dist(ref_pts, ref_valid, queries, query_valid)
    if isinstance(radius, torch.Tensor):
        return d2 <= radius.to(_F32) ** 2
    return d2 <= _host_rho2(radius)


def _host_rho2(radius):
    """The f32 square of the f32 radius, as a Python float (exact: the
    product of two f32 values is exact in f64 and rounds once to f32)."""
    r = float(np.float32(radius))
    return float(np.float32(r * r))


def _rho2(radius, device):
    """rho^2 [1] f32 on the device, from a float or a tensor radius (the
    plain version's form)."""
    return (torch.as_tensor(radius, device=device).to(_F32) ** 2).reshape(1).contiguous()


def radius_neighbor_moments(pts, valid, radius):
    """K5 as its plain version, on every device."""
    return radius_neighbor_moments_ref(pts, valid, radius)


def radius_neighbor_moments_ref(pts, valid, radius, pair_budget=1 << 22):
    """Plain version of radius_neighbor_moments, over chunks of queries.
    d2 is rounded op by op as (dx*dx + dy*dy) + dz*dz, as the kernel does,
    so both count the same pairs."""
    p = pts.to(_F32)
    v = valid.to(torch.bool)
    dev = p.device
    r = torch.where(v[:, None], p, torch.zeros_like(p))  # a NaN in a masked slot stays out
    rho2 = _rho2(radius, dev)
    n = p.shape[0]
    chunk = max(1, pair_budget // max(n, 1))
    cnt, s1, s2 = [], [], []
    for a in range(0, n, chunk):
        q = r[a : a + chunk]
        d = r[None, :, :] - q[:, None, :]  # [C, N, 3]
        dx, dy, dz = d.unbind(-1)
        d2 = dx * dx + dy * dy + dz * dz
        f = ((d2 <= rho2) & v[None, :] & v[a : a + chunk, None]).to(_F32)
        g = f[..., None] * d
        gx, gy, gz = g.unbind(-1)
        cnt.append(f.sum(1))
        s1.append(g.sum(1))
        s2.append(torch.stack([(gx * dx).sum(1), (gx * dy).sum(1), (gx * dz).sum(1),
                               (gy * dy).sum(1), (gy * dz).sum(1), (gz * dz).sum(1)], dim=1))
    if n == 0:
        z = torch.zeros(0, dtype=_F32, device=dev)
        return z, z.reshape(0, 3), z.reshape(0, 3, 3)
    c, s, m2 = torch.cat(cnt), torch.cat(s1), torch.cat(s2)
    inv = 1.0 / torch.clamp(c, min=1.0)
    mean = torch.where(v[:, None], r + s * inv[:, None], torch.zeros_like(r))
    sx, sy, sz = s.unbind(-1)
    outer = torch.stack([sx * sx, sx * sy, sx * sz, sy * sy, sy * sz, sz * sz], dim=1)
    c6 = (m2 - outer * inv[:, None]) * (1.0 / torch.clamp(c - 1.0, min=1.0))[:, None]
    c6 = torch.where((c >= 2.0)[:, None], c6, torch.zeros_like(c6))
    cov = c6[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(n, 3, 3)
    return c, mean, cov
