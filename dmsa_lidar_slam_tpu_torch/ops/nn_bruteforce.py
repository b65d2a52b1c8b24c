"""Brute-force neighbour queries: kernels K4 and K5 and their plain versions
(counterpart of dmsa_lidar_slam_tpu/ops/nn_bruteforce.py).

K4 (min_sq_dist, has_neighbor_within): the exact squared distance to the
nearest valid reference, |q - r|^2 computed directly (csrc/k4_nn.cu: one
kernel over query tiles x reference splits, minima combined exactly by
atomicMin on the f32 bits); invalid references never win, invalid queries
get +inf, as do all queries when no reference is valid.

K5 (radius_neighbor_moments): per valid point, the count, mean and
covariance of the valid points within a radius, self included, with the
moments taken about the query point (csrc/k5_moments.cu: a kernel over
query tiles x reference splits whose sums run only where a warp has a
neighbour, and a finish kernel that sums the splits in a fixed order).

A radius is a host number or a tensor (for K5 on the card, a one-element
f32 tensor on the points' device).  Neither wrapper turns a host number
into a card tensor: that is a blocking copy, which syncs the stream.
rho^2 is the f32 radius squared in f32 either way, as the plain versions
compute it.
"""

import numbers

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

_F32 = torch.float32


def min_sq_dist(ref_pts, ref_valid, queries, query_valid):
    """Squared distance [Q] from each query to the nearest valid reference.

    ref_pts [N, 3], ref_valid [N] bool, queries [Q, 3], query_valid [Q]
    bool."""
    if not queries.is_cuda:
        return min_sq_dist_ref(ref_pts, ref_valid, queries, query_valid)
    dev = queries.device
    r = ref_pts.to(_F32).contiguous()
    q = queries.to(_F32).contiguous()
    rv, qv = ref_valid.contiguous(), query_valid.contiguous()
    n, nq = r.shape[0], q.shape[0]
    cuda_lib.require(r, "ref_pts", _F32, (n, 3), dev)
    cuda_lib.require(q, "queries", _F32, (nq, 3), dev)
    # torch.bool is one byte, 0 or 1: the kernel reads the masks as they are
    cuda_lib.require(rv, "ref_valid", torch.bool, (n,), dev)
    cuda_lib.require(qv, "query_valid", torch.bool, (nq,), dev)
    out = torch.empty(nq, dtype=_F32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["min_sq_dist"] += 1
    cuda_lib.check(
        cuda_lib.library().k4_min_sq_dist(P(r), P(rv), n, P(q), P(qv), nq, P(out), cuda_lib.stream_ptr(dev)),
        "k4_min_sq_dist",
    )
    return out


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


def _radius_operand(radius, device):
    """The radius as k5_radius_moments takes it: (rho_host, rho pointer or
    None).  A host number goes in as an f32 argument, a one-element f32
    tensor on the points' card as its pointer; the kernel squares either in
    f32.  Any other radius is refused."""
    if isinstance(radius, torch.Tensor):
        if radius.numel() != 1 or radius.dtype != _F32 or radius.device != device:
            raise ValueError(f"radius: one f32 value on {device} expected, got {radius.dtype} "
                             f"shape {tuple(radius.shape)} on {radius.device}")
        return 0.0, cuda_lib.ptr(radius)
    if isinstance(radius, numbers.Real):
        return float(radius), None
    raise ValueError(f"radius: a number or an f32 tensor expected, got {type(radius).__name__}")


def radius_neighbor_moments(pts, valid, radius):
    """Per-point neighbour moments within `radius`, self included.

    pts [N, 3], valid [N] bool, radius a host number or (on the card) a
    one-element f32 tensor on the points' device.  Returns
    (count [N], mean [N, 3], cov [N, 3, 3]) f32 in the points' frame:
    over the valid r with |r - q|^2 <= radius^2, cov = (S - s s^T / count) /
    max(count - 1, 1) with s, S the first and second moments of r - q, zero
    where count < 2.  Invalid points get count 0, mean 0 and cov 0 (the
    reference computes their rows too; no consumer reads them)."""
    if not pts.is_cuda:
        return radius_neighbor_moments_ref(pts, valid, radius)
    dev = pts.device
    p = pts.to(_F32).contiguous()
    v = valid.contiguous()
    n = p.shape[0]
    cuda_lib.require(p, "pts", _F32, (n, 3), dev)
    # torch.bool is one byte, 0 or 1: the kernel reads the mask as it is
    cuda_lib.require(v, "valid", torch.bool, (n,), dev)
    rho_host, rho_ptr = _radius_operand(radius, dev)
    # three allocations: slicing one buffer into views costs the host more
    cnt = torch.empty(n, dtype=_F32, device=dev)
    mean = torch.empty((n, 3), dtype=_F32, device=dev)
    cov = torch.empty((n, 3, 3), dtype=_F32, device=dev)
    if n == 0:
        return cnt, mean, cov
    # the per-split partial sums, laid out by the library
    (nbytes,) = cuda_lib.scratch_bytes("k5_scratch_bytes", 1, n)
    part = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["radius_neighbor_moments"] += 1
    cuda_lib.check(
        cuda_lib.library().k5_radius_moments(P(p), P(v), n, rho_host, rho_ptr, P(part), P(cnt), P(mean), P(cov),
                                             cuda_lib.stream_ptr(dev)),
        "k5_radius_moments",
    )
    return cnt, mean, cov


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
