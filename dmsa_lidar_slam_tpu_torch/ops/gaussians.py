"""Gaussian cell statistics: per-voxel mean / covariance / information
matrix (counterpart of dmsa_lidar_slam_tpu/ops/gaussians.py).

Acceptance rules as the reference: at least `min_points` members, at
least two distinct ring ids, eigenvalue floor 1e-4 before inversion,
rebalancing weights w_k = obs_k / n_k normalized to mean 1 over valid
cells.  Cells are the contiguous runs of the voxel-key sort, identified by
the sorted position of their first member (run-start slots).

build_cells + fused_residuals.pack_rows is the plain version of the K1
cell-build kernel (ops/fused_residuals.py).
"""

from typing import NamedTuple, Optional

import torch

from dmsa_lidar_slam_tpu_torch.ops import voxel
from dmsa_lidar_slam_tpu_torch.ops.eig3 import floored_inverse_sym6, sym6_matvec

COV_EIG_FLOOR = 1e-4  # Gaussians.h:193


class CellSet(NamedTuple):
    order: torch.Tensor  # [N] sort permutation
    start: torch.Tensor  # [N] run start per sorted point
    end: torch.Tensor  # [N] one past run end per sorted point
    info6: torch.Tensor  # [N, 6] info at run-start rows (0 elsewhere / invalid)
    lamw6: torch.Tensor  # [N, 6] weight * info of the member's cell
    mu0: torch.Tensor  # [N, 3] cell mean at build time, per member
    w_sorted: torch.Tensor  # [N] validity in sorted order (points dtype)
    weight: torch.Tensor  # [N] rebalancing weight at run starts
    count: torch.Tensor  # [N] member count per member
    valid: torch.Tensor  # [N] cell validity at run-start rows
    num_valid: torch.Tensor  # []
    num_raw: torch.Tensor  # []
    valid_mem: Optional[torch.Tensor] = None  # [N] validity at every member


def _outer6(v):
    x, y, z = v.unbind(-1)
    return torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], dim=-1)


def build_cells(
    points, mask, ring_ids, grid_size, min_points: int, split_ids=None, aux=None, key_points=None
):
    """Bin points and compute accepted Gaussian cells at one resolution.

    aux optional [N, A] per-point payload returned in sorted order: then
    the result is (CellSet, aux_sorted).  key_points (default: points)
    supply the voxel keys when the statistics use other coordinates."""
    n = points.shape[0]
    kp = points if key_points is None else key_points
    rb = voxel.bin_runs(kp, mask, grid_size, channel=split_ids)
    order, new_cell, start, end = rb.order, rb.new_cell, rb.start, rb.end
    pts_s = points[order]
    w_s = mask[order].to(points.dtype)
    rings_s = ring_ids[order]

    ring_prev = torch.cat([rings_s[:1], rings_s[:-1]])
    ringdiff = ((~new_cell) & (rings_s != ring_prev)).to(points.dtype)

    vals1 = torch.cat([w_s[:, None], pts_s * w_s[:, None], ringdiff[:, None], w_s[:, None]], dim=1)
    sums1 = voxel.run_sums(vals1, start)
    count_pp = sums1[:, 0]
    safe_n = torch.clamp(count_pp, min=1.0)
    mean_pp = sums1[:, 1:4] / safe_n[:, None]
    diverse_pp = sums1[:, 4] > 0.5
    obs_cell_pp = sums1[:, 5] / safe_n

    centered = (pts_s - mean_pp) * w_s[:, None]
    m2 = voxel.run_sums(_outer6(centered), start)
    cov6 = m2 / torch.clamp(count_pp - 1.0, min=1.0)[:, None]

    valid_mem = (count_pp > 0.5) & (count_pp >= min_points) & diverse_pp
    valid = new_cell & valid_mem

    info6 = floored_inverse_sym6(cov6, COV_EIG_FLOOR)
    info6 = torch.where(valid[:, None], info6, torch.zeros_like(info6))

    raw_w = torch.where(valid, obs_cell_pp / safe_n, torch.zeros_like(safe_n))
    num_valid = torch.sum(valid)
    mean_w = torch.sum(raw_w) / torch.clamp(num_valid, min=1)
    weight = torch.where(valid, raw_w / torch.clamp(mean_w, min=1e-30), torch.zeros_like(raw_w))
    lamw6 = (info6 * weight[:, None])[start]

    cs = CellSet(
        order=order,
        start=start,
        end=end,
        info6=info6,
        lamw6=lamw6,
        mu0=mean_pp,
        w_sorted=w_s,
        weight=weight,
        count=count_pp,
        valid=valid,
        num_valid=num_valid,
        num_raw=rb.num_cells,
        valid_mem=valid_mem,
    )
    return cs if aux is None else (cs, aux[order])


def cell_residuals(points, mask, cells: CellSet):
    """Per-cell DMSA residuals with membership and Lambda frozen at build
    time: r = sqrt(|sum_j d0^T wL d0 - n s^T wL s|), d0 = p - mu0.
    Returns [N], nonzero at run-start slots of valid cells."""
    pts_s = points[cells.order]
    d0 = (pts_s - cells.mu0) * cells.w_sorted[:, None]
    quad = torch.sum(sym6_matvec(cells.lamw6, d0) * d0, dim=1)
    sums = voxel.run_sums(torch.cat([d0, quad[:, None]], dim=1), cells.start)
    s_mean = sums[:, :3] / torch.clamp(cells.count, min=1.0)[:, None]
    corr = cells.count * torch.sum(sym6_matvec(cells.lamw6, s_mean) * s_mean, dim=1)
    val = sums[:, 3] - corr
    return torch.where(cells.valid, torch.sqrt(torch.abs(val) + 1e-30), torch.zeros_like(val))


def concat_cells(cells_list, n_points: int) -> CellSet:
    """Merge per-resolution CellSets into one over the concatenated sorted
    layout (orders still index the same [n_points] points; run offsets are
    shifted by each slab's start, which is always a run start)."""
    if len(cells_list) == 1:
        return cells_list[0]
    offs = [i * n_points for i in range(len(cells_list))]

    def cat(field, shift=False):
        parts = [getattr(c, field) for c in cells_list]
        if shift:
            parts = [p + o for p, o in zip(parts, offs)]
        return torch.cat(parts, dim=0)

    return CellSet(
        order=cat("order"),
        start=cat("start", shift=True),
        end=cat("end", shift=True),
        info6=cat("info6"),
        lamw6=cat("lamw6"),
        mu0=cat("mu0"),
        w_sorted=cat("w_sorted"),
        weight=cat("weight"),
        count=cat("count"),
        valid=cat("valid"),
        num_valid=sum(c.num_valid for c in cells_list),
        num_raw=sum(c.num_raw for c in cells_list),
        valid_mem=cat("valid_mem") if all(c.valid_mem is not None for c in cells_list) else None,
    )


def cell_residuals_and_grad(points, mask, cells: CellSet):
    """cell_residuals plus the closed-form per-point residual gradient.

    Returns (res [N], grad3_sorted [N, 3]): grad3_sorted[j] = d res[slot(j)]
    / d p_j for the sorted point j (zero for masked points and invalid
    cells), sign(val) * wL (p_j - mu_current) / res (the mean term vanishes
    because the centred offsets sum to zero)."""
    pts_s = points[cells.order]
    d0 = (pts_s - cells.mu0) * cells.w_sorted[:, None]
    quad = torch.sum(sym6_matvec(cells.lamw6, d0) * d0, dim=1)
    sums = voxel.run_sums(torch.cat([d0, quad[:, None]], dim=1), cells.start)
    s_mean = sums[:, :3] / torch.clamp(cells.count, min=1.0)[:, None]
    corr = cells.count * torch.sum(sym6_matvec(cells.lamw6, s_mean) * s_mean, dim=1)
    val = sums[:, 3] - corr
    r = torch.sqrt(torch.abs(val) + 1e-30)
    res = torch.where(cells.valid, r, torch.zeros_like(r))
    ldiff = sym6_matvec(cells.lamw6, d0 - s_mean)
    scale = torch.sign(val) / r
    valid_m = cells.valid[cells.start]
    g = torch.where(valid_m[:, None], scale[:, None] * ldiff, torch.zeros_like(ldiff)) * cells.w_sorted[:, None]
    return res, g
