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

from bench_port.reference.ops import voxel
from bench_port.reference.ops.eig3 import floored_inverse_sym6

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
    runs: voxel.Runs  # the sort's runs, the masked tail left out (every run sum of this build)
    valid_mem: Optional[torch.Tensor] = None  # [N] validity at every member


def _outer6(v):
    x, y, z = v.unbind(-1)
    return torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], dim=-1)


def build_cells(
    points, mask, ring_ids, grid_size, min_points: int, split_ids=None, aux=None, key_points=None, obs_weight=None
):
    """Bin points and compute accepted Gaussian cells at one resolution.

    aux optional [N, A] per-point payload returned in sorted order: then
    the result is (CellSet, aux_sorted).  key_points (default: points)
    supply the voxel keys when the statistics use other coordinates.
    obs_weight optional [N] per-point observation weight: each member's
    obs is obs_weight * w (None: obs = w), and the per-cell mean of obs
    feeds the rebalancing weight (getWeightOfPointSet,
    OptimizablePointSet.h:52)."""
    n = points.shape[0]
    kp = points if key_points is None else key_points
    rb = voxel.bin_runs(kp, mask, grid_size, channel=split_ids)
    order, new_cell, start, end = rb.order, rb.new_cell, rb.start, rb.end
    pts_s = points[order]
    w_s = mask[order].to(points.dtype)
    rings_s = ring_ids[order]

    ring_prev = torch.cat([rings_s[:1], rings_s[:-1]])
    ringdiff = ((~new_cell) & (rings_s != ring_prev)).to(points.dtype)
    obs_s = w_s if obs_weight is None else obs_weight.to(points.dtype)[order] * w_s

    vals1 = torch.cat([w_s[:, None], pts_s * w_s[:, None], ringdiff[:, None], obs_s[:, None]], dim=1)
    runs = voxel.sorted_runs(start, torch.sum(mask))
    sums1 = voxel.run_sums(vals1, runs)
    count_pp = sums1[:, 0]
    safe_n = torch.clamp(count_pp, min=1.0)
    mean_pp = sums1[:, 1:4] / safe_n[:, None]
    diverse_pp = sums1[:, 4] > 0.5
    obs_cell_pp = sums1[:, 5] / safe_n

    centered = (pts_s - mean_pp) * w_s[:, None]
    m2 = voxel.run_sums(_outer6(centered), runs)
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
        runs=runs,
        valid_mem=valid_mem,
    )
    return cs if aux is None else (cs, aux[order])
