"""Scan preprocessing: adaptive random-grid downsampling and range window
(counterpart of dmsa_lidar_slam_tpu/pipeline/preprocess.py).

Grids 0.4 / 0.3 / 0.2 / 0.15 m coarse-to-fine; keep the first whose voxel
count reaches max_num_points (else the finest); then keep points with
range in (min_dist, max(range_sorted[max_num], min_dist_ds)).
"""

from typing import NamedTuple

import torch

from bench_port.reference.ops import voxel

GRID_LADDER = (0.4, 0.3, 0.2, 0.15)


class PreprocessResult(NamedTuple):
    indices: torch.Tensor  # [cap] indices into the raw scan
    mask: torch.Tensor  # [cap]
    grid_size: torch.Tensor  # [] chosen grid (f32)
    num_kept: torch.Tensor  # [] may exceed cap


def preprocess_scan(raw_pts, raw_mask, prio, max_num_points: int, min_dist_ds, min_dist, cap: int):
    """raw_pts [NR, 3] f32 lidar frame, raw_mask [NR], prio [NR] int32."""
    counts = voxel.count_voxels_ladder(raw_pts, raw_mask, GRID_LADDER)
    ladder = torch.tensor(GRID_LADDER, dtype=raw_pts.dtype, device=raw_pts.device)
    reaches = counts >= max_num_points
    first = torch.argmax(reaches.to(torch.int32))
    grid = torch.where(torch.any(reaches), ladder[first], ladder[-1])

    keep = voxel.random_downsample_mask(raw_pts, raw_mask, grid, prio)

    ranges = torch.linalg.norm(raw_pts, dim=1)
    ranges_sel = torch.where(keep, ranges, torch.full_like(ranges, float("inf")))
    n_sel = torch.sum(keep)
    sorted_r = torch.sort(ranges_sel).values
    pick = torch.clamp(torch.clamp(n_sel - 1, min=0), max=max_num_points)
    thres = torch.clamp(sorted_r[pick], min=min_dist_ds)

    final = keep & (ranges < thres) & (ranges > min_dist)
    num_kept = torch.sum(final)
    idx, mask = voxel.compact(final, cap)
    return PreprocessResult(indices=idx, mask=mask, grid_size=grid, num_kept=num_kept)


def transform_to_imu(points, R_l2i, t_l2i):
    return points @ R_l2i.T + t_l2i
