"""Static-point selection, visibility and overlap for the sliding window
(counterpart of dmsa_lidar_slam_tpu/map/static_points.py).

Both nearest-neighbour queries go through kernel K4
(ops.nn_bruteforce.has_neighbor_within).
"""

from typing import NamedTuple

import torch

from bench_port.reference.ops import nn_bruteforce, voxel


class StaticSelection(NamedTuple):
    static_pts: torch.Tensor  # [cap, 3] world frame
    static_mask: torch.Tensor  # [cap]
    static_ring: torch.Tensor  # [cap]
    overlap_counts: torch.Tensor  # [S] selected points per candidate keyframe
    overlap_fraction: torch.Tensor  # [] window-vs-static overlap ratio
    num_selected: torch.Tensor  # []
    num_active: torch.Tensor  # []


def visibility(curr_pos, points, normals):
    """Plane-based visibility test (isVisible, DmsaSlam.h:360-375)."""
    d = torch.sum(points * normals, dim=-1)
    r = torch.sum(normals * curr_pos, dim=-1)
    return (r - d) >= -1e-5


def select_static_points(
    window_pts,  # [NW, 3] current global window points
    window_mask,  # [NW]
    kf_pts,  # [S, P, 3] candidate keyframes' global clouds
    kf_normals,  # [S, P, 3]
    kf_rings,  # [S, P]
    kf_pt_mask,  # [S, P]
    curr_pos,  # [3] f32
    min_grid,  # [] f32
    prio,  # [S*P] int32 random priorities for the downsampling
    cap: int,
) -> StaticSelection:
    S, P, _ = kf_pts.shape
    q = kf_pts.reshape(-1, 3)
    qm = kf_pt_mask.reshape(-1)
    near = nn_bruteforce.has_neighbor_within(window_pts, window_mask, q, qm, min_grid)
    vis = visibility(curr_pos, kf_pts, kf_normals).reshape(-1)
    selected = near & vis & qm

    overlap_counts = torch.sum(selected.reshape(S, P), dim=1)
    num_selected = torch.sum(selected)

    keep = voxel.random_downsample_mask(q, selected, min_grid / 2.0, prio)
    num_active = torch.sum(keep)
    idx, out_mask = voxel.compact(keep, cap)
    static_pts = q[idx]
    static_ring = kf_rings.reshape(-1)[idx]

    near_w = (
        nn_bruteforce.has_neighbor_within(static_pts, out_mask, window_pts, window_mask, min_grid)
        & window_mask
    )
    frac = torch.sum(near_w) / torch.clamp(torch.sum(window_mask), min=1)
    overlap_fraction = torch.where(num_active > 0, frac, torch.zeros_like(frac))
    return StaticSelection(
        static_pts=static_pts,
        static_mask=out_mask,
        static_ring=static_ring,
        overlap_counts=overlap_counts,
        overlap_fraction=overlap_fraction,
        num_selected=num_selected,
        num_active=num_active,
    )
