"""Normal estimation (counterpart of dmsa_lidar_slam_tpu/map/normals.py).

Per point: the covariance of its neighbourhood, normal = eigenvector of the
smallest eigenvalue, flipped toward the viewpoint; points with fewer than 3
valid neighbours get (0, 0, 1).  Two neighbourhoods, chosen by device as
the reference chooses by backend:

  - CUDA tensors: every valid point within 2 * grid_size (kernel K5,
    ops.nn_bruteforce.radius_neighbor_moments), the reference's accelerator
    path (normals.py:39-43);
  - CPU tensors: the exact 6 nearest neighbours on the hash grid, the
    reference's path off its accelerator (kSearch(6), DmsaSlam.h:557-568).
"""

import torch

from dmsa_lidar_slam_tpu_torch.ops import knn
from dmsa_lidar_slam_tpu_torch.ops import nn_bruteforce as nb
from dmsa_lidar_slam_tpu_torch.ops.eig3 import smallest_eigvec_sym3

K_NEIGHBORS = 6  # DmsaSlam.h:565


def estimate_normals(points, mask, grid_size, viewpoint=None, k: int = K_NEIGHBORS, cap: int = 8):
    """Normals [N, 3] f32 for a voxel-downsampled cloud."""
    if points.is_cuda:
        return radius_normals(points, mask, grid_size, viewpoint)
    grid = knn.build_grid(points, mask, 2.0 * grid_size)
    idx, d2, valid = knn.knn_indices(grid, points, mask, k, cap=cap)
    neigh = grid.sorted_pts[idx]  # [N, k, 3]
    w = valid.to(points.dtype)
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    mean = torch.sum(neigh * w[:, :, None], dim=1) / cnt[:, None]
    d = (neigh - mean[:, None, :]) * w[:, :, None]
    cov = torch.einsum("nki,nkj->nij", d, d) / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]
    return _oriented_normals(points, mask, cov, torch.sum(w, dim=1), viewpoint)


def radius_normals(points, mask, grid_size, viewpoint=None):
    """The radius-moment branch: neighbours within 2 * grid_size (K5 on
    CUDA tensors, its plain version on CPU tensors)."""
    cnt, _, cov = nb.radius_neighbor_moments(points.to(torch.float32), mask, 2.0 * grid_size)
    return _oriented_normals(points, mask, cov, cnt, viewpoint)


def _oriented_normals(points, mask, cov, n_neigh, viewpoint):
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=points.dtype, device=points.device)
    normal = smallest_eigvec_sym3(cov)
    to_vp = viewpoint[None, :] - points
    flip = torch.sum(normal * to_vp, dim=1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    default = torch.zeros_like(normal)
    default[:, 2] = 1.0
    normal = torch.where((n_neigh < 3.0)[:, None], default, normal)
    return torch.where(mask[:, None], normal, default).to(torch.float32)
