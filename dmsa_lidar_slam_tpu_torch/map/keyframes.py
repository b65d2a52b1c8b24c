"""Keyframe map problem adapter (counterpart of
dmsa_lidar_slam_tpu/map/keyframes.py): keyframe poses as a relative chain,
world point (k, j) = quat_rotate(q_k, x_kj) + t_k, gravity and odometry
residuals, and normal-based cell splitting.
"""

import dataclasses
from functools import lru_cache
from typing import NamedTuple

import torch

from dmsa_lidar_slam_tpu_torch.core import poses as cp
from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.dmsa.optimizer import ForwardOut, TabularProblem

GRAVITY_W = (0.0, 0.0, -9.805)  # MapManagement.h:64
STD_DEV_ACC = 0.3  # MapManagement.h:48
ODOM_STD = 0.01  # MapManagement.h:69-70


@dataclasses.dataclass(frozen=True)
class MapShapes:
    n_keyframes: int
    n_pts_per_kf: int


class KeyframeMapData(NamedTuple):
    local_pts: torch.Tensor  # [K, P, 3] f32
    local_normals: torch.Tensor  # [K, P, 3] f32
    pt_mask: torch.Tensor  # [K, P]
    pt_ring: torch.Tensor  # [K, P]
    grid_size: torch.Tensor  # [K] f32
    kf_mask: torch.Tensor  # [K]
    anchor_orient: torch.Tensor  # [3] f64
    anchor_transl: torch.Tensor  # [3]
    stamps: torch.Tensor  # [K] f64
    grav_meas: torch.Tensor  # [K, 3]
    grav_plausible: torch.Tensor  # [K]
    odom_rel_transl: torch.Tensor  # [K, 3]
    odom_rel_orient: torch.Tensor  # [K, 3]
    gravity: torch.Tensor  # [3]
    cov_grav_inv: torch.Tensor  # [3, 3]
    odom_transl_cov_inv: torch.Tensor  # [3, 3]
    odom_orient_cov_inv: torch.Tensor  # [3, 3]
    balancing_grav: torch.Tensor  # []
    balancing_odom: torch.Tensor  # []


def normal_split_ids(normals_w):
    """Bucket world normals into 6 direction classes (dominant axis x sign)."""
    ax = torch.argmax(torch.abs(normals_w), dim=-1)
    comp = torch.where(
        ax == 0, normals_w[..., 0], torch.where(ax == 1, normals_w[..., 1], normals_w[..., 2])
    )
    return (ax * 2 + (comp > 0.0).to(ax.dtype)).to(torch.int32)


def global_chain(params, data: KeyframeMapData, shapes: MapShapes):
    z = torch.zeros(shapes.n_keyframes - 1, 3, dtype=data.anchor_orient.dtype, device=params.device)
    anchor = cp.PoseChain(
        orient=torch.cat([data.anchor_orient[None], z]), transl=torch.cat([data.anchor_transl[None], z])
    )
    chain = cp.chain_from_params(params, anchor)
    return chain, cp.relative2global(chain)


def _extras(chain, gp, data, use_gravity, use_odometry, params):
    extras = []
    if use_gravity:
        extras.append(gravity_residuals(gp, data))
    if use_odometry:
        extras.append(odometry_residuals(chain, data))
    if extras:
        return torch.cat(extras)
    return torch.zeros(0, dtype=params.dtype, device=params.device)


def _kf_tables(params, data, shapes, use_gravity, use_odometry):
    chain, gp = global_chain(params, data, shapes)
    q = rot.axang2quat(gp.orient)
    extra = _extras(chain, gp, data, use_gravity, use_odometry, params)
    pad = torch.zeros(shapes.n_keyframes, 1, dtype=q.dtype, device=q.device)
    tab = torch.cat([q, gp.transl, pad], dim=1).to(torch.float32)
    ident = torch.zeros(1, 8, dtype=torch.float32, device=tab.device)
    ident[0, 0] = 1.0
    return torch.cat([tab, ident], dim=0), extra


def _kf_point_arrays(data, shapes):
    s, ppk = shapes.n_keyframes, shapes.n_pts_per_kf
    xs = data.local_pts.reshape(-1, 3).to(torch.float32)
    tidx = torch.arange(s, device=xs.device).repeat_interleave(ppk)
    return xs, tidx


@lru_cache(maxsize=None)
def make_forward(shapes: MapShapes, use_gravity: bool, use_odometry: bool, use_split: bool):
    """ForwardOut function for keyframe/submap optimization."""

    def forward(params, data: KeyframeMapData) -> ForwardOut:
        chain, gp = global_chain(params, data, shapes)
        q = rot.axang2quat(gp.orient).to(torch.float32)[:, None, :]
        t = gp.transl.to(torch.float32)
        pts_w = rot.quat_rotate(q, data.local_pts) + t[:, None, :]
        mask = data.pt_mask & data.kf_mask[:, None]
        extra = _extras(chain, gp, data, use_gravity, use_odometry, params)
        split = None
        if use_split:
            split = normal_split_ids(rot.quat_rotate(q, data.local_normals).reshape(-1, 3))
        return ForwardOut(
            points=pts_w.reshape(-1, 3),
            mask=mask.reshape(-1),
            ring_ids=data.pt_ring.reshape(-1),
            extra=extra,
            split_ids=split,
        )

    return forward


@lru_cache(maxsize=None)
def make_tabular(shapes: MapShapes, use_gravity: bool, use_odometry: bool) -> TabularProblem:
    """The keyframe problem in table form: one table row per keyframe pose
    (plus the unused identity row, so both problems share the kernels)."""
    return TabularProblem(
        n_table=shapes.n_keyframes + 1,
        tables=lambda params, data: _kf_tables(params, data, shapes, use_gravity, use_odometry),
        point_arrays=lambda data: _kf_point_arrays(data, shapes),
    )


def gravity_residuals(gp: cp.GlobalPoses, data: KeyframeMapData):
    """Gravity error terms (updateGravityErrors, MapManagement.h:210-232)."""
    R = rot.axang2rotm(gp.orient)
    diff = torch.einsum("kij,kj->ki", R, data.grav_meas.to(gp.orient.dtype)) - data.gravity[None, :]
    quad = torch.einsum("ki,ij,kj->k", diff, data.cov_grav_inv, diff) * data.balancing_grav
    k_idx = torch.arange(gp.orient.shape[0], device=gp.orient.device)
    active = (k_idx > 0) & data.grav_plausible & data.kf_mask
    return torch.where(active, torch.sqrt(torch.abs(quad) + 1e-30), torch.zeros_like(quad))


def odometry_residuals(chain: cp.PoseChain, data: KeyframeMapData):
    """Odometry error terms (updateOdometryErrors, MapManagement.h:234-252)."""
    pdt = chain.orient.dtype
    transl_diff = data.odom_rel_transl[1:].to(pdt) - chain.transl[1:]
    R_cur = rot.axang2rotm(chain.orient[1:])
    R_prior = rot.axang2rotm(data.odom_rel_orient[1:].to(pdt))
    orient_diff = rot.rotm2axang(torch.einsum("kji,kjl->kil", R_cur, R_prior))
    quad = torch.einsum("ki,ij,kj->k", transl_diff, data.odom_transl_cov_inv, transl_diff)
    quad = quad + torch.einsum("ki,ij,kj->k", orient_diff, data.odom_orient_cov_inv, orient_diff)
    quad = quad * data.balancing_odom
    return torch.where(data.kf_mask[1:], torch.sqrt(torch.abs(quad) + 1e-30), torch.zeros_like(quad))
