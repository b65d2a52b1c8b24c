"""Continuous-time sliding-window trajectory — the window problem adapter
(counterpart of dmsa_lidar_slam_tpu/trajectory/continuous.py).

A handful of control poses over the window, a dense pose table of fixed
length n_dense (barycentric-rational translations, slerped orientations),
per-point table indices, IMU preintegration factors between control poses,
IMU residuals and gravity initialization.  Pose math in f64; the per-point
transform in f32.
"""

import dataclasses
from functools import lru_cache
from typing import NamedTuple

import torch

from bench_port.reference.core import interpolation as interp
from bench_port.reference.core import poses as cp
from bench_port.reference.core import rotations as rot
from bench_port.reference.dmsa.optimizer import ForwardOut, TabularProblem
from bench_port.reference.imu import preintegration as preint_mod

GRAVITY_W = (0.0, 0.0, -9.805)  # ContinuousTrajectory.h:345


@dataclasses.dataclass(frozen=True)
class WindowShapes:
    n_window_pts: int
    n_static: int
    n_ctrl: int = 6
    n_dense: int = 501

    def __post_init__(self):
        assert (self.n_dense - 1) % (self.n_ctrl - 1) == 0, "control stamps must land on dense samples"

    @property
    def interval_len(self) -> int:
        return (self.n_dense - 1) // (self.n_ctrl - 1)

    @property
    def param_indices(self):
        return tuple(k * self.interval_len for k in range(self.n_ctrl))


class WindowData(NamedTuple):
    local_pts: torch.Tensor  # [NW, 3] f32 IMU/body frame
    pt_mask: torch.Tensor  # [NW]
    pt_ring: torch.Tensor  # [NW] i32
    pt_tform_idx: torch.Tensor  # [NW] dense-table index
    static_pts: torch.Tensor  # [NS, 3] f32 world
    static_mask: torch.Tensor  # [NS]
    static_ring: torch.Tensor  # [NS]
    anchor_orient: torch.Tensor  # [3] f64
    anchor_transl: torch.Tensor  # [3]
    ctrl_stamps: torch.Tensor  # [C]
    dt: torch.Tensor  # []
    horizon: torch.Tensor  # []
    acc_dense: torch.Tensor  # [D, 3]
    gyr_dense: torch.Tensor  # [D, 3]
    gravity: torch.Tensor  # [3]
    preint_rot: torch.Tensor  # [C-1, 3, 3]
    preint_vel: torch.Tensor  # [C-1, 3]
    preint_pos: torch.Tensor  # [C-1, 3]
    cov_inv: torch.Tensor  # [C-1, 9, 9]
    preint_pos_full: torch.Tensor  # [3]
    balancing_imu: torch.Tensor  # []


def ctrl_stamps_from_dt(dt, shapes: WindowShapes):
    idx = torch.tensor(shapes.param_indices, dtype=dt.dtype, device=dt.device)
    return idx * dt


@lru_cache(maxsize=None)
def _uniform_consts_np(shapes: WindowShapes):
    return interp.uniform_grid_consts(shapes.n_dense, shapes.n_ctrl, shapes.interval_len, d=2)


_CONST_CACHE = {}


def _uniform_consts(shapes: WindowShapes, dtype, device):
    key = (shapes, dtype, str(device))
    if key not in _CONST_CACHE:
        A, left, right, u = _uniform_consts_np(shapes)
        _CONST_CACHE[key] = (
            torch.as_tensor(A, dtype=dtype, device=device),
            torch.as_tensor(left, device=device),
            torch.as_tensor(right, device=device),
            torch.as_tensor(u, dtype=dtype, device=device),
        )
    return _CONST_CACHE[key]


def _full_anchor(anchor_orient, anchor_transl, n):
    z = torch.zeros(n - 1, 3, dtype=anchor_orient.dtype, device=anchor_orient.device)
    return cp.PoseChain(
        orient=torch.cat([anchor_orient[None], z]), transl=torch.cat([anchor_transl[None], z])
    )


def dense_pose_tables(params, data: WindowData, shapes: WindowShapes):
    """Control chain -> dense pose table: (chain, gp, q_dense [D,4],
    d_transl [D,3]) with the dt-invariant constant interpolation operators."""
    chain = cp.chain_from_params(params, _full_anchor(data.anchor_orient, data.anchor_transl, shapes.n_ctrl))
    gp = cp.relative2global(chain)
    A, left, right, u = _uniform_consts(shapes, gp.transl.dtype, gp.transl.device)
    d_transl = A @ gp.transl
    q = rot.axang2quat(gp.orient)
    q_dense = rot.quat_slerp(q[left], q[right], u)
    return chain, gp, q_dense, d_transl


def dense_poses(params, data: WindowData, shapes: WindowShapes):
    """As dense_pose_tables with dense orientations as axis-angle [D, 3]
    (the reference's dense_poses and dense_poses_jit)."""
    chain, gp, q_dense, d_transl = dense_pose_tables(params, data, shapes)
    return chain, gp, rot.quat2axang(q_dense), d_transl


def _identity_row(device):
    ident = torch.zeros(1, 8, dtype=torch.float32, device=device)
    ident[0, 0] = 1.0
    return ident


def _window_tables(params, data, shapes, use_imu):
    chain, gp, q_dense, d_transl = dense_pose_tables(params, data, shapes)
    if use_imu:
        extra = imu_residuals(chain, gp, d_transl, data, shapes)
    else:
        extra = torch.zeros(0, dtype=params.dtype, device=params.device)
    pad = torch.zeros(shapes.n_dense, 1, dtype=q_dense.dtype, device=q_dense.device)
    tab = torch.cat([q_dense, d_transl, pad], dim=1).to(torch.float32)
    return torch.cat([tab, _identity_row(tab.device)], dim=0), extra


def _window_point_arrays(data: WindowData, shapes: WindowShapes):
    xs = torch.cat([data.local_pts, data.static_pts], dim=0).to(torch.float32)
    tidx = torch.cat(
        [
            data.pt_tform_idx.to(torch.int64),
            torch.full((shapes.n_static,), shapes.n_dense, dtype=torch.int64, device=xs.device),
        ]
    )
    return xs, tidx


@lru_cache(maxsize=None)
def make_forward(shapes: WindowShapes, use_imu: bool):
    """ForwardOut function of the window problem."""

    def forward(params, data: WindowData) -> ForwardOut:
        tab, extra = _window_tables(params, data, shapes, use_imu)
        xs, tidx = _window_point_arrays(data, shapes)
        pts = rot.quat_rotate(tab[tidx, 0:4], xs) + tab[tidx, 4:7]
        mask = torch.cat([data.pt_mask, data.static_mask])
        rings = torch.cat([data.pt_ring, data.static_ring])
        return ForwardOut(points=pts, mask=mask, ring_ids=rings, extra=extra)

    return forward


@lru_cache(maxsize=None)
def make_tabular(shapes: WindowShapes, use_imu: bool) -> TabularProblem:
    """The window problem in table form: point j = quat_rotate(q_dense[idx_j],
    x_j) + t_dense[idx_j]; static map points on the trailing identity row."""
    return TabularProblem(
        n_table=shapes.n_dense + 1,
        tables=lambda params, data: _window_tables(params, data, shapes, use_imu),
        point_arrays=lambda data: _window_point_arrays(data, shapes),
    )


def imu_residuals(chain, gp, d_transl, data: WindowData, shapes: WindowShapes):
    """IMU factor errors between consecutive control poses
    (updateImuError, ContinuousTrajectory.h:603-663).  Returns [C-1]."""
    pi = torch.tensor(shapes.param_indices, dtype=torch.int64, device=d_transl.device)
    one_div = 1.0 / data.dt
    R_start = rot.axang2rotm(gp.orient[:-1])
    delta_t = data.ctrl_stamps[1:] - data.ctrl_stamps[:-1]
    v_start = one_div * (d_transl[pi[:-1] + 1] - d_transl[pi[:-1]])
    v_end = one_div * (d_transl[pi[1:]] - d_transl[pi[1:] - 1])
    dp_world = (
        gp.transl[1:]
        - gp.transl[:-1]
        - v_start * delta_t[:, None]
        - 0.5 * delta_t[:, None] ** 2 * data.gravity[None, :]
    )
    pos_error = torch.einsum("kji,kj->ki", R_start, dp_world) - data.preint_pos
    R_rel = rot.axang2rotm(chain.orient[1:])
    rot_error = rot.rotm2axang(torch.einsum("kji,kjl->kil", data.preint_rot, R_rel))
    dv_world = v_end - v_start - data.gravity[None, :] * delta_t[:, None]
    vel_error = torch.einsum("kji,kj->ki", R_start, dv_world) - data.preint_vel
    combined = torch.cat([rot_error, vel_error, pos_error], dim=1)
    quad = torch.einsum("ki,kij,kj->k", combined, data.cov_inv, combined)
    return torch.sqrt(torch.abs(quad * data.balancing_imu) + 1e-30)


def compute_preint_factors(gyr_dense, acc_dense, dt, cov_gyr, cov_acc, shapes: WindowShapes):
    """Preintegrate every control interval and the full horizon
    (updatePreintFactors, ContinuousTrajectory.h:520-568)."""
    L = shapes.interval_len
    K = shapes.n_ctrl - 1
    st = preint_mod.preintegrate_intervals(
        gyr_dense[: K * L].reshape(K, L, 3), acc_dense[: K * L].reshape(K, L, 3), dt, cov_gyr, cov_acc
    )
    cov_inv = torch.linalg.inv(st.cov)
    full = preint_mod.preintegrate(gyr_dense, acc_dense, dt, cov_gyr, cov_acc)
    return st.delta_rot, st.delta_vel, st.delta_pos, cov_inv, full.delta_pos


def init_gravity_anchor_orientation(acc_first, gravity):
    """Gravity-direction init (initGravityDir, ContinuousTrajectory.h:263-299)."""
    R_to_grav = rot.rodrigues_between(gravity, -acc_first)
    return rot.rotm2axang(R_to_grav.T)


def submap_gravity_estimate(gp, d_transl, data: WindowData, shapes: WindowShapes):
    """Gravity in the IMU frame of the window start
    (getSubmapGravityEstimate, ContinuousTrajectory.h:593-601)."""
    v_start_w = (d_transl[1] - d_transl[0]) / data.dt
    R_start = rot.axang2rotm(gp.orient[0])
    num = R_start.T @ (gp.transl[-1] - gp.transl[0] - v_start_w * data.horizon) - data.preint_pos_full
    return num / (0.5 * data.horizon**2)


def centralize(data: WindowData):
    """Move the anchor translation to the origin, shift static points."""
    origin = data.anchor_transl
    data = data._replace(
        anchor_transl=torch.zeros_like(origin),
        static_pts=data.static_pts - origin.to(data.static_pts.dtype)[None, :],
    )
    return data, origin


def decentralize(data: WindowData, origin):
    return data._replace(
        anchor_transl=origin,
        static_pts=data.static_pts + origin.to(data.static_pts.dtype)[None, :],
    )
