"""On-manifold IMU preintegration (Forster et al., RSS'15), bias-free
(counterpart of dmsa_lidar_slam_tpu/imu/preintegration.py).

The per-sample recursion is reduced with a log-depth inclusive scan over
the semidirect-product monoid of (dR, dv, dp, T) and over the covariance
pairs (A, Q): ceil(log2 T) batched rounds, not a T-step loop of launches.
State ordering [rot, vel, pos] blocks of 3, as the reference.
"""

from typing import NamedTuple

import torch

from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.core.poses import inclusive_scan


class PreintState(NamedTuple):
    delta_rot: torch.Tensor  # [..., 3, 3]
    delta_vel: torch.Tensor  # [..., 3]
    delta_pos: torch.Tensor  # [..., 3]
    cov: torch.Tensor  # [..., 9, 9]


def right_jacobian(aa):
    """Right Jacobian of SO(3), series-safe."""
    theta2 = torch.sum(aa * aa, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    K = rot.skew(aa)
    KK = K @ K
    small = theta2 < 1e-10
    c1 = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    c2 = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-30),
    )
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye - c1[..., None, None] * K + c2[..., None, None] * KK


def preintegrate(omega, acc, dt, cov_gyr, cov_acc) -> PreintState:
    """Integrate [..., T, 3] gyro/accel runs with constant step dt; leading
    dims are batch (e.g. the control intervals of a window)."""
    dtype, dev = omega.dtype, omega.device
    T = omega.shape[-2]
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    rot_incr = rot.axang2rotm(dt * omega)  # [..., T, 3, 3]
    dv_loc = acc * dt
    dp_loc = 0.5 * acc * dt * dt
    seg_t = dt.expand(omega.shape[:-1])
    tdim = omega.dim() - 2

    def combine(s1, s2):
        R1, v1, p1, t1 = s1
        R2, v2, p2, t2 = s2
        R = R1 @ R2
        v = v1 + (R1 @ v2[..., None])[..., 0]
        p = p1 + v1 * t2[..., None] + (R1 @ p2[..., None])[..., 0]
        return R, v, p, t1 + t2

    Rp, vp, pp, _ = inclusive_scan(combine, (rot_incr, dv_loc, dp_loc, seg_t), dim=tdim)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    lead = omega.shape[:-2]
    dR_before = torch.cat([eye3.expand(*lead, 1, 3, 3), Rp[..., :-1, :, :]], dim=-3)

    dt2 = dt * dt
    dRsa = dR_before @ rot.skew(acc)
    Z = torch.zeros(*lead, T, 3, 3, dtype=dtype, device=dev)
    I = eye3.expand(*lead, T, 3, 3)
    A = torch.cat(
        [
            torch.cat([rot_incr.transpose(-1, -2), Z, Z], dim=-1),
            torch.cat([-dRsa * dt, I, Z], dim=-1),
            torch.cat([-0.5 * dRsa * dt2, I * dt, I], dim=-1),
        ],
        dim=-2,
    )  # [..., T, 9, 9]
    Jr = right_jacobian(rot.rotm2axang(dR_before)) * dt
    B = torch.cat(
        [
            torch.cat([Jr, Z], dim=-1),
            torch.cat([Z, dR_before * dt], dim=-1),
            torch.cat([Z, 0.5 * dR_before * dt2], dim=-1),
        ],
        dim=-2,
    )  # [..., T, 9, 6]
    noise = torch.zeros(6, 6, dtype=dtype, device=dev)
    noise[0:3, 0:3] = cov_gyr
    noise[3:6, 3:6] = cov_acc
    Q = B @ noise @ B.transpose(-1, -2)

    def combine_cov(a, b):
        A1, Q1 = a
        A2, Q2 = b
        return A2 @ A1, A2 @ Q1 @ A2.transpose(-1, -2) + Q2

    _, Q_all = inclusive_scan(combine_cov, (A, Q), dim=tdim)
    return PreintState(
        delta_rot=Rp[..., -1, :, :],
        delta_vel=vp[..., -1, :],
        delta_pos=pp[..., -1, :],
        cov=Q_all[..., -1, :, :],
    )


def preintegrate_intervals(omega, acc, dt, cov_gyr, cov_acc) -> PreintState:
    """Batch-preintegrate [K, T, 3] interval runs -> PreintState with
    leading dim K."""
    return preintegrate(omega, acc, dt, cov_gyr, cov_acc)


def dead_reckon_controls(axang0, pos0, vel0, preint: PreintState, delta_t, gravity):
    """Forward dead-reckoning across control intervals from preint factors.
    Returns global axis-angles [K+1, 3] and positions [K+1, 3]."""
    R = rot.axang2rotm(axang0)
    p, v = pos0, vel0
    aa_seq, p_seq = [axang0], [pos0]
    for k in range(delta_t.shape[0]):
        dtk = delta_t[k]
        p_new = p + v * dtk + 0.5 * gravity * dtk**2 + R @ preint.delta_pos[k]
        v = v + gravity * dtk + R @ preint.delta_vel[k]
        R = R @ preint.delta_rot[k]
        p = p_new
        aa_seq.append(rot.rotm2axang(R))
        p_seq.append(p)
    return torch.stack(aa_seq), torch.stack(p_seq)
