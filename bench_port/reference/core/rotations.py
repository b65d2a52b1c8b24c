"""Rotation primitives on axis-angle vectors (counterpart of
dmsa_lidar_slam_tpu/core/rotations.py).

Closed-form Rodrigues and quaternion-log forms; every function accepts
arbitrary leading batch dimensions and is safe under ``torch.func`` (no
data-dependent control flow), so the optimizer can take its table
Jacobian with ``jacfwd``.
"""

import torch

_EPS = 1e-12


def _cross(a, b):
    """a x b from separate multiplies and subtracts (no fused multiply-add),
    so the f32 point transforms round like the reference's."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def skew(v):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def axang2rotm(aa):
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues)."""
    theta2 = torch.sum(aa * aa, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    K = skew(aa)
    KK = K @ K
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * KK


def rotm2axang(R):
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3] (quaternion route)."""
    return quat2axang(rotm2quat(R))


def axang2quat(aa):
    """Axis-angle [..., 3] -> unit quaternion [..., 4] (w, x, y, z)."""
    theta2 = torch.sum(aa * aa, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    half = 0.5 * theta
    small = theta2 < 1e-12
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    xyz = aa * k[..., None]
    return torch.cat([w[..., None], xyz], dim=-1)


def quat_rotate(q, v):
    """Rotate v [..., 3] by unit quaternions q [..., 4]:
    v' = v + w t + u x t with u = q.xyz, t = 2 (u x v)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def quat_rotate_vjp_q(q, v, g):
    """Cotangent of quat_rotate wrt q for output cotangent g: [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v, g = torch.broadcast_tensors(u, v, g)
    t = 2.0 * _cross(u, v)
    aw = torch.sum(g * t, dim=-1, keepdim=True)
    au = 2.0 * w * _cross(v, g) + _cross(t, g) + 2.0 * _cross(v, _cross(g, u))
    return torch.cat([aw, au], dim=-1)


def quat2axang(q):
    """Quaternion [..., 4] (w, x, y, z) -> axis-angle [..., 3]."""
    q = q * torch.sign(q[..., :1] + _EPS)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-9
    scale = torch.where(
        small,
        2.0 / torch.clamp(w, min=0.5),
        theta / torch.where(small, torch.ones_like(vnorm), vnorm),
    )
    return v * scale[..., None]


def rotm2quat(R):
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (branch-free
    Shepperd-style selection, as the reference)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw_ = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) / 2.0
    qx_ = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) / 2.0
    qy_ = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) / 2.0
    qz_ = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) / 2.0

    c0 = torch.stack([qw_, (m21 - m12) / (4 * qw_ + _EPS), (m02 - m20) / (4 * qw_ + _EPS), (m10 - m01) / (4 * qw_ + _EPS)], dim=-1)
    c1 = torch.stack([(m21 - m12) / (4 * qx_ + _EPS), qx_, (m01 + m10) / (4 * qx_ + _EPS), (m02 + m20) / (4 * qx_ + _EPS)], dim=-1)
    c2 = torch.stack([(m02 - m20) / (4 * qy_ + _EPS), (m01 + m10) / (4 * qy_ + _EPS), qy_, (m12 + m21) / (4 * qy_ + _EPS)], dim=-1)
    c3 = torch.stack([(m10 - m01) / (4 * qz_ + _EPS), (m02 + m20) / (4 * qz_ + _EPS), (m12 + m21) / (4 * qz_ + _EPS), qz_], dim=-1)

    cand = torch.stack([c0, c1, c2, c3], dim=-2)  # [..., 4, 4]
    pivots = torch.stack([qw_, qx_, qy_, qz_], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    sel = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(cand, -2, sel)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    """Hamilton product of quaternions [..., 4] (w, x, y, z)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def slerp(aa1, aa2, t):
    """Slerp between two axis-angle rotations; t=0 -> aa1, t=1 -> aa2."""
    return quat2axang(quat_slerp(axang2quat(aa1), axang2quat(aa2), t))


def quat_slerp(q1, q2, t):
    """Shortest-path slerp of unit quaternions with lerp fallback when close."""
    t = torch.as_tensor(t, dtype=q1.dtype, device=q1.device)
    dot = torch.sum(q1 * q2, dim=-1)
    q2 = torch.where(dot[..., None] < 0.0, -q2, q2)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    close = sin_theta < 1e-6
    safe = torch.where(close, torch.ones_like(sin_theta), sin_theta)
    w1 = torch.where(close, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w2 = torch.where(close, t, torch.sin(t * theta) / safe)
    q = w1[..., None] * q1 + w2[..., None] * q2
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rodrigues_between(v_from, v_to):
    """Rotation matrix taking direction v_from to v_to (Rodrigues)."""
    v1 = v_from / torch.linalg.norm(v_from, dim=-1, keepdim=True)
    v2 = v_to / torch.linalg.norm(v_to, dim=-1, keepdim=True)
    axis_raw = _cross(v1, v2)
    norm = torch.linalg.norm(axis_raw, dim=-1, keepdim=True)
    axis = axis_raw / torch.clamp(norm, min=_EPS)
    angle = torch.arccos(torch.clamp(torch.sum(v1 * v2, dim=-1), -1.0, 1.0))
    K = skew(axis)
    return (
        _eye_like(K)
        + torch.sin(angle)[..., None, None] * K
        + (1.0 - torch.cos(angle))[..., None, None] * (K @ K)
    )

