"""Closed-form symmetric 3x3 spectral functions (counterpart of
dmsa_lidar_slam_tpu/ops/eig3.py).

Eigenvalues by the trigonometric closed form; matrix functions g(A) by the
Newton-form spectral polynomial
    g(A) = dd1 I + dd12 (A - l1 I) + dd123 (A - l1 I)(A - l2 I)
with divided differences that fall back to derivatives when eigenvalues
(nearly) coincide.  Packed symmetric order: 00, 01, 02, 11, 12, 22.
"""

import math

import torch

_EPS = 1e-12


def _where(c, a, b):
    return torch.where(c, a, b)


def sym_eigvals3(A):
    """Eigenvalues of symmetric [..., 3, 3], descending [..., 3]."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    iso = p2 < _EPS
    return torch.stack([_where(iso, q, l1), _where(iso, q, l2), _where(iso, q, l3)], dim=-1)


def sym_eigvals6(a):
    """Eigenvalues of packed symmetric [..., 6], descending [..., 3]."""
    a00, a01, a02, a11, a12, a22 = a.unbind(-1)
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    detB = b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02) + a02 * (a01 * a12 - b11 * a02)
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    iso = p2 < _EPS
    return torch.stack([_where(iso, q, l1), _where(iso, q, l2), _where(iso, q, l3)], dim=-1)


def _floor_fns(floor):
    """Hard eigenvalue floor g(x) = 1/max(x, floor) and its derivatives."""
    m = floor

    def g(x):
        return 1.0 / torch.clamp(x, min=m)

    def dg(x):
        return _where(x > m, -1.0 / torch.clamp(x * x, min=_EPS), torch.zeros_like(x))

    def d2g(x):
        return _where(x > m, 2.0 / torch.clamp(x * x * x, min=_EPS), torch.zeros_like(x))

    return g, dg, d2g


def _divided_diff(g, dg, a, b):
    diff = a - b
    small = torch.abs(diff) < 1e-6
    safe = _where(small, torch.ones_like(diff), diff)
    return _where(small, dg(0.5 * (a + b)), (g(a) - g(b)) / safe)


def _newton_coeffs(lam, g, dg, d2g):
    l1, l2, l3 = lam.unbind(-1)
    dd1 = g(l1)
    dd12 = _divided_diff(g, dg, l1, l2)
    dd23 = _divided_diff(g, dg, l2, l3)
    diff13 = l1 - l3
    small13 = torch.abs(diff13) < 1e-6
    safe13 = _where(small13, torch.ones_like(diff13), diff13)
    dd123 = _where(small13, 0.5 * d2g((l1 + l3) * 0.5), (dd12 - dd23) / safe13)
    return l1, l2, dd1, dd12, dd123


def matrix_function_sym3(A, g, dg, d2g):
    l1, l2, dd1, dd12, dd123 = _newton_coeffs(sym_eigvals3(A), g, dg, d2g)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    A1 = A - l1[..., None, None] * eye
    A2 = A - l2[..., None, None] * eye
    out = dd1[..., None, None] * eye + dd12[..., None, None] * A1 + dd123[..., None, None] * (A1 @ A2)
    return 0.5 * (out + out.transpose(-1, -2))


def floored_inverse_sym3(A, floor):
    """V diag(1/max(lambda, floor)) V^T without computing V."""
    return matrix_function_sym3(A, *_floor_fns(floor))


def floored_inverse_sym6(a, floor):
    """Packed twin of floored_inverse_sym3: [..., 6] -> [..., 6]."""
    l1, l2, dd1, dd12, dd123 = _newton_coeffs(sym_eigvals6(a), *_floor_fns(floor))
    a00, a01, a02, a11, a12, a22 = a.unbind(-1)
    p00, p11, p22 = a00 - l1, a11 - l1, a22 - l1
    q00, q11, q22 = a00 - l2, a11 - l2, a22 - l2
    r00 = p00 * q00 + a01 * a01 + a02 * a02
    r01 = p00 * a01 + a01 * q11 + a02 * a12
    r02 = p00 * a02 + a01 * a12 + a02 * q22
    r11 = a01 * a01 + p11 * q11 + a12 * a12
    r12 = a01 * a02 + p11 * a12 + a12 * q22
    r22 = a02 * a02 + a12 * a12 + p22 * q22
    return torch.stack(
        [
            dd12 * p00 + dd123 * r00 + dd1,
            dd12 * a01 + dd123 * r01,
            dd12 * a02 + dd123 * r02,
            dd12 * p11 + dd123 * r11 + dd1,
            dd12 * a12 + dd123 * r12,
            dd12 * p22 + dd123 * r22 + dd1,
        ],
        dim=-1,
    )


def pack_sym6(A):
    return torch.stack(
        [A[..., 0, 0], A[..., 0, 1], A[..., 0, 2], A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]], dim=-1
    )


def sym6_matvec(a, v):
    """Packed symmetric [..., 6] times vector [..., 3] -> [..., 3]."""
    a00, a01, a02, a11, a12, a22 = a.unbind(-1)
    x, y, z = v.unbind(-1)
    return torch.stack(
        [a00 * x + a01 * y + a02 * z, a01 * x + a11 * y + a12 * z, a02 * x + a12 * y + a22 * z], dim=-1
    )


def smallest_eigvec_sym3(A):
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3]:
    the largest cross product of two rows of A - lam_min I; isotropic
    inputs fall back to +z."""
    lam_min = sym_eigvals3(A)[..., 2]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - lam_min[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    cands = torch.stack(
        [torch.linalg.cross(r0, r1, dim=-1), torch.linalg.cross(r1, r2, dim=-1), torch.linalg.cross(r2, r0, dim=-1)],
        dim=-2,
    )
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    ok = nrm[..., 0] > 1e-20
    return _where(ok[..., None], v / _where(ok[..., None], nrm, torch.ones_like(nrm)), fallback)
