"""Keyframe map problem adapter (counterpart of
dmsa_lidar_slam_tpu/map/keyframes.py): keyframe poses as a relative chain,
world point (k, j) = quat_rotate(q_k, x_kj) + t_k, gravity and odometry
residuals, and normal-based cell splitting.
"""

import dataclasses
from functools import lru_cache, partial
from typing import NamedTuple, Optional

import torch

from dmsa_lidar_slam_tpu_torch.core import poses as cp
from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.dmsa.optimizer import ForwardOut, TabularProblem, tables_and_jacobian
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

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


def _table_forward(tab, extra, data: KeyframeMapData, shapes: MapShapes, use_split: bool) -> ForwardOut:
    """The forward at the table's params: each keyframe's points (and, with
    use_split, the split channel's normals) rotated and moved by its row."""
    xs, tidx = _kf_point_arrays(data, shapes)
    q = tab[tidx, 0:4]
    split = None
    if use_split:
        split = normal_split_ids(rot.quat_rotate(q, data.local_normals.reshape(-1, 3)))
    return ForwardOut(
        points=rot.quat_rotate(q, xs) + tab[tidx, 4:7],
        mask=(data.pt_mask & data.kf_mask[:, None]).reshape(-1),
        ring_ids=data.pt_ring.reshape(-1),
        extra=extra,
        split_ids=split,
    )


@lru_cache(maxsize=None)
def make_forward(shapes: MapShapes, use_gravity: bool, use_odometry: bool, use_split: bool):
    """ForwardOut function for keyframe/submap optimization."""

    def forward(params, data: KeyframeMapData) -> ForwardOut:
        return _table_forward(*_kf_tables(params, data, shapes, use_gravity, use_odometry), data, shapes, use_split)

    return forward


@lru_cache(maxsize=None)
def make_structured(shapes: MapShapes, use_gravity: bool, use_odometry: bool, use_split: bool):
    """Structured-Jacobian forward for the keyframe problem (see
    dmsa.optimizer): each point depends only on its keyframe's global pose
    (q_k, t_k), so the tables and their Jacobian come from keyframe_tables
    (K7 on the card, torch.func on the CPU) and the per-point contraction
    is a batched [Pp, 4] x [4, P] product per keyframe."""

    def structured(params, data: KeyframeMapData):
        tab, extra, dtab, j_extra = keyframe_tables(params, data, shapes, use_gravity, use_odometry)
        out = _table_forward(tab, extra, data, shapes, use_split)
        k, ppk, p_dim = shapes.n_keyframes, shapes.n_pts_per_kf, params.shape[0]
        q32 = tab[:k, None, 0:4]
        gq = dtab[:, :k, 0:4].permute(1, 2, 0).contiguous()  # [K, 4, P]
        gt = dtab[:, :k, 4:7].permute(1, 2, 0).contiguous()  # [K, 3, P]

        def contract(grad3_orig):
            g = grad3_orig.reshape(k, ppk, 3)
            aq = rot.quat_rotate_vjp_q(q32, data.local_pts, g)  # [K, Pp, 4]
            jp = torch.einsum("kpc,kcq->kpq", aq, gq) + torch.einsum("kpc,kcq->kpq", g, gt)
            return jp.reshape(k * ppk, p_dim)

        return out, contract, j_extra.T

    return structured


# K7 (csrc/k7_keyframe_tables.cu, a port-only kernel: the JAX package leaves
# this graph to XLA inside its jitted step): the tables of _kf_tables with
# their forward-mode Jacobian, and the same tables at the line search's
# candidates, one launch each for CUDA tensors; for CPU tensors the plain
# path the kernel replaces (the *_ref twins: torch.func's jacfwd and vmap
# over _kf_tables).  On the card the wrappers enqueue nothing but the launch
# and its output allocations, and never wait for the card.
K7_MAX_KF = 128  # keyframes the kernel takes (its shared-memory chain)


def _n_extra(shapes: MapShapes, use_gravity: bool, use_odometry: bool) -> int:
    s = shapes.n_keyframes
    return (s if use_gravity else 0) + (s - 1 if use_odometry else 0)


def keyframe_tables(params, data: KeyframeMapData, shapes: MapShapes, use_gravity: bool, use_odometry: bool):
    """(tab [S+1, 8] f32, extra [E] f64, dtab [P, S+1, 8] f32, j_extra
    [P, E] f64): the submap's tables at params [P] and their Jacobian;
    E = S with the gravity residuals plus S - 1 with the odometry ones."""
    if not params.is_cuda:
        return keyframe_tables_ref(params, data, shapes, use_gravity, use_odometry)
    p_dim, rows, e = params.shape[0], shapes.n_keyframes + 1, _n_extra(shapes, use_gravity, use_odometry)
    dev = params.device
    tab = torch.empty((rows, 8), dtype=torch.float32, device=dev)
    extra = torch.empty(e, dtype=torch.float64, device=dev)
    dtab = torch.empty((p_dim, rows, 8), dtype=torch.float32, device=dev)
    j_extra = torch.empty((p_dim, e), dtype=torch.float64, device=dev)
    _k7_launch(params, 0, data, shapes, use_gravity, use_odometry, tab, extra, dtab, j_extra)
    return tab, extra, dtab, j_extra


def keyframe_tables_batch(cand_params, data: KeyframeMapData, shapes: MapShapes, use_gravity: bool,
                          use_odometry: bool):
    """(tabs [K, S+1, 8] f32, extras [K, E] f64): the submap's tables at
    each row of cand_params [K, P]."""
    if not cand_params.is_cuda:
        return keyframe_tables_batch_ref(cand_params, data, shapes, use_gravity, use_odometry)
    k, dev = cand_params.shape[0], cand_params.device
    tabs = torch.empty((k, shapes.n_keyframes + 1, 8), dtype=torch.float32, device=dev)
    extras = torch.empty((k, _n_extra(shapes, use_gravity, use_odometry)), dtype=torch.float64, device=dev)
    _k7_launch(cand_params, k, data, shapes, use_gravity, use_odometry, tabs, extras, None, None)
    return tabs, extras


def keyframe_tables_ref(params, data: KeyframeMapData, shapes: MapShapes, use_gravity: bool, use_odometry: bool):
    return tables_and_jacobian(lambda p: _kf_tables(p, data, shapes, use_gravity, use_odometry), params)


def keyframe_tables_batch_ref(cand_params, data: KeyframeMapData, shapes: MapShapes, use_gravity: bool,
                              use_odometry: bool):
    return torch.func.vmap(lambda p: _kf_tables(p, data, shapes, use_gravity, use_odometry))(cand_params)


def _k7_launch(params, n_sets, data, shapes, use_gravity, use_odometry, tab, extra, dtab, j_extra):
    dev = params.device
    s = shapes.n_keyframes
    p_dim = 6 * (s - 1)
    if not 2 <= s <= K7_MAX_KF:
        raise ValueError(f"keyframe_tables: {s} keyframes, the kernel takes 2..{K7_MAX_KF}")
    params = params.contiguous()
    cuda_lib.require(params, "params", torch.float64, (n_sets, p_dim) if n_sets else (p_dim,), dev)
    f64, b8, grav, odom = torch.float64, torch.bool, use_gravity, use_odometry
    # (read, tensor, name, dtype, shape); the measurements and priors in the
    # pose dtype, as the residuals take them
    operands = [
        (True, data.anchor_orient, "anchor_orient", f64, (3,)),
        (True, data.anchor_transl, "anchor_transl", f64, (3,)),
        (grav or odom, data.kf_mask, "kf_mask", b8, (s,)),
        (grav, data.grav_plausible, "grav_plausible", b8, (s,)),
        (grav, data.grav_meas.to(f64), "grav_meas", f64, (s, 3)),
        (grav, data.gravity, "gravity", f64, (3,)),
        (grav, data.cov_grav_inv, "cov_grav_inv", f64, (3, 3)),
        (grav, data.balancing_grav, "balancing_grav", f64, ()),
        (odom, data.odom_rel_transl.to(f64), "odom_rel_transl", f64, (s, 3)),
        (odom, data.odom_rel_orient.to(f64), "odom_rel_orient", f64, (s, 3)),
        (odom, data.odom_transl_cov_inv, "odom_transl_cov_inv", f64, (3, 3)),
        (odom, data.odom_orient_cov_inv, "odom_orient_cov_inv", f64, (3, 3)),
        (odom, data.balancing_odom, "balancing_odom", f64, ()),
    ]
    keep, ptrs = [], []
    for read, t, name, dtype, shape in operands:
        if not read:  # a term the problem leaves out: the kernel reads none of its operands
            ptrs.append(None)
            continue
        t = t.contiguous()
        cuda_lib.require(t, name, dtype, shape, dev)
        keep.append(t)
        ptrs.append(t.data_ptr())
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["keyframe_tables"] += 1
    cuda_lib.check(
        cuda_lib.library().k7_keyframe_tables(
            P(params), n_sets, p_dim, s, int(use_gravity), int(use_odometry), *ptrs,
            P(tab), P(extra), None if dtab is None else P(dtab), None if j_extra is None else P(j_extra),
            cuda_lib.stream_ptr(dev),
        ),
        "k7_keyframe_tables",
    )


@lru_cache(maxsize=None)
def make_tabular(shapes: MapShapes, use_gravity: bool, use_odometry: bool,
                 use_split: Optional[bool] = None) -> TabularProblem:
    """The keyframe problem in table form: one table row per keyframe pose
    (plus the unused identity row, so both problems share the kernels).
    The tables with their Jacobian, and the line search's candidate tables,
    come from keyframe_tables / keyframe_tables_batch (K7 on the card,
    torch.func on the CPU).  With use_split a bool, the forward reads its
    points from the table (make_forward's, with or without the split
    channel); with None the optimizer calls its own forward function (one
    that adds observation weights, say)."""
    forward_tab = None if use_split is None else partial(_table_forward, shapes=shapes, use_split=use_split)
    return TabularProblem(
        n_table=shapes.n_keyframes + 1,
        tables=lambda params, data: _kf_tables(params, data, shapes, use_gravity, use_odometry),
        point_arrays=lambda data: _kf_point_arrays(data, shapes),
        tables_jac=lambda params, data: keyframe_tables(params, data, shapes, use_gravity, use_odometry),
        tables_batch=lambda cands, data: keyframe_tables_batch(cands, data, shapes, use_gravity, use_odometry),
        forward_tab=forward_tab,
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


def min_grid_size(data: KeyframeMapData):
    """Minimum grid size over active keyframes (MapManagement.h:126-131)."""
    return torch.min(torch.where(data.kf_mask, data.grid_size, torch.full_like(data.grid_size, float("inf"))))


def global_points(params, data: KeyframeMapData, shapes: MapShapes):
    """Assembled global map with normals (updateGlobalPoints,
    MapManagement.h:120-149).  Returns (points [K*P, 3], normals, mask,
    rings)."""
    out = make_forward(shapes, False, False, False)(params, data)
    _, gp = global_chain(params, data, shapes)
    R = rot.axang2rotm(gp.orient).to(torch.float32)
    nrm_w = torch.einsum("kij,kpj->kpi", R, data.local_normals).reshape(-1, 3)
    return out.points, nrm_w, out.mask, out.ring_ids
