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

from dmsa_lidar_slam_tpu_torch.core import interpolation as interp
from dmsa_lidar_slam_tpu_torch.core import poses as cp
from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.dmsa.optimizer import ForwardOut, TabularProblem, tables_and_jacobian
from dmsa_lidar_slam_tpu_torch.imu import preintegration as preint_mod
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

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


def dense_times(data: WindowData, shapes: WindowShapes):
    return torch.arange(shapes.n_dense, dtype=data.dt.dtype, device=data.dt.device) * data.dt


def ctrl_stamps_from_dt(dt, shapes: WindowShapes):
    idx = torch.tensor(shapes.param_indices, dtype=dt.dtype, device=dt.device)
    return idx * dt


@lru_cache(maxsize=None)
def grid_consts(shapes: WindowShapes, device):
    """The dense grid's interpolation operators (A [D, C] f64, left [D],
    right [D], u [D] f64) on `device`, the one cache that dense_pose_tables
    and K6 read.  Made outside any torch.func transform, so that a first
    call from inside one still caches plain tensors, with storage for a
    kernel to read."""
    a_mat, left, right, u = interp.uniform_grid_consts(shapes.n_dense, shapes.n_ctrl, shapes.interval_len, d=2)
    with torch._C._DisableFuncTorch():
        return (torch.as_tensor(a_mat, dtype=torch.float64, device=device), torch.as_tensor(left, device=device),
                torch.as_tensor(right, device=device), torch.as_tensor(u, dtype=torch.float64, device=device))


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
    A, left, right, u = grid_consts(shapes, gp.transl.device)
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


def _table_forward(tab, extra, data: WindowData, shapes: WindowShapes) -> ForwardOut:
    xs, tidx = _window_point_arrays(data, shapes)
    pts = rot.quat_rotate(tab[tidx, 0:4], xs) + tab[tidx, 4:7]
    mask = torch.cat([data.pt_mask, data.static_mask])
    rings = torch.cat([data.pt_ring, data.static_ring])
    return ForwardOut(points=pts, mask=mask, ring_ids=rings, extra=extra)


# K6 (csrc/k6_window_tables.cu, a port-only kernel: the JAX package leaves
# this graph to XLA inside its jitted step): the tables of _window_tables
# with their forward-mode Jacobian, and the same tables at the line search's
# candidates, one launch each for CUDA tensors; for CPU tensors the plain
# path the kernel replaces (the *_ref twins: torch.func's jacfwd and vmap
# over _window_tables).  On the card the wrappers enqueue nothing but the
# launch and its output allocations, and never wait for the card.
K6_MAX_CTRL = 16  # control poses the kernel takes (its shared-memory chain)


def window_tables(params, data: WindowData, shapes: WindowShapes, use_imu: bool):
    """(tab [D+1, 8] f32, extra [E] f64, dtab [P, D+1, 8] f32, j_extra
    [P, E] f64): the window's tables at params [P] and their Jacobian;
    E = n_ctrl - 1 with the IMU residuals, else 0."""
    if not params.is_cuda:
        return window_tables_ref(params, data, shapes, use_imu)
    p_dim, rows, e = params.shape[0], shapes.n_dense + 1, _n_extra(shapes, use_imu)
    dev = params.device
    tab = torch.empty((rows, 8), dtype=torch.float32, device=dev)
    extra = torch.empty(e, dtype=torch.float64, device=dev)
    dtab = torch.empty((p_dim, rows, 8), dtype=torch.float32, device=dev)
    j_extra = torch.empty((p_dim, e), dtype=torch.float64, device=dev)
    _k6_launch(params, 0, data, shapes, use_imu, tab, extra, dtab, j_extra)
    return tab, extra, dtab, j_extra


def window_tables_batch(cand_params, data: WindowData, shapes: WindowShapes, use_imu: bool):
    """(tabs [K, D+1, 8] f32, extras [K, E] f64): the window's tables at
    each row of cand_params [K, P]."""
    if not cand_params.is_cuda:
        return window_tables_batch_ref(cand_params, data, shapes, use_imu)
    k, dev = cand_params.shape[0], cand_params.device
    tabs = torch.empty((k, shapes.n_dense + 1, 8), dtype=torch.float32, device=dev)
    extras = torch.empty((k, _n_extra(shapes, use_imu)), dtype=torch.float64, device=dev)
    _k6_launch(cand_params, k, data, shapes, use_imu, tabs, extras, None, None)
    return tabs, extras


def window_tables_ref(params, data: WindowData, shapes: WindowShapes, use_imu: bool):
    return tables_and_jacobian(lambda p: _window_tables(p, data, shapes, use_imu), params)


def window_tables_batch_ref(cand_params, data: WindowData, shapes: WindowShapes, use_imu: bool):
    return torch.func.vmap(lambda p: _window_tables(p, data, shapes, use_imu))(cand_params)


def _n_extra(shapes, use_imu):
    return shapes.n_ctrl - 1 if use_imu else 0


def _k6_launch(params, n_sets, data, shapes, use_imu, tab, extra, dtab, j_extra):
    dev = params.device
    c, d = shapes.n_ctrl, shapes.n_dense
    p_dim, e = 6 * (c - 1), c - 1
    if not 2 <= c <= K6_MAX_CTRL:
        raise ValueError(f"window_tables: {c} control poses, the kernel takes 2..{K6_MAX_CTRL}")
    params = params.contiguous()
    cuda_lib.require(params, "params", torch.float64, (n_sets, p_dim) if n_sets else (p_dim,), dev)
    a_mat, left, right, u = grid_consts(shapes, dev)
    operands = [(data.anchor_orient, "anchor_orient", (3,)), (data.anchor_transl, "anchor_transl", (3,)),
                (a_mat, "A", (d, c)), (left, "left", (d,)), (right, "right", (d,)), (u, "u", (d,))]
    if use_imu:
        operands += [
            (data.dt, "dt", ()), (data.ctrl_stamps, "ctrl_stamps", (c,)), (data.gravity, "gravity", (3,)),
            (data.preint_rot, "preint_rot", (e, 3, 3)), (data.preint_vel, "preint_vel", (e, 3)),
            (data.preint_pos, "preint_pos", (e, 3)), (data.cov_inv, "cov_inv", (e, 9, 9)),
            (data.balancing_imu, "balancing_imu", ()),
        ]
    keep = []
    for t, name, shape in operands:
        t = t.contiguous()
        cuda_lib.require(t, name, torch.int64 if name in ("left", "right") else torch.float64, shape, dev)
        keep.append(t)
    ptrs = [t.data_ptr() for t in keep] + [None] * (14 - len(keep))  # no IMU: the kernel reads none of those
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["window_tables"] += 1
    cuda_lib.check(
        cuda_lib.library().k6_window_tables(
            P(params), n_sets, p_dim, c, d, int(use_imu), *ptrs,
            P(tab), P(extra), None if dtab is None else P(dtab), None if j_extra is None else P(j_extra),
            cuda_lib.stream_ptr(dev),
        ),
        "k6_window_tables",
    )


@lru_cache(maxsize=None)
def make_forward(shapes: WindowShapes, use_imu: bool):
    """ForwardOut function of the window problem."""

    def forward(params, data: WindowData) -> ForwardOut:
        return _table_forward(*_window_tables(params, data, shapes, use_imu), data, shapes)

    return forward


@lru_cache(maxsize=None)
def make_structured(shapes: WindowShapes, use_imu: bool):
    """Structured-Jacobian forward of the window problem (see
    dmsa.optimizer): a point's world position depends only on its dense-
    table row, so the tables and their Jacobian come from window_tables
    (K6 on the card, torch.func on the CPU) and the per-point chain rule is
    the closed-form quat_rotate VJP plus one gathered contraction.  Static
    map points do not depend on the parameters: their rows are zero."""

    def structured(params, data: WindowData):
        tab, extra, dtab, j_extra = window_tables(params, data, shapes, use_imu)
        out = _table_forward(tab, extra, data, shapes)
        idx = data.pt_tform_idx.to(torch.int64)
        qp = tab[idx, 0:4]
        d = shapes.n_dense
        gq = dtab[:, :d, 0:4].permute(1, 2, 0).contiguous()[idx]  # [NW, 4, P]
        gt = dtab[:, :d, 4:7].permute(1, 2, 0).contiguous()[idx]  # [NW, 3, P]
        nw = shapes.n_window_pts
        p_dim = params.shape[0]

        def contract(grad3_orig):
            g = grad3_orig[:nw]
            aq = rot.quat_rotate_vjp_q(qp, data.local_pts, g)  # [NW, 4]
            jp = torch.einsum("nc,ncp->np", aq, gq) + torch.einsum("nc,ncp->np", g, gt)
            zeros = torch.zeros(shapes.n_static, p_dim, dtype=jp.dtype, device=jp.device)
            return torch.cat([jp, zeros], dim=0)

        return out, contract, j_extra.T

    return structured


@lru_cache(maxsize=None)
def make_tabular(shapes: WindowShapes, use_imu: bool) -> TabularProblem:
    """The window problem in table form: point j = quat_rotate(q_dense[idx_j],
    x_j) + t_dense[idx_j]; static map points on the trailing identity row.
    The tables with their Jacobian, and the line search's candidate tables,
    come from window_tables / window_tables_batch (K6 on the card,
    torch.func on the CPU); the forward reads its points from the table."""
    return TabularProblem(
        n_table=shapes.n_dense + 1,
        tables=lambda params, data: _window_tables(params, data, shapes, use_imu),
        point_arrays=lambda data: _window_point_arrays(data, shapes),
        tables_jac=lambda params, data: window_tables(params, data, shapes, use_imu),
        tables_batch=lambda cands, data: window_tables_batch(cands, data, shapes, use_imu),
        forward_tab=lambda tab, extra, data: _table_forward(tab, extra, data, shapes),
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


def register_tform_indices(rel_stamps, dt, n_dense):
    """Per-point dense-table index (registerPcBuffer,
    ContinuousTrajectory.h:245-261): lower_bound of (stamp - t0) over the
    uniform dense grid, clamped."""
    idx = torch.ceil(rel_stamps / dt - 1e-9).to(torch.int32)
    return torch.clamp(idx, 0, n_dense - 1)


def initial_guess(old_gp, old_stamps, old_t0: float, new_t0: float, new_ctrl_stamps, preint_factors,
                  delta_t_ctrl, gravity, use_imu: bool, last_known: int, n_ctrl: int):
    """Window initial guess (updateInitialGuess, ContinuousTrajectory.h:
    367-469) with `last_known` computed by the caller on the host.

    Prefix poses (control stamps the old window still covers) come from
    slerp + barycentric interpolation of the old control poses, the
    terminal velocity from the barycentric derivative, the rest from IMU
    dead-reckoning or constant-velocity extrapolation.  Returns the full
    PoseChain (anchor row 0 + relative poses)."""
    shift = torch.as_tensor(new_t0 - old_t0, dtype=old_stamps.dtype, device=old_stamps.device)
    t_query = new_ctrl_stamps[: last_known + 1] + shift
    pref_orient = interp.interp_rotations(t_query, old_stamps, old_gp.orient)
    pref_transl = interp.barycentric_interp(t_query, old_stamps, old_gp.transl, d=2)
    v0 = interp.barycentric_derivative(
        new_ctrl_stamps[last_known : last_known + 1] + shift, old_stamps, old_gp.transl, d=2
    )[0]
    if use_imu:
        pr_rot, pr_vel, pr_pos = preint_factors
        aa_suffix, p_suffix = preint_mod.dead_reckon_controls(
            pref_orient[last_known],
            pref_transl[last_known],
            v0,
            preint_mod.PreintState(
                delta_rot=pr_rot[last_known:], delta_vel=pr_vel[last_known:], delta_pos=pr_pos[last_known:],
                cov=None,
            ),
            delta_t_ctrl[last_known:],
            gravity,
        )
        g_orient = torch.cat([pref_orient[:last_known], aa_suffix], dim=0)
        g_transl = torch.cat([pref_transl[:last_known], p_suffix], dim=0)
        return cp.global2relative(cp.GlobalPoses(orient=g_orient, transl=g_transl))
    # constant velocity: repeat the last known relative pose (ContinuousTrajectory.h:458-468)
    tail_n = n_ctrl - 1 - last_known
    z = torch.zeros(tail_n, 3, dtype=pref_orient.dtype, device=pref_orient.device)
    chain = cp.global2relative(
        cp.GlobalPoses(orient=torch.cat([pref_orient, z], dim=0), transl=torch.cat([pref_transl, z], dim=0))
    )
    tail = (torch.arange(n_ctrl, device=z.device) > last_known)[:, None]
    return cp.PoseChain(
        orient=torch.where(tail, chain.orient[last_known][None, :], chain.orient),
        transl=torch.where(tail, chain.transl[last_known][None, :], chain.transl),
    )


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
