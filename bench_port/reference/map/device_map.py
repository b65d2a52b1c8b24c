"""Device-resident keyframe map (counterpart of
dmsa_lidar_slam_tpu/map/device_map.py): add with shift-out-oldest
(MapManagement.h:311-389), closest-k candidates (:88-118), the submap
view (:254-276) and its write-back (:278-288), uncapped and capped, as
functions of a NamedTuple of tensors.  Functions return new states; they
do not mutate their inputs.
"""

from typing import NamedTuple

import torch

from bench_port.reference.core import poses as cp
from bench_port.reference.core import rotations as rot
from bench_port.reference.map import keyframes as kfm


class DeviceMapState(NamedTuple):
    local_pts: torch.Tensor  # [K, P, 3] f32, keyframe-local
    local_normals: torch.Tensor  # [K, P, 3] f32
    pt_mask: torch.Tensor  # [K, P] bool
    pt_ring: torch.Tensor  # [K, P] i32
    grid_size: torch.Tensor  # [K] f32
    orient_w: torch.Tensor  # [K, 3] f64
    transl_w: torch.Tensor  # [K, 3]
    stamps: torch.Tensor  # [K] f64, relative to the run's stamp base
    grav_meas: torch.Tensor  # [K, 3]
    grav_plausible: torch.Tensor  # [K] bool
    odom_rel_orient: torch.Tensor  # [K, 3]
    odom_rel_transl: torch.Tensor  # [K, 3]
    count: torch.Tensor  # [] i32
    num_updates: torch.Tensor  # [] i32


def empty_state(shapes: kfm.MapShapes, pose_dtype, device) -> DeviceMapState:
    K, P = shapes.n_keyframes, shapes.n_pts_per_kf
    f32, i32 = torch.float32, torch.int32

    def z(*s, dtype=pose_dtype):
        return torch.zeros(*s, dtype=dtype, device=device)

    return DeviceMapState(
        local_pts=z(K, P, 3, dtype=f32),
        local_normals=z(K, P, 3, dtype=f32),
        pt_mask=z(K, P, dtype=torch.bool),
        pt_ring=z(K, P, dtype=i32),
        grid_size=torch.full((K,), float("inf"), dtype=f32, device=device),
        orient_w=z(K, 3),
        transl_w=z(K, 3),
        stamps=z(K, dtype=torch.float64),
        grav_meas=z(K, 3),
        grav_plausible=z(K, dtype=torch.bool),
        odom_rel_orient=z(K, 3),
        odom_rel_transl=z(K, 3),
        count=z((), dtype=i32),
        num_updates=z((), dtype=i32),
    )


def _rel_pose(o_prev, t_prev, o_curr, t_curr):
    R_prev = rot.axang2rotm(o_prev)
    R_curr = rot.axang2rotm(o_curr)
    return rot.rotm2axang(R_prev.T @ R_curr), R_prev.T @ (t_curr - t_prev)


_ROW_FIELDS = (
    "local_pts", "local_normals", "pt_mask", "pt_ring", "grid_size", "orient_w", "transl_w",
    "stamps", "grav_meas", "grav_plausible", "odom_rel_orient", "odom_rel_transl",
)


def add_keyframe(state: DeviceMapState, position_w, orient_w, stamp, pts_local, normals, rings,
                 pt_mask, grid_size, grav_meas, grav_plausible):
    """Add with shift-out-oldest.  Returns (new_state, retired_orient,
    retired_transl, retired_stamp, retired_valid)."""
    K = state.orient_w.shape[0]
    count = int(state.count)  # host sync: the ring slot
    full = count >= K
    retired = (state.orient_w[0].clone(), state.transl_w[0].clone(), state.stamps[0].clone())
    rows = {f: getattr(state, f) for f in _ROW_FIELDS}
    if full:
        rows = {f: torch.roll(v, -1, dims=0) for f, v in rows.items()}
    idx = K - 1 if full else count
    if idx > 0:
        rel_o, rel_t = _rel_pose(rows["orient_w"][idx - 1], rows["transl_w"][idx - 1], orient_w, position_w)
    else:
        rel_o, rel_t = orient_w, position_w
    values = dict(
        local_pts=pts_local, local_normals=normals, pt_mask=pt_mask, pt_ring=rings, grid_size=grid_size,
        orient_w=orient_w, transl_w=position_w, stamps=stamp, grav_meas=grav_meas,
        grav_plausible=grav_plausible, odom_rel_orient=rel_o, odom_rel_transl=rel_t,
    )
    new = {}
    for f, v in rows.items():
        arr = v.clone()
        arr[idx] = torch.as_tensor(values[f], dtype=arr.dtype, device=arr.device)
        new[f] = arr
    new_state = DeviceMapState(
        **new,
        count=torch.clamp(state.count + 1, max=K),
        num_updates=state.num_updates + 1,
    )
    full_t = torch.tensor(full, device=state.count.device)
    return new_state, retired[0], retired[1], retired[2], full_t


def closest_candidates(state: DeviceMapState, pos_w, n_candidates: int, max_dist):
    """Top-n closest active keyframes within max_dist: (ids [S], valid [S])."""
    K = state.orient_w.shape[0]
    active = torch.arange(K, device=pos_w.device) < state.count
    d = torch.linalg.norm(state.transl_w - pos_w[None, :], dim=1)
    d = torch.where(active, d, torch.full_like(d, float("inf")))
    neg_d, ids = torch.topk(-d, n_candidates)
    dist = -neg_d
    return ids, torch.isfinite(dist) & (dist < max_dist)


def candidate_clouds(state: DeviceMapState, ids, valid):
    """World-frame clouds and normals of the candidate keyframes [S, P, 3]."""
    R = rot.axang2rotm(state.orient_w[ids]).to(torch.float32)
    t = state.transl_w[ids].to(torch.float32)
    pts = torch.einsum("sij,spj->spi", R, state.local_pts[ids]) + t[:, None, :]
    nrm = torch.einsum("sij,spj->spi", R, state.local_normals[ids])
    mask = state.pt_mask[ids] & valid[:, None]
    return pts, nrm, state.pt_ring[ids], mask


def submap_view_capped(state: DeviceMapState, from_id: int, n_submap: int, balancing_grav,
                       balancing_odom, cov_grav_inv, odom_t_cov_inv, odom_r_cov_inv, gravity):
    """The suffix [from_id..count-1] at the fixed shape [n_submap, P]
    (caller guarantees count - from_id <= n_submap).  Returns
    (KeyframeMapData, params0 [6 (n_submap - 1)])."""
    S = n_submap
    m = state.count - from_id

    def take(x):
        return torch.roll(x, -from_id, dims=0)[:S]

    gp = cp.GlobalPoses(orient=take(state.orient_w), transl=take(state.transl_w))
    chain = cp.global2relative(gp)
    params0 = cp.params_from_chain(chain)
    kf_mask = torch.arange(S, device=state.count.device) < m
    grid = take(state.grid_size)
    data = kfm.KeyframeMapData(
        local_pts=take(state.local_pts),
        local_normals=take(state.local_normals),
        pt_mask=take(state.pt_mask),
        pt_ring=take(state.pt_ring),
        grid_size=torch.where(kf_mask, grid, torch.full_like(grid, float("inf"))),
        kf_mask=kf_mask,
        anchor_orient=chain.orient[0],
        anchor_transl=chain.transl[0],
        stamps=take(state.stamps),
        grav_meas=take(state.grav_meas),
        grav_plausible=take(state.grav_plausible),
        odom_rel_transl=take(state.odom_rel_transl),
        odom_rel_orient=take(state.odom_rel_orient),
        gravity=gravity,
        cov_grav_inv=cov_grav_inv,
        odom_transl_cov_inv=odom_t_cov_inv,
        odom_orient_cov_inv=odom_r_cov_inv,
        balancing_grav=balancing_grav,
        balancing_odom=balancing_odom,
    )
    return data, params0


def write_back_capped(state: DeviceMapState, from_id: int, params):
    """Recompose globals of keyframes (from_id..count-1] from the optimized
    capped-submap chain, keyframe from_id anchored."""
    K = state.orient_w.shape[0]
    S = params.shape[0] // 6 + 1
    z = torch.zeros(S - 1, 3, dtype=state.orient_w.dtype, device=params.device)
    anchor = cp.PoseChain(
        orient=torch.cat([state.orient_w[from_id][None], z]),
        transl=torch.cat([state.transl_w[from_id][None], z]),
    )
    gp = cp.relative2global(cp.chain_from_params(params, anchor))
    pad = torch.zeros(K - S, 3, dtype=gp.orient.dtype, device=params.device)
    new_orient = torch.roll(torch.cat([gp.orient, pad]), from_id, dims=0)
    new_transl = torch.roll(torch.cat([gp.transl, pad]), from_id, dims=0)
    k_idx = torch.arange(K, device=params.device)
    write = ((k_idx > from_id) & (k_idx < state.count) & (k_idx < from_id + S))[:, None]
    return state._replace(
        orient_w=torch.where(write, new_orient, state.orient_w),
        transl_w=torch.where(write, new_transl, state.transl_w),
    )


def min_grid_from(state: DeviceMapState, from_id: int):
    k_idx = torch.arange(state.grid_size.shape[0], device=state.grid_size.device)
    sel = (k_idx >= from_id) & (k_idx < state.count)
    return torch.min(torch.where(sel, state.grid_size, torch.full_like(state.grid_size, float("inf"))))
