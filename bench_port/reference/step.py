"""The fused pipeline's per-scan step in plain PyTorch: a frozen copy of
dmsa_lidar_slam_tpu_torch/pipeline/fused.py (FusedState ... make_step) on
one device, every kernel K1-K5 as its plain version (ops/), the pose
dtype a parameter.  The benchmark's reference: it reads the program's
state only to start a step from it, and computes everything else again.
"""

from typing import NamedTuple

import dataclasses

import numpy as np
import torch

from bench_port.reference.config import Config
from bench_port.reference.core import poses as cp
from bench_port.reference.core import rotations as rot
from bench_port.reference.dmsa import optimizer as opt
from bench_port.reference.map import device_map as dmap
from bench_port.reference.map import keyframes as kfm
from bench_port.reference.map import normals as nrm
from bench_port.reference.map import static_points as sp
from bench_port.reference.ops import voxel
from bench_port.reference.pipeline import preprocess as pp
from bench_port.reference.trajectory import continuous as ct
from bench_port.reference.trajectory.device_guess import traced_initial_guess
from bench_port.reference.utils.dtypes import POSE_DTYPE

# event row (f32): [type, pose(6), related_kf, retired_flag, retired_pose(6),
# overlap, stop_reason, num_gauss, n_kept, grid, retired_stamp_hi, grav_ok,
# retired_stamp_lo, shuffle_overflow] -> width 25
EV_WIDTH = 25
EV_NONE, EV_INIT_KF, EV_KEYFRAME, EV_NONKEYFRAME = 0.0, 1.0, 2.0, 3.0

# raw-point wire quantization: 5 mm, +-163.8 m
PT_SCALE = 0.005
PT_INV_SCALE = 200.0

_F32 = torch.float32


class FusedState(NamedTuple):
    scan_pts: torch.Tensor  # [S, cap, 3] f32 IMU frame
    scan_mask: torch.Tensor  # [S, cap]
    scan_rings: torch.Tensor  # [S, cap] i32
    scan_rel_stamps: torch.Tensor  # [S, cap] f32
    scan_grid: torch.Tensor  # [S] f32
    num_scans: torch.Tensor  # [] i32
    kf: dmap.DeviceMapState
    ow_orient: torch.Tensor  # [C, 3] f64
    ow_transl: torch.Tensor  # [C, 3]
    ow_stamps: torch.Tensor  # [C]
    ow_horizon: torch.Tensor  # []
    submap_initialized: torch.Tensor  # [] bool
    events: torch.Tensor  # [EV_CAP, EV_WIDTH] f32
    ev_index: torch.Tensor  # [] i32


@dataclasses.dataclass(frozen=True)
class FusedShapes:
    n_clouds: int
    scan_cap: int
    raw_cap: int
    n_static: int
    n_ctrl: int
    n_dense: int
    kf_cap: int
    kf_pts_cap: int
    n_candidates: int
    ev_cap: int

    def __post_init__(self):
        assert self.n_clouds <= 6, "pack layout carries scan_t0_rel in one row"

    @property
    def aux_rows(self) -> int:
        return self.n_dense + 4

    @property
    def window(self) -> ct.WindowShapes:
        return ct.WindowShapes(
            n_window_pts=self.n_clouds * self.scan_cap, n_static=self.n_static,
            n_ctrl=self.n_ctrl, n_dense=self.n_dense,
        )

    @property
    def map(self) -> kfm.MapShapes:
        return kfm.MapShapes(n_keyframes=self.kf_cap, n_pts_per_kf=self.kf_pts_cap)


def shapes_from_config(c: Config, flush_every: int) -> FusedShapes:
    scan_cap = -(-int(c.scan_cap_factor * c.max_num_points_per_scan) // 256) * 256
    return FusedShapes(
        n_clouds=c.n_clouds,
        scan_cap=scan_cap,
        raw_cap=max(c.raw_scan_cap, scan_cap),
        n_static=c.static_points_cap,
        n_ctrl=c.num_control_poses,
        n_dense=c.n_dense,
        kf_cap=c.last_n_keyframes_for_optim,
        kf_pts_cap=c.keyframe_points_cap,
        n_candidates=c.closest_k_keyframes_as_static_points,
        ev_cap=max(flush_every, 16),
    )


def empty_state(shapes: FusedShapes, device, pdt=POSE_DTYPE) -> FusedState:
    S, cap, C = shapes.n_clouds, shapes.scan_cap, shapes.n_ctrl
    return FusedState(
        scan_pts=torch.zeros(S, cap, 3, dtype=_F32, device=device),
        scan_mask=torch.zeros(S, cap, dtype=torch.bool, device=device),
        scan_rings=torch.zeros(S, cap, dtype=torch.int32, device=device),
        scan_rel_stamps=torch.zeros(S, cap, dtype=_F32, device=device),
        scan_grid=torch.full((S,), 0.4, dtype=_F32, device=device),
        num_scans=torch.zeros((), dtype=torch.int32, device=device),
        kf=dmap.empty_state(shapes.map, pdt, device),
        ow_orient=torch.zeros(C, 3, dtype=pdt, device=device),
        ow_transl=torch.zeros(C, 3, dtype=pdt, device=device),
        ow_stamps=torch.zeros(C, dtype=pdt, device=device),
        ow_horizon=torch.zeros((), dtype=pdt, device=device),
        submap_initialized=torch.zeros((), dtype=torch.bool, device=device),
        events=torch.zeros(shapes.ev_cap, EV_WIDTH, dtype=_F32, device=device),
        ev_index=torch.zeros((), dtype=torch.int32, device=device),
    )


class StepPriorities(NamedTuple):
    """int32 random priorities of the step's three downsamplings."""

    preprocess: torch.Tensor  # [raw_cap]
    static: torch.Tensor  # [n_candidates * kf_pts_cap]
    keyframe: torch.Tensor  # [n_window_pts]


def draw_priorities(seed: int, shapes: FusedShapes, device) -> StepPriorities:
    """The step's priorities from one torch.Generator seeded with `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def bits(n):
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, generator=g, device=device)

    return StepPriorities(
        preprocess=bits(shapes.raw_cap),
        static=bits(shapes.n_candidates * shapes.kf_pts_cap),
        keyframe=bits(shapes.window.n_window_pts),
    )


def _fit_rows(arr, target):
    n = arr.shape[0]
    if n >= target:
        return arr[:target]
    pad = torch.zeros(target - n, *arr.shape[1:], dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def _roll_push(x, value, full: bool, slot: int):
    x = torch.roll(x, -1, dims=0) if full else x.clone()
    x[slot] = value
    return x


def submap_keyframes(c: Config, shapes: FusedShapes) -> int:
    """Keyframes of the (capped) submap problem."""
    cap = c.submap_max_keyframes or shapes.kf_cap
    return max(2, min(cap, shapes.kf_cap))


def make_step(config: Config, shapes: FusedShapes, device, pdt=POSE_DTYPE):
    """Build the per-scan step: step(state, pack, aux, prio) -> state, its
    pose math in `pdt` (float64 as the configuration states it; the control
    passes a lower precision)."""
    c = config
    dev = torch.device(device)
    wshapes = shapes.window
    mshapes = shapes.map
    C = shapes.n_ctrl
    nw = wshapes.n_window_pts

    def t64(x):
        return torch.as_tensor(np.asarray(x), dtype=pdt, device=dev)

    fwd_imu = ct.make_forward(wshapes, use_imu=True)
    tabular_window = ct.make_tabular(wshapes, use_imu=True)
    T = c.lidar_to_imu_tform
    R_l2i = torch.as_tensor(T[:3, :3], dtype=_F32, device=dev)
    t_l2i = torch.as_tensor(T[:3, 3], dtype=_F32, device=dev)
    gravity = t64(ct.GRAVITY_W)
    cov_gyr = t64(c.cov_gyr)
    cov_acc = t64(c.cov_acc)
    cov_grav_inv = t64(np.linalg.inv(kfm.STD_DEV_ACC**2 * np.eye(3)))
    odom_cov_inv = t64(np.linalg.inv(kfm.ODOM_STD**2 * np.eye(3)))

    settings_window = opt.OptimSettings(
        num_iter=c.num_iter_sliding_window_optim,
        min_num_points_per_set=c.min_num_points_gauss,
        step_length_optim=c.alpha_sliding_window_no_imu,
        max_step=c.max_step_sliding_window_no_imu,
    )
    settings_map = opt.OptimSettings(
        num_iter=c.num_iter_keyframe_optim,
        min_num_points_per_set=c.min_num_points_gauss_key,
        step_length_optim=c.alpha_keyframe_optim,
        max_step=0.01,
        epsilon=c.epsilon_keyframe_opt,
        use_centralization=False,
    )
    use_grav_terms = c.use_gravity_term_in_keyframe_opt and c.use_imu
    S_sub = submap_keyframes(c, shapes)
    sub_mshapes = kfm.MapShapes(n_keyframes=S_sub, n_pts_per_kf=shapes.kf_pts_cap)
    kf_fwd = kfm.make_forward(sub_mshapes, use_grav_terms, c.use_odometry_term_in_keyframe_opt, True)
    kf_tabular = kfm.make_tabular(sub_mshapes, use_grav_terms, c.use_odometry_term_in_keyframe_opt)

    def assemble_window(state, sc, acc_dense, gyr_dense):
        rel = state.scan_rel_stamps + sc["scan_t0_rel"][:, None]
        tform_idx = torch.clamp(
            torch.ceil(rel.reshape(-1) / sc["dt"].to(_F32) - 1e-6).to(torch.int64), 0, shapes.n_dense - 1
        )
        ctrl_stamps = ct.ctrl_stamps_from_dt(sc["dt"], wshapes)
        pr_rot, pr_vel, pr_pos, cov_inv, pr_full = ct.compute_preint_factors(
            gyr_dense, acc_dense, sc["dt"], cov_gyr, cov_acc, wshapes
        )
        eye9 = torch.eye(9, dtype=pdt, device=dev).expand(cov_inv.shape)
        cov_inv = torch.where(sc["use_imu"], cov_inv, eye9)
        ns = shapes.n_static
        return ct.WindowData(
            local_pts=state.scan_pts.reshape(-1, 3),
            pt_mask=state.scan_mask.reshape(-1),
            pt_ring=state.scan_rings.reshape(-1),
            pt_tform_idx=tform_idx,
            static_pts=torch.zeros(ns, 3, dtype=_F32, device=dev),
            static_mask=torch.zeros(ns, dtype=torch.bool, device=dev),
            static_ring=torch.zeros(ns, dtype=torch.int32, device=dev),
            anchor_orient=torch.zeros(3, dtype=pdt, device=dev),
            anchor_transl=torch.zeros(3, dtype=pdt, device=dev),
            ctrl_stamps=ctrl_stamps,
            dt=sc["dt"],
            horizon=sc["horizon"],
            acc_dense=acc_dense,
            gyr_dense=gyr_dense,
            gravity=gravity,
            preint_rot=pr_rot,
            preint_vel=pr_vel,
            preint_pos=pr_pos,
            cov_inv=cov_inv,
            preint_pos_full=pr_full,
            balancing_imu=sc["balancing_imu"],
        )

    def gravity_estimate(params, data, use_imu):
        _, gp, _, d_t = ct.dense_poses(params, data, wshapes)
        grav = ct.submap_gravity_estimate(gp, d_t, data, wshapes)
        plaus = (torch.abs(torch.linalg.norm(grav) - torch.linalg.norm(gravity)) < c.gravity_outlier_thresh) & use_imu
        return torch.where(use_imu, grav, torch.zeros_like(grav)), plaus

    def make_keyframe_cloud(points_w, mask, rings, anchor_o, anchor_t, min_grid, prio):
        pts_c, rings_c, out_mask, n_kept = voxel.downsample_compact(points_w, mask, rings, min_grid, prio,
                                                                    mshapes.n_pts_per_kf)
        rings_out = torch.where(out_mask, rings_c, torch.zeros_like(rings_c))
        R_inv = rot.axang2rotm(anchor_o).T.to(_F32)
        pts_local = (pts_c - anchor_t.to(_F32)[None, :]) @ R_inv.T
        pts_local = torch.where(out_mask[:, None], pts_local, torch.zeros_like(pts_local))
        normals = nrm.estimate_normals(pts_local, out_mask, min_grid)
        return pts_local, normals, rings_out, out_mask, n_kept

    def store_old_window(state, params, data):
        _, gp, _, _ = ct.dense_poses(params, data, wshapes)
        return state._replace(
            ow_orient=gp.orient, ow_transl=gp.transl, ow_stamps=data.ctrl_stamps, ow_horizon=data.horizon
        )

    def new_event():
        return torch.zeros(EV_WIDTH, dtype=_F32, device=dev)

    def init_map(state, data, params0, sc):
        P = mshapes.n_pts_per_kf
        pts0 = _fit_rows(state.scan_pts[0], P)
        mask0 = _fit_rows(state.scan_mask[0], P)
        rings0 = _fit_rows(state.scan_rings[0], P)
        normals0 = nrm.estimate_normals(pts0, mask0, state.scan_grid[0])
        grav, plaus = gravity_estimate(params0, data, sc["use_imu"])
        kf_new, *_ = dmap.add_keyframe(
            state.kf, data.anchor_transl, data.anchor_orient, sc["win_t0"], pts0, normals0, rings0,
            mask0, state.scan_grid[0], grav, plaus,
        )
        ev = new_event()
        ev[0] = EV_INIT_KF
        ev[1:4] = data.anchor_orient.to(_F32)
        ev[4:7] = data.anchor_transl.to(_F32)
        ev[19] = torch.sum(mask0).to(_F32)
        ev[20] = state.scan_grid[0]
        state = store_old_window(state._replace(kf=kf_new), params0, data)
        return state._replace(submap_initialized=torch.ones((), dtype=torch.bool, device=dev)), ev

    def do_submap(state, min_related_adj):
        """The submap optimization on one device."""
        from_id = max(min_related_adj, 0, int(state.kf.count) - S_sub)
        sdata, sparams = dmap.submap_view_capped(
            state.kf, from_id, S_sub, t64(c.balancing_factor_gravity), t64(c.balancing_factor_odometry),
            cov_grav_inv, odom_cov_inv, odom_cov_inv, gravity,
        )
        smin_grid = dmap.min_grid_from(state.kf, from_id)
        params_new = opt.optimize(kf_fwd, sparams, sdata, settings_map, smin_grid, tabular_fn=kf_tabular).params
        return state._replace(kf=dmap.write_back_capped(state.kf, from_id, params_new))

    def main_window(state, data, params0, sc, prio):
        curr_pos = data.anchor_transl
        min_grid = torch.min(state.scan_grid)
        cand_ids, cand_valid = dmap.closest_candidates(
            state.kf, curr_pos, shapes.n_candidates, c.dist_static_points_keyframe
        )
        kf_pts, kf_nrm, kf_rings, kf_mask = dmap.candidate_clouds(state.kf, cand_ids, cand_valid)
        out0 = fwd_imu(params0, data)
        sel = sp.select_static_points(
            out0.points[:nw], out0.mask[:nw], kf_pts, kf_nrm, kf_rings, kf_mask,
            curr_pos.to(_F32), min_grid, prio.static, shapes.n_static,
        )
        data = data._replace(static_pts=sel.static_pts, static_mask=sel.static_mask, static_ring=sel.static_ring)
        max_overlap_kf = cand_ids[torch.argmax(sel.overlap_counts)]
        has_sel = sel.overlap_counts > 0
        big = torch.full_like(cand_ids, 2**31 - 1)
        min_related = torch.where(
            torch.any(has_sel), torch.min(torch.where(has_sel, cand_ids, big)), torch.full_like(cand_ids[0], -1)
        )

        cdata, origin = ct.centralize(data)
        result = opt.optimize(
            fwd_imu, params0, cdata, settings_window, min_grid,
            step_length=sc["step_length"], max_step=sc["max_step"], tabular_fn=tabular_window,
        )
        data = ct.decentralize(cdata, origin)
        params_opt = result.params
        data_o = data._replace(static_mask=torch.zeros_like(data.static_mask))

        count = int(state.kf.count)  # host sync
        last_kf_pos = state.kf.transl_w[max(count - 1, 0)]
        dist = torch.linalg.norm(curr_pos - last_kf_pos)
        new_kf = bool((sel.overlap_fraction < c.min_overlap_new_keyframe) | (dist > c.dist_new_keyframe))
        min_related_adj = int(min_related) - (1 if count >= shapes.kf_cap else 0)

        ev = new_event()
        if new_kf:
            out = fwd_imu(params_opt, data_o)
            pts_local, normals, rings_out, out_mask, n_kept = make_keyframe_cloud(
                out.points[:nw], out.mask[:nw], out.ring_ids[:nw], data_o.anchor_orient,
                data_o.anchor_transl, min_grid, prio.keyframe,
            )
            grav, plaus = gravity_estimate(params_opt, data_o, sc["use_imu"])
            kf_new, ret_o, ret_t, ret_stamp, retired = dmap.add_keyframe(
                state.kf, data_o.anchor_transl, data_o.anchor_orient, sc["win_t0"], pts_local, normals,
                rings_out, out_mask, min_grid, grav, plaus,
            )
            state = state._replace(kf=kf_new)
            count = int(state.kf.count)
            run_submap = c.optimize_sliding_window_keyframes and min_related_adj >= 0 and count >= 3
            span_from = max(max(min_related_adj, 0), count - S_sub)
            submap_span = count - span_from if run_submap else 0
            if run_submap:
                state = do_submap(state, min_related_adj)
            last = max(count - 1, 0)
            data_o = data_o._replace(anchor_orient=state.kf.orient_w[last], anchor_transl=state.kf.transl_w[last])
            ev[0] = EV_KEYFRAME
            ev[1:4] = data_o.anchor_orient.to(_F32)
            ev[4:7] = data_o.anchor_transl.to(_F32)
            ev[7] = float(submap_span)
            ev[8] = retired.to(_F32)
            ev[9:12] = ret_o.to(_F32)
            ev[12:15] = ret_t.to(_F32)
            ev[19] = n_kept.to(_F32)
            ev[22] = plaus.to(_F32)
            rs_hi = ret_stamp.to(_F32)
            ev[21] = rs_hi
            ev[23] = (ret_stamp - rs_hi.to(torch.float64)).to(_F32)
        else:
            kf_o = state.kf.orient_w[max_overlap_kf]
            kf_t = state.kf.transl_w[max_overlap_kf]
            R_kf = rot.axang2rotm(kf_o)
            rel_t = R_kf.T @ (curr_pos - kf_t)
            rel_o = rot.rotm2axang(R_kf.T @ rot.axang2rotm(data_o.anchor_orient))
            ev[0] = EV_NONKEYFRAME
            ev[1:4] = rel_o.to(_F32)
            ev[4:7] = rel_t.to(_F32)
            ev[7] = max_overlap_kf.to(_F32)

        state = store_old_window(state, params_opt, data_o)
        ev[15] = sel.overlap_fraction.to(_F32)
        ev[16] = result.stop_reason.to(_F32)
        ev[17] = result.num_gaussians.to(_F32)
        ev[18] = sel.num_active.to(_F32)
        ev[20] = min_grid
        return state, ev

    def window_step(state, sc, acc_dense, gyr_dense, shift_t0, prio):
        data = assemble_window(state, sc, acc_dense, gyr_dense)
        if bool(state.submap_initialized):  # host sync
            chain0 = traced_initial_guess(
                state.ow_orient, state.ow_transl, state.ow_stamps, shift_t0, state.ow_horizon,
                data.ctrl_stamps, data.preint_rot, data.preint_vel, data.preint_pos,
                data.ctrl_stamps[1:] - data.ctrl_stamps[:-1], gravity, sc["use_imu"],
            )
        else:
            acc_for_init = torch.where(sc["acc_init_valid"], sc["acc_init"], data.acc_dense[0])
            anchor_o = torch.where(
                sc["use_imu"], ct.init_gravity_anchor_orientation(acc_for_init, gravity),
                torch.zeros(3, dtype=pdt, device=dev),
            )
            chain0 = cp.PoseChain(
                orient=torch.cat([anchor_o[None], torch.zeros(C - 1, 3, dtype=pdt, device=dev)]),
                transl=torch.zeros(C, 3, dtype=pdt, device=dev),
            )
        data = data._replace(anchor_orient=chain0.orient[0], anchor_transl=chain0.transl[0])
        params0 = cp.params_from_chain(chain0)
        if int(state.kf.count) > 0:  # host sync
            return main_window(state, data, params0, sc, prio)
        return init_map(state, data, params0, sc)

    def step(state: FusedState, pack, aux, prio: StepPriorities) -> FusedState:
        """pack int16 [raw_cap, 5] (xyz at 5 mm, stamp u16, ring); aux f32
        [n_dense + 4, 6] (the reference's layout, fused.py make_step)."""
        rc, D, S = shapes.raw_cap, shapes.n_dense, shapes.n_clouds
        imu_rows, srow, trow, xrow, grow = aux[:D], aux[D], aux[D + 1], aux[D + 2], aux[D + 3]
        acc_dense = imu_rows[:, :3].to(pdt)
        gyr_dense = imu_rows[:, 3:].to(pdt)
        sc = dict(
            dt=srow[0].to(pdt),
            horizon=srow[1].to(pdt),
            scan_t0_rel=trow[:S],
            use_imu=srow[2] > 0.5,
            step_length=srow[3].to(pdt),
            max_step=srow[4].to(pdt),
            balancing_imu=srow[5].to(pdt),
            win_t0=xrow[2].to(torch.float64) + xrow[3].to(torch.float64),
            acc_init=grow[:3].to(pdt),
            acc_init_valid=grow[3] > 0.5,
        )
        shift_t0 = xrow[0].to(pdt)

        raw_pts = pack[:, :3].to(_F32) * PT_SCALE
        qscale = grow[5].to(_F32)
        raw_rel = (pack[:, 3].to(torch.int32) & 0xFFFF).to(_F32) * qscale
        raw_rings = pack[:, 4].to(torch.int32)
        raw_mask = torch.arange(rc, device=dev) < grow[4].to(torch.int64)

        res = pp.preprocess_scan(
            raw_pts, raw_mask, prio.preprocess, c.max_num_points_per_scan, c.min_dist_ds, c.min_dist,
            shapes.scan_cap,
        )
        new_pts = pp.transform_to_imu(raw_pts[res.indices], R_l2i, t_l2i)
        new_pts = torch.where(res.mask[:, None], new_pts, torch.zeros_like(new_pts))
        new_rel = torch.where(res.mask, raw_rel[res.indices], torch.zeros_like(raw_rel[res.indices]))
        new_rings = torch.where(res.mask, raw_rings[res.indices], torch.zeros_like(raw_rings[res.indices]))

        n_scans = int(state.num_scans)  # host sync
        full = n_scans >= S
        slot = S - 1 if full else n_scans
        state = state._replace(
            scan_pts=_roll_push(state.scan_pts, new_pts, full, slot),
            scan_mask=_roll_push(state.scan_mask, res.mask, full, slot),
            scan_rings=_roll_push(state.scan_rings, new_rings, full, slot),
            scan_rel_stamps=_roll_push(state.scan_rel_stamps, new_rel, full, slot),
            scan_grid=_roll_push(state.scan_grid, res.grid_size, full, slot),
            num_scans=torch.clamp(state.num_scans + 1, max=S),
        )
        if min(n_scans + 1, S) >= S:
            state, ev = window_step(state, sc, acc_dense, gyr_dense, shift_t0, prio)
        else:
            ev = new_event()
            ev[19] = res.num_kept.to(_F32)
            ev[20] = res.grid_size
        events = state.events.clone()
        events[int(state.ev_index) % shapes.ev_cap] = ev
        return state._replace(events=events, ev_index=state.ev_index + 1)

    return step
