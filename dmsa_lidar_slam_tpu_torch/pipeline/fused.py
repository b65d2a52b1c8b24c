"""Fused device-resident SLAM pipeline, one step per scan (counterpart of
dmsa_lidar_slam_tpu/pipeline/fused.py).

All estimator state lives on one explicit device: the preprocessed scan
ring, the keyframe map, the previous window's control poses and a per-scan
event ledger, downloaded in one transfer every `flush_every` scans.  Per
scan the host packs the raw scan (int16 wire format) and a small f32 aux
block, and runs the step: preprocessing, window assembly with IMU
preintegration and the initial guess, static points (K4), the sliding-
window DMSA (K1-K3), the keyframe decision, the submap DMSA (K1-K3) and
one 25-column event row.

The step branches on the host where the reference branches under
lax.cond (buffer full, map initialized, keyframe decision, submap run),
which reads a device scalar each time; PERF.md counts these syncs.

With Config.distributed_keyframe_opt the submap optimization spreads over
the ranks of the process group (parallel.spatial, or parallel.keyframe_dist
with dist_backend="hash"): every rank runs this same pipeline on the same
scans, and the submap's points are sharded over the ranks among which they
divide evenly.  The ranks' states stay bit-identical: each host branch
reads values that are the same on every rank.

Randomness: the reference draws its downsampling priorities from the jax
PRNG, which torch cannot reproduce.  Here the step takes its three int32
priority vectors as an explicit input (StepPriorities); the pipeline draws
them from a torch.Generator seeded with the pack's seed.
"""

import dataclasses
import logging
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.config import Config
from dmsa_lidar_slam_tpu_torch.core import poses as cp
from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.imu.buffer import ImuBuffer
from dmsa_lidar_slam_tpu_torch.map import device_map as dmap
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.map import normals as nrm
from dmsa_lidar_slam_tpu_torch.map import static_points as sp
from dmsa_lidar_slam_tpu_torch.ops import voxel
from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist, launch
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
from dmsa_lidar_slam_tpu_torch.pipeline import preprocess as pp
from dmsa_lidar_slam_tpu_torch.pipeline.metrics import Metrics
from dmsa_lidar_slam_tpu_torch.pipeline.output import OutputManager
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
from dmsa_lidar_slam_tpu_torch.trajectory.device_guess import traced_initial_guess
from dmsa_lidar_slam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from dmsa_lidar_slam_tpu_torch.utils.dtypes import POSE_DTYPE

log = logging.getLogger("dmsa_fused_torch")

# event row (f32): [type, pose(6), related_kf, retired_flag, retired_pose(6),
# overlap, stop_reason, num_gauss, n_kept, grid, retired_stamp_hi, grav_ok,
# retired_stamp_lo, shuffle_overflow] -> width 25; shuffle_overflow = points
# dropped by the spatial backend's all_to_all buckets in the submap
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


def empty_state(shapes: FusedShapes, device) -> FusedState:
    S, cap, C = shapes.n_clouds, shapes.scan_cap, shapes.n_ctrl
    pdt = POSE_DTYPE
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


def make_step(config: Config, shapes: FusedShapes, device, mesh: Optional[pmesh.Mesh] = None,
              metrics: Optional[Metrics] = None):
    """Build the per-scan step: step(state, pack, aux, prio) -> state.  With
    a mesh of more than one rank the submap optimization is distributed over
    it (the ranks outside the mesh take its result).

    The step records into `metrics` (a throwaway Metrics when None) the
    spans step.preprocess, window.assemble, map.init, window.static,
    window.optimize, window.decide, keyframe.cloud and keyframe.submap, the
    latter's children submap.view (the view and its grid), submap.optimize
    (the solve, the mesh's broadcast included) and submap.write_back, the
    optimizer's window.gn.* and submap.gn.* spans (the latter under
    submap.optimize) and iteration counters, and the counters submap.span
    (keyframes per solve) and submap.params (the solve's P), each summed."""
    c = config
    m = Metrics() if metrics is None else metrics
    pdt = POSE_DTYPE
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
    kf_tabular = kfm.make_tabular(sub_mshapes, use_grav_terms, c.use_odometry_term_in_keyframe_opt, True)
    dist_submap_opt = None
    if mesh is not None and mesh.member:
        dist_submap_opt = keyframe_dist.make_submap_optimizer(c, settings_map, mesh, sub_mshapes, use_grav_terms,
                                                              c.use_odometry_term_in_keyframe_opt)

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
        """The submap optimization; returns (state, the spatial shuffle's
        overflow as a card scalar, None on one card)."""
        from_id = max(min_related_adj, 0, int(state.kf.count) - S_sub)
        with m.stage("submap.view"):
            sdata, sparams = dmap.submap_view_capped(
                state.kf, from_id, S_sub, t64(c.balancing_factor_gravity), t64(c.balancing_factor_odometry),
                cov_grav_inv, odom_cov_inv, odom_cov_inv, gravity,
            )
            smin_grid = dmap.min_grid_from(state.kf, from_id)
        m.count("submap.params", sparams.shape[0])
        overflow = None
        with m.stage("submap.optimize"):
            if mesh is None:
                params_new = opt.optimize(kf_fwd, sparams, sdata, settings_map, smin_grid, tabular_fn=kf_tabular,
                                          metrics=m, name="submap").params
            else:
                params_new, overflow = sparams, torch.zeros((), dtype=pdt, device=dev)
                if mesh.member:
                    params_new, ov = dist_submap_opt(sparams, sdata, smin_grid)
                    overflow = ov.to(pdt)
                # the ranks outside the mesh take its result
                out = pmesh.broadcast_from_mesh(mesh, torch.cat([params_new, overflow[None]]))
                params_new, overflow = out[:-1], out[-1]
        with m.stage("submap.write_back"):
            kf = dmap.write_back_capped(state.kf, from_id, params_new)
        return state._replace(kf=kf), overflow

    def main_window(state, data, params0, sc, prio):
        curr_pos = data.anchor_transl
        with m.stage("window.static"):
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

        with m.stage("window.optimize"):
            cdata, origin = ct.centralize(data)
            result = opt.optimize(
                fwd_imu, params0, cdata, settings_window, min_grid,
                step_length=sc["step_length"], max_step=sc["max_step"], tabular_fn=tabular_window,
                metrics=m, name="window",
            )
            data = ct.decentralize(cdata, origin)

        with m.stage("window.decide"):
            params_opt = result.params
            data_o = data._replace(static_mask=torch.zeros_like(data.static_mask))
            count = int(state.kf.count)  # host sync
            last_kf_pos = state.kf.transl_w[max(count - 1, 0)]
            dist = torch.linalg.norm(curr_pos - last_kf_pos)
            new_kf = bool((sel.overlap_fraction < c.min_overlap_new_keyframe) | (dist > c.dist_new_keyframe))
            min_related_adj = int(min_related) - (1 if count >= shapes.kf_cap else 0)

        if new_kf:
            with m.stage("keyframe.cloud"):
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
            shuffle_ov = None
            if run_submap:
                m.count("submap.span", submap_span)
                with m.stage("keyframe.submap"):
                    state, shuffle_ov = do_submap(state, min_related_adj)

        with m.stage("window.decide"):
            ev = new_event()
            if new_kf:
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
                if shuffle_ov is not None:
                    ev[24] = shuffle_ov.to(_F32)
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
        with m.stage("window.assemble"):
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
            map_ready = int(state.kf.count) > 0  # host sync
        if map_ready:
            return main_window(state, data, params0, sc, prio)
        with m.stage("map.init"):
            return init_map(state, data, params0, sc)

    def step(state: FusedState, pack, aux, prio: StepPriorities) -> FusedState:
        """pack int16 [raw_cap, 5] (xyz at 5 mm, stamp u16, ring); aux f32
        [n_dense + 4, 6] (the reference's layout, fused.py make_step)."""
        with m.stage("step.preprocess"):
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


class FusedDmsaSlam:
    """Host wrapper with the reference's public API: one upload and one
    step per scan, batched event download every `flush_every` scans."""

    def __init__(self, config: Optional[Config] = None, flush_every: int = 16, device=DEFAULT_DEVICE):
        self.config = config or Config()
        self.device = resolve(device)
        self.shapes = shapes_from_config(self.config, flush_every)
        self.flush_every = min(flush_every, self.shapes.ev_cap)
        self.mesh = None
        if self.config.distributed_keyframe_opt:
            mesh = launch.global_keyframe_mesh(
                "data", n_points=submap_keyframes(self.config, self.shapes) * self.shapes.kf_pts_cap)
            if mesh.size > 1:
                self.mesh = mesh
            else:
                log.warning("distributed_keyframe_opt requested but only 1 usable device")
        self.metrics = Metrics()
        self.step = make_step(self.config, self.shapes, self.device, mesh=self.mesh, metrics=self.metrics)
        self.state = empty_state(self.shapes, self.device)
        self.imu_buffer = ImuBuffer()
        self.output = OutputManager()
        # tests may replace this to inject priorities (e.g. the reference's)
        self.priorities = lambda seed: draw_priorities(seed, self.shapes, self.device)

        self.time_initialized = False
        self.received_imu = False
        self.buffered_scan = None
        self.scan_counter = 0
        self._flushed_upto = 0
        self._scan_minmax: List = []
        self._window_t0_history: List[float] = []
        self._prev_window_t0: Optional[float] = None
        self._stamp_base: Optional[float] = None
        self._imu_disabled_logged = False
        self.max_submap_span = 0
        self.shuffle_overflow = 0  # points the spatial backend's shuffle dropped (ev[24])

    # ------------------------------------------------------------------ API
    def process_imu(self, acc, gyr, stamp: float):
        if not self.time_initialized:
            return
        self.received_imu = True
        acc = np.array(acc, float)
        if self.config.acceleration_in_g:
            acc = acc * 9.81
        self.imu_buffer.add_measurement(acc, gyr, stamp + self.config.timeshift_to_imu)

    def process_imu_batch(self, acc, gyr, stamps):
        if not self.time_initialized or len(stamps) == 0:
            return
        self.received_imu = True
        acc = np.asarray(acc, float)
        if self.config.acceleration_in_g:
            acc = acc * 9.81
        self.imu_buffer.add_batch(acc, gyr, np.asarray(stamps, float) + self.config.timeshift_to_imu)

    def process_scan(self, points: np.ndarray, stamps: np.ndarray, rings: np.ndarray):
        if not self.time_initialized:
            self.metrics.start_clock(float(stamps.min()))
            self.time_initialized = True
        ratio = self.metrics.realtime_ratio(float(stamps[0]))
        if self.scan_counter % 10 == 0:
            log.info("realtime ratio %.2fx at scan %d", ratio, self.scan_counter)
        if self.buffered_scan is None:
            self.buffered_scan = (points, stamps, rings)
            return
        to_process, self.buffered_scan = self.buffered_scan, (points, stamps, rings)
        self._dispatch(*to_process)
        self.scan_counter += 1
        if self.scan_counter - self._flushed_upto >= self.flush_every:
            with self.metrics.stage("flush"):
                self._flush_events()

    def pack_scan(self, points, stamps, rings):
        """Host half of a step: the int16 wire pack and the f32 aux block
        (numpy), exactly as the reference builds them."""
        c = self.config
        sh = self.shapes
        n = min(len(points), sh.raw_cap)
        if len(points) > sh.raw_cap:
            log.warning("raw scan truncated: %d > %d", len(points), sh.raw_cap)
        scan_t0 = float(stamps[:n].min())
        scan_t1 = float(stamps[:n].max())
        self._scan_minmax.append((scan_t0, scan_t1))
        if len(self._scan_minmax) > sh.n_clouds:
            self._scan_minmax.pop(0)
        mins = [a for a, _ in self._scan_minmax]
        maxs = [b for _, b in self._scan_minmax]
        t0_w = min(mins)
        horizon = max(maxs) - t0_w + 1e-3
        dt = horizon / (sh.n_dense - 1)
        shift_t0 = 0.0 if self._prev_window_t0 is None else t0_w - self._prev_window_t0
        self._prev_window_t0 = t0_w
        self._window_t0_history.append(t0_w)

        use_imu_now = c.use_imu and self.received_imu
        if self.scan_counter == 0 and c.use_imu and not self.received_imu and not self._imu_disabled_logged:
            log.warning("no IMU before initialization; disabling IMU")
            self._imu_disabled_logged = True
            c.use_imu = False
            use_imu_now = False
        if use_imu_now and self.imu_buffer.num_updates > 0:
            dense_t = t0_w + np.arange(sh.n_dense) * dt
            acc_d, gyr_d, timediff = self.imu_buffer.resample_nearest(dense_t)
            if timediff > 0.1:
                log.warning("traj-to-IMU timediff %.3f s", timediff)
        else:
            use_imu_now = False
            acc_d = np.zeros((sh.n_dense, 3))
            gyr_d = np.zeros((sh.n_dense, 3))

        pack = np.zeros((sh.raw_cap, 5), dtype=np.int16)
        aux = np.zeros((sh.aux_rows, 6), dtype=np.float32)
        span = max(scan_t1 - scan_t0, 1e-6)
        qscale = span / 65535.0
        q = np.nan_to_num(np.asarray(points[:n], np.float32) * PT_INV_SCALE, nan=0.0, posinf=0.0, neginf=0.0)
        np.rint(q, out=q)
        bad = np.abs(q).max(axis=1) > 32767.0
        if bad.any():
            q[bad] = 0.0
        pack[:n, :3] = q
        pack[:n, 3] = ((stamps[:n] - scan_t0) * (1.0 / qscale)).astype(np.uint16).view(np.int16)
        pack[:n, 4] = np.asarray(rings[:n]) & 0x7FFF
        D = sh.n_dense
        aux[:D, :3] = acc_d
        aux[:D, 3:] = gyr_d
        aux[D, :] = [
            dt,
            horizon,
            1.0 if use_imu_now else 0.0,
            c.alpha_sliding_window_imu if use_imu_now else c.alpha_sliding_window_no_imu,
            c.max_step_sliding_window_imu if use_imu_now else c.max_step_sliding_window_no_imu,
            c.imu_factor_weight_submap if use_imu_now else 0.0,
        ]
        rel = [a - t0_w for a, _ in self._scan_minmax]
        rel = [0.0] * (sh.n_clouds - len(rel)) + rel
        aux[D + 1, : sh.n_clouds] = rel
        aux[D + 2, 0] = shift_t0
        aux[D + 2, 1] = float(self.scan_counter + 1)
        if self._stamp_base is None:
            self._stamp_base = t0_w
        t0_rel = t0_w - self._stamp_base
        t0_hi = np.float32(t0_rel)
        aux[D + 2, 2] = t0_hi
        aux[D + 2, 3] = np.float32(t0_rel - float(t0_hi))
        acc_init = self.imu_buffer.initial_acc_mean
        if acc_init is not None:
            aux[D + 3, :3] = acc_init
            aux[D + 3, 3] = 1.0
        aux[D + 3, 4] = float(n)
        aux[D + 3, 5] = qscale
        self.received_imu = False
        return pack, aux

    def _dispatch(self, points, stamps, rings):
        with self.metrics.stage("pack_fill"):
            pack, aux = self.pack_scan(points, stamps, rings)
        seed = int(aux[self.shapes.n_dense + 2, 1])
        with self.metrics.stage("upload"):
            pack_dev = torch.from_numpy(pack).to(self.device, non_blocking=True)
            aux_dev = torch.from_numpy(aux).to(self.device, non_blocking=True)
        with self.metrics.stage("step", args=str(self.scan_counter)):
            self.state = self.step(self.state, pack_dev, aux_dev, self.priorities(seed))

    # ------------------------------------------------------------- events
    def _flush_events(self):
        n_new = self.scan_counter - self._flushed_upto
        if n_new <= 0:
            return
        events = self.state.events.cpu().numpy()
        cap = self.shapes.ev_cap
        for i in range(self._flushed_upto, self.scan_counter):
            ev = events[i % cap]
            t0_w = self._window_t0_history[i]
            etype = int(round(ev[0]))
            if etype in (1, 2):
                if etype == 2:
                    self.max_submap_span = max(self.max_submap_span, int(round(ev[7])))
                    ov = int(round(ev[24]))
                    if ov > 0:  # spatial all_to_all bucket overflow
                        self.shuffle_overflow += ov
                        log.warning("spatial shuffle overflow: %d points dropped (total %d)", ov,
                                    self.shuffle_overflow)
                if ev[8] > 0.5 and etype == 2:
                    ret_stamp = (self._stamp_base or 0.0) + float(ev[21]) + float(ev[23])
                    self.output.add_static_keyframe_pose(ev[12:15], ev[9:12], ret_stamp)
                self.output.inform_about_new_keyframe()
            elif etype == 3:
                self.output.add_non_keyframe_pose(ev[4:7], ev[1:4], t0_w, int(ev[7]))
        self._flushed_upto = self.scan_counter

    # ------------------------------------------------------------- outputs
    @property
    def kf_count(self) -> int:
        return int(self.state.kf.count)

    def keyframe_poses(self):
        """(stamps, transl [n,3], orient [n,3]) of the active keyframes."""
        n = self.kf_count
        transl = self.state.kf.transl_w.cpu().numpy()[:n]
        orient = self.state.kf.orient_w.cpu().numpy()[:n]
        base = self._stamp_base or 0.0
        stamps = self.state.kf.stamps.cpu().numpy()[:n] + base if n else np.zeros(0)
        return stamps, transl, orient

    def map_points(self, first: int = 0):
        """Global keyframe map [N, 3] from keyframe `first` on (PCD export,
        viewers); one download of the map state."""
        n = self.kf_count
        if n == 0 or first >= n:
            return None
        from scipy.spatial.transform import Rotation

        kf = self.state.kf
        pts = kf.local_pts[first:n].cpu().numpy()
        msk = kf.pt_mask[first:n].cpu().numpy()
        orient = kf.orient_w[first:n].cpu().numpy()
        transl = kf.transl_w[first:n].cpu().numpy()
        out = []
        for k in range(n - first):
            R = Rotation.from_rotvec(orient[k]).as_matrix().astype(np.float32)
            out.append(pts[k][msk[k]] @ R.T + transl[k].astype(np.float32))
        return np.concatenate(out)

    def submap_points(self, span: int = 8):
        """Clouds of the most recent `span` keyframes (the live view's submap,
        dmsa_slam_ros.cpp:222-225)."""
        return self.map_points(first=max(0, self.kf_count - span))

    def current_pose(self):
        """(position [3], rotvec [3]) of the latest keyframe pose."""
        n = self.kf_count
        if n == 0:
            return None
        return (
            self.state.kf.transl_w[n - 1].cpu().numpy().astype(float),
            self.state.kf.orient_w[n - 1].cpu().numpy().astype(float),
        )

    def all_poses(self):
        self._flush_events()
        stamps, transl, orient = self.keyframe_poses()
        return self.output.dense_poses_list(stamps, transl, orient)

    def save_poses(self, result_dir: str) -> str:
        self._flush_events()
        stamps, transl, orient = self.keyframe_poses()
        return self.output.save_dense_poses(stamps, transl, orient, result_dir)
