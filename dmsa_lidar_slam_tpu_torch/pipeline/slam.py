"""The host-orchestrated SLAM pipeline (counterpart of
dmsa_lidar_slam_tpu/pipeline/slam.py; DmsaSlam, include/DMSA/DmsaSlam.h).

Host-side control flow mirroring the reference, driving PyTorch stages on
one device (the card unless the caller asks for the CPU):

  scan -> preprocess -> ring buffer -> window build + initial guess ->
  static-point selection (K4) -> sliding-window DMSA (structured
  Gauss-Newton) -> keyframe decision -> keyframe creation (normals: K5 on
  the card) + submap DMSA -> output ledger.

With Config.distributed_keyframe_opt the submap DMSA goes over the ranks
of the process group instead (_distributed_keyframe_optimize; K1-K3 on
every rank with the default spatial backend).

Randomness: the reference draws its three downsampling priority vectors
(preprocess, static points, keyframe cloud) from jax.random.PRNGKey(counter)
with a per-call counter.  Here they come from `self.priorities(counter, n)`,
by default a torch.Generator seeded with the counter; tests replace it to
feed the reference's own bits.
"""

import logging
from typing import List, Optional

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from dmsa_lidar_slam_tpu_torch.config import Config
from dmsa_lidar_slam_tpu_torch.core import poses as cp
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.imu.buffer import ImuBuffer
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.map import normals as nrm
from dmsa_lidar_slam_tpu_torch.map import static_points as sp
from dmsa_lidar_slam_tpu_torch.map.management import KeyframeMap
from dmsa_lidar_slam_tpu_torch.ops import voxel
from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist, launch
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
from dmsa_lidar_slam_tpu_torch.pipeline import preprocess as pp
from dmsa_lidar_slam_tpu_torch.pipeline.metrics import Metrics
from dmsa_lidar_slam_tpu_torch.pipeline.output import OutputManager
from dmsa_lidar_slam_tpu_torch.trajectory import builder
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
from dmsa_lidar_slam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from dmsa_lidar_slam_tpu_torch.utils.dtypes import POSE_DTYPE

log = logging.getLogger("dmsa_slam_torch")


def draw_priorities(counter: int, n: int, device) -> torch.Tensor:
    """int32 [n] downsampling priorities from a torch.Generator seeded with
    `counter`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(counter))
    return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, generator=g, device=device)


class OldWindow(object):
    """Previous window's optimized control poses (for the initial guess)."""

    __slots__ = ("orient_w", "transl_w", "ctrl_stamps", "t0", "horizon")

    def __init__(self, orient_w, transl_w, ctrl_stamps, t0, horizon):
        self.orient_w = orient_w
        self.transl_w = transl_w
        self.ctrl_stamps = ctrl_stamps
        self.t0 = t0
        self.horizon = horizon


class DmsaSlam:
    def __init__(self, config: Optional[Config] = None, device=DEFAULT_DEVICE):
        self.config = config or Config()
        c = self.config
        self.device = resolve(device)

        self.scan_cap = -(-int(c.scan_cap_factor * c.max_num_points_per_scan) // 256) * 256
        self.window_shapes = ct.WindowShapes(
            n_window_pts=c.n_clouds * self.scan_cap,
            n_static=c.static_points_cap,
            n_ctrl=c.num_control_poses,
            n_dense=c.n_dense,
        )
        self.map_shapes = kfm.MapShapes(n_keyframes=c.last_n_keyframes_for_optim, n_pts_per_kf=c.keyframe_points_cap)

        self.imu_buffer = ImuBuffer()
        self.scan_buffer: List[builder.HostScan] = []
        self.scan_updates = 0
        self.buffered_scan = None  # one-cloud delay (DmsaSlam.h:121-132)
        self.kf_map = KeyframeMap(self.map_shapes, self.device)
        self.output = OutputManager()
        self.metrics = Metrics()

        self.time_initialized = False
        self.submap_initialized = False
        self.received_imu = False
        self.old_window: Optional[OldWindow] = None
        self._prng_counter = 0
        self._dist_kf_mesh = None  # the distributed keyframe optimization's mesh and
        self._dist_kf_opt = None  # optimizer, built at their first use
        # tests may replace this to inject priorities (e.g. the reference's)
        self.priorities = lambda counter, n: draw_priorities(counter, n, self.device)

        # optimizer settings (initConfig, DmsaSlam.h:84-99)
        self.settings_window_imu = opt.OptimSettings(
            num_iter=c.num_iter_sliding_window_optim,
            min_num_points_per_set=c.min_num_points_gauss,
            step_length_optim=c.alpha_sliding_window_imu,
            max_step=c.max_step_sliding_window_imu,
        )
        self.settings_window_no_imu = opt.OptimSettings(
            num_iter=c.num_iter_sliding_window_optim,
            min_num_points_per_set=c.min_num_points_gauss,
            step_length_optim=c.alpha_sliding_window_no_imu,
            max_step=c.max_step_sliding_window_no_imu,
        )
        self.settings_map = opt.OptimSettings(
            num_iter=c.num_iter_keyframe_optim,
            min_num_points_per_set=c.min_num_points_gauss_key,
            step_length_optim=c.alpha_keyframe_optim,
            max_step=0.01,
            epsilon=c.epsilon_keyframe_opt,
            grid_size_1_factor=2.0,  # DmsaSlam.h:97-98 (1.5 overwritten)
            grid_size_2_factor=5.0,
            use_centralization=False,  # MapManagement.h:73-86 disables it
        )

        T = c.lidar_to_imu_tform
        self._R_l2i = np.asarray(T[:3, :3], dtype=np.float32)
        self._t_l2i = np.asarray(T[:3, 3], dtype=np.float32)

    def _t(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ IMU
    def process_imu(self, acc, gyr, stamp: float):
        """processImuMeasurements (DmsaSlam.h:101-114)."""
        if not self.time_initialized:
            return
        self.received_imu = True
        acc = np.array(acc, float)
        if self.config.acceleration_in_g:
            acc = acc * 9.81  # dmsa_slam_ros.cpp:312-316
        self.imu_buffer.add_measurement(acc, gyr, stamp + self.config.timeshift_to_imu)

    def process_imu_batch(self, acc, gyr, stamps):
        if not self.time_initialized or len(stamps) == 0:
            return
        self.received_imu = True
        acc = np.asarray(acc, float)
        if self.config.acceleration_in_g:
            acc = acc * 9.81
        self.imu_buffer.add_batch(acc, gyr, np.asarray(stamps, float) + self.config.timeshift_to_imu)

    # ----------------------------------------------------------------- scan
    def _next_priorities(self, n: int) -> torch.Tensor:
        self._prng_counter += 1
        return self.priorities(self._prng_counter, n)

    def process_scan(self, points: np.ndarray, stamps: np.ndarray, rings: np.ndarray):
        """processPointCloud (DmsaSlam.h:116-204).

        points [n, 3] f32 in the LIDAR frame, stamps [n] f64 absolute
        seconds, rings [n] int."""
        c = self.config
        if not self.time_initialized:
            self.metrics.start_clock(float(stamps.min()))
            self.time_initialized = True

        ratio = self.metrics.realtime_ratio(float(stamps[0]))
        if self.scan_updates % 10 == 0:
            log.info("realtime ratio %.2fx at scan %d", ratio, self.scan_updates)

        # one-cloud delay so IMU coverage exists for the newest scan
        if self.buffered_scan is None:
            self.buffered_scan = (points, stamps, rings)
            return
        to_process, self.buffered_scan = self.buffered_scan, (points, stamps, rings)
        points, stamps, rings = to_process

        scan = self._preprocess(points, stamps, rings)
        self.scan_buffer.append(scan)
        self.scan_updates += 1
        if len(self.scan_buffer) > c.n_clouds:
            self.scan_buffer.pop(0)
        if len(self.scan_buffer) < c.n_clouds:
            log.info("scan buffer filling %d/%d", len(self.scan_buffer), c.n_clouds)
            return
        self._run_window()

    def _preprocess(self, points, stamps, rings) -> builder.HostScan:
        """preProcess (DmsaSlam.h:570-634) on the device + host gather."""
        c = self.config
        with self.metrics.stage("preprocess"):
            n = len(points)
            # raw padding must cover the post-downsample capacity
            cap_raw = max(c.raw_scan_cap, self.scan_cap)
            if n > cap_raw:
                log.warning("raw scan truncated: %d > %d", n, cap_raw)
                points, stamps, rings = points[:cap_raw], stamps[:cap_raw], rings[:cap_raw]
                n = cap_raw
            raw = np.zeros((cap_raw, 3), dtype=np.float32)
            raw[:n] = points
            mask = np.zeros(cap_raw, dtype=bool)
            mask[:n] = np.all(np.isfinite(points), axis=1)

            res = pp.preprocess_scan(
                self._t(raw), self._t(mask), self._next_priorities(cap_raw), c.max_num_points_per_scan,
                c.min_dist_ds, c.min_dist, self.scan_cap,
            )
            idx = res.indices.cpu().numpy()
            m = res.mask.cpu().numpy()
            num_kept = int(res.num_kept)
            if num_kept > self.scan_cap:
                log.warning("scan overflow: kept %d > cap %d", num_kept, self.scan_cap)
            sel = idx[m]
            pts_imu = points[sel] @ self._R_l2i.T + self._t_l2i
            grid = float(res.grid_size)
            if self.scan_updates % 10 == 0:
                log.info("grid size preprocessing: %.2f / num points: %d", grid, len(sel))
            return builder.HostScan(
                points=pts_imu.astype(np.float32),
                stamps=stamps[sel].astype(np.float64),
                rings=rings[sel].astype(np.int32),
                grid_size=grid,
            )

    # --------------------------------------------------------------- window
    def _run_window(self):
        c = self.config
        pdt = POSE_DTYPE
        use_imu_now = c.use_imu and self.received_imu

        with self.metrics.stage("window_build"):
            data, t0_w, min_grid, timediff = builder.build_window(
                self.scan_buffer, self.window_shapes, self.imu_buffer if use_imu_now else None, c.cov_gyr,
                c.cov_acc, c.imu_factor_weight_submap, use_imu_now, self.device,
            )
            if use_imu_now and timediff > 0.1:
                log.warning("traj-to-IMU timediff %.3f s", timediff)

        # deactivate IMU permanently if absent at init (DmsaSlam.h:431-435)
        if not self.submap_initialized and c.use_imu and not self.received_imu:
            log.warning("no IMU data before initialization; disabling IMU")
            c.use_imu = False
            use_imu_now = False

        # initial guess (updateInitialGuess, ContinuousTrajectory.h:367-469)
        shapes = self.window_shapes
        if not self.submap_initialized:
            if use_imu_now:
                # gravity init from the static-start mean acc when available
                acc0 = self.imu_buffer.initial_acc_mean
                acc0 = data.acc_dense[0] if acc0 is None else self._t(acc0, pdt)
                data = data._replace(anchor_orient=ct.init_gravity_anchor_orientation(acc0, data.gravity))
            self.submap_initialized = True
            params0 = torch.zeros(6 * (shapes.n_ctrl - 1), dtype=pdt, device=self.device)
        else:
            ow = self.old_window
            ctrl_stamps = data.ctrl_stamps.cpu().numpy()
            last_known = 0
            for k in range(shapes.n_ctrl):
                if t0_w + ctrl_stamps[k] < ow.t0 + ow.horizon:
                    last_known = k
            chain = ct.initial_guess(
                cp.GlobalPoses(self._t(ow.orient_w, pdt), self._t(ow.transl_w, pdt)),
                self._t(ow.ctrl_stamps, pdt),
                ow.t0,
                t0_w,
                data.ctrl_stamps,
                (data.preint_rot, data.preint_vel, data.preint_pos),
                data.ctrl_stamps[1:] - data.ctrl_stamps[:-1],
                data.gravity,
                use_imu_now,
                last_known,
                shapes.n_ctrl,
            )
            data = data._replace(anchor_orient=chain.orient[0], anchor_transl=chain.transl[0])
            params0 = cp.params_from_chain(chain)

        fwd = ct.make_forward(shapes, use_imu=use_imu_now)
        structured = ct.make_structured(shapes, use_imu=use_imu_now)

        # map init from the first full window (DmsaSlam.h:153-157,469-498)
        if not self.kf_map.is_initialized:
            self._initialize_map(params0, data, t0_w, use_imu_now)
            self._store_old_window(params0, data, t0_w)
            return

        # static points + overlap (DmsaSlam.h:159-163,264-358)
        with self.metrics.stage("static_points"):
            sel, max_overlap_key, min_related_key = self._add_static_points(fwd, params0, data, min_grid)
            overlap = float(sel.overlap_fraction) if sel is not None else 0.0
            if sel is not None:
                data = data._replace(static_pts=sel.static_pts, static_mask=sel.static_mask, static_ring=sel.static_ring)

        # sliding-window optimization (DmsaSlam.h:166)
        settings = self.settings_window_imu if use_imu_now else self.settings_window_no_imu
        with self.metrics.stage("window_optimize"):
            cdata, origin = ct.centralize(data)
            result = opt.optimize(fwd, params0, cdata, settings, min_grid, structured_fn=structured)
            data = ct.decentralize(cdata, origin)
            params_opt = result.params
        if log.isEnabledFor(logging.INFO):
            log.info("window optim: iters=%d stop=%d gaussians=%d", int(result.num_iters),
                     int(result.stop_reason), int(result.num_gaussians))

        # drop static points (DmsaSlam.h:168)
        data = data._replace(static_mask=torch.zeros_like(data.static_mask))
        self._store_old_window(params_opt, data, t0_w)

        # keyframe decision (DmsaSlam.h:170-201)
        curr_pos = data.anchor_transl.cpu().numpy().astype(float)
        last_kf_pos = self.kf_map.transl_w[self.kf_map.count - 1]
        dist = float(np.linalg.norm(curr_pos - last_kf_pos))
        if overlap < c.min_overlap_new_keyframe or dist > c.dist_new_keyframe:
            if self.kf_map.is_full:
                min_related_key -= 1
            log.info("add keyframe no. %d overlap %.2f", self.kf_map.num_updates, overlap)
            with self.metrics.stage("keyframe_create"):
                self._add_new_keyframe(fwd, params_opt, data, t0_w, min_grid, use_imu_now)
            if c.optimize_sliding_window_keyframes:
                with self.metrics.stage("keyframe_optimize"):
                    self._keyframe_optimization(min_related_key)
        else:
            # non-keyframe pose relative to the max-overlap keyframe (DmsaSlam.h:189-199)
            kf_o = self.kf_map.orient_w[max_overlap_key]
            kf_t = self.kf_map.transl_w[max_overlap_key]
            R_kf = Rotation.from_rotvec(kf_o).as_matrix()
            anchor_o = data.anchor_orient.cpu().numpy().astype(float)
            rel_t = R_kf.T @ (curr_pos - kf_t)
            rel_R = R_kf.T @ Rotation.from_rotvec(anchor_o).as_matrix()
            self.output.add_non_keyframe_pose(rel_t, Rotation.from_matrix(rel_R).as_rotvec(), t0_w, max_overlap_key)

        self.received_imu = False

    def _store_old_window(self, params, data, t0_w):
        _, gp, _, _ = ct.dense_poses(params, data, self.window_shapes)
        self.old_window = OldWindow(
            orient_w=gp.orient.cpu().numpy(),
            transl_w=gp.transl.cpu().numpy(),
            ctrl_stamps=data.ctrl_stamps.cpu().numpy(),
            t0=t0_w,
            horizon=float(data.horizon),
        )

    # ------------------------------------------------------------ keyframes
    def _initialize_map(self, params, data, t0_w, use_imu_now):
        """initializeMap (DmsaSlam.h:469-498): first keyframe from the
        oldest scan in the buffer, local points as they are (IMU frame)."""
        scan0 = self.scan_buffer[0]
        P = self.map_shapes.n_pts_per_kf
        if len(scan0.points) > P:
            log.warning("keyframe cloud overflow at init: %d > cap %d", len(scan0.points), P)
        n = min(len(scan0.points), P)
        pts = scan0.points[:n]
        rings = scan0.rings[:n]
        normals = nrm.estimate_normals(self._t(pts), torch.ones(n, dtype=torch.bool, device=self.device), scan0.grid_size)
        grav, plaus = self._gravity_estimate(params, data, use_imu_now)
        self.kf_map.add_keyframe(
            data.anchor_transl.cpu().numpy().astype(float), data.anchor_orient.cpu().numpy().astype(float), t0_w,
            pts, normals.cpu().numpy(), rings, scan0.grid_size, grav, plaus,
        )
        self.output.inform_about_new_keyframe()

    def _gravity_estimate(self, params, data, use_imu_now):
        if not use_imu_now:
            return np.zeros(3), False
        _, gp, _, d_t = ct.dense_poses(params, data, self.window_shapes)
        grav = ct.submap_gravity_estimate(gp, d_t, data, self.window_shapes).cpu().numpy().astype(float)
        plaus = abs(np.linalg.norm(grav) - np.linalg.norm(self.kf_map.gravity)) < self.config.gravity_outlier_thresh
        if not plaus:
            log.info("discarded implausible gravity estimate |g|=%.2f", np.linalg.norm(grav))
        return grav, plaus

    def _add_static_points(self, fwd, params, data, min_grid):
        """addStaticPoints (DmsaSlam.h:264-358)."""
        c = self.config
        curr_pos = data.anchor_transl.cpu().numpy().astype(float)
        ids = self.kf_map.closest_n_ids(curr_pos, c.closest_k_keyframes_as_static_points)
        ids = [k for k in ids if np.linalg.norm(curr_pos - self.kf_map.transl_w[k]) < c.dist_static_points_keyframe]
        if not ids:
            return None, 0, -1

        S = c.closest_k_keyframes_as_static_points
        P = self.map_shapes.n_pts_per_kf
        kf_pts = np.zeros((S, P, 3), dtype=np.float32)
        kf_nrm = np.zeros((S, P, 3), dtype=np.float32)
        kf_rng = np.zeros((S, P), dtype=np.int32)
        kf_msk = np.zeros((S, P), dtype=bool)
        for j, k in enumerate(ids):
            pts, normals, rings = self.kf_map.global_cloud(k)
            kf_pts[j, : len(pts)] = pts
            kf_nrm[j, : len(pts)] = normals
            kf_rng[j, : len(pts)] = rings
            kf_msk[j, : len(pts)] = True

        out = fwd(params, data)
        nw = self.window_shapes.n_window_pts
        sel = sp.select_static_points(
            out.points[:nw], out.mask[:nw], self._t(kf_pts), self._t(kf_nrm), self._t(kf_rng), self._t(kf_msk),
            self._t(curr_pos, torch.float32), self._t(min_grid, torch.float32), self._next_priorities(S * P),
            self.window_shapes.n_static,
        )
        counts = sel.overlap_counts.cpu().numpy()
        num_active = int(sel.num_active)
        if num_active > self.window_shapes.n_static:
            log.warning("static point overflow: %d > cap %d", num_active, self.window_shapes.n_static)
        max_overlap_key = ids[int(np.argmax(counts[: len(ids)]))]
        with_pts = [ids[j] for j in range(len(ids)) if counts[j] > 0]
        min_related = min(with_pts) if with_pts else -1
        if self.scan_updates % 10 == 0:
            log.info("num pts active: %d mapsize: %d/%d", num_active, self.kf_map.count, self.map_shapes.n_keyframes)
        return sel, max_overlap_key, min_related

    def _add_new_keyframe(self, fwd, params, data, t0_w, min_grid, use_imu_now):
        """addNewKeyframeToMap (DmsaSlam.h:500-555)."""
        out = fwd(params, data)
        nw = self.window_shapes.n_window_pts
        P = self.map_shapes.n_pts_per_kf
        pts_c, rings_c, m, n_kept = voxel.downsample_compact(
            out.points[:nw], out.mask[:nw], out.ring_ids[:nw], min_grid, self._next_priorities(nw), P)
        if int(n_kept) > P:
            log.warning("keyframe cloud overflow: %d > cap %d", int(n_kept), P)
        mask = m.cpu().numpy()
        pts_w = pts_c.cpu().numpy()[mask]
        rings = rings_c.cpu().numpy()[mask]

        anchor_o = data.anchor_orient.cpu().numpy().astype(float)
        anchor_t = data.anchor_transl.cpu().numpy().astype(float)
        R_inv = Rotation.from_rotvec(anchor_o).as_matrix().T.astype(np.float32)
        pts_local = (pts_w - anchor_t.astype(np.float32)) @ R_inv.T

        normals = nrm.estimate_normals(
            self._t(pts_local), torch.ones(len(pts_local), dtype=torch.bool, device=self.device), min_grid
        )
        grav, plaus = self._gravity_estimate(params, data, use_imu_now)

        # retire the oldest keyframe to the output ledger (DmsaSlam.h:549-553)
        if self.kf_map.is_full:
            self.output.add_static_keyframe_pose(self.kf_map.transl_w[0], self.kf_map.orient_w[0], self.kf_map.stamps[0])
        self.output.inform_about_new_keyframe()
        self.kf_map.add_keyframe(anchor_t, anchor_o, t0_w, pts_local, normals.cpu().numpy(), rings, min_grid, grav, plaus)

    def _keyframe_optimization(self, from_id: int):
        """keyframeOptimization (DmsaSlam.h:212-238)."""
        c = self.config
        if from_id < 0 or self.map_shapes.n_keyframes < 3 or self.kf_map.count < 2:
            return
        if c.submap_max_keyframes:
            # the same explicit span cap as the fused pipeline
            from_id = max(from_id, self.kf_map.count - c.submap_max_keyframes)
        use_grav = c.use_gravity_term_in_keyframe_opt and c.use_imu
        use_odom = c.use_odometry_term_in_keyframe_opt

        data, params0 = self.kf_map.to_problem_data(from_id, c.balancing_factor_gravity, c.balancing_factor_odometry)
        min_grid = float(self.kf_map.grid_size[from_id : self.kf_map.count].min())
        if c.distributed_keyframe_opt:
            params_opt = self._distributed_keyframe_optimize(
                data, self._t(params0, POSE_DTYPE), min_grid, use_grav, use_odom, from_id)
        else:
            fwd = kfm.make_forward(self.map_shapes, use_grav, use_odom, True)
            structured = kfm.make_structured(self.map_shapes, use_grav, use_odom, True)
            result = opt.optimize(fwd, self._t(params0, POSE_DTYPE), data, self.settings_map, min_grid,
                                  structured_fn=structured)
            if log.isEnabledFor(logging.INFO):
                log.info("keyframe optim from %d: iters=%d stop=%d gaussians=%d", from_id, int(result.num_iters),
                         int(result.stop_reason), int(result.num_gaussians))
            params_opt = result.params
        self.kf_map.write_back(from_id, params_opt.cpu().numpy())

        # re-anchor the current trajectory at the corrected last keyframe (DmsaSlam.h:233-237)
        last = self.kf_map.count - 1
        self._reanchor_old_window(self.kf_map.orient_w[last], self.kf_map.transl_w[last])

    def _distributed_keyframe_optimize(self, data, params0, min_grid: float, use_grav: bool, use_odom: bool,
                                       from_id: int):
        """keyframeOptimization over the ranks of the process group
        (parallel.spatial, or parallel.keyframe_dist with dist_backend=
        "hash"): the submap's points sharded over the ranks among which they
        divide evenly, the normal equations reduced over the mesh, the small
        chain solve replicated.  Without a process group the mesh is this
        one rank.  The mesh and the optimizer are built at the first submap
        and serve every later one."""
        if self._dist_kf_mesh is None:
            self._dist_kf_mesh = launch.global_keyframe_mesh(
                "data", n_points=self.map_shapes.n_keyframes * self.map_shapes.n_pts_per_kf)
            if self._dist_kf_mesh.member:
                self._dist_kf_opt = keyframe_dist.make_submap_optimizer(
                    self.config, self.settings_map, self._dist_kf_mesh, self.map_shapes, use_grav, use_odom)
        mesh = self._dist_kf_mesh
        params = params0
        if mesh.member:
            params, overflow = self._dist_kf_opt(params0, data, min_grid)
            if int(overflow):
                log.warning("spatial shuffle overflow: %d points dropped", int(overflow))
            log.info("distributed keyframe optim from %d over %d ranks", from_id, mesh.size)
        return pmesh.broadcast_from_mesh(mesh, params)

    def _reanchor_old_window(self, new_anchor_o, new_anchor_t):
        """Replace the stored window's anchor pose and recompose its global
        control poses, keeping the relative chain (host math on a few
        poses)."""
        ow = self.old_window
        if ow is None:
            return
        n = len(ow.orient_w)
        R_old = Rotation.from_rotvec(ow.orient_w).as_matrix()
        rel_R = [R_old[k - 1].T @ R_old[k] for k in range(1, n)]
        rel_t = [R_old[k - 1].T @ (ow.transl_w[k] - ow.transl_w[k - 1]) for k in range(1, n)]
        R = Rotation.from_rotvec(np.asarray(new_anchor_o)).as_matrix()
        t = np.asarray(new_anchor_t, dtype=float).copy()
        ow.orient_w[0] = new_anchor_o
        ow.transl_w[0] = t
        for k in range(1, n):
            t = t + R @ rel_t[k - 1]
            R = R @ rel_R[k - 1]
            ow.orient_w[k] = Rotation.from_matrix(R).as_rotvec()
            ow.transl_w[k] = t

    # ---------------------------------------------------------------- misc
    def map_points(self, first: int = 0):
        """Assembled global keyframe map [N, 3] (PCD export, viewers)."""
        if self.kf_map.count == 0 or first >= self.kf_map.count:
            return None
        parts = [self.kf_map.global_cloud(k)[0] for k in range(first, self.kf_map.count)]
        return np.concatenate(parts, axis=0)

    def submap_points(self, span: int = 8):
        """Clouds of the most recent `span` keyframes (the live view's
        submap, dmsa_slam_ros.cpp:222-225)."""
        return self.map_points(first=max(0, self.kf_map.count - span))

    def current_pose(self):
        """(position [3], rotvec [3]) of the latest keyframe pose."""
        n = self.kf_map.count
        if n == 0:
            return None
        return np.array(self.kf_map.transl_w[n - 1], float), np.array(self.kf_map.orient_w[n - 1], float)

    def save_poses(self, result_dir: str) -> str:
        """savePoses (DmsaSlam.h:206-209)."""
        n = self.kf_map.count
        return self.output.save_dense_poses(
            self.kf_map.stamps[:n], self.kf_map.transl_w[:n], self.kf_map.orient_w[:n], result_dir
        )
