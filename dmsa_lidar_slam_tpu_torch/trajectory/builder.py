"""Host-side assembly of WindowData from the scan and IMU buffers
(counterpart of dmsa_lidar_slam_tpu/trajectory/builder.py;
prepareTrajectoryForOptimization, DmsaSlam.h:416-467).

Window timing from the scan buffer's min/max point stamps, dense-grid IMU
resampling, preintegration factors, per-point transform indices, and the
static-point slots (filled later by the static-point selection).  The
scans live on the host as numpy; the WindowData goes to `device`.
"""

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.imu.buffer import ImuBuffer
from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
from dmsa_lidar_slam_tpu_torch.utils.dtypes import POSE_DTYPE


class HostScan(NamedTuple):
    """One preprocessed scan on the host (already in the IMU frame)."""

    points: np.ndarray  # [n, 3] f32
    stamps: np.ndarray  # [n] f64 absolute
    rings: np.ndarray  # [n] i32
    grid_size: float


def build_window(
    scans: List[HostScan],
    shapes: ct.WindowShapes,
    imu_buffer: Optional[ImuBuffer],
    cov_gyr: np.ndarray,
    cov_acc: np.ndarray,
    balancing_imu: float,
    use_imu: bool,
    device,
    anchor_orient=None,
    anchor_transl=None,
):
    """Returns (WindowData on `device`, t0, min_grid_size, imu_timediff)."""
    pdt = POSE_DTYPE
    dev = torch.device(device)

    def t64(x):
        return torch.as_tensor(np.asarray(x), dtype=pdt, device=dev)

    all_stamps = np.concatenate([s.stamps for s in scans])
    t0 = float(all_stamps.min())
    t_max = float(all_stamps.max())
    # horizon includes one extra dt_res-like step (ContinuousTrajectory.h:309)
    horizon = t_max - t0 + 0.001
    dt = horizon / (shapes.n_dense - 1)

    nw = shapes.n_window_pts
    pts = np.zeros((nw, 3), dtype=np.float32)
    rel_stamps = np.zeros(nw, dtype=np.float64)
    rings = np.zeros(nw, dtype=np.int32)
    mask = np.zeros(nw, dtype=bool)
    total = sum(len(s.points) for s in scans)
    if total > nw:
        raise ValueError(f"window overflow: {total} points > capacity {nw}")
    off = 0
    for s in scans:
        n = len(s.points)
        pts[off : off + n] = s.points
        rel_stamps[off : off + n] = s.stamps - t0
        rings[off : off + n] = s.rings
        mask[off : off + n] = True
        off += n

    tform_idx = np.minimum(np.ceil(rel_stamps / dt - 1e-9).astype(np.int32), shapes.n_dense - 1)
    tform_idx = np.maximum(tform_idx, 0)
    tform_idx[~mask] = 0
    ctrl_stamps = np.asarray(shapes.param_indices, dtype=np.float64) * dt

    # IMU resampling onto the dense grid (transferImuMeasurements)
    imu_timediff = 0.0
    if use_imu and imu_buffer is not None and imu_buffer.num_updates > 0:
        dense_t = t0 + np.arange(shapes.n_dense) * dt
        acc_dense, gyr_dense, imu_timediff = imu_buffer.resample_nearest(dense_t)
    else:
        use_imu = False
        acc_dense = np.zeros((shapes.n_dense, 3))
        gyr_dense = np.zeros((shapes.n_dense, 3))

    K = shapes.n_ctrl - 1
    if use_imu:
        pr_rot, pr_vel, pr_pos, cov_inv, pr_full = ct.compute_preint_factors(
            t64(gyr_dense), t64(acc_dense), t64(dt), t64(cov_gyr), t64(cov_acc), shapes
        )
    else:
        pr_rot = torch.eye(3, dtype=pdt, device=dev).repeat(K, 1, 1)
        pr_vel = torch.zeros(K, 3, dtype=pdt, device=dev)
        pr_pos = torch.zeros(K, 3, dtype=pdt, device=dev)
        cov_inv = torch.eye(9, dtype=pdt, device=dev).repeat(K, 1, 1)
        pr_full = torch.zeros(3, dtype=pdt, device=dev)

    ns = shapes.n_static
    data = ct.WindowData(
        local_pts=torch.as_tensor(pts, device=dev),
        pt_mask=torch.as_tensor(mask, device=dev),
        pt_ring=torch.as_tensor(rings, device=dev),
        pt_tform_idx=torch.as_tensor(tform_idx, device=dev),
        static_pts=torch.zeros(ns, 3, dtype=torch.float32, device=dev),
        static_mask=torch.zeros(ns, dtype=torch.bool, device=dev),
        static_ring=torch.zeros(ns, dtype=torch.int32, device=dev),
        anchor_orient=t64(np.zeros(3) if anchor_orient is None else anchor_orient),
        anchor_transl=t64(np.zeros(3) if anchor_transl is None else anchor_transl),
        ctrl_stamps=t64(ctrl_stamps),
        dt=t64(dt),
        horizon=t64(horizon),
        acc_dense=t64(acc_dense),
        gyr_dense=t64(gyr_dense),
        gravity=t64(ct.GRAVITY_W),
        preint_rot=pr_rot,
        preint_vel=pr_vel,
        preint_pos=pr_pos,
        cov_inv=cov_inv,
        preint_pos_full=pr_full,
        balancing_imu=t64(balancing_imu),
    )
    min_grid = min(s.grid_size for s in scans)
    return data, t0, min_grid, imu_timediff
