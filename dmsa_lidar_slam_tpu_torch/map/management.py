"""Host-side keyframe map state and mutations (counterpart of
dmsa_lidar_slam_tpu/map/management.py).

The mutation side of the reference's MapManagement (reference:
include/DMSA/MapManagement.h): add-keyframe with shift-out-oldest semantics
and odometry-prior capture (:311-389), k-closest query (:88-118), submap
extraction (:254-276) and pose write-back (:278-288).  Storage is padded
numpy on the host; the submap problem (to_problem_data) goes to the map's
device, where map.keyframes computes over it.
"""

from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

import torch

from dmsa_lidar_slam_tpu_torch.map import keyframes as kf
from dmsa_lidar_slam_tpu_torch.utils.dtypes import POSE_DTYPE


def _rel_pose(o_prev, t_prev, o_curr, t_curr):
    R_prev = Rotation.from_rotvec(o_prev).as_matrix()
    R_curr = Rotation.from_rotvec(o_curr).as_matrix()
    rel_R = R_prev.T @ R_curr
    rel_o = Rotation.from_matrix(rel_R).as_rotvec()
    rel_t = R_prev.T @ (np.asarray(t_curr) - np.asarray(t_prev))
    return rel_o, rel_t


class KeyframeMap:
    """Fixed-capacity keyframe buffer with global poses as canonical state."""

    def __init__(self, shapes: kf.MapShapes, device, std_dev_acc: float = kf.STD_DEV_ACC):
        K, P = shapes.n_keyframes, shapes.n_pts_per_kf
        self.shapes = shapes
        self.device = torch.device(device)
        self.count = 0
        self.num_updates = 0
        self.local_pts = np.zeros((K, P, 3), dtype=np.float32)
        self.local_normals = np.zeros((K, P, 3), dtype=np.float32)
        self.pt_mask = np.zeros((K, P), dtype=bool)
        self.pt_ring = np.zeros((K, P), dtype=np.int32)
        self.grid_size = np.full(K, np.inf, dtype=np.float32)
        self.orient_w = np.zeros((K, 3), dtype=np.float64)
        self.transl_w = np.zeros((K, 3), dtype=np.float64)
        self.stamps = np.zeros(K, dtype=np.float64)
        self.grav_meas = np.zeros((K, 3), dtype=np.float64)
        self.grav_plausible = np.zeros(K, dtype=bool)
        self.odom_rel_orient = np.zeros((K, 3), dtype=np.float64)
        self.odom_rel_transl = np.zeros((K, 3), dtype=np.float64)
        self.gravity = np.array(kf.GRAVITY_W)
        self.cov_grav_inv = np.linalg.inv(std_dev_acc**2 * np.eye(3))
        self.odom_transl_cov_inv = np.linalg.inv(kf.ODOM_STD**2 * np.eye(3))
        self.odom_orient_cov_inv = np.linalg.inv(kf.ODOM_STD**2 * np.eye(3))

    @property
    def is_initialized(self) -> bool:
        return self.count > 0

    @property
    def is_full(self) -> bool:
        return self.count == self.shapes.n_keyframes

    @property
    def min_grid_size(self) -> float:
        return float(self.grid_size[: self.count].min()) if self.count else np.inf

    def add_keyframe(
        self,
        position_w,
        orient_w,
        stamp: float,
        local_pts,
        local_normals,
        rings,
        grid_size: float,
        grav_meas=None,
        grav_plausible: bool = False,
    ):
        """addKeyframe (MapManagement.h:311-389): append, or shift out the
        oldest when full; capture the relative-odometry prior of the new
        keyframe w.r.t. its predecessor."""
        P = self.shapes.n_pts_per_kf
        n = len(local_pts)
        if n > P:
            raise ValueError(f"keyframe overflow: {n} > capacity {P}")

        if self.is_full:
            # shift out oldest (MapManagement.h:326-335)
            for arr in (
                self.local_pts,
                self.local_normals,
                self.pt_mask,
                self.pt_ring,
                self.grid_size,
                self.orient_w,
                self.transl_w,
                self.stamps,
                self.grav_meas,
                self.grav_plausible,
                self.odom_rel_orient,
                self.odom_rel_transl,
            ):
                arr[:-1] = arr[1:]
            idx = self.shapes.n_keyframes - 1
        else:
            idx = self.count
            self.count += 1
        self.num_updates += 1

        self.local_pts[idx] = 0.0
        self.local_normals[idx] = 0.0
        self.pt_mask[idx] = False
        self.pt_ring[idx] = 0
        self.local_pts[idx, :n] = local_pts
        self.local_normals[idx, :n] = local_normals
        self.pt_ring[idx, :n] = rings
        self.pt_mask[idx, :n] = True
        self.grid_size[idx] = grid_size
        self.orient_w[idx] = orient_w
        self.transl_w[idx] = position_w
        self.stamps[idx] = stamp
        self.grav_meas[idx] = grav_meas if grav_meas is not None else 0.0
        self.grav_plausible[idx] = grav_plausible

        # odometry prior (MapManagement.h:339-355)
        if idx > 0:
            rel_o, rel_t = _rel_pose(
                self.orient_w[idx - 1], self.transl_w[idx - 1], orient_w, position_w
            )
        else:
            rel_o, rel_t = np.asarray(orient_w, float), np.asarray(position_w, float)
        self.odom_rel_orient[idx] = rel_o
        self.odom_rel_transl[idx] = rel_t

    def closest_n_ids(self, pos_w, n: int) -> List[int]:
        """k-closest keyframes by position (getClosestNIds,
        MapManagement.h:88-118)."""
        if self.count == 0:
            return []
        d = np.linalg.norm(self.transl_w[: self.count] - np.asarray(pos_w), axis=1)
        order = np.argsort(d, kind="stable")
        return order[: min(n, self.count)].tolist()

    def relative_chain(self, from_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Relative chain over keyframes [from_id..count-1]; entry 0 is the
        absolute pose of keyframe from_id."""
        m = self.count - from_id
        rel_o = np.zeros((m, 3))
        rel_t = np.zeros((m, 3))
        rel_o[0] = self.orient_w[from_id]
        rel_t[0] = self.transl_w[from_id]
        for j in range(1, m):
            k = from_id + j
            rel_o[j], rel_t[j] = _rel_pose(
                self.orient_w[k - 1], self.transl_w[k - 1], self.orient_w[k], self.transl_w[k]
            )
        return rel_o, rel_t

    def to_problem_data(
        self,
        from_id: int,
        balancing_grav: float,
        balancing_odom: float,
    ) -> Tuple[kf.KeyframeMapData, np.ndarray]:
        """Submap [from_id..count-1] as optimizer data on the map's device
        (getSubmap, MapManagement.h:254-276).  Returns (data, params0
        numpy)."""
        K = self.shapes.n_keyframes
        m = self.count - from_id
        sel = np.arange(from_id, self.count)
        pdt = POSE_DTYPE
        dev = self.device

        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        def pad_rows(a, fill=0):
            out = np.full((K,) + a.shape[1:], fill, dtype=a.dtype)
            out[:m] = a[sel]
            return out

        rel_o, rel_t = self.relative_chain(from_id)
        params0 = np.zeros(6 * (K - 1))
        params0[: 3 * (K - 1)].reshape(K - 1, 3)[: m - 1] = rel_o[1:]
        params0[3 * (K - 1) :].reshape(K - 1, 3)[: m - 1] = rel_t[1:]

        data = kf.KeyframeMapData(
            local_pts=t(pad_rows(self.local_pts)),
            local_normals=t(pad_rows(self.local_normals)),
            pt_mask=t(pad_rows(self.pt_mask)),
            pt_ring=t(pad_rows(self.pt_ring)),
            grid_size=t(pad_rows(self.grid_size, fill=np.inf)),
            kf_mask=t(np.arange(K) < m),
            anchor_orient=t(rel_o[0], pdt),
            anchor_transl=t(rel_t[0], pdt),
            stamps=t(pad_rows(self.stamps)),
            grav_meas=t(pad_rows(self.grav_meas)),
            grav_plausible=t(pad_rows(self.grav_plausible)),
            odom_rel_transl=t(pad_rows(self.odom_rel_transl)),
            odom_rel_orient=t(pad_rows(self.odom_rel_orient)),
            gravity=t(self.gravity, pdt),
            cov_grav_inv=t(self.cov_grav_inv, pdt),
            odom_transl_cov_inv=t(self.odom_transl_cov_inv, pdt),
            odom_orient_cov_inv=t(self.odom_orient_cov_inv, pdt),
            balancing_grav=t(balancing_grav, pdt),
            balancing_odom=t(balancing_odom, pdt),
        )
        return data, params0

    def write_back(self, from_id: int, params: np.ndarray):
        """updatePosesFromSubmap (MapManagement.h:278-288): recompose global
        poses of keyframes from_id+1.. from the optimized relative chain,
        keeping keyframe from_id fixed."""
        K = self.shapes.n_keyframes
        m = self.count - from_id
        rel_o = np.asarray(params[: 3 * (K - 1)]).reshape(K - 1, 3)[: m - 1]
        rel_t = np.asarray(params[3 * (K - 1) :]).reshape(K - 1, 3)[: m - 1]
        R = Rotation.from_rotvec(self.orient_w[from_id]).as_matrix()
        t = self.transl_w[from_id].copy()
        for j in range(m - 1):
            t = t + R @ rel_t[j]
            R = R @ Rotation.from_rotvec(rel_o[j]).as_matrix()
            self.orient_w[from_id + 1 + j] = Rotation.from_matrix(R).as_rotvec()
            self.transl_w[from_id + 1 + j] = t

    def global_cloud(self, keyframe_id: int):
        """One keyframe's points+normals in world frame
        (getGlobalKeyframeCloud, MapManagement.h:290-299)."""
        n = int(self.pt_mask[keyframe_id].sum())
        R = Rotation.from_rotvec(self.orient_w[keyframe_id]).as_matrix().astype(np.float32)
        pts = self.local_pts[keyframe_id, :n] @ R.T + self.transl_w[keyframe_id].astype(np.float32)
        nrm = self.local_normals[keyframe_id, :n] @ R.T
        return pts, nrm, self.pt_ring[keyframe_id, :n]
