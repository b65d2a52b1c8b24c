# Copy of dmsa_lidar_slam_tpu/pipeline/output.py; only the imports differ.
"""Trajectory output ledger and TUM-format writer.

Equivalent of the reference's OutputManagement (reference:
include/DMSA/OutputManagement.h): interleaves keyframe poses and
non-keyframe poses (stored relative to their reference keyframe and made
global lazily once that keyframe retires from the active buffer), and
writes `stamp tx ty tz qx qy qz qw` lines (:80-96).
"""

import os
from typing import List, Optional

import numpy as np
from scipy.spatial.transform import Rotation


class _NonKeyframePose(object):
    __slots__ = ("transl", "orient", "stamp", "relative", "related_keyframe_id")

    def __init__(self, transl, orient, stamp, related_keyframe_id):
        self.transl = np.array(transl, dtype=float)
        self.orient = np.array(orient, dtype=float)
        self.stamp = float(stamp)
        self.relative = True
        self.related_keyframe_id = int(related_keyframe_id)


class OutputManager:
    def __init__(self):
        self.order_is_key: List[bool] = []
        self.static_keyframes: List[tuple] = []  # (stamp, transl, orient)
        self.non_keyframes: List[_NonKeyframePose] = []

    @property
    def num_static_keyframes(self) -> int:
        return len(self.static_keyframes)

    def inform_about_new_keyframe(self):
        self.order_is_key.append(True)

    def add_static_keyframe_pose(self, transl, orient, stamp: float):
        """Oldest keyframe retires from the ring buffer
        (addStaticKeyframePose, OutputManagement.h:46-53)."""
        self.static_keyframes.append(
            (float(stamp), np.array(transl, float).copy(), np.array(orient, float).copy())
        )

    def add_non_keyframe_pose(self, transl_from_kf, orient_from_kf, stamp: float, keyframe_id: int):
        """Pose relative to active keyframe `keyframe_id` (0-based into the
        live buffer); stored with the absolute ledger id like
        OutputManagement.h:63-74."""
        self.non_keyframes.append(
            _NonKeyframePose(
                transl_from_kf, orient_from_kf, stamp, keyframe_id + self.num_static_keyframes
            )
        )
        self.order_is_key.append(False)

    @staticmethod
    def _tum_line(stamp, pos, orient) -> str:
        q = Rotation.from_rotvec(np.array(orient, float)).as_quat()  # x,y,z,w
        return (
            f"{stamp:.6f} "
            f"{pos[0]:.5f} {pos[1]:.5f} {pos[2]:.5f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )

    def _make_global(self, nk: _NonKeyframePose):
        stamp, kf_t, kf_o = self.static_keyframes[nk.related_keyframe_id]
        R = Rotation.from_rotvec(kf_o).as_matrix()
        nk.transl = R @ nk.transl + kf_t
        nk.orient = Rotation.from_matrix(
            R @ Rotation.from_rotvec(nk.orient).as_matrix()
        ).as_rotvec()
        nk.relative = False

    def dense_poses_list(
        self,
        active_kf_stamps: np.ndarray,
        active_kf_transl: np.ndarray,
        active_kf_orient: np.ndarray,
    ):
        """The merged trajectory in insertion order (saveDensePoses semantics,
        OutputManagement.h:98-180) as (stamps [n], transl [n,3], orient [n,3])."""
        out = []
        key_id = 0
        nsk = self.num_static_keyframes
        non_key_iter = iter(self.non_keyframes)
        for is_key in self.order_is_key:
            if is_key:
                if key_id < nsk:
                    stamp, t, o = self.static_keyframes[key_id]
                    out.append((stamp, t, o))
                else:
                    j = key_id - nsk
                    if j < len(active_kf_stamps):
                        out.append(
                            (
                                float(active_kf_stamps[j]),
                                np.array(active_kf_transl[j], float),
                                np.array(active_kf_orient[j], float),
                            )
                        )
                key_id += 1
            else:
                nk = next(non_key_iter)
                if nk.relative and nk.related_keyframe_id < nsk:
                    self._make_global(nk)
                if nk.relative:
                    j = nk.related_keyframe_id - nsk
                    if j < len(active_kf_stamps):
                        R = Rotation.from_rotvec(np.array(active_kf_orient[j])).as_matrix()
                        pos = R @ nk.transl + np.array(active_kf_transl[j])
                        orient = Rotation.from_matrix(
                            R @ Rotation.from_rotvec(nk.orient).as_matrix()
                        ).as_rotvec()
                        out.append((nk.stamp, pos, orient))
                else:
                    out.append((nk.stamp, nk.transl, nk.orient))
        if not out:
            return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3))
        stamps = np.array([s for s, _, _ in out])
        transl = np.stack([t for _, t, _ in out])
        orient = np.stack([o for _, _, o in out])
        return stamps, transl, orient

    def save_dense_poses(
        self,
        active_kf_stamps: np.ndarray,
        active_kf_transl: np.ndarray,
        active_kf_orient: np.ndarray,
        result_dir: str,
        prefix: str = "",
    ) -> str:
        """Write Poses<prefix>.txt (saveDensePoses, OutputManagement.h:98-180)."""
        os.makedirs(result_dir, exist_ok=True)
        path = os.path.join(result_dir, f"Poses{prefix}.txt")
        stamps, transl, orient = self.dense_poses_list(
            active_kf_stamps, active_kf_transl, active_kf_orient
        )
        lines = [self._tum_line(s, t, o) for s, t, o in zip(stamps, transl, orient)]
        with open(path, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        return path
