"""The pipeline's tunables: a frozen copy of the Config dataclass of
dmsa_lidar_slam_tpu_torch/config.py (the YAML loader left out).  The
benchmark builds it from a configuration file's "pipeline" keys.
"""

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Config:
    # --- reference tunables (Config.h:17-71), reference defaults ---
    n_clouds: int = 5
    num_control_poses: int = 6
    sensor: str = "hesai"
    optimize_sliding_window_keyframes: bool = True
    last_n_keyframes_for_optim: int = 10
    max_num_points_per_scan: int = 3000
    min_dist_ds: float = 30.0
    alpha_keyframe_optim: float = 0.3
    num_iter_keyframe_optim: int = 10

    alpha_sliding_window_imu: float = 0.05
    alpha_sliding_window_no_imu: float = 0.3
    max_step_sliding_window_imu: float = 0.05
    max_step_sliding_window_no_imu: float = 0.3
    dist_new_keyframe: float = 2.0
    dist_static_points_keyframe: float = 30.0
    min_overlap_new_keyframe: float = 0.75
    num_iter_sliding_window_optim: int = 15
    closest_k_keyframes_as_static_points: int = 10
    min_dist: float = 0.0

    dt_res: float = 0.001
    use_imu: bool = True
    timeshift_to_imu: float = 0.0
    min_num_points_gauss: int = 6
    imu_factor_weight_submap: float = 0.001

    use_gravity_term_in_keyframe_opt: bool = True
    balancing_factor_gravity: float = 1.0
    use_odometry_term_in_keyframe_opt: bool = True
    balancing_factor_odometry: float = 1000.0

    min_grid_size_keyframe_opt: float = 0.15
    sigma_acc: float = 0.3
    sigma_gyr: float = 0.01

    epsilon_keyframe_opt: float = 1e-4
    min_num_points_gauss_key: int = 6
    gravity_outlier_thresh: float = 1.0
    expected_max_num_static_pts: int = 200000

    acceleration_in_g: bool = False

    # extrinsics lidar->imu (dmsa_slam_ros.cpp builds from quaternion+transl)
    lidar_to_imu_quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)  # (w,x,y,z)
    lidar_to_imu_transl: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # --- IO ---
    bag_dirs: List[str] = dataclasses.field(default_factory=list)
    lidar_topic: str = ""
    imu_topic: str = ""
    result_dir: str = "."
    # live view: the reference opens a PCL viewer window (custom.yaml
    # `live_view`); headless equivalent here = cyclic self-contained HTML
    # map view written next to the results (pipeline/viz.py)
    live_view: bool = False

    # --- TPU-build specific: distributed keyframe adjustment ------------
    # route keyframeOptimization (DmsaSlam.h:212-238) through the sharded
    # GN loop over jax.devices() (parallel.keyframe_dist) instead of the
    # single-chip optimizer — BASELINE config 5's multi-device shape
    distributed_keyframe_opt: bool = False
    dist_table_size: int = 65536  # hash-cell table per grid resolution
    # "spatial": shuffle points to voxel-owner devices, exact local cells,
    # ~1 MB collectives/iteration (parallel.spatial — SCALING.md backend B);
    # "hash": r3 point-sharded hash cells with psum'd table reductions.
    # NOTE: "hash" optimizes a COARSER model than single-chip/"spatial" —
    # it has no normal-split cell channel (Gaussians.h:27-85 analogue) and
    # owner election drops ~occupied_voxels/2T of cells; the pipelines log
    # a warning when it is selected.
    dist_backend: str = "spatial"

    # --- TPU-build specific shape caps (padding discipline) ---
    # fixed compile-time span of the submap keyframe optimization: the
    # suffix [max(minRelatedKeyId, count - cap) .. count) is materialized
    # at this shape.  None (default) = last_n_keyframes_for_optim, i.e. the
    # reference's uncapped suffix [minRelatedKeyId .. end]
    # (DmsaSlam.h:212-238).  Setting an explicit smaller cap trades the
    # revisit-depth of the submap adjustment for compute (both pipelines
    # honor it; see tests/test_approximations.py for the accuracy cost).
    submap_max_keyframes: Optional[int] = None
    scan_cap_factor: float = 2.0  # per-scan capacity = factor * max_num_points
    n_dense: int = 501  # dense pose table length per window
    static_points_cap: int = 32768  # device-side static point capacity
    keyframe_points_cap: int = 4096  # per-keyframe local cloud capacity
    raw_scan_cap: int = 300000  # raw scan padding before downsampling

    @property
    def cov_acc(self) -> np.ndarray:
        return (self.sigma_acc**2) * np.eye(3)

    @property
    def cov_gyr(self) -> np.ndarray:
        return (self.sigma_gyr**2) * np.eye(3)

    @property
    def lidar_to_imu_tform(self) -> np.ndarray:
        w, x, y, z = self.lidar_to_imu_quat
        n = math.sqrt(w * w + x * x + y * y + z * z)
        w, x, y, z = w / n, x / n, y / n, z / n
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = self.lidar_to_imu_transl
        return T
