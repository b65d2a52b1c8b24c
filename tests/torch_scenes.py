"""The two-scan alignment problem of tests/test_two_scan_alignment.py (the
room scene of tests/synthetic.py seen from two poses ~45 cm apart) as
numpy arrays, for the port's tests and chip_smoke.py.

Imports only numpy, scipy and tests/synthetic.py, so chip_smoke.py can use
it on a machine that has no jax.
"""

import numpy as np
from scipy.spatial.transform import Rotation

from tests import synthetic

# a start ~20 cm / ~40 mrad off the true relative pose (params: rotvec,
# translation)
TWO_SCAN_PERTURBATION = np.array([0.02, -0.02, 0.03, 0.15, -0.12, 0.06])


def two_scan_problem(seed=42, n_pts=3000):
    """((local_pts [2, n, 3] f32, mask [2, n], ring [2, n] i32, anchor_orient
    [3], anchor_transl [3]), true relative params [6]) with the reference
    test's draws."""
    rng = np.random.default_rng(seed)
    world1 = synthetic.sample_scene_points(rng, n_pts)
    world2 = synthetic.sample_scene_points(rng, n_pts)
    pose0 = (np.array([-4.0, -1.0, 1.2]), np.array([0.0, 0.0, 0.1]))
    pose1 = (np.array([-3.6, -0.8, 1.25]), np.array([0.0, 0.02, 0.18]))
    local1, rings1, _ = synthetic.scan_from_pose(rng, world1, *pose0)
    local2, rings2, _ = synthetic.scan_from_pose(rng, world2, *pose1)
    arrays = (
        np.stack([local1, local2]).astype(np.float32),
        np.ones((2, n_pts), dtype=bool),
        np.stack([rings1, rings2]).astype(np.int32),
        pose0[1].astype(np.float64),
        pose0[0].astype(np.float64),
    )
    R0 = Rotation.from_rotvec(pose0[1]).as_matrix()
    R1 = Rotation.from_rotvec(pose1[1]).as_matrix()
    true = np.concatenate([Rotation.from_matrix(R0.T @ R1).as_rotvec(), R0.T @ (pose1[0] - pose0[0])])
    return arrays, true


def pose_errors(params, true):
    """(translation error m, rotation-vector error rad)."""
    return float(np.linalg.norm(params[3:] - true[3:])), float(np.linalg.norm(params[:3] - true[:3]))
