"""Window initial guess with a device-side `last_known` (counterpart of
dmsa_lidar_slam_tpu/trajectory/device_guess.py; updateInitialGuess,
ContinuousTrajectory.h:367-469).

Control stamps still covered by the previous window are interpolated from
its control poses (slerp + barycentric rational), the terminal velocity
comes from the barycentric derivative, and the rest is IMU dead-reckoning
(or constant velocity without IMU).  The dead-reckon pass runs over all
C - 1 intervals with the carry reset to the interpolated state while the
interval index is <= last_known, so no branch depends on device data.
"""

import torch

from dmsa_lidar_slam_tpu_torch.core import interpolation as interp
from dmsa_lidar_slam_tpu_torch.core import poses as cp
from dmsa_lidar_slam_tpu_torch.core import rotations as rot


def traced_initial_guess(old_orient_w, old_transl_w, old_stamps, shift, old_horizon, new_ctrl_stamps,
                         preint_rot, preint_vel, preint_pos, delta_t_ctrl, gravity, use_imu):
    """Returns the full PoseChain (anchor row 0 + relatives) of the new window."""
    C = new_ctrl_stamps.shape[0]
    dev = new_ctrl_stamps.device
    t_query = new_ctrl_stamps + shift
    last_known = torch.clamp(torch.sum((t_query < old_horizon).to(torch.int64)) - 1, min=0)

    interp_orient = interp.interp_rotations(t_query, old_stamps, old_orient_w)
    interp_transl = interp.barycentric_interp(t_query, old_stamps, old_transl_w, d=2)
    v_all = interp.barycentric_derivative(t_query, old_stamps, old_transl_w, d=2)
    v0 = v_all[last_known]

    R = torch.eye(3, dtype=old_orient_w.dtype, device=dev)
    p = torch.zeros(3, dtype=old_orient_w.dtype, device=dev)
    v = v0
    dr_orient, dr_transl = [], []
    for k in range(C - 1):
        reset = k <= last_known
        R = torch.where(reset, rot.axang2rotm(interp_orient[k]), R)
        p = torch.where(reset, interp_transl[k], p)
        v = torch.where(reset, v0, v)
        dtk = delta_t_ctrl[k]
        p_new = p + v * dtk + 0.5 * gravity * dtk**2 + R @ preint_pos[k]
        v = v + gravity * dtk + R @ preint_vel[k]
        R = R @ preint_rot[k]
        p = p_new
        dr_orient.append(rot.rotm2axang(R))
        dr_transl.append(p)
    dr_orient = torch.stack(dr_orient)
    dr_transl = torch.stack(dr_transl)

    k_idx = torch.arange(C, device=dev)
    use_interp = (k_idx <= last_known)[:, None]
    imu_orient = torch.where(use_interp, interp_orient, torch.cat([interp_orient[:1], dr_orient]))
    imu_transl = torch.where(use_interp, interp_transl, torch.cat([interp_transl[:1], dr_transl]))
    chain_imu = cp.global2relative(cp.GlobalPoses(imu_orient, imu_transl))

    chain_ni = cp.global2relative(cp.GlobalPoses(interp_orient, interp_transl))
    tail = (k_idx > last_known)[:, None]
    chain_cv = cp.PoseChain(
        orient=torch.where(tail, chain_ni.orient[last_known][None, :], chain_ni.orient),
        transl=torch.where(tail, chain_ni.transl[last_known][None, :], chain_ni.transl),
    )
    return cp.PoseChain(
        orient=torch.where(use_imu, chain_imu.orient, chain_cv.orient),
        transl=torch.where(use_imu, chain_imu.transl, chain_cv.transl),
    )
