#!/usr/bin/env python3
"""Are the window's IMU residuals zero-bias at the TRUE poses?  The
PyTorch port's counterpart of tools/diag_imu_bias.py.

    python3 tools/torch_diag_imu_bias.py [--device cpu]

Builds a bench-like window (5 scans from scan 20, past the ramp: constant
twist, noise-free IMU of SyntheticSequence(rng=default_rng(3))) as the
fused pipeline's window assembly builds it (imu.buffer.ImuBuffer fed from
the static start, so that the gyro-bias estimate over the first samples
holds; nearest resampling onto the dense grid; trajectory.continuous.
compute_preint_factors), sets the control poses to the truth, and prints
the raw rotation, velocity and position errors of each interval's IMU
factor, the weighted residuals (continuous.imu_residuals), and the
residuals at a trajectory perturbed by 0.01 in every parameter (what the
optimizer trades against the lidar terms).  Pose math in f64.  The last
line is one JSON object with every array.  Runs on the card unless given
--device cpu.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def imu_bias(device, seed: int = 3) -> dict:
    """The diagnosis as numpy arrays (f64): timediff, v_lin, v_start,
    rot_error, vel_error, pos_error, residuals, cov_inv_diag,
    residuals_perturbed."""
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.core import poses as cp
    from dmsa_lidar_slam_tpu_torch.core import rotations as rot
    from dmsa_lidar_slam_tpu_torch.imu.buffer import ImuBuffer
    from dmsa_lidar_slam_tpu_torch.io.synthetic import SyntheticSequence
    from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct

    pdt = torch.float64

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=pdt, device=device)

    seq = SyntheticSequence(rng=np.random.default_rng(seed), noise_std=0.0)
    shapes = ct.WindowShapes(n_window_pts=8, n_static=0, n_ctrl=6, n_dense=501)
    i0 = 20  # well past the ramp: constant twist
    t0_w = seq.t_start + i0 * seq.sweep
    t1_w = seq.t_start + (i0 + 5) * seq.sweep
    horizon = (t1_w - t0_w) + 1e-3
    dt = horizon / (shapes.n_dense - 1)

    buf = ImuBuffer()
    ts, acc, gyr = seq.imu_samples(seq.t_start - 0.2, t1_w + 0.1)
    for j in range(len(ts)):
        buf.add_measurement(acc[j], gyr[j], ts[j])
    dense_t = t0_w + np.arange(shapes.n_dense) * dt
    acc_d, gyr_d, timediff = buf.resample_nearest(dense_t)

    cov_gyr, cov_acc = t(0.01**2 * np.eye(3)), t(0.3**2 * np.eye(3))
    pr_rot, pr_vel, pr_pos, cov_inv, pr_full = ct.compute_preint_factors(t(gyr_d), t(acc_d), t(dt), cov_gyr,
                                                                         cov_acc, shapes)
    ctrl_t = t0_w + np.array(shapes.param_indices) * dt
    gp = cp.GlobalPoses(orient=t(np.stack([seq.pose(s).rotvec for s in ctrl_t])),
                        transl=t(np.stack([seq.pose(s).position for s in ctrl_t])))
    chain = cp.global2relative(gp)
    data = ct.WindowData(
        local_pts=torch.zeros(8, 3, dtype=torch.float32, device=device),
        pt_mask=torch.zeros(8, dtype=torch.bool, device=device),
        pt_ring=torch.zeros(8, dtype=torch.int32, device=device),
        pt_tform_idx=torch.zeros(8, dtype=torch.int32, device=device),
        static_pts=torch.zeros(0, 3, dtype=torch.float32, device=device),
        static_mask=torch.zeros(0, dtype=torch.bool, device=device),
        static_ring=torch.zeros(0, dtype=torch.int32, device=device),
        anchor_orient=chain.orient[0], anchor_transl=chain.transl[0],
        ctrl_stamps=ct.ctrl_stamps_from_dt(t(dt), shapes), dt=t(dt), horizon=t(horizon),
        acc_dense=t(acc_d), gyr_dense=t(gyr_d), gravity=t(ct.GRAVITY_W),
        preint_rot=pr_rot, preint_vel=pr_vel, preint_pos=pr_pos, cov_inv=cov_inv, preint_pos_full=pr_full,
        balancing_imu=t(0.001),
    )
    params = cp.params_from_chain(chain)
    chain2, gp2, _, d_transl = ct.dense_pose_tables(params, data, shapes)

    # the raw error components, as continuous.imu_residuals forms them
    pi = torch.tensor(shapes.param_indices, dtype=torch.int64, device=device)
    one_div = 1.0 / data.dt
    r_start = rot.axang2rotm(gp2.orient[:-1])
    delta_t = data.ctrl_stamps[1:] - data.ctrl_stamps[:-1]
    v_start = one_div * (d_transl[pi[:-1] + 1] - d_transl[pi[:-1]])
    v_end = one_div * (d_transl[pi[1:]] - d_transl[pi[1:] - 1])
    dp_world = (gp2.transl[1:] - gp2.transl[:-1] - v_start * delta_t[:, None]
                - 0.5 * delta_t[:, None] ** 2 * data.gravity[None, :])
    pos_error = torch.einsum("kji,kj->ki", r_start, dp_world) - data.preint_pos
    r_tmp = torch.einsum("kji,kjl->kil", data.preint_rot, rot.axang2rotm(chain2.orient[1:]))
    rot_error = rot.rotm2axang(r_tmp)
    dv_world = v_end - v_start - data.gravity[None, :] * delta_t[:, None]
    vel_error = torch.einsum("kji,kj->ki", r_start, dv_world) - data.preint_vel
    res = ct.imu_residuals(chain2, gp2, d_transl, data, shapes)

    pert = params + 0.01 * t(np.random.default_rng(0).standard_normal(params.shape))
    ch_p, gp_p, _, dt_p = ct.dense_pose_tables(pert, data, shapes)
    res_p = ct.imu_residuals(ch_p, gp_p, dt_p, data, shapes)

    def host(x):
        return x.detach().cpu().numpy()

    return dict(
        timediff=float(timediff), v_lin=np.asarray(seq.v_lin), v_start=host(v_start), rot_error=host(rot_error),
        vel_error=host(vel_error), pos_error=host(pos_error), residuals=host(res),
        cov_inv_diag=host(torch.diagonal(cov_inv, dim1=1, dim2=2)[0]), residuals_perturbed=host(res_p),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from dmsa_lidar_slam_tpu_torch.utils.device import resolve

    dev = resolve(args.device)
    out = imu_bias(dev)
    np.set_printoptions(precision=6, suppress=True)
    print("resample timediff:", out["timediff"])
    print("true v_lin:", out["v_lin"], " v_start fd:", out["v_start"])
    print("rot_error:\n", out["rot_error"])
    print("vel_error:\n", out["vel_error"])
    print("pos_error:\n", out["pos_error"])
    print("weighted residuals:", out["residuals"])
    print("cov_inv diag magnitude:", out["cov_inv_diag"])
    print("residuals @ perturbed (0.01):", out["residuals_perturbed"])
    print(json.dumps(dict(device=str(dev), **{k: np.asarray(v).tolist() for k, v in out.items()})))


if __name__ == "__main__":
    main()
