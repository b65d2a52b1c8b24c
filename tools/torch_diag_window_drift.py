#!/usr/bin/env python3
"""Per-scan window drift of the PyTorch port on the bench scene (the
port's counterpart of tools/diag_window_drift.py).

    python3 tools/torch_diag_window_drift.py [--no-imu] [--seed 3] [--scans 50] [--device cpu]

Runs FusedDmsaSlam(bench_config()) over bench_sequence(seed), each scan's
IMU sample by sample, and after every scan that ran a window step reads the
stored optimized window (the fused state's ow_orient, ow_transl,
ow_stamps) and holds each control pose against the analytic truth in a
constant gauge (the truth's position and yaw at the first window's first
control pose; the yaw is not observable from the gravity init): the
position error and the yaw error of every control pose, and at the anchor
(pose 0) and the tail (pose 5) the error along the track, across it and
vertical, and the orientation error's tilt and yaw in mrad.  So it shows
whether drift enters at the anchor (hand-off, gauge), at the tail (the new
poses) or uniformly (the map's pull).  Ends with the keyframe and ledger
ATE.  The last line is one JSON object with every row.  Runs on the card
unless given --device cpu.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def window_row(slam, seq, gauge):
    """The drift of the stored window of `slam` (a FusedDmsaSlam that has
    just run a window step) against the truth of `seq` in `gauge` (R0,
    p0): per control pose position and yaw error, and the anchor / tail
    decomposition."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    t0_w = slam._window_t0_history[-1]
    transl = slam.state.ow_transl.cpu().numpy()
    orient = slam.state.ow_orient.cpu().numpy()
    t_abs = t0_w + slam.state.ow_stamps.cpu().numpy()
    r0, p0 = gauge
    est_w = transl @ r0.T + p0[None, :]
    gt_pos = np.stack([seq.pose(float(t)).position for t in t_abs])
    gt_yaw = np.array([seq.pose(float(t)).rotvec[2] for t in t_abs])
    est_yaw = np.array([Rotation.from_rotvec(o).as_euler("zyx")[0] for o in orient]) + np.arctan2(r0[1, 0], r0[0, 0])
    dvec = est_w - gt_pos
    v_dir = seq.v_lin / np.linalg.norm(seq.v_lin)
    e_alg = dvec @ v_dir
    e_z = dvec[:, 2]
    e_crs = np.sign(np.cross(np.tile(v_dir, (len(dvec), 1)), dvec)[:, 2]) * np.sqrt(
        np.maximum(np.linalg.norm(dvec, axis=1) ** 2 - e_alg**2 - e_z**2, 0))
    tilt, yaw = [], []
    for k in (0, 5):
        r_est = r0 @ Rotation.from_rotvec(orient[k]).as_matrix()
        r_gt = Rotation.from_rotvec(seq.pose(float(t_abs[k])).rotvec).as_matrix()
        aa = Rotation.from_matrix(r_gt.T @ r_est).as_rotvec()
        tilt.append(float(np.linalg.norm(aa[:2]) * 1e3))
        yaw.append(float(aa[2] * 1e3))
    ev = slam.state.events[(int(slam.state.ev_index) - 1) % slam.shapes.ev_cap].cpu().numpy()
    return dict(etype=int(ev[0]), overlap=float(ev[15]), pos_err=np.linalg.norm(dvec, axis=1).tolist(),
                yaw_err=(est_yaw - gt_yaw).tolist(), along=[float(e_alg[0]), float(e_alg[5])],
                cross=[float(e_crs[0]), float(e_crs[5])], z=[float(e_z[0]), float(e_z[5])], tilt_mrad=tilt,
                yaw_mrad=yaw)


def window_drift(slam, seq, scans: int, pts_per_scan: int = 20000) -> dict:
    """Feed `scans` scans of `seq` into the FusedDmsaSlam `slam`, each
    scan's IMU sample by sample; after each scan that ran a window step
    its window_row.  Returns {rows: [dict(scan=i, **window_row)],
    kf_ate_m, ledger_ate_m}."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse

    t_imu = seq.t_start - 0.2
    rows, gauge = [], None
    for i in range(scans):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(t_imu, t_end)
        for j in range(len(ts)):
            slam.process_imu(acc[j], gyr[j], ts[j])
        t_imu = t_end
        slam.process_scan(*seq.scan(i, pts_per_scan))
        if slam.scan_counter == 0 or not bool(slam.state.submap_initialized):
            continue
        if gauge is None:  # the estimator's frame: the truth at the first window's t0
            tp0 = seq.pose(float(slam._window_t0_history[-1] + float(slam.state.ow_stamps[0])))
            gauge = (Rotation.from_rotvec([0.0, 0.0, tp0.rotvec[2]]).as_matrix(), np.asarray(tp0.position))
        rows.append(dict(scan=i, **window_row(slam, seq, gauge)))
    slam._flush_events()
    ks, kt, _ = slam.keyframe_poses()
    ls, lt, _ = slam.all_poses()
    return dict(rows=rows, kf_ate_m=ate_rmse(ks, kt, seq), ledger_ate_m=ate_rmse(ls, lt, seq))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--scans", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_config, bench_sequence
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam
    from dmsa_lidar_slam_tpu_torch.utils.device import resolve

    dev = resolve(args.device)
    slam = FusedDmsaSlam(bench_config(use_imu=not args.no_imu), flush_every=20, device=dev)
    out = window_drift(slam, bench_sequence(args.seed), args.scans)
    for r in out["rows"]:
        p = r["pos_err"]
        print(f"scan {r['scan']:3d} etype={r['etype']} ov={r['overlap']:.2f} perr0={p[0]:.3f} perr5={p[5]:.3f} "
              f"alg=[{r['along'][0]:+.3f} {r['along'][1]:+.3f}] crs=[{r['cross'][0]:+.3f} {r['cross'][1]:+.3f}] "
              f"z=[{r['z'][0]:+.3f} {r['z'][1]:+.3f}] tilt=[{r['tilt_mrad'][0]:.1f} {r['tilt_mrad'][1]:.1f}] "
              f"yaw=[{r['yaw_mrad'][0]:+.1f} {r['yaw_mrad'][1]:+.1f}]mrad")
    print("keyframe ATE:", out["kf_ate_m"], " ledger ATE:", out["ledger_ate_m"])
    print(json.dumps(dict(device=str(dev), seed=args.seed, use_imu=not args.no_imu, scans=args.scans, **out)))


if __name__ == "__main__":
    main()
