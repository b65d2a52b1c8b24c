#!/usr/bin/env python3
"""Diagnose the bench ATE of the PyTorch port: keyframe-only against
full-ledger error, with the per-pose breakdown (the port's counterpart of
tools/bench_diag.py).

    python3 tools/torch_bench_diag.py [--seed 3] [--no-imu] [--scans 50] [--device cpu]

Runs FusedDmsaSlam(bench_config()) over bench_sequence(seed), each scan's
IMU sample by sample, then prints the keyframe count and the retired
keyframes, the keyframe-only ATE, the output ledger's ATE, each ledger
pose's error unaligned (anchored at the first pose: "KF" for a keyframe or
a retired keyframe, "nk" for a non-keyframe), the stop reasons of the event
rows (column 16) and the keyframe rows' overlaps (column 15).  The last
line is one JSON object with the same.  Runs on the card unless given
--device cpu.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_diag(slam, seq, scans: int, pts_per_scan: int = 20000) -> dict:
    """Feed `scans` scans of `seq` into the FusedDmsaSlam `slam` and return
    the diagnosis: keyframes, retired, kf_ate_m, ledger_poses,
    ledger_ate_m, per_pose [(index, "KF"|"nk", t - t_start, error m)],
    stop_reasons {reason: rows}, overlaps (the keyframe rows')."""
    import numpy as np

    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, feed_scan

    t_imu = seq.t_start - 0.2
    for i in range(scans):
        t_imu = feed_scan(slam, seq, i, t_imu, pts_per_scan)
    slam._flush_events()
    ks, kt, _ = slam.keyframe_poses()
    ls, lt, _ = slam.all_poses()
    gt = np.asarray([seq.pose(float(s)).position for s in ls])
    est = np.asarray(lt, float) - np.asarray(lt[0], float) + gt[0]
    err = np.linalg.norm(est - gt, axis=1)
    retired = [s for s, _, _ in slam.output.static_keyframes]
    per_pose = []
    for i, s in enumerate(ls):
        kind = "KF" if bool(np.isin(s, ks)) or any(abs(s - r) < 1e-9 for r in retired) else "nk"
        per_pose.append((i, kind, float(s - seq.t_start), float(err[i])))
    ev = slam.state.events.cpu().numpy()
    reasons, counts = np.unique(ev[:, 16], return_counts=True)
    return dict(
        keyframes=slam.kf_count, retired=len(retired), kf_ate_m=ate_rmse(ks, kt, seq), ledger_poses=len(ls),
        ledger_ate_m=ate_rmse(ls, lt, seq), per_pose=per_pose,
        stop_reasons={float(r): int(c) for r, c in zip(reasons, counts)},
        overlaps=[float(o) for o in ev[ev[:, 0] > 1.5, 15]],
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--scans", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_config, bench_sequence
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam
    from dmsa_lidar_slam_tpu_torch.utils.device import resolve

    dev = resolve(args.device)
    slam = FusedDmsaSlam(bench_config(use_imu=not args.no_imu), flush_every=20, device=dev)
    out = bench_diag(slam, bench_sequence(args.seed), args.scans)
    print("keyframes:", out["keyframes"], "retired:", out["retired"])
    print("keyframe-only ATE:", out["kf_ate_m"])
    print("ledger poses:", out["ledger_poses"], "ledger ATE:", out["ledger_ate_m"])
    for i, kind, t, e in out["per_pose"]:
        print(f"{i:3d} {kind} t={t:7.3f} err={e:7.4f}")
    print("stop reasons (col16):", out["stop_reasons"])
    print("overlaps:", [round(o, 2) for o in out["overlaps"]])
    print(json.dumps(dict(device=str(dev), seed=args.seed, use_imu=not args.no_imu, scans=args.scans, **out)))


if __name__ == "__main__":
    main()
