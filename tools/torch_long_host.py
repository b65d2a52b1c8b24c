#!/usr/bin/env python3
"""The host pipeline, DmsaSlam(long_config()), on a CUDA card past the
first submap span >= 17 and the first retirement, and its replay from a
checkpoint.

    python3 tools/torch_long_host.py

Runs DmsaSlam(long_config()) on the card over chip_smoke.long_data(SCANS)
(225 scans of long_sequence(3): 131,072 raw points over 128 rings, with
bench.py's stressors; phase (h)'s data), saves a checkpoint
(pipeline/checkpoint.save_checkpoint) under build/torch_long_host/ before
scan SAVE_AT (190, before the first retirement at ~198), and runs on to
the end.  Then a fresh DmsaSlam on the card loads the checkpoint and
replays scans SAVE_AT onwards: the replay must
equal the run bit for bit (every keyframe-map array, the output ledger,
the previous window, the counters, the keyframe scans, the submap solves
and each scan's decision record).

Prints the card's name and power limit, each keyframe step's decision
(chip_smoke.HostStepRecorder) as "keyframe step" lines, each submap solve
(chip_smoke.record_submaps: scan, keyframes added so far, from_id, span)
as "solve" lines, and last one JSON summary: ATE, the deepest span and the
scan of the first span >= 17, the first retirement and the keyframe steps
after it (solves and skip reasons), the wall ms per scan from scan 10 on
and per keyframe scan, the peak memory, the K4 and K5 launches of the run
(counters zeroed just before it, read just after) and the replay's
differences.  Gates, bench.py's long gates (bench.py:47-48) and the
replay: ATE <= 0.05 m, a span >= 17, the first retirement reached, K4 and
K5 launched, the replay equal to the run; any miss exits non-zero.  Needs
a CUDA card; exits non-zero without one.
"""

import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCANS = 225
SAVE_AT = 190

# pipeline.slam.DmsaSlam's state: the keyframe map's arrays and counters,
# the previous window, the scalars a checkpoint carries
KF_ATTRS = ("local_pts", "local_normals", "pt_mask", "pt_ring", "grid_size", "orient_w", "transl_w", "stamps",
            "grav_meas", "grav_plausible", "odom_rel_orient", "odom_rel_transl", "count", "num_updates")
SCALARS = ("scan_updates", "time_initialized", "submap_initialized", "received_imu", "_prng_counter")


def state_differences(a, b):
    """The names of the DmsaSlam state that differs between a and b (empty:
    equal bit for bit)."""
    import numpy as np

    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import _output_arrays

    diff = [f for f in KF_ATTRS if not np.array_equal(getattr(a.kf_map, f), getattr(b.kf_map, f))]
    diff += [f for f in SCALARS if getattr(a, f) != getattr(b, f)]
    oa, ob = _output_arrays(a.output), _output_arrays(b.output)
    diff += [k for k in oa if not np.array_equal(oa[k], ob[k])]
    if (a.old_window is None) != (b.old_window is None):
        diff.append("old_window")
    elif a.old_window is not None:
        diff += [f"old_window.{f}" for f in ("orient_w", "transl_w", "ctrl_stamps", "t0", "horizon")
                 if not np.array_equal(getattr(a.old_window, f), getattr(b.old_window, f))]
    return diff


def drive(slam, data, first, recorder):
    """Feed data (scans first, first + 1, ...) to slam with `recorder`
    installed, syncing the card after each scan.  Returns (walls s, keyframe scans,
    records by scan)."""
    import torch

    from chip_smoke import feed

    walls, kf_scans, records = [], [], {}
    with recorder.installed(slam):
        for i, rec in enumerate(data, start=first):
            updates = slam.kf_map.num_updates
            t = time.perf_counter()
            feed(slam, [rec])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if slam.kf_map.num_updates > updates:
                kf_scans.append(i)
            r = recorder.collect(slam, i)
            if r is not None:
                records[i] = r
    return walls, kf_scans, records


def long_host(device, seq, data, config, save_at, ck_dir):
    """The run, the checkpoint before scan save_at and the replay (module
    docstring).  Returns the summary dict."""
    import numpy as np
    import torch

    from chip_smoke import LONG_MIN_SPAN, LONG_WARM, HostStepRecorder, record_submaps
    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import load_checkpoint, save_checkpoint
    from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam

    ckpt = os.path.join(ck_dir, f"host_{save_at}.npz")
    slam = DmsaSlam(config, device=device)
    solves = record_submaps(slam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    walls, kf_scans, records = drive(slam, data[:save_at], 0, HostStepRecorder())
    save_checkpoint(slam, ckpt)
    n_saved = len(solves)
    w2, k2, r2 = drive(slam, data[save_at:], save_at, HostStepRecorder())
    launches = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    walls, kf_scans, records = walls + w2, kf_scans + k2, {**records, **r2}

    replay = load_checkpoint(DmsaSlam(config, device=device), ckpt)
    replay_solves = record_submaps(replay)
    rw, rk, rr = drive(replay, data[save_at:], save_at, HostStepRecorder())
    replay_diff = state_differences(replay, slam)
    if rk != k2:
        replay_diff.append("keyframe_scans")
    if replay_solves != solves[n_saved:]:
        replay_diff.append("solves")
    if rr != r2:
        replay_diff.append("decision_records")

    n = slam.kf_map.count
    st, tr, _ = slam.output.dense_poses_list(slam.kf_map.stamps[:n], slam.kf_map.transl_w[:n],
                                             slam.kf_map.orient_w[:n])
    ate = ate_rmse(st, tr, seq) if len(st) >= 3 else float("nan")
    kf_steps = {s: r for s, r in sorted(records.items()) if r["keyframe"]}
    for s, r in kf_steps.items():
        print("keyframe step " + json.dumps(r), flush=True)
    for sol in solves:
        print("solve " + json.dumps(sol), flush=True)
    first_ret = next((s for s, r in kf_steps.items() if r["full"]), None)
    deep = [s for s, r in kf_steps.items() if r["span"] >= LONG_MIN_SPAN]
    after = {s: r for s, r in kf_steps.items() if first_ret is not None and s >= first_ret}
    kf_walls = [walls[i] for i in kf_scans if i >= LONG_WARM]
    return dict(
        scans=len(data), save_at=save_at, keyframes=n, keyframes_added=slam.kf_map.num_updates,
        retired_to_output=slam.output.num_static_keyframes, keyframe_scans=kf_scans, submap_solves=len(solves),
        deepest_span=max((sp for *_, sp in solves), default=0), first_span_scan=deep[0] if deep else None,
        first_retirement_scan=first_ret, keyframe_steps_after_first_retirement=len(after),
        solves_after_first_retirement=sum(r["run_submap"] for r in after.values()),
        skips_after_first_retirement={s: r["skip"] for s, r in after.items() if not r["run_submap"]},
        trajectory_poses=len(st), ate_m=ate,
        wall_ms_per_scan_10_on=1000.0 * float(np.mean(walls[LONG_WARM:])),
        wall_ms_per_keyframe_scan=1000.0 * float(np.mean(kf_walls)) if kf_walls else None,
        replay_wall_ms_per_scan=1000.0 * float(np.mean(rw)), peak_mem_gib=peak, launches=launches,
        replay_differences=replay_diff,
    )


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_long_host: needs a CUDA card")
    from chip_smoke import LONG_ATE_GATE_M, LONG_MIN_SPAN, long_data
    from dmsa_lidar_slam_tpu_torch.io.synthetic import long_config
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_lib.library()
    t0 = time.perf_counter()
    seq, data = long_data(SCANS)
    gen_s = time.perf_counter() - t0
    ck_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "torch_long_host")
    shutil.rmtree(ck_dir, ignore_errors=True)
    os.makedirs(ck_dir)
    out = long_host(dev, seq, data, long_config(), SAVE_AT, ck_dir)
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, generation_s=gen_s,
               wall_s=time.perf_counter() - t0, **out)
    print(json.dumps(out), flush=True)
    misses = []
    if not out["ate_m"] <= LONG_ATE_GATE_M:
        misses.append(f"ATE {out['ate_m']} above {LONG_ATE_GATE_M}")
    if out["deepest_span"] < LONG_MIN_SPAN:
        misses.append(f"deepest span {out['deepest_span']} < {LONG_MIN_SPAN}")
    if out["first_retirement_scan"] is None or out["retired_to_output"] < 1:
        misses.append("no keyframe retired")
    for k in ("min_sq_dist", "radius_neighbor_moments"):
        if out["launches"][k] == 0:
            misses.append(f"kernel {k} never launched")
    if out["replay_differences"]:
        misses.append(f"the replay differs from the run: {out['replay_differences']}")
    if misses:
        raise SystemExit("torch_long_host: " + "; ".join(misses))


if __name__ == "__main__":
    main()
