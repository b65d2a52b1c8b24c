#!/usr/bin/env python3
"""Time and profile one pipeline of the PyTorch port on a CUDA card.

    python3 tools/torch_profile.py --pipeline host --scans 40 --profile 1
    python3 tools/torch_profile.py --pipeline fused --profile 0 --root path/to/other/checkout

Feeds bench_sequence(3) at bench_config() width (20,000 raw points per
scan, with its IMU) straight to the pipeline's process_imu_batch /
process_scan, synchronizing the card after every scan.  Prints one JSON
line:

  wall_ms_per_scan     host clock per scan over the unprofiled scans from
                       scan 10 on;
  kf_count, ate_m      keyframes and the output trajectory's ATE;
  profiled scans       the last --profile scans under torch.profiler (after
                       the timed ones: CUPTI tracing slows every launch
                       while it is on): kernel launches (cudaLaunchKernel
                       calls), stream / device syncs and copy calls per scan,
                       device busy ms per scan (the sum of kernel and copy
                       times; the pipeline's own stage annotations left
                       out) and its share of the profiled wall time, and
                       the top kernels by device time.  Reading the trace
                       costs minutes at ~10^5 launches per scan, so keep
                       --profile small;
  launches             the port's own kernel counters over the whole run.

--root imports the port from another checkout, so that two commits can be
compared in one run on one card.  Needs a CUDA card; exits non-zero
without one.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", choices=["host", "fused"], default="host")
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--profile", type=int, default=1, help="profile the last N scans (0: none)")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA card")
    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, bench_config, bench_sequence
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    seq = bench_sequence(3)
    data = []
    t_imu = seq.t_start - 0.2
    for i in range(args.scans):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(t_imu, t_end)
        data.append((*seq.scan(i, 20000, n_rings=16), ts, acc, gyr))
        t_imu = t_end
    if args.pipeline == "host":
        from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam

        slam = DmsaSlam(bench_config(), device=dev)
    else:
        from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

        slam = FusedDmsaSlam(bench_config(), flush_every=20, device=dev)
    cuda_lib.library()
    cuda_lib.reset_launches()

    a, b = args.scans - args.profile, args.scans
    walls, prof, prof_wall = [], None, 0.0
    for i, (pts, stamps, rings, ts, acc, gyr) in enumerate(data):
        if i == a:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        slam.process_imu_batch(acc, gyr, ts)
        slam.process_scan(pts, stamps, rings)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if prof is None:
            walls.append((i, dt))
        else:
            prof_wall += dt
    prof_out = {}
    if prof is not None:
        prof.__exit__(None, None, None)
        events = prof.events()
        cpu_counts = {}
        for e in events:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                cpu_counts[e.name] = cpu_counts.get(e.name, 0) + 1
        kernels = {}
        for e in events:
            # GPU-side copies of the CPU stage annotations are not device work
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in cpu_counts:
                kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time
        busy_us = sum(kernels.values())
        n_prof = b - a
        prof_out = dict(
            profiled_scans=[a, b],
            profiled_wall_ms_per_scan=1000.0 * prof_wall / n_prof,
            launches_per_scan=cpu_counts.get("cudaLaunchKernel", 0) / n_prof,
            syncs_per_scan=(cpu_counts.get("cudaStreamSynchronize", 0) + cpu_counts.get("cudaDeviceSynchronize", 0))
            / n_prof,
            memcpy_calls_per_scan=cpu_counts.get("cudaMemcpyAsync", 0) / n_prof,
            device_busy_ms_per_scan=busy_us / 1000.0 / n_prof,
            device_busy_share=busy_us / 1e6 / max(prof_wall, 1e-9),
            top_kernels_ms_per_scan=[
                (k[:80], v / 1000.0 / n_prof) for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[: args.top]
            ],
        )

    if args.pipeline == "host":
        n = slam.kf_map.count
        kf_count = n
        st, tr, _ = slam.output.dense_poses_list(slam.kf_map.stamps[:n], slam.kf_map.transl_w[:n], slam.kf_map.orient_w[:n])
    else:
        kf_count = slam.kf_count
        st, tr, _ = slam.all_poses()
    timed = [dt for i, dt in walls if i >= 10]
    out = dict(
        pipeline=args.pipeline,
        root=os.path.abspath(args.root),
        device=torch.cuda.get_device_name(0),
        scans=args.scans,
        kf_count=kf_count,
        ate_m=ate_rmse(st, tr, seq),
        wall_ms_per_scan=1000.0 * sum(timed) / max(len(timed), 1),
        **prof_out,
        launches=dict(cuda_lib.LAUNCHES),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
