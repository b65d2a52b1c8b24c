#!/usr/bin/env python3
"""Time and profile one pipeline of the PyTorch port on a CUDA card.

    python3 tools/torch_profile.py --pipeline host --scans 40 --profile 1
    python3 tools/torch_profile.py --pipeline fused --profile 0 --root path/to/other/checkout
    python3 tools/torch_profile.py --pipeline fused --config long
    python3 tools/torch_profile.py --pipeline host --config long --scans 30 --profile 2

Feeds bench_sequence(3) at bench_config() width (20,000 raw points per
scan, with its IMU) straight to the pipeline's process_imu_batch /
process_scan, synchronizing the card after every scan.  With --config long
(the counterpart of tools/profile_long.py) it feeds
long_sequence(3) to long_config(): 131,072 raw points over 128 rings with
bench.py's stressors (chip_smoke.long_data), 40 warm-up scans and then the
profiled ones (by default 46 scans, the last 5 profiled: in the fused
pipeline the keyframe step of scan 44 and its submap solve at 48 slots
among them).  Prints one JSON
line:

  wall_ms_per_scan     host clock per scan over the unprofiled scans from
                       scan 10 on;
  kf_count, ate_m      keyframes and the output trajectory's ATE;
  profiled scans       the last --profile scans under torch.profiler (after
                       the timed ones: CUPTI tracing slows every launch
                       while it is on), read from the trace that
                       pipeline/traceutil.capture writes: kernel launches
                       (cudaLaunchKernel calls), stream / device syncs and
                       copy calls per scan, device busy ms per scan
                       (traceutil.device_busy_ms: kernel, copy and memset
                       spans) and its share of the profiled wall time, the
                       top kernels by device time, and the launches and
                       device ms per scan of each of the port's own kernels
                       (csrc/, traceutil.csrc_kernel_name).  Exporting the
                       trace takes seconds per 10^5 launches, so keep
                       --profile small;
  launches             the port's own kernel counters over the whole run;
  stages               the pipeline's host spans and counters
                       (pipeline/metrics.py Metrics.summary()) over the
                       whole run;
  keyframes_profiled   keyframes added during the profiled scans;
  k1_masked_share      with --mask-share (fused pipeline): per K1 input
                       size n, the K1 calls and the share of their n slots
                       that are masked (1 - valid / n, over all calls).
                       Counting syncs once per K1 call, so keep it out of
                       timed runs.

--root imports the port from another checkout, so that two commits can be
compared in one run on one card (--profile needs a checkout that has
pipeline/traceutil.py).  Needs a CUDA card; exits non-zero
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
    ap.add_argument("--config", choices=["bench", "long"], default="bench")
    ap.add_argument("--scans", type=int, default=None, help="default 40, with --config long 46")
    ap.add_argument("--profile", type=int, default=None, help="profile the last N scans (0: none); "
                    "default 1, with --config long 5")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--mask-share", action="store_true", help="count the masked share of K1's inputs")
    args = ap.parse_args(argv)
    long = args.config == "long"
    args.scans = args.scans or (46 if long else 40)
    args.profile = (5 if long else 1) if args.profile is None else args.profile
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA card")
    from chip_smoke import bench_data, long_data
    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, bench_config, long_config
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    seq, data = long_data(args.scans) if long else bench_data(args.scans)
    config = long_config() if long else bench_config()
    if args.pipeline == "host":
        from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam

        slam = DmsaSlam(config, device=dev)
    else:
        from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

        slam = FusedDmsaSlam(config, flush_every=20, device=dev)
    cuda_lib.library()
    cuda_lib.reset_launches()
    masks = {}  # K1 input size n -> [calls, slots, valid]
    if args.mask_share:
        from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr

        build = fr.build_packed

        def counted(points_w, mask, *rest, **kw):
            c = masks.setdefault(int(mask.shape[0]), [0, 0, 0])
            c[0] += 1
            c[1] += int(mask.shape[0])
            c[2] += int(mask.sum())
            return build(points_w, mask, *rest, **kw)

        fr.build_packed = counted

    a, b = args.scans - args.profile, args.scans

    def run(scans):
        """Feed the scans, syncing after each; their host seconds."""
        out = []
        for pts, stamps, rings, ts, acc, gyr in scans:
            t0 = time.perf_counter()
            slam.process_imu_batch(acc, gyr, ts)
            slam.process_scan(pts, stamps, rings)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    def keyframes():
        return slam.kf_map.num_updates if args.pipeline == "host" else int(slam.state.kf.num_updates)

    walls = list(enumerate(run(data[:a])))
    prof_out = {}
    if b > a:
        from dmsa_lidar_slam_tpu_torch.pipeline import traceutil

        kf0 = keyframes()
        with traceutil.capture() as trace_dir:
            prof_wall = sum(run(data[a:b]))
        busy_ms, kernels, launches = traceutil.op_totals(trace_dir)
        calls = traceutil.host_call_counts(trace_dir)
        n_prof = b - a
        port = {}  # csrc kernel -> [launches, device ms] per scan
        for k, v in kernels.items():
            name = traceutil.csrc_kernel_name(k)
            if name:
                c = port.setdefault(name, [0.0, 0.0])
                c[0] += launches[k] / n_prof
                c[1] += v / 1000.0 / n_prof
        prof_out = dict(
            profiled_scans=[a, b],
            profiled_wall_ms_per_scan=1000.0 * prof_wall / n_prof,
            trace_dir=trace_dir,
            launches_per_scan=calls.get("cudaLaunchKernel", 0) / n_prof,
            syncs_per_scan=(calls.get("cudaStreamSynchronize", 0) + calls.get("cudaDeviceSynchronize", 0)) / n_prof,
            memcpy_calls_per_scan=calls.get("cudaMemcpyAsync", 0) / n_prof,
            device_busy_ms_per_scan=busy_ms / n_prof,
            device_busy_share=busy_ms / 1e3 / max(prof_wall, 1e-9),
            top_kernels_ms_per_scan=[
                (k[:80], v / 1000.0 / n_prof) for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[: args.top]
            ],
            port_kernels_per_scan=port,
            keyframes_profiled=keyframes() - kf0,
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
        config=args.config,
        root=os.path.abspath(args.root),
        device=torch.cuda.get_device_name(0),
        scans=args.scans,
        kf_count=kf_count,
        ate_m=ate_rmse(st, tr, seq),
        wall_ms_per_scan=1000.0 * sum(timed) / max(len(timed), 1),
        **prof_out,
        launches=dict(cuda_lib.LAUNCHES),
        stages=slam.metrics.summary(),
        **({"k1_masked_share": {n: dict(calls=c, masked_share=1.0 - v / s) for n, (c, s, v) in sorted(masks.items())}}
           if args.mask_share else {}),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
