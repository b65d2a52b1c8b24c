"""CLI runner: rosbag(s) -> DMSA SLAM -> Poses.txt + PointCloud.pcd
(counterpart of dmsa_lidar_slam_tpu/pipeline/runner.py; main() /
dmsa_slam_ros::spin, src/main.cpp:19-29, src/dmsa_slam_ros.cpp:240-307).

Iterates the bag(s) over the lidar and IMU topics in bag order, feeds the
SLAM pipeline, writes outputs every 20 clouds and at the end.  Runs on the
CUDA card unless run(..., device="cpu") asks for the CPU.

Usage:
    python -m dmsa_lidar_slam_tpu_torch.pipeline.runner configs/slam_settings.yaml \\
        configs/newer_college_ouster_64.yaml [--pipeline fused|host] [--max-scans N]

With --distributed-keyframe-opt under torchrun (torchrun --nproc_per_node=N
-m dmsa_lidar_slam_tpu_torch.pipeline.runner ...), every rank runs this
same program on the same bag, the keyframe submap optimization spreads over
the ranks (parallel.launch: NCCL, one card per rank), and only rank 0
writes Poses.txt, PointCloud.pcd and the viewers: the ranks are replicas.
Without torchrun's environment the flag runs on this one process.

The pipeline's host spans and counters (pipeline.metrics.Metrics: for the
fused pipeline the wrapper's pack_fill / upload / step / flush, the step's
own spans, the optimizer's <name>.gn.* spans and iteration counters, the
submap counters) are the operator's to read three ways: the closing
"stage timings" log line (total and self seconds, calls and enclosing span
of each span, each counter's count), the --profile trace (each span a
named range on the profiler's clock, nested as it ran, beside the kernels
it launched; the step's range carries the scan counter), and
tools/torch_profile.py (its JSON line's `stages`).
"""

import argparse
import contextlib
import logging
import time

from dmsa_lidar_slam_tpu_torch.config import load_config
from dmsa_lidar_slam_tpu_torch.io import pointcloud2 as pc2
from dmsa_lidar_slam_tpu_torch.io import rosbag
from dmsa_lidar_slam_tpu_torch.io.pcd import save_pcd
from dmsa_lidar_slam_tpu_torch.parallel import launch
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam
from dmsa_lidar_slam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve

log = logging.getLogger("dmsa_runner_torch")

CYCLIC_SAVE_EVERY = 20  # clouds (dmsa_slam_ros.cpp:495-506)
LIVE_PUBLISH_EVERY = 5  # scans between live-view snapshots


def save_outputs(slam, result_dir: str, with_viz: bool = False):
    path = slam.save_poses(result_dir)
    pts = slam.map_points()
    if pts is not None and len(pts):
        save_pcd(f"{result_dir}/PointCloud.pcd", pts)
    if with_viz:
        from dmsa_lidar_slam_tpu_torch.pipeline import viz

        viz.export_all(slam, result_dir)
    return path


def _profiler(profile_dir):
    """torch.profiler over the whole run, written as a Chrome trace into
    profile_dir (host spans are named by pipeline.metrics)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))


def run(
    config_paths,
    overrides=None,
    max_scans=None,
    result_dir=None,
    pipeline="fused",
    viz_every=0,
    profile_dir=None,
    live_port=None,
    live_host="127.0.0.1",
    device=DEFAULT_DEVICE,
):
    cfg = load_config(*config_paths, overrides=overrides)
    device = resolve(device)
    if cfg.distributed_keyframe_opt:
        device = launch.initialize_distributed(device=device)
    writer = pmesh.world_rank() == 0  # the ranks are replicas: one writes
    if result_dir:
        cfg.result_dir = result_dir
    if cfg.live_view and not viz_every:
        viz_every = CYCLIC_SAVE_EVERY
    live = None
    if live_port is not None and writer:
        from dmsa_lidar_slam_tpu_torch.pipeline.live_view import LiveViewServer

        live = LiveViewServer(port=live_port, host=live_host).start()
        log.warning("live view at http://localhost:%d/", live.port)
    if pipeline == "fused":
        from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

        slam = FusedDmsaSlam(cfg, device=device)
    else:
        slam = DmsaSlam(cfg, device=device)

    topics = [t for t in (cfg.lidar_topic, cfg.imu_topic) if t]
    t_start = time.perf_counter()
    prof = contextlib.nullcontext()
    if profile_dir:
        prof = _profiler(profile_dir)
        log.info("capturing a torch.profiler trace -> %s", profile_dir)
    try:
        with prof:
            n_scans = _process_bags(slam, cfg, topics, max_scans, viz_every, live, writer)
        wall = time.perf_counter() - t_start
        path = save_outputs(slam, cfg.result_dir, with_viz=bool(viz_every)) if writer else None
        log.info("processed %d scans in %.1fs -> %s", n_scans, wall, path)
        log.info("stage timings: %s", slam.metrics.summary())
        if live is not None:
            live.publish(slam, n_scans)  # final frame stays served until exit
    except BaseException:
        if live is not None:
            live.stop()
        raise
    return slam


def _process_bags(slam, cfg, topics, max_scans, viz_every, live=None, writer=True):
    n_scans = 0
    last_pc_stamp = None
    for msg in rosbag.read_messages_multi(cfg.bag_dirs, topics):
        if msg.topic == cfg.lidar_topic:
            cloud = pc2.parse_pointcloud2(msg.raw)
            if cfg.sensor == "unknown" and last_pc_stamp is None:
                last_pc_stamp = cloud.stamp
                continue
            pts, stamps, rings = pc2.decode_points(cloud, cfg.sensor, last_pc_stamp)
            last_pc_stamp = cloud.stamp
            slam.process_scan(pts, stamps, rings)
            n_scans += 1
            if live is not None and n_scans % LIVE_PUBLISH_EVERY == 0:
                live.publish(slam, n_scans)
            if writer and n_scans % CYCLIC_SAVE_EVERY == 0:
                save_outputs(slam, cfg.result_dir, with_viz=viz_every and n_scans % viz_every == 0)
            if max_scans and n_scans >= max_scans:
                break
        elif msg.topic == cfg.imu_topic:
            imu = pc2.parse_imu(msg.raw)
            slam.process_imu(imu.linear_acceleration, imu.angular_velocity, imu.stamp)
    return n_scans


def main(argv=None):
    parser = argparse.ArgumentParser(description="DMSA LiDAR SLAM (PyTorch + CUDA)")
    parser.add_argument("configs", nargs="+", help="YAML config overlay paths (in order)")
    parser.add_argument("--max-scans", type=int, default=None)
    parser.add_argument("--result-dir", default=None)
    parser.add_argument(
        "--pipeline",
        choices=["fused", "host"],
        default="fused",
        help="fused: device-resident one step per scan; host: reference-style orchestration",
    )
    parser.add_argument("--viz-every", type=int, default=0, help="export PLY/HTML viz every N scans")
    parser.add_argument(
        "--live-view-port",
        type=int,
        default=None,
        help="serve a live map/trajectory view at http://localhost:PORT/ while running (0 = pick a free port)",
    )
    parser.add_argument(
        "--live-view-host",
        default="127.0.0.1",
        help="bind address for the live view (default loopback; 0.0.0.0 exposes it to the network)",
    )
    parser.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace of the whole run into this directory",
    )
    parser.add_argument(
        "--distributed-keyframe-opt",
        action="store_true",
        help="spread the keyframe submap adjustment over the ranks of torchrun (one process without it)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    overrides = {"distributed_keyframe_opt": True} if args.distributed_keyframe_opt else None
    run(
        args.configs,
        overrides=overrides,
        max_scans=args.max_scans,
        result_dir=args.result_dir,
        pipeline=args.pipeline,
        viz_every=args.viz_every,
        profile_dir=args.profile_dir,
        live_port=args.live_view_port,
        live_host=args.live_view_host,
    )


if __name__ == "__main__":
    main()
