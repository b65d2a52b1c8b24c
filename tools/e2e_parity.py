#!/usr/bin/env python3
"""End-to-end parity of the PyTorch port against the JAX reference, on the
CPU, at the bench's scale.

    python3 tools/e2e_parity.py [--scans 50] [--points 20000] [--out build/e2e_parity]
    python3 tools/e2e_parity.py --long [--scans 110]

Both packages' fused pipelines (FusedDmsaSlam with bench_config(), flush
every 20 scans) run bench_sequence(3), --scans scans of --points raw points
with their IMU (chip_smoke.bench_data), on the CPU.  With --long they run
the JAX package's long bench instead: long_config() on long_sequence(3),
--scans scans of 131,072 raw points over 128 rings with
bench.py's stressors (chip_smoke.long_data); its output lands in
build/e2e_parity_long.  The reference runs its tabular optimizer path
(DMSA_FUSED_TABULAR=1: its kernels as their plain XLA versions), the port
its kernels' plain PyTorch versions; the port's step takes the reference's
own jax PRNG bits, so both downsample the same points and what differs is
numerics.  Each run writes its trajectory as a TUM file (Poses.txt), the
analytic truth is written at each run's stamps, and both packages'
pipeline/evaluate report:

  ate_port, ate_reference   each trajectory's ATE against the truth;
  port_vs_reference         ATE and RPE (1-frame intervals) of the port's
                            trajectory against the reference's;
  evaluate_packages_agree   both packages' evaluate gave the same numbers;
  kf_count, max_submap_span, retired, ...
                            each run's keyframes, deepest submap span,
                            keyframes retired to its output, and its
                            keyframe steps (chip_smoke.span_summary).

Prints one JSON line (also written to --out/e2e_parity.json, with --long
e2e_parity_long.json).  The
reference and jax are imported by name, only inside the reference half
(_reference).
"""

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def drive(slam, data, result_dir):
    """Feed every scan, reading each step's event row; write Poses.txt;
    (path, run summary)."""
    from chip_smoke import feed, record_step, span_summary

    spans, retired_at = {}, []
    t0 = time.perf_counter()
    for rec in data:
        stepped = slam.scan_counter
        feed(slam, [rec])
        if slam.scan_counter > stepped:
            record_step(slam, stepped, spans, retired_at)
    wall = (time.perf_counter() - t0) / len(data)
    path = slam.save_poses(result_dir)
    return path, dict(kf_count=slam.kf_count, max_submap_span=slam.max_submap_span,
                      retired=slam.output.num_static_keyframes, **span_summary(spans, retired_at),
                      host_s_per_scan_cpu=wall)


def port_run(data, result_dir, priorities, config):
    synthetic = importlib.import_module("dmsa_lidar_slam_tpu_torch.io.synthetic")
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    slam = FusedDmsaSlam(getattr(synthetic, config)(), flush_every=20, device="cpu")
    slam.priorities = lambda seed: priorities(seed, slam.shapes)
    return drive(slam, data, result_dir)


def _reference(module):
    """A module of jax or of the reference package, imported by name (the
    port's side of this tool never imports either): jax on the CPU, the
    reference's fused pipeline on its tabular path."""
    os.environ["DMSA_FUSED_TABULAR"] = "1"
    jax = importlib.import_module("jax")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return importlib.import_module(module)


def reference_run(data, result_dir, config):
    make_config = getattr(_reference("dmsa_lidar_slam_tpu.io.synthetic"), config)
    FusedDmsaSlam = _reference("dmsa_lidar_slam_tpu.pipeline.fused").FusedDmsaSlam
    return drive(FusedDmsaSlam(make_config(), flush_every=20), data, result_dir)


def reference_priorities():
    """(seed, shapes) -> the port's StepPriorities holding the three int32
    priority vectors the reference's step draws from the pack's seed
    (fused.py: fold_in(key, 917) for the preprocessing, the k1 / k2 keys for
    the static points and the keyframe cloud)."""
    jax = _reference("jax")
    jnp = _reference("jax.numpy")
    import torch

    from dmsa_lidar_slam_tpu_torch.pipeline.fused import StepPriorities

    def bits(key, n):
        return torch.as_tensor(np.array(jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)))

    def draw(seed, shapes):
        key = jax.random.PRNGKey(seed)
        k1, k2, _ = jax.random.split(key, 3)
        return StepPriorities(
            preprocess=bits(jax.random.fold_in(key, 917), shapes.raw_cap),
            static=bits(k1, shapes.n_candidates * shapes.kf_pts_cap),
            keyframe=bits(k2, shapes.window.n_window_pts),
        )

    return draw


def evaluate_all(port_poses, ref_poses, port_truth, ref_truth):
    """The same numbers from both packages' evaluate."""
    out = {}
    for name in ("dmsa_lidar_slam_tpu_torch", "dmsa_lidar_slam_tpu"):
        ev = importlib.import_module(f"{name}.pipeline.evaluate")
        vs = dict(ate=ev.ate(port_poses, ref_poses), rpe=ev.rpe(port_poses, ref_poses))
        out[name] = dict(ate_port=ev.ate(port_poses, port_truth), ate_reference=ev.ate(ref_poses, ref_truth),
                         port_vs_reference=vs)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--long", action="store_true", help="the long bench: long_config() on long_sequence(3)")
    ap.add_argument("--scans", type=int, default=None, help="default 50, with --long 110")
    ap.add_argument("--points", type=int, default=None, help="default 20000, with --long 131072")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    name = "e2e_parity_long" if args.long else "e2e_parity"
    args.out = args.out or os.path.join(ROOT, "build", name)
    os.makedirs(args.out, exist_ok=True)

    from chip_smoke import LONG_PTS, bench_data, long_data, write_truth

    if args.long:
        args.scans, args.points = args.scans or 110, args.points or LONG_PTS
        seq, data = long_data(args.scans, args.points)
        config = "long_config"
    else:
        args.scans, args.points = args.scans or 50, args.points or 20000
        seq, data = bench_data(args.scans, args.points)
        config = "bench_config"
    ref_poses, ref_run = reference_run(data, os.path.join(args.out, "reference"), config)
    port_poses, port_run_ = port_run(data, os.path.join(args.out, "port"), reference_priorities(), config)
    port_truth = os.path.join(args.out, "truth_port.txt")
    ref_truth = os.path.join(args.out, "truth_reference.txt")
    write_truth(seq, port_poses, port_truth)
    write_truth(seq, ref_poses, ref_truth)
    ev = evaluate_all(port_poses, ref_poses, port_truth, ref_truth)
    res = dict(
        config=config, scans=args.scans, points=args.points, device="cpu",
        **{k: dict(port=port_run_[k], reference=ref_run[k]) for k in ref_run},
        **ev["dmsa_lidar_slam_tpu_torch"],
        evaluate_packages_agree=ev["dmsa_lidar_slam_tpu_torch"] == ev["dmsa_lidar_slam_tpu"],
    )
    line = json.dumps(res)
    with open(os.path.join(args.out, f"{name}.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
