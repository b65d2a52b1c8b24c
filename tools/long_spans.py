#!/usr/bin/env python3
"""The long configuration's keyframe record on a CUDA card, with the
keyframe normals from either branch of map/normals.py.

    python3 tools/long_spans.py [--normals radius|knn6] [--scans 310]

Runs FusedDmsaSlam(long_config()) on the card over chip_smoke.long_data
(long_sequence(3), 131,072 raw points over 128 rings, bench.py's
stressors).  --normals radius keeps the card's branch (K5's radius
moments); knn6 takes the normals from the 6-nearest-neighbour branch, the
one CPU runs of either package take, computed on a host copy of each cloud.
The normals feed the static points' visibility test and so the submap's
related keyframes.  Prints one JSON line: ATE, keyframes, retired,
chip_smoke.span_summary and each keyframe step's span from scan 150 on.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--normals", choices=["radius", "knn6"], default="radius")
    ap.add_argument("--scans", type=int, default=310)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("long_spans: needs a CUDA card")
    from chip_smoke import feed, long_data, record_step, span_summary
    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, long_config
    from dmsa_lidar_slam_tpu_torch.map import normals as nrm
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    if args.normals == "knn6":
        card_normals = nrm.estimate_normals

        def host_knn_normals(points, mask, grid_size, viewpoint=None):
            host = [x.cpu() if torch.is_tensor(x) else x for x in (points, mask, grid_size, viewpoint)]
            return card_normals(*host).to(points.device)

        nrm.estimate_normals = host_knn_normals
    seq, data = long_data(args.scans)
    slam = FusedDmsaSlam(long_config(), flush_every=20, device=torch.device("cuda", 0))
    spans, retired_at = {}, []
    t0 = time.perf_counter()
    for rec in data:
        stepped = slam.scan_counter
        feed(slam, [rec])
        if slam.scan_counter > stepped:
            record_step(slam, stepped, spans, retired_at)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, tr, _ = slam.all_poses()
    print(json.dumps(dict(
        normals=args.normals, scans=args.scans, device=torch.cuda.get_device_name(0), wall_s=wall,
        ate_m=ate_rmse(st, tr, seq), keyframes=slam.kf_count, max_submap_span=slam.max_submap_span,
        retired=slam.output.num_static_keyframes, **span_summary(spans, retired_at),
        spans_from_150=[(k, v) for k, v in sorted(spans.items()) if k >= 150],
    )), flush=True)


if __name__ == "__main__":
    main()
