"""A cell at a size the CPU runs in seconds, for the tests: the long
configuration at the test suite's small caps (tests/test_torch_long.py
LONG_OVERRIDES: 1,024 raw points, 600 per scan, 1,024-point keyframe
clouds, a 6-keyframe ring, a keyframe every 0.1 m) on the loop mix."""

import copy
import json

from bench_port import harness

OVERRIDES = dict(
    raw_scan_cap=1024, max_num_points_per_scan=600, keyframe_points_cap=1024, static_points_cap=2048,
    last_n_keyframes_for_optim=6, dist_new_keyframe=0.1, min_num_points_gauss=5, min_num_points_gauss_key=5,
)


def loaded(root, warmup=8, segment=(8, 14), prewarm=2, name="nc_os128.loop"):
    """load_cell's tuple for a cell (nc_os128.loop) cut to the tiny size:
    1,000 points a scan over the configuration's rings."""
    cell, cfg, traffic, manifest = harness.load_cell(root, name)
    cfg = copy.deepcopy(cfg)
    cfg["pipeline"].update(OVERRIDES)
    cfg["stream"].update(points_per_scan=1000)
    traffic = json.loads(json.dumps(traffic))
    traffic.update(warmup_scans=warmup, segment=list(segment), prewarm_scans=prewarm,
                   stressors=dict(traffic["stressors"], short_after=segment[0], short_every=segment[0] + 3))
    return cell, cfg, traffic, manifest
