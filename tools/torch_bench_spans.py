#!/usr/bin/env python3
"""One traced run of a benchmark cell (bench_port), printing the program's
spans and counters over its timed window: each span's self and total host
ms a scan, calls and parent, then the counters.

    python3 tools/torch_bench_spans.py nc_os128.loop 2024101811

Runs bench_port.harness.run_cell(cell, seed, 51 s, trace=1) on the card and
keeps the Metrics.summary() the harness reads at the window's end.  The
first line is one JSON object (cell, seed, scans, keyframe_scans, spans,
counters, the cell's per-layer metrics, correct); the table follows, by
self time.  Needs a CUDA card.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    cell, seed = (argv or sys.argv[1:])[:2]
    sys.path.insert(0, ROOT)
    from bench_port import harness
    from dmsa_lidar_slam_tpu_torch.pipeline import metrics as pm

    summaries = []
    summary = pm.Metrics.summary

    def recorded(self):
        s = summary(self)
        summaries.append(s)
        return s

    pm.Metrics.summary = recorded
    result, extras = harness.run_cell(ROOT, cell, int(seed), 51, 1)
    s, n = summaries[0], result["attempted"]
    spans = {k: dict(self_ms=1e3 * v["self_s"] / n, total_ms=1e3 * v["total_s"] / n, calls=v["calls"],
                     parent=v["parent"]) for k, v in s.items() if "total_s" in v}
    counters = {k: v["count"] for k, v in s.items() if "count" in v}
    print(json.dumps(dict(cell=cell, seed=int(seed), scans=n, keyframe_scans=extras["keyframe_scans"], spans=spans,
                          counters=counters, metrics=result["metrics"], correct=result["correct"])))
    for k, v in sorted(spans.items(), key=lambda kv: -kv[1]["self_ms"]):
        print(f"{k:22s} self {v['self_ms']:9.3f} ms/scan  total {v['total_ms']:9.3f}  calls {v['calls']}  "
              f"parent {v['parent']}")
    print(json.dumps(counters))


if __name__ == "__main__":
    main()
