"""keyframe.submap_ms: host ms per call of the fused step's
`keyframe.submap` span over the window's scans: the submap solve
(K1-K3) and its write-back.  Keyframe branch of the step
(pipeline/fused.py do_submap)."""


def read(run):
    st = run["stages"].get("keyframe.submap")
    if not st or not st["calls"]:
        return None
    return 1e3 * st["total_s"] / st["calls"]
