"""keyframe.cloud_ms: host ms per call of the fused step's
`keyframe.cloud` span over the window's scans: the forward pass, the
keyframe cloud's downsample and K5 normals, the gravity estimate and the
map insert.  Keyframe branch of the step (pipeline/fused.py main_window)."""


def read(run):
    st = run["stages"].get("keyframe.cloud")
    if not st or not st["calls"]:
        return None
    return 1e3 * st["total_s"] / st["calls"]
