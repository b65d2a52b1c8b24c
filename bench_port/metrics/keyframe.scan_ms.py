"""keyframe.scan_ms: median host ms of the window's scans that added a
keyframe.  Keyframe branch of the step (keyframe cloud, K5 normals,
submap solve)."""

import statistics


def read(run):
    ms = [1e3 * s for s, kf in zip(run["scan_s"], run["is_kf"]) if kf]
    return statistics.median(ms) if ms else None
