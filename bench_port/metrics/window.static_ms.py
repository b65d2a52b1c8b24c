"""window.static_ms: host ms per call of the fused step's `window.static`
span over the window's scans: the closest keyframes, their clouds, the
forward pass and K4's static-point selection.  Window branch of the step
(pipeline/fused.py main_window)."""


def read(run):
    st = run["stages"].get("window.static")
    if not st or not st["calls"]:
        return None
    return 1e3 * st["total_s"] / st["calls"]
