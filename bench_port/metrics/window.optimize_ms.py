"""window.optimize_ms: host ms per call of the fused step's
`window.optimize` span over the window's scans: the window's
centralisation, its Gauss-Newton solve (K1-K3) and the decentralisation.
Window branch of the step (pipeline/fused.py main_window)."""


def read(run):
    st = run["stages"].get("window.optimize")
    if not st or not st["calls"]:
        return None
    return 1e3 * st["total_s"] / st["calls"]
