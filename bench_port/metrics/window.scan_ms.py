"""window.scan_ms: median host ms of the window's scans that added no
keyframe (the keyframe updates counter did not rise).  Window branch of
the step (main_window, K1-K4)."""

import statistics


def read(run):
    ms = [1e3 * s for s, kf in zip(run["scan_s"], run["is_kf"]) if not kf]
    return statistics.median(ms) if ms else None
