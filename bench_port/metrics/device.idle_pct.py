"""device.idle_pct: 100 x (1 - busy / wall) over the profiled scans, busy
the card's kernel, copy and memset time.  Device layer (one H100)."""


def read(run):
    p = run["profile"]
    if not p or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
