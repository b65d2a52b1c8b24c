"""step.syncs_per_scan: cudaStreamSynchronize + cudaDeviceSynchronize
calls per profiled scan, the harness's one sync after each scan
included.  Fused step layer."""


def read(run):
    p = run["profile"]
    return None if not p else p["syncs"] / p["scans"]
