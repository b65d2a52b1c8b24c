"""step.launches_per_scan: kernel launches (cudaLaunchKernel and its
driver forms) per profiled scan.  Fused step layer (pipeline/fused.py
make_step, the optimizer's tabular path)."""


def read(run):
    p = run["profile"]
    return None if not p else p["launches"] / p["scans"]
