"""kernel.k2_roofline: K2's bound time over its device time over the
K2 calls of the profiled scans, in %.  Kernel layer (csrc/k2_gn.cu)."""


def read(run):
    p, b = run["profile"], run["rooflines"]
    if not p or not b or p["k2_device_s"] <= 0:
        return None
    return 100.0 * b[1] / p["k2_device_s"]
