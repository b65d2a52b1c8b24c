"""kernel.k1_roofline: K1's bound time (bench_port/tracing.py k1_work
over the peaks) over its device time, both summed over the K1 calls of
the profiled scans, in %.  Kernel layer (csrc/k1_build.cu; the call's
torch.sort counts as K1's time)."""


def read(run):
    p, b = run["profile"], run["rooflines"]
    if not p or not b or p["k1_device_s"] <= 0:
        return None
    return 100.0 * b[0] / p["k1_device_s"]
