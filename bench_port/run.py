"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload nc_os128.loop --seed 7 --seconds 40 --trace 0

From the root of a checkout, on a machine with an NVIDIA card.  Standard
output ends with one JSON line: correct, attempted, failed, metrics
(--trace 0: the cell's end-to-end metrics; --trace 1: its per-layer ones)
and device, with --trace 1 also busy_s / window_s and a breakdown, and
last `checks`: each compared number beside its limit.  The same checks
end standard error.  Exits non-zero, printing no result, without a card,
when the JAX package or JAX was loaded, or when the check fails to run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run may fill stays in the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_port", sub)
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: the program's host work is one Python thread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from bench_port import harness

    cell, *_ = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        harness.log("bench_port: torch.cuda.is_available() is false: the benchmark needs an NVIDIA card")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        harness.log(f"bench_port: {torch.cuda.device_count()} card(s), the cell asks for {cell['chips']}")
        return 2
    harness.log(f"bench_port: {torch.cuda.get_device_name(0)}, power limit {harness.power_limit()}")
    result, extras = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, args.trace, t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"bench_port: modules of JAX or the JAX package were loaded: {bad}")
        return 3
    result["power_limit"] = harness.power_limit()
    result["checks"] = result.pop("checks")
    harness.log("bench_port: " + json.dumps({k: v for k, v in extras.items() if k != "numbers"}))
    harness.log("bench_port: readings " + json.dumps(extras["numbers"]))
    for name, value, limit in result["checks"]:
        harness.log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
