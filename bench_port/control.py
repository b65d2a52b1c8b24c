"""The control of the check that decides `correct`, and the planted
faults, on the card at a cell's own size: for each seed one run of the
cell (set-up, a window), then the checked steps held against the
reference in the program's place three ways: the program; the control (the
plain reference in float32 pose math with TF32 matmuls, one step below
each precision the configuration states: float64 poses, float32 matmuls
with TF32 off); and the faults (the reference with its submap write-back
left out, so the keyframe poses are written back unmoved; K5's normals
over half the radius; the program's trajectory stopped where the segment
starts).  Prints one JSON line per seed with the three sets of numbers and
the limits.  The benchmark's own runs do not run it.

    python3 bench_port/control.py --workload nc_os128.loop --seconds 51 --seeds 11 12 13
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bench_port import compare, harness

    if not torch.cuda.is_available():
        harness.log("control: needs an NVIDIA card")
        return 2
    for seed in args.seeds:
        result, extras = harness.run_cell(ROOT, args.workload, seed, args.seconds, 0, control=torch.float32)
        limits = harness.load_cell(ROOT, args.workload)[2]["limits"]
        ctl_ok, _ = compare.verdict(extras["control_numbers"], limits)
        print(json.dumps(dict(workload=args.workload, seed=seed, program=extras["numbers"],
                              control=extras["control_numbers"], faults=extras["fault_numbers"], limits=limits,
                              program_correct=result["correct"], control_correct=ctl_ok,
                              checked_steps=extras["checked_steps"], device=result["device"]["kind"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
