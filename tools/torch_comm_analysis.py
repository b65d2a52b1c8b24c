#!/usr/bin/env python3
"""Collective traffic per Gauss-Newton iteration of the port's distributed
keyframe adjustment (counterpart of tools/comm_analysis.py, which counts
the JAX package's collectives from its traced program).

Here the optimisation really runs, on RANKS gloo ranks spawned on this
host, and parallel.mesh's collective counter records every collective the
two backends issue: the hash backend (parallel.keyframe_dist, a hash
table of TABLE slots) and the spatial one (parallel.spatial, with the
split channel).  The shape is tools/comm_analysis.py's: the flagship map
(parallel.dryrun) at 48 keyframes x 4,096 points, 10 iterations at most,
minimum 10 points per cell, 8 ranks.  Per backend it prints the
primitive, payload, executions per iteration (the iteration loop's calls
over the iterations run) and bytes per execution, the per-iteration
totals, and the set-up calls (outside the loop) apart.  The counts are
rank 0's; the tool checks that every rank issued the same.

    python3 tools/torch_comm_analysis.py                 # the ranks share one card over gloo
    python3 tools/torch_comm_analysis.py --device cpu    # CPU ranks

Writes build/comm_analysis/comm_<device>.{json,md}.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

S, PPK = 48, 4096  # tools/comm_analysis.py: the long bench's uncapped submap
TABLE = 65536  # config.dist_table_size's default there
NUM_ITER = 10
MIN_POINTS = 10
RANKS = 8
GRIDS = (1.2, 3.0)  # tools/comm_analysis.py's grids
TIMEOUT_S = 3000.0  # the ranks' run, start-up included (8 CPU ranks take the longest)


def _payload(r):
    return f"{r['dtype']}[{'x'.join(map(str, r['shape']))}]"


def table(rows, iters):
    """Markdown rows of one scope: executions per iteration when iters."""
    head = ("| primitive | payload | executions per iteration | bytes/exec |" if iters
            else "| primitive | payload | executions | bytes/exec |")
    lines = [head, "|---|---|---|---|"]
    for r in rows:
        n = r["calls"] / iters if iters else r["calls"]
        lines.append(f"| {r['primitive']} | {_payload(r)} | {n:g} | {r['bytes']:,} |")
    return lines


def summarize(rows, iters):
    calls = sum(r["calls"] for r in rows) / max(iters, 1)
    nbytes = sum(r["calls"] * r["bytes"] for r in rows) / max(iters, 1)
    return calls, nbytes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (every rank on cuda:0 over gloo) or cpu")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "comm_analysis"))
    a = ap.parse_args(argv)

    import torch

    from dmsa_lidar_slam_tpu_torch.parallel import dryrun, launch

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false; pass --device cpu for CPU ranks")
    os.makedirs(a.out, exist_ok=True)
    _, data, params0, _ = dryrun.flagship_problem(S, PPK, device="cpu")
    t0 = time.perf_counter()
    per_rank = launch.run_local_ranks(dryrun.collective_counts, RANKS, a.out, data, params0, GRIDS, NUM_ITER,
                                      MIN_POINTS, TABLE, device=a.device, timeout_s=TIMEOUT_S)
    wall = time.perf_counter() - t0

    def counts(r):
        return {name: (c["rows"], c["setup"], c["iterations"]) for name, c in r.items()}

    assert all(counts(r) == counts(per_rank[0]) for r in per_rank), "the ranks issued different collectives"

    p_dim = 6 * (S - 1)
    lines = [f"# Collectives per Gauss-Newton iteration, {S} keyframes x {PPK} points "
             f"(P = {p_dim}), {RANKS} {a.device} ranks over gloo, table {TABLE}, {NUM_ITER} iterations at most",
             ""]
    summary = {}
    for name, c in per_rank[0].items():
        iters = c["iterations"]
        calls, nbytes = summarize(c["rows"], iters)
        summary[name] = dict(iterations=iters, calls_per_iteration=calls, bytes_per_iteration=nbytes,
                             wall_s=c["wall_s"], rows=c["rows"], setup_rows=c["setup"])
        lines += [f"## {name} backend: {iters} iterations run", ""] + table(c["rows"], iters) + [
            "", f"**Per iteration: {calls:g} calls, {nbytes / 1e6:.3f} MB.**", ""]
        lines += (["Set-up (outside the iteration loop):", ""] + table(c["setup"], 0) if c["setup"]
                  else ["Set-up (outside the iteration loop): none."])
        lines.append("")
    lines.append(f"(wall {wall:.1f} s with start-up; counts do not depend on the device)")
    text = "\n".join(lines)
    print(text)
    tag = a.device.split(":")[0]
    with open(os.path.join(a.out, f"comm_{tag}.md"), "w") as f:
        f.write(text + "\n")
    with open(os.path.join(a.out, f"comm_{tag}.json"), "w") as f:
        json.dump(dict(keyframes=S, points=PPK, ranks=RANKS, table=TABLE, device=a.device,
                       max_iterations=NUM_ITER, backends=summary, wall_s=wall), f, indent=1)
    return summary


if __name__ == "__main__":
    main()
