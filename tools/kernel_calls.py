#!/usr/bin/env python3
"""Time the K1 (build_packed) and K2 (gn_system) calls of the PyTorch port
at chip_smoke.py's shapes, for this checkout or another one.

    python3 tools/kernel_calls.py
    python3 tools/kernel_calls.py --root path/to/other/checkout

The inputs are chip_smoke.py's scene problems (the same seeds): K1 at n =
28,672 and 409,600 (the grid 1.5 m as the optimizer passes it, an f32
scalar on the card), K2 at P = 30 over the window's packed rows and P = 594
over the 100-keyframe ring's, and the stable torch.sort of K1's keys at n =
28,672 on its own.  For each call it prints one JSON line, each number from
chip_smoke.py's own helpers:

  ms               CUDA events after one warm-up call, over chip_smoke's
                   reps (K1 10, K2 5, the sort 10): chip_smoke's ms;
  ms_steady        the same over 20 calls after 20 warm-up calls: the first
                   calls after an idle card run slower;
  host_ms          the host clock over 20 calls, no sync;
  device_ms        the card's busy time for one call (the sum of its kernel
                   and copy durations, torch.profiler);
  device_launches  the kernels that one call runs on the card, those inside
                   torch ops included (torch.profiler);
  kernels          their names, counts and device us.

All calls are timed before any is profiled: CUPTI tracing slows whatever
runs while it is on.

--root imports the port from another checkout (its own kernels are built
there), so that two commits can be compared in one run on one card: run
parent, change, change, parent.  Needs a CUDA card; exits non-zero without
one.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    """chip_smoke.py of this checkout (its problem builders and timers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    smoke = _load_smoke()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_calls: needs a CUDA card")
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib, voxel
    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr

    dev = torch.device("cuda", 0)
    cuda_lib.library()
    rng = np.random.default_rng(0)
    packs = {}
    rows = []
    for n, dtab in ((28672, 502), (409600, 101)):
        pts, mask, rings, xs, ti, tab = smoke._scene_problem(rng, n, dtab, dev)
        grids = [f * torch.tensor(0.6, dtype=torch.float32, device=dev) for f in (1.0, 2.5)]
        pk = [fr.build_packed(pts, mask, rings, xs, ti, g, 10, tab)[0] for g in grids]
        packs[n] = (torch.cat(pk, dim=1), tab)
        k1_args = (pts, mask, rings, xs, ti, grids[1], 10, tab)
        rows.append(("build_packed", f"n={n}", lambda a=k1_args: fr.build_packed(*a), 10))
        if n == 28672:
            key = voxel.combined_key(*voxel.voxel_keys(pts, mask, grids[1]))
            rows.append(("torch.sort", f"K1 keys n={n}", lambda k=key: torch.sort(k, stable=True), 10))
    for n, p_dim in ((28672, 30), (409600, 594)):
        packed, tab = packs[n]
        dtabs = 0.1 * torch.randn(p_dim, tab.shape[0], 8, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(1))
        dtabs[:, -1, :] = 0.0
        mc = packed.shape[1] // 10 + 2
        rows.append(("gn_system", f"P={p_dim} M={packed.shape[1]}",
                     lambda t=tab, d=dtabs, p=packed, mc=mc: fr.gn_system(t, d, p, max_cells=mc), 5))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    steady = smoke.STEADY_REPS
    timed = [(smoke._timed(fn, reps), smoke._timed(fn, steady, warmup=steady), smoke._host_ms(fn, steady))
             for _, _, fn, reps in rows]
    for (name, shape, fn, _), (ms, ms_steady, host_ms) in zip(rows, timed):
        device_ms, kernels = smoke._profile(fn)
        print(json.dumps(dict(tag=args.tag, root=os.path.abspath(args.root), card=smi, kernel=name, shape=shape,
                              ms=ms, ms_steady=ms_steady, host_ms=host_ms, device_ms=device_ms,
                              device_launches=sum(c for c, _ in kernels.values()), kernels=kernels)), flush=True)


if __name__ == "__main__":
    main()
