#!/usr/bin/env python3
"""Time the K1-K7 calls (build_packed, gn_system, cand_errors, min_sq_dist,
radius_neighbor_moments, window_tables, keyframe_tables) of the PyTorch port at
chip_smoke.py's shapes, for this checkout or another one.

    python3 tools/kernel_calls.py
    python3 tools/kernel_calls.py --root path/to/other/checkout

The inputs are chip_smoke.py's scene problems (the same seeds): K1 at n =
28,672 and 409,600 (the grid 1.5 m as the optimizer passes it, an f32
scalar on the card), at n = 28,672 with the window's real masked share
(chip_smoke.WINDOW_MASKED_SHARE), at the long configuration's submap (n =
196,608, LONG_SUBMAP_MASKED_SHARE) and at the submap view of a span-4
solve (44 of 48 keyframes masked; the compact and the 12-row layout), K2 at P = 30 over the window's packed
rows and P = 594 over the 100-keyframe ring's, K3 at K = 15 over each of
the three packed inputs, K4 at chip_smoke's two static-point queries, K5 at
chip_smoke's 4,096-point keyframe cloud (rho = 0.8 m) with the radius as a
host number (the host pipeline's form) and as an f32 card scalar (the fused
pipeline's), K6 in both modes at chip_smoke's window (and, beside it, the
torch.func path it replaces; a checkout without K6 times only that path),
K7 the same way at the bench's submap (S = 48, P = 282) and the upstream
ring (S = 100, P = 594) of tests/torch_keyframes.py, gravity terms on,
and the stable torch.sort of K1's keys at n = 28,672 on its own.  For each call
it prints one JSON line, each number from chip_smoke.py's own helpers:

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


def _load(name, path):
    """A module of this checkout by its path (chip_smoke.py: its problem
    builders and timers; tests/torch_window.py: K6's window;
    tests/torch_keyframes.py: K7's submaps)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    smoke = _load("chip_smoke_helpers", "chip_smoke.py")
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_calls: needs a CUDA card")
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib, voxel
    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
    from dmsa_lidar_slam_tpu_torch.ops import nn_bruteforce as nb
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
    from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct

    dev = torch.device("cuda", 0)
    cuda_lib.library()
    rng = np.random.default_rng(0)
    packs = {}
    rows = []
    share = smoke.WINDOW_MASKED_SHARE
    for n, dtab, masked, prng in ((28672, 502, 0.05, rng), (409600, 101, 0.05, rng),
                                  (28672, 502, share, np.random.default_rng(1))):
        pts, mask, rings, xs, ti, tab = smoke._scene_problem(prng, n, dtab, dev, masked)
        grids = [f * torch.tensor(0.6, dtype=torch.float32, device=dev) for f in (1.0, 2.5)]
        pk = [fr.build_packed(pts, mask, rings, xs, ti, g, 10, tab)[0] for g in grids]
        packs[n, masked] = (torch.cat(pk, dim=1), tab)
        k1_args = (pts, mask, rings, xs, ti, grids[1], 10, tab)
        label = "" if masked == 0.05 else f" masked={masked}"
        rows.append(("build_packed", f"n={n}{label}", lambda a=k1_args: fr.build_packed(*a), 10))
        if n == 28672 and masked == 0.05:
            key = voxel.combined_key(*voxel.voxel_keys(pts, mask, grids[1]))
            rows.append(("torch.sort", f"K1 keys n={n}", lambda k=key: torch.sort(k, stable=True), 10))
    # K1 at the long configuration's submap (random masked share) and at the
    # submap view a span-4 solve sees (44 of 48 keyframes masked, both
    # layouts), chip_smoke's long_rows / submap_view_rows inputs, the
    # coarser grid
    s, ppk = smoke.LONG_SUBMAP_SHAPE
    n = s * ppk
    g = 2.5 * torch.tensor(0.4, dtype=torch.float32, device=dev)
    lrng = np.random.default_rng(smoke.LONG_SEED)
    long_in = smoke._scene_problem(lrng, n, s + 1, dev, smoke.LONG_SUBMAP_MASKED_SHARE)
    lsplit = torch.as_tensor(lrng.integers(0, 6, size=n), dtype=torch.int32, device=dev)
    k1_long = (*long_in[:5], g, 10, long_in[5], lsplit)
    rows.append(("build_packed", f"n={n} long submap, masked={smoke.LONG_SUBMAP_MASKED_SHARE}",
                 lambda a=k1_long: fr.build_packed(*a), 10))
    srng = np.random.default_rng(smoke.SUBMAP_VIEW_SEED)
    pts, mask, rings, xs, ti, tab, split = smoke._scene_problem(srng, n, s + 1, dev, 0.05, with_split=True,
                                                                 tidx=np.repeat(np.arange(s), ppk))
    mask &= ti >= s - smoke.SUBMAP_VIEW_ACTIVE
    obs = torch.as_tensor(srng.uniform(0.5, 2.0, size=n), dtype=torch.float32, device=dev)
    label = f"n={n} submap view, {s - smoke.SUBMAP_VIEW_ACTIVE} of {s} keyframes masked"
    k1_view = (pts, mask, rings, xs, ti, g, 10, tab, split)
    rows.append(("build_packed", label, lambda a=k1_view: fr.build_packed(*a), 10))
    rows.append(("build_packed", label + ", 12-row, weights", lambda a=k1_view: fr.build_packed(*a, obs), 10))
    for n, p_dim in ((28672, 30), (409600, 594)):
        packed, tab = packs[n, 0.05]
        dtabs = 0.1 * torch.randn(p_dim, tab.shape[0], 8, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(1))
        dtabs[:, -1, :] = 0.0
        mc = packed.shape[1] // 10 + 2
        rows.append(("gn_system", f"P={p_dim} M={packed.shape[1]}",
                     lambda t=tab, d=dtabs, p=packed, mc=mc: fr.gn_system(t, d, p, max_cells=mc), 5))
    for (n, masked), (packed, tab) in packs.items():
        tabs = smoke._cand_tables(tab, dev)
        label = "" if masked == 0.05 else f" masked={masked}"
        rows.append(("cand_errors", f"K=15 Dtab={tab.shape[0]} M={packed.shape[1]}{label}",
                     lambda t=tabs, p=packed: fr.cand_errors(t, p), 10))
    for n_ref, n_q in ((20480, 12288), (8192, 20480)):
        a = smoke._clouds(rng, n_ref, n_q, dev)
        rows.append(("min_sq_dist", f"refs={n_ref} queries={n_q}", lambda a=a: nb.min_sq_dist(*a), 20))
    kpts, kmask, grid = smoke._keyframe_cloud(dev)
    rho_card = 2.0 * torch.tensor(grid, dtype=torch.float32, device=dev)
    for rho, label in ((2.0 * grid, "host float"), (rho_card, "card scalar")):
        rows.append(("radius_neighbor_moments", f"N={kpts.shape[0]} rho={2.0 * grid} {label}",
                     lambda r=rho: nb.radius_neighbor_moments(kpts, kmask, r), 20))
    window = _load("torch_window_helpers", os.path.join("tests", "torch_window.py"))
    shapes, wdata, params = window.window_problem(smoke.K6_SEED, device=dev)
    cands = window.candidates(params, smoke.K6_SEED)
    tab_fn = lambda p: ct._window_tables(p, wdata, shapes, True)  # noqa: E731
    rows.append(("torch.func jacfwd", "window P=30 D=502", lambda: torch.func.jacfwd(tab_fn)(params), 3))
    rows.append(("torch.func vmap", "window K=15 D=502", lambda: torch.func.vmap(tab_fn)(cands), 3))
    if hasattr(ct, "window_tables"):  # a tree with K6
        rows.append(("window_tables", "jacobian P=30 D=502",
                     lambda: ct.window_tables(params, wdata, shapes, True), 20))
        rows.append(("window_tables", "batch K=15 D=502",
                     lambda: ct.window_tables_batch(cands, wdata, shapes, True), 20))
    keyframes = _load("torch_keyframes_helpers", os.path.join("tests", "torch_keyframes.py"))
    for s in (48, 100):  # the bench's submap, the upstream ring; gravity terms on, odometry off
        kshapes, kdata, kparams = keyframes.keyframe_problem(smoke.K7_SEED, s=s, device=dev)
        kcands = window.candidates(kparams, smoke.K7_SEED)
        kf_fn = lambda p, d=kdata, sh=kshapes: kfm._kf_tables(p, d, sh, True, False)  # noqa: E731
        p_dim = kparams.shape[0]
        rows.append(("torch.func jacfwd", f"submap P={p_dim} S={s}",
                     lambda f=kf_fn, p=kparams: torch.func.jacfwd(f)(p), 3))
        rows.append(("torch.func vmap", f"submap K=15 S={s}", lambda f=kf_fn, c=kcands: torch.func.vmap(f)(c), 3))
        if hasattr(kfm, "keyframe_tables"):  # a tree with K7
            a = (kparams, kdata, kshapes, True, False)
            rows.append(("keyframe_tables", f"jacobian P={p_dim} S={s}", lambda a=a: kfm.keyframe_tables(*a), 20))
            rows.append(("keyframe_tables", f"batch K=15 S={s}",
                         lambda a=(kcands, *a[1:]): kfm.keyframe_tables_batch(*a), 20))
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
