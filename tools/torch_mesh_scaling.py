#!/usr/bin/env python3
"""The distributed keyframe adjustment at 1/2/4/8 ranks on one problem
(counterpart of tools/mesh_scaling.py).

The dry run's flagship map (parallel.dryrun: 32 keyframes x 2,048 points,
186 pose parameters, gravity and odometry terms, 6 iterations at the
reference dry run's settings) goes through the hash backend
(parallel.keyframe_dist), as the reference's tool runs it, and through the
spatial one (parallel.spatial, with the split channel), on 1, 2, 4 and 8
gloo ranks spawned on this host.  Per backend and rank count it prints the
wall time of one optimisation (after a warm-up one), the valid points each
rank works on and their balance (min / max: the hash backend's resident
shard, the spatial backend's points owned after the shuffle at the start,
first grid), the cells, the iterations (hash) and the largest parameter
deviation from the one-rank run.  The ranks share this host's cores
(and, on the card, the one card), so the wall times record orchestration
overhead: they are no scaling claim.  The balance is what would set the efficiency on separate
cards.

    python3 tools/torch_mesh_scaling.py                 # the ranks share one card over gloo
    python3 tools/torch_mesh_scaling.py --device cpu    # CPU ranks

Writes build/mesh_scaling/scaling_<device>.{json,md}.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WORLDS = (1, 2, 4, 8)
N_KF, PPK = 32, 2048  # the dry run's flagship map
TIMEOUT_S = 1800.0  # one rank count's run, start-up included


def rank_run(rank, world, device, n_kf, ppk):
    """On each rank: each backend once to warm up, then timed (the card
    synchronised on both sides); returns {backend: dict}."""
    import torch

    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
    from dmsa_lidar_slam_tpu_torch.parallel import dryrun, keyframe_dist, spatial
    from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh()
    shapes, data, params0, _ = dryrun.flagship_problem(n_kf, ppk, device=device)
    fp, fm, _, aux = keyframe_dist.flatten_problem(data)
    grids = torch.tensor([2.0 * dryrun.MIN_GRID, 5.0 * dryrun.MIN_GRID], dtype=torch.float32, device=fp.device)
    runs = dryrun.backend_runs(mesh, shapes, data, params0, grids, **dryrun.DIST_KW)
    sync = torch.cuda.synchronize if fp.is_cuda else (lambda: None)
    out = {}
    for name, run in runs.items():
        run()
        sync()
        t0 = time.perf_counter()
        res = run()
        sync()
        wall = time.perf_counter() - t0
        cells = res[3] if name == "hash" else res[2]
        out[name] = dict(wall_s=wall, params=res[0].cpu(), cells=int(cells),
                         iterations=int(res[1]) if name == "hash" else None,
                         valid_points=int(pmesh.shard_leading(mesh, fm).sum()))
    # the spatial backend's work is the rows each rank owns after the
    # shuffle: the valid points whose voxel (first grid, start params) it owns
    tab = kfm.make_tabular(shapes, True, True).tables(params0, aux)[0]
    tidx = torch.arange(shapes.n_keyframes, device=fp.device).repeat_interleave(shapes.n_pts_per_kf)
    owner = spatial.owner_of_voxels(spatial.world_points(tab, fp, tidx), fm, grids[0], mesh.size)
    out["spatial"]["owned_points"] = int((owner == mesh.rank).sum())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (every rank on cuda:0 over gloo) or cpu")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mesh_scaling"))
    a = ap.parse_args(argv)

    import torch

    from dmsa_lidar_slam_tpu_torch.parallel import launch

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false; pass --device cpu for CPU ranks")
    os.makedirs(a.out, exist_ok=True)
    results = {}
    for w in WORLDS:
        per_rank = launch.run_local_ranks(rank_run, w, a.out, N_KF, PPK, device=a.device, timeout_s=TIMEOUT_S)
        for name in per_rank[0]:
            assert all(torch.equal(r[name]["params"], per_rank[0][name]["params"]) for r in per_rank), \
                f"{name}: the ranks' parameters differ at {w} ranks"
        results[w] = per_rank
        print(f"{w} ranks done", flush=True)

    n_total = N_KF * PPK
    rows = []
    lines = [f"# The distributed keyframe adjustment at {'/'.join(map(str, WORLDS))} {a.device} ranks over gloo, "
             f"{N_KF} x {PPK} points ({n_total:,}), {6 * (N_KF - 1)} pose parameters", "",
             "All ranks share one host" + (" and its one card" if a.device.startswith("cuda") else "")
             + ": wall times record orchestration overhead, not scaling.", "",
             "| backend | ranks | wall s | valid pts per rank (min..max; spatial: owned after the shuffle) | balance "
             "| cells | iterations "
             "| max param dev vs 1 rank |", "|---|---|---|---|---|---|---|---|"]
    for name in ("hash", "spatial"):
        base = results[WORLDS[0]][0][name]["params"]
        for w in WORLDS:
            r0 = results[w][0][name]
            # the hash backend's work per rank is its resident shard, the
            # spatial backend's the rows it owns after the shuffle
            valid = [r[name]["owned_points" if name == "spatial" else "valid_points"] for r in results[w]]
            dev = float((r0["params"] - base).abs().max())
            row = dict(backend=name, ranks=w, wall_s=max(r[name]["wall_s"] for r in results[w]),
                       points_per_rank=n_total // w, valid_points_per_rank=valid,
                       balance_min_over_max=min(valid) / max(valid), cells=r0["cells"], iterations=r0["iterations"],
                       max_param_dev_vs_1_rank=dev)
            rows.append(row)
            lines.append(f"| {name} | {w} | {row['wall_s']:.3f} | {min(valid)}..{max(valid)} | "
                         f"{row['balance_min_over_max']:.4f} | {row['cells']} | {row['iterations'] or '-'} | "
                         f"{dev:.3e} |")
    text = "\n".join(lines)
    print(text)
    tag = a.device.split(":")[0]
    with open(os.path.join(a.out, f"scaling_{tag}.md"), "w") as f:
        f.write(text + "\n")
    with open(os.path.join(a.out, f"scaling_{tag}.json"), "w") as f:
        json.dump(dict(device=a.device, keyframes=N_KF, points=PPK, rows=rows), f, indent=1)
    return rows


if __name__ == "__main__":
    main()
