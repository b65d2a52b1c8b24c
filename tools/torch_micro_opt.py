#!/usr/bin/env python3
"""Time the window DMSA optimization of the PyTorch port on one problem
under controlled variants (the port's counterpart of tools/micro_opt.py).

    python3 tools/torch_micro_opt.py [--device cpu]

Builds tools/micro_opt.py's bench-shaped window problem (5 scans x 4,096
points of SyntheticSequence(rng=default_rng(0)) + 8,192 static points of
the room scene, 501 dense samples, 6 control poses, no IMU) and times
opt.optimize over the same variants: the autodiff and the structured
Jacobian paths x line-search grids of 14 / 9 / 1 fractions x 10 and 2
iterations, and the tabular path (K1-K3) on the card's kernels (on the CPU
their plain versions).  For each variant one line: ms per call (host clock
over REPS calls ending in a synchronize, after one warm-up call),
iterations, stop reason, cells (num_gaussians), the port's kernel launches
per call (cuda_lib.launch_counts), and from one more call under
pipeline/traceutil.capture the CUDA kernel launches (cudaLaunchKernel),
host syncs (cudaStreamSynchronize + cudaDeviceSynchronize) and copy calls
(cudaMemcpyAsync) per call and per iteration; on the CPU those three are
null.  Then the forward alone, forward + one cell build, and forward +
build + residuals.  The last line is one JSON object with every row and
the card's name and power limit.

Runs on the card unless given --device cpu; with no card and no --device
cpu it exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FULL = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.05, 0.02, 0.01, 0.005, 0.002)
REF9 = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
ONE = (0.5,)
REPS = 5  # timed calls per variant, as tools/micro_opt.py's
# (name, line-search fractions, path, iterations), tools/micro_opt.py's
# variants and the tabular path
VARIANTS = (
    ("autodiff ls14 it10", FULL, "autodiff", 10),
    ("struct   ls14 it10", FULL, "structured", 10),
    ("struct   ls9  it10", REF9, "structured", 10),
    ("struct   ls1  it10", ONE, "structured", 10),
    ("autodiff ls1  it10", ONE, "autodiff", 10),
    ("struct   ls14 it2 ", FULL, "structured", 2),
    ("tabular  ls14 it10", FULL, "tabular", 10),
    ("tabular  ls14 it2 ", FULL, "tabular", 2),
)


def build_problem(device):
    """tools/micro_opt.py's window problem on `device`: (shapes, data,
    params, min_grid)."""
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.io.synthetic import SyntheticSequence, room_scene, sample_scene_points
    from dmsa_lidar_slam_tpu_torch.trajectory import builder
    from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
    from dmsa_lidar_slam_tpu_torch.utils.dtypes import POSE_DTYPE

    seq = SyntheticSequence(rng=np.random.default_rng(0), noise_std=0.01)
    scans = []
    for i in range(5):
        pts, stamps, rings = seq.scan(i, 4096)
        scans.append(builder.HostScan(points=pts, stamps=stamps, rings=rings, grid_size=0.2))
    shapes = ct.WindowShapes(n_window_pts=5 * 4096, n_static=8192, n_ctrl=6, n_dense=501)
    data, _, min_grid, _ = builder.build_window(scans, shapes, None, np.eye(3) * 1e-4, np.eye(3) * 1e-2, 1e-3,
                                                False, device)
    rng = np.random.default_rng(1)
    st = sample_scene_points(rng, shapes.n_static, planes=room_scene(1.0)).astype(np.float32)
    data = data._replace(
        static_pts=torch.as_tensor(st, device=device),
        static_mask=torch.ones(shapes.n_static, dtype=torch.bool, device=device),
        static_ring=torch.as_tensor(rng.integers(0, 32, shapes.n_static).astype(np.int32), device=device),
    )
    params = torch.zeros(6 * (shapes.n_ctrl - 1), dtype=POSE_DTYPE, device=device)
    return shapes, data, params, float(min_grid)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_micro_opt: no CUDA card (give --device cpu to run on the CPU)")
    from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib, gaussians
    from dmsa_lidar_slam_tpu_torch.pipeline import traceutil
    from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct

    card = args.device == "cuda"
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    if card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        cuda_lib.library()
    else:
        smi = None
    kind = torch.cuda.get_device_name(0) if card else "cpu"
    print(f"device={kind} ({smi})", flush=True)

    def sync():
        if card:
            torch.cuda.synchronize()

    shapes, data, params, min_grid = build_problem(dev)
    fwd = ct.make_forward(shapes, use_imu=False)
    paths = dict(autodiff={}, structured=dict(structured_fn=ct.make_structured(shapes, use_imu=False)),
                 tabular=dict(tabular_fn=ct.make_tabular(shapes, use_imu=False)))
    print(f"n_pts={shapes.n_window_pts + shapes.n_static}", flush=True)

    def timeit(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = fn()
        sync()
        return 1000.0 * (time.perf_counter() - t0) / REPS, out

    rows = []
    for name, fracs, path, iters in VARIANTS:
        settings = opt.OptimSettings(num_iter=iters, min_num_points_per_set=10, epsilon=0.0,
                                     line_search_fracs=fracs)

        def call():
            return opt.optimize(fwd, params, data, settings, min_grid, **paths[path])

        ms, r = timeit(call)
        sync()
        cuda_lib.reset_launches()
        call()
        sync()
        launches = {k: v for k, v in cuda_lib.launch_counts().items() if v}
        n_it = int(r.num_iters)
        calls = {}
        if card:
            with traceutil.capture() as trace_dir:
                call()
                sync()
            calls = traceutil.host_call_counts(trace_dir)
        row = dict(variant=name.strip(), path=path, line_search=len(fracs), num_iter=iters, ms=ms, iters=n_it,
                   stop=int(r.stop_reason), cells=int(r.num_gaussians), kernel_launches=launches)
        for key, names in (("cuda_launches", ("cudaLaunchKernel",)),
                           ("syncs", ("cudaStreamSynchronize", "cudaDeviceSynchronize")),
                           ("copies", ("cudaMemcpyAsync",))):
            n = sum(calls.get(c, 0) for c in names) if card else None
            row[key] = n
            row[key + "_per_iter"] = n / max(n_it, 1) if card else None
        rows.append(row)
        print(f"{name}: {ms:9.2f} ms  iters={n_it} stop={row['stop']} cells={row['cells']} "
              f"launches={launches} cuda_launches={row['cuda_launches']} syncs={row['syncs']} "
              f"copies={row['copies']}", flush=True)

    def forward_only():
        return fwd(params, data).points

    def cellbuild():
        out = fwd(params, data)
        return gaussians.build_cells(out.points, out.mask, out.ring_ids, 2 * min_grid, 10).info6

    def resid():
        out = fwd(params, data)
        c = gaussians.build_cells(out.points, out.mask, out.ring_ids, 2 * min_grid, 10)
        return gaussians.cell_residuals(out.points, out.mask, c)

    parts = {}
    for label, fn in (("forward only", forward_only), ("forward+1cellbuild", cellbuild),
                      ("fwd+build+residuals", resid)):
        parts[label] = timeit(fn)[0]
        print(f"{label + ':':22s}{parts[label]:9.2f} ms", flush=True)
    print(json.dumps(dict(device=kind, nvidia_smi=smi, reps=REPS, variants=rows, parts_ms=parts)), flush=True)


if __name__ == "__main__":
    main()
