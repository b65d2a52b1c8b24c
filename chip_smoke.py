#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Needs a CUDA card, nvcc and this repository's dmsa_lidar_slam_tpu_torch
package beside this script; it exits non-zero otherwise.  Phases, each
printed on its own lines and none of them caught:

  1. the card's name and power limit (nvidia-smi), then the build of the
     hand-written kernels (csrc/*.cu -> build/kernels/, one nvcc per source,
     all at once) and its wall time;
  2. each kernel K1-K5 against its plain PyTorch version on the card, on the
     same inputs at the main path's shapes, with the stated tolerance, both
     times from CUDA events after one warm-up call (ms, plain_ms), and the
     least time the card could take for the same work (bound_ms: bytes over
     3.35 TB/s or f32 operations over 67 TFLOP/s, whichever is larger,
     counted from this run's inputs); the steady-state time after 20
     warm-up calls (ms_steady) and the host's time to enqueue one call
     (host_ms); K1's keys bit for bit against voxel.voxel_keys, with the
     grid as a host number and as a card scalar, and K1 and K2 bit for bit
     against a second call;
  3. the fused pipeline: FusedDmsaSlam on bench_sequence(3) with
     bench_config(), 50 scans of 20,000 points.  Launch counters are zeroed
     just before and read just after; every kernel must have run,
     kf_count >= 3, max_submap_span > 0 and the trajectory ATE against the
     analytic truth <= 0.03 m;
  4. the host pipeline through the CLI runner's entry point:
     pipeline.runner.run(--pipeline host) over a rosbag written from 40
     scans of bench_sequence(3) at bench_config() width (20,000 points per
     scan).  Counters zeroed just before and read just after: K4 and K5
     must have run, kf_count >= 3, Poses.txt and PointCloud.pcd written, and
     the output trajectory's ATE <= 0.03 m;
  5. the CUDA kernels one call of each kernel row runs on the card
     (device_launches) and the card's busy time for it (device_ms), from
     torch.profiler over one call after a warm-up, those inside torch ops
     included.  Last, because CUPTI tracing slows whatever runs while it is
     on.

The line before the last is a JSON object with one entry per kernel and
shape; the last line is {"ok": true, "device": {...}}.  Any failed check
raises, so a failing run prints no result.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ATE_GATE_M = 0.03
N_SCANS = 50
HOST_SCANS = 40
PTS_PER_SCAN = 20000
STEADY_REPS = 20  # warm-up and timed calls of ms_steady and host_ms
# the H100 SXM's published peaks: HBM3 bytes/s and f32 operations/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def _bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time for the work on this card."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _warm(fn, calls):
    """`calls` calls, then a sync."""
    import torch

    for _ in range(calls):
        fn()
    torch.cuda.synchronize()


def _timed(fn, reps, warmup=1):
    """Mean ms per call from CUDA events over `reps` calls enqueued back to
    back, after `warmup` calls and a sync.  `ms` of the kernel rows takes
    one warm-up call; `ms_steady` as many as it times, since the first calls
    after an idle card run slower than the steady state (PERF.md)."""
    import torch

    _warm(fn, warmup)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _host_ms(fn, reps):
    """Mean host ms to enqueue one call, no sync in between, after as many
    warm-up calls."""
    import torch

    _warm(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / reps


def _profile(fn):
    """(device ms, kernels {name: (count, device us)}) of one call after a
    warm-up, from torch.profiler: device ms is the card's busy time (kernels
    and copies); copies and memsets are not kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    on_card = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != on_card}
    busy_us, kernels = 0.0, {}
    for e in events:
        if e.device_type == on_card and e.name not in host_names:
            busy_us += e.device_time
            if not e.name.startswith(("Memcpy", "Memset")):
                c, us = kernels.get(e.name[:60], (0, 0.0))
                kernels[e.name[:60]] = (c + 1, us + e.device_time)
    return busy_us / 1000.0, kernels


def _scene_problem(rng, n, dtab, device):
    """Points on the synthetic room's surfaces, spread over a pose table:
    world = quat_rotate(q[tidx], xs) + t[tidx] exactly as the kernels read it."""
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.core import rotations as rot
    from dmsa_lidar_slam_tpu_torch.io.synthetic import sample_scene_points

    world = sample_scene_points(rng, n) + 0.01 * rng.standard_normal((n, 3))
    tidx = rng.integers(0, dtab - 1, size=n)
    tidx[:: 9] = dtab - 1  # static points on the identity row
    aa = 0.1 * rng.standard_normal((dtab - 1, 3))
    q = rot.axang2quat(torch.as_tensor(aa)).numpy()
    t = 0.5 * rng.standard_normal((dtab - 1, 3))
    tab = np.zeros((dtab, 8))
    tab[:-1, 0:4], tab[:-1, 4:7] = q, t
    tab[-1, 0] = 1.0
    tab_t = torch.as_tensor(tab, dtype=torch.float32, device=device)
    w_t = torch.as_tensor(world, dtype=torch.float32, device=device)
    ti = torch.as_tensor(tidx, device=device)
    qi = tab_t[ti, 0:4]
    qinv = torch.cat([qi[:, :1], -qi[:, 1:]], dim=1)
    xs = rot.quat_rotate(qinv, w_t - tab_t[ti, 4:7])
    mask = torch.as_tensor(rng.uniform(size=n) > 0.05, device=device)
    rings = torch.as_tensor(rng.integers(0, 16, size=n), dtype=torch.int32, device=device)
    pts = rot.quat_rotate(tab_t[ti, 0:4], xs) + tab_t[ti, 4:7]
    return pts, mask, rings, xs, ti, tab_t


def kernel_checks(device):
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib, voxel
    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
    from dmsa_lidar_slam_tpu_torch.ops import nn_bruteforce as nb

    rng = np.random.default_rng(0)
    results, calls = [], []

    def record(name, src, replaces, err, tol, fn, reps, plain_fn, plain_reps, shape, n_bytes, n_ops):
        ok = bool(err <= tol)
        ms = _timed(fn, reps)
        plain_ms = _timed(plain_fn, plain_reps)
        ms_steady = _timed(fn, STEADY_REPS, warmup=STEADY_REPS)
        host_ms = _host_ms(fn, STEADY_REPS)
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        print(f"  {name:23s} {shape:34s} max_abs_err={err:.3e} tol={tol:.3e} "
              f"kernel={ms:.4f} ms steady={ms_steady:.4f} ms host={host_ms:.4f} ms plain={plain_ms:.4f} ms "
              f"bound={bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'FAIL'}", flush=True)
        assert ok, f"{name} at {shape}: error {err} above tolerance {tol}"
        # library_ms: no single PyTorch call computes any of these functions
        # (K4's nearest distance is cdist then amin, two calls; see PERF.md)
        results.append(dict(name=f"{name} {shape}", route="cuda", source=src, replaces=replaces,
                            max_abs_err=float(err), tolerance=float(tol), ms=float(ms), ms_steady=float(ms_steady),
                            host_ms=float(host_ms), plain_ms=float(plain_ms), bound_ms=float(bound_ms),
                            bound_by=bound_by, library_ms=None, bytes=int(n_bytes), operations=int(n_ops)))
        calls.append(fn)

    packs = {}
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(device)
    # K1 at the window (2 x 28,672 over the 502-row dense table) and the
    # 100-keyframe ring (409,600 points over 101 keyframe rows)
    for n, dtab, grid in ((28672, 502, 0.6), (409600, 101, 0.6)):
        pts, mask, rings, xs, ti, tab = _scene_problem(rng, n, dtab, device)
        builds = []
        for factor in (1.0, 2.5):
            # the keys with the grid as a host number and as the optimizer
            # passes it (factor times an f32 scalar on the card); the cells
            # with the latter
            g = factor * torch.tensor(grid, dtype=torch.float32, device=device)
            for gk in (float(g), g):
                key = fr._k1_keys(pts, mask, gk, None, lib, stream)
                want = voxel.combined_key(*voxel.voxel_keys(pts, mask, gk))
                assert torch.equal(key, want), f"K1: keys differ, grid {gk!r}"
            args = (pts, mask, rings, xs, ti, g, 10, tab)
            pk, nv, nr = fr.build_packed(*args)
            again = fr.build_packed(*args)
            assert all(torch.equal(a, b) for a, b in zip((pk, nv, nr), again)), "K1: not repeatable"
            pk_r, nv_r, nr_r = fr.build_packed_ref(*args)
            torch.cuda.synchronize()
            assert int(nv) == int(nv_r) and int(nr) == int(nr_r), (int(nv), int(nv_r), int(nr), int(nr_r))
            exact = torch.equal(pk[12:15], pk_r[12:15]) and torch.equal(pk[0:3], pk_r[0:3])
            assert exact, "K1: xs / w / tidx / run-start rows must match exactly"
            sel = pk_r[6:12].abs().sum(0) > 0
            assert float((pk[15] - pk_r[15]).abs().max()) <= 1e-6, "K1: 1/count rows differ"
            mu_err = float((pk[3:6][:, sel] - pk_r[3:6][:, sel]).abs().max())
            assert mu_err <= 2e-4, f"K1: cell means differ by {mu_err} m"
            # lamw6: f32 moments in another order (about the run's first
            # member vs two-pass), amplified by the eigenvalue floor; relative
            # to the lamw6 scale, as the reference's kernel test
            scale = float(pk_r[6:12][:, sel].abs().max())
            err = float((pk[6:12][:, sel] - pk_r[6:12][:, sel]).abs().max()) / scale
            builds.append((pk, err))
        # bytes: points, mask, rings, local points, int64 table index and the
        # table in; the [16, n] packed rows out.  operations: ~45 per point
        # (transform, moments), ~200 per occupied cell (floored inverse)
        n_raw = int(fr.build_packed_ref(*args)[2])
        record("build_packed", "dmsa_lidar_slam_tpu_torch/csrc/k1_build.cu",
               "dmsa_lidar_slam_tpu/ops/fused_residuals.py:875", max(e for _, e in builds), 2e-2,
               lambda args=args: fr.build_packed(*args), 10, lambda args=args: fr.build_packed_ref(*args), 3,
               f"n={n}", 101 * n + 32 * dtab, 45 * n + 200 * n_raw)
        packs[n] = (torch.cat([b[0] for b in builds], dim=1), tab)

    # K2 at the window (P=30, M=57,344) and the 100-keyframe submap
    # (P=594, M=819,200); K3 at K=15 candidates on both
    for n, p_dim in ((28672, 30), (409600, 594)):
        packed, tab = packs[n]
        m = packed.shape[1]
        dtabs = 0.1 * torch.randn(p_dim, tab.shape[0], 8, device=device,
                                  generator=torch.Generator(device=device).manual_seed(1))
        dtabs[:, -1, :] = 0.0
        max_cells = m // 10 + 2
        h = fr.gn_system(tab, dtabs, packed, max_cells=max_cells)
        assert torch.equal(h, fr.gn_system(tab, dtabs, packed, max_cells=max_cells)), "K2: not repeatable"
        h_r = fr.gn_system_ref(tab, dtabs, packed, include_mean_term=False)
        torch.cuda.synchronize()
        # f32 sums over ~1e4-1e5 cells in another order
        err = float((h - h_r).abs().max()) / float(h_r.abs().max())
        # operations: per member of a valid cell its cotangent (~40) and the
        # 7P-wide row contraction (14 P); per valid cell the rank-1 update
        # of the [P+1, P+1] system (2 (P+1)^2)
        m_valid = int(((packed[6:12].abs().sum(0) > 0) & (packed[12] > 0)).sum())
        n_cells = int((packed[15] > 0).sum())
        record("gn_system", "dmsa_lidar_slam_tpu_torch/csrc/k2_gn.cu",
               "dmsa_lidar_slam_tpu/ops/fused_residuals.py:426", err, 1e-3,
               lambda tab=tab, dtabs=dtabs, packed=packed, mc=max_cells: fr.gn_system(tab, dtabs, packed, max_cells=mc),
               5, lambda tab=tab, dtabs=dtabs, packed=packed: fr.gn_system_ref(tab, dtabs, packed, include_mean_term=False),
               2, f"P={p_dim} M={m}", 32 * tab.shape[0] * (1 + p_dim) + 64 * m + 4 * (p_dim + 1) ** 2,
               m_valid * (40 + 14 * p_dim) + 2 * n_cells * (p_dim + 1) ** 2)

        tabs = []
        for k in range(15):
            tk = tab.clone()
            tk[:-1, 4:7] += 0.002 * k * torch.randn(tab.shape[0] - 1, 3, device=device,
                                                     generator=torch.Generator(device=device).manual_seed(10 + k))
            tabs.append(tk)
        tabs = torch.stack(tabs)
        e = fr.cand_errors(tabs, packed)
        e_r = fr.cand_errors_ref(tabs, packed)
        torch.cuda.synchronize()
        # candidate errors are compared with each other: f32-class sums,
        # relative to each candidate's value
        err = float(((e - e_r).abs() / e_r.abs().clamp(min=1e-30)).max())
        # operations: per candidate, ~50 per member of a valid cell
        # (transform, offset, packed quadratic form, run sums), ~20 per cell
        record("cand_errors", "dmsa_lidar_slam_tpu_torch/csrc/k3_cand.cu",
               "dmsa_lidar_slam_tpu/ops/fused_residuals.py:313", err, 2e-4,
               lambda tabs=tabs, packed=packed: fr.cand_errors(tabs, packed), 10,
               lambda tabs=tabs, packed=packed: fr.cand_errors_ref(tabs, packed), 3,
               f"K=15 Dtab={tab.shape[0]} M={m}", 15 * 32 * tab.shape[0] + 64 * m + 60,
               15 * (50 * m_valid + 20 * n_cells))

    # K4 at the two static-point queries of a bench scan
    for n_ref, n_q in ((20480, 12288), (8192, 20480)):
        ref = torch.as_tensor(30 * rng.uniform(-1, 1, (n_ref, 3)), dtype=torch.float32, device=device)
        q = torch.as_tensor(30 * rng.uniform(-1, 1, (n_q, 3)), dtype=torch.float32, device=device)
        rv = torch.as_tensor(rng.uniform(size=n_ref) > 0.1, device=device)
        qv = torch.as_tensor(rng.uniform(size=n_q) > 0.1, device=device)
        d = nb.min_sq_dist(ref, rv, q, qv)
        d_r = nb.min_sq_dist_ref(ref, rv, q, qv)
        torch.cuda.synchronize()
        fin = torch.isfinite(d_r)
        assert torch.equal(fin, torch.isfinite(d)), "K4: +inf pattern differs"
        # same f32 difference-of-coordinates formula, another rounding order
        err = float(((d - d_r)[fin].abs() / d_r[fin].clamp(min=1.0)).max())
        # operations: 10 per pair (3 differences, 3 products, 2 sums, the
        # validity penalty, the min)
        record("min_sq_dist", "dmsa_lidar_slam_tpu_torch/csrc/k4_nn.cu",
               "dmsa_lidar_slam_tpu/ops/nn_bruteforce.py:86", err, 1e-5,
               lambda a=(ref, rv, q, qv): nb.min_sq_dist(*a), 20,
               lambda a=(ref, rv, q, qv): nb.min_sq_dist_ref(*a), 3,
               f"refs={n_ref} queries={n_q}", 13 * n_ref + 17 * n_q, 10 * n_ref * n_q)

    # K5 at a keyframe cloud: one bench scan downsampled at the 0.4 m grid
    # and cut to the 4,096-point keyframe cap, rho = 2 x grid
    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_sequence
    from dmsa_lidar_slam_tpu_torch.ops import voxel

    grid, n_kf = 0.4, 4096
    scan = torch.as_tensor(bench_sequence(3).scan(20, PTS_PER_SCAN)[0], dtype=torch.float32, device=device)
    prio = torch.randint(-(2**31), 2**31, (scan.shape[0],), dtype=torch.int32, device=device,
                         generator=torch.Generator(device=device).manual_seed(2))
    keep = voxel.random_downsample_mask(scan, torch.ones(scan.shape[0], dtype=torch.bool, device=device), grid, prio)
    idx, kmask = voxel.compact(keep, n_kf)
    kpts = torch.where(kmask[:, None], scan[idx], torch.zeros_like(scan[idx])).contiguous()
    out = nb.radius_neighbor_moments(kpts, kmask, 2.0 * grid)
    out_r = nb.radius_neighbor_moments_ref(kpts, kmask, 2.0 * grid)
    torch.cuda.synchronize()
    cnt, mean, cov = out
    cnt_r, mean_r, cov_r = out_r
    agree = float((cnt == cnt_r).to(torch.float32).mean())
    print(f"  radius_neighbor_moments N={n_kf} valid={int(kmask.sum())} rho={2 * grid} "
          f"count agreement {agree:.6f} (tol: 1.0, the same op-by-op d2), mean count {float(cnt_r.mean()):.2f}",
          flush=True)
    assert agree == 1.0, "K5: neighbour counts differ"
    # f32 sums of the same neighbourhood offsets in another order: means to
    # 1e-5 m (coordinates up to ~14 m), covariances to 1e-5 of their scale
    mean_err = float((mean - mean_r).abs().max())
    cov_scale = float(cov_r.abs().max())
    cov_err = float((cov - cov_r).abs().max())
    assert mean_err <= 1e-5, f"K5: means differ by {mean_err} m"
    # bytes: points and mask in, count, mean and the full 3x3 cov out.
    # operations: 9 per pair of valid points for the distance test, ~20 per
    # neighbour counted (this run's counts) for the ten sums
    nv = int(kmask.sum())
    record("radius_neighbor_moments", "dmsa_lidar_slam_tpu_torch/csrc/k5_moments.cu",
           "dmsa_lidar_slam_tpu/ops/nn_bruteforce.py:216", cov_err, 1e-5 * cov_scale,
           lambda: nb.radius_neighbor_moments(kpts, kmask, 2.0 * grid), 20,
           lambda: nb.radius_neighbor_moments_ref(kpts, kmask, 2.0 * grid), 3,
           f"N={n_kf} rho={2 * grid}", 65 * n_kf, 9 * nv * nv + 20 * int(cnt_r.sum()))
    results[-1].update(count_agreement=agree, mean_max_abs_err=mean_err)
    return results, calls


def pipeline_run(device):
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, bench_config, bench_sequence
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    seq = bench_sequence(3)
    data = []
    t_imu = seq.t_start - 0.2
    for i in range(N_SCANS):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(t_imu, t_end)
        data.append((*seq.scan(i, PTS_PER_SCAN, n_rings=16), ts, acc, gyr))
        t_imu = t_end

    slam = FusedDmsaSlam(bench_config(), flush_every=20, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    walls = []
    for pts, stamps, rings, ts, acc, gyr in data:
        t0 = time.perf_counter()
        slam.process_imu_batch(acc, gyr, ts)
        slam.process_scan(pts, stamps, rings)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(cuda_lib.LAUNCHES)
    st, tr, _ = slam.all_poses()
    ate = ate_rmse(st, tr, seq)
    timed = sum(walls[10:])
    out = dict(
        launches=launches,
        kf_count=slam.kf_count,
        max_submap_span=slam.max_submap_span,
        ate_m=ate,
        wall_ms_per_scan_all=1000.0 * sum(walls) / len(walls),
        wall_ms_per_scan_10_50=1000.0 * timed / (N_SCANS - 10),
        data_s_per_wall_s_10_50=(N_SCANS - 10) * seq.sweep / timed,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print("  pipeline " + json.dumps(out), flush=True)
    events = slam.state.events.cpu().numpy()
    assert all(np.isfinite(events).ravel()), "non-finite event row"
    for k, v in launches.items():
        assert v > 0, f"kernel {k} never launched on the fused path"
    assert slam.kf_count >= 3, slam.kf_count
    assert slam.max_submap_span > 0, slam.max_submap_span
    assert ate <= ATE_GATE_M, f"ATE {ate} above {ATE_GATE_M}"
    return launches


def host_run(device):
    """The host pipeline through the CLI runner's entry point, over a rosbag
    of HOST_SCANS bench scans written into the git-ignored build/."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.io.pcd import load_pcd
    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, bench_config, bench_sequence
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.pipeline import runner
    from tests.torch_bag import bag_overrides, write_sequence_bag

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_host")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        seq = bench_sequence(3)
        bag = os.path.join(out_dir, "bench.bag")
        write_sequence_bag(bag, seq, HOST_SCANS, PTS_PER_SCAN)
        cfg = bench_config()
        over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        over.update(bag_overrides(bag, out_dir))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        slam = runner.run([], overrides=over, pipeline="host", device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)
        poses = np.loadtxt(os.path.join(out_dir, "Poses.txt"), ndmin=2)
        pcd, _ = load_pcd(os.path.join(out_dir, "PointCloud.pcd"))
        ate = ate_rmse(poses[:, 0], poses[:, 1:4], seq)
        out = dict(
            launches=launches,
            kf_count=slam.kf_map.count,
            keyframes_added=slam.kf_map.num_updates,
            poses_written=len(poses),
            map_points_written=len(pcd),
            ate_m=ate,
            wall_ms_per_scan_runner=1000.0 * wall / HOST_SCANS,
            stages_ms=slam.metrics.summary(),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        print("  host pipeline " + json.dumps(out), flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for k in ("min_sq_dist", "radius_neighbor_moments"):
        assert launches[k] > 0, f"kernel {k} never launched on the host path"
    assert slam.kf_map.count >= 3, slam.kf_map.count
    assert len(poses) >= 3 and len(pcd) > 500, (len(poses), len(pcd))
    assert np.all(np.isfinite(poses)), "non-finite pose"
    assert ate <= ATE_GATE_M, f"host pipeline ATE {ate} above {ATE_GATE_M}"
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {cuda_lib.BUILD_SECONDS} s) "
          f"-> {cuda_lib.library_path()}", flush=True)

    print("kernels vs plain versions:", flush=True)
    results, calls = kernel_checks(device)
    print("main path, fused pipeline:", flush=True)
    fused = pipeline_run(device)
    print("main path, host pipeline (CLI runner):", flush=True)
    host = host_run(device)
    print("CUDA kernels per call (torch.profiler):", flush=True)
    for r, fn in zip(results, calls):
        device_ms, kernels = _profile(fn)
        r["device_ms"], r["device_launches"] = device_ms, sum(c for c, _ in kernels.values())
        print(f"  {r['name']:55s} kernels={r['device_launches']} device={device_ms:.4f} ms", flush=True)
    for r in results:
        k = r["name"].split()[0]
        r["launches"] = fused[k] + host[k]
        r["launches_by_path"] = {"fused": fused[k], "host": host[k]}
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
