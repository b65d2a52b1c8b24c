#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Needs a CUDA card, nvcc and this repository's dmsa_lidar_slam_tpu_torch
package beside this script; it exits non-zero otherwise.  Phases, each
printed on its own lines and none of them caught:

  1. the card's name and power limit and its SM clock's maximum
     (nvidia-smi), then the build of the
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
     grid as a host number and as a card scalar, and K1-K5 bit for bit
     against a second call; K1 and K3 once more at the window's real
     masked share (WINDOW_MASKED_SHARE); K1-K3 at the long configuration's
     submap (phase h: n = 196,608 per grid over 49 table rows with the
     split channel, masked at LONG_SUBMAP_MASKED_SHARE; K2 at P = 282, its
     dense-J path; K3 at K = 15); K1 at the submap view a span-4 solve
     sees (48 slots of 4,096 points, 44 keyframes masked: one masked run
     of ~92% of n), in both layouts; K1's 12-row layout (observation
     weights uniform in [0.5, 2] and the split channel of the surfaces'
     normals, at n = 28,672, 5% and WINDOW_MASKED_SHARE masked; its
     launches are cuda_lib.BRANCHES["build_rows12"]); K5 with its radius
     as a host number (the host pipeline's form) and as an f32 card scalar
     (the fused pipeline's), bit for bit the same, and timed both ways;
     K6 (the window's pose tables, port-only) in both modes at the window's
     shape (P = 30, K = 15 candidates, n_dense = 501, IMU residuals)
     against the torch.func path it replaces (its plain version, timed as
     plain_ms), bit for bit against a second call; K7 (the submap's pose
     tables, port-only) the same way at the bench's submap (S = 48,
     P = 282) and the upstream ring (S = 100, P = 594), gravity terms on;
  3. the fused pipeline: FusedDmsaSlam on bench_sequence(3) with
     bench_config(), 50 scans of 20,000 points.  Launch counters are zeroed
     just before and read just after; every kernel must have run,
     kf_count >= 3, max_submap_span > 0 and the trajectory ATE against the
     analytic truth <= 0.03 m.  After scan SAVE_AT the run saves a
     checkpoint (pipeline/checkpoint.py) into build/, outside the timed
     scans;
  (b) a fresh FusedDmsaSlam on the card loads that checkpoint and replays
     scans SAVE_AT-49, counters zeroed just before and read just after:
     the same keyframe count, keyframe positions and orientations within
     FUSED_RESUME_TOL of the uninterrupted run's, ATE <= 0.03 m, K1-K4 launched
     (and K5 where a keyframe was added);
  (d) the fused run's trajectory and the analytic truth as TUM files under
     build/, through `python -m dmsa_lidar_slam_tpu_torch.pipeline.evaluate`
     in a subprocess: its ATE <= 0.03 m, and its RPE;
  4. the host pipeline through the CLI runner's entry point:
     pipeline.runner.run(--pipeline host) over a rosbag written from
     HOST_SCANS (40) scans of bench_sequence(3) at bench_config() width (20,000 points per
     scan).  Counters zeroed just before and read just after: K4 and K5
     must have run, kf_count >= 3, Poses.txt and PointCloud.pcd written, and
     the output trajectory's ATE <= 0.03 m;
  (c) DmsaSlam on the card over HOST_CK_SCANS bench scans, checkpointed at
     HOST_SAVE_AT; a fresh DmsaSlam loads the checkpoint and replays the
     rest, counters zeroed just before and read just after: the same
     keyframes bit for bit (HOST_RESUME_TOL = 0), K4 and K5 launched;
  (e) the two-scan alignment (dmsa/problems.py, the room scene of
     tests/torch_scenes.py) from ~20 cm / ~40 mrad off through the
     optimizer's autodiff path on the card: within 1 cm / 1 mrad of the
     truth; iterations, stop reason and ms;
  (f) the native PointCloud2 decoder (io/native.py) built with g++ from
     the checkout (a failed build fails the phase) on the Ouster message of
     one bench scan: bit for bit the numpy decoder's output;
  (g) the distributed keyframe adjustment (parallel/*) at the shipped
     100-keyframe ring (100 x 4,096 points, P = 594; DIST_SHAPE), a
     synthetic map with gravity and odometry terms and normals, poses
     perturbed, all at the pipelines' keyframe settings (DIST_OPT: the
     shipped 10 iterations): (g1) the single-card tabular optimizer (K1-K3,
     K2's dense-J path), the shipped call and then its iterations one call
     each (the same params bit for bit): the keyframe position error after
     G1_DESCENT_ITERS at most G1_DESCENT_GAIN of the start's, after the
     shipped call at most G1_SHIPPED_GAIN of it; K1-K3 against their plain
     versions at the per-rank shapes of the spatial backend (the rows rank
     0 receives at 2 ranks and at 1), and K7's one iteration from the
     start within DIST_STEP_TOL_M of the same iteration on torch.func's
     tables; (g2) parallel.spatial at world size 1 over NCCL: no overflow,
     K1-K3 and K7 launched, parameters within G2_PARAM_TOL of (g1)'s
     shipped call; (g4) the hash backend at world size 1, its
     parameter error at most HASH_GAIN of the start's; then 2 spawned ranks
     sharing the card over gloo, counters zeroed and read in each rank:
     (g3) parallel.spatial, the shipped call (no overflow, K1-K3 launched
     on each rank, bit-identical parameters; its distance to (g1) printed:
     the rank count reorders the block sums, and late iterations amplify
     that) and one iteration from (g1)'s params after each count of
     DIST_STEP_FROM, keyframe positions within DIST_STEP_TOL_M of (g1)'s
     next; (g4) the hash backend at bench_config's 16-keyframe submap,
     bit-identical, the error falling; (g5) FusedDmsaSlam with
     distributed_keyframe_opt over the first DIST_FUSED_SCANS bench scans
     (cut in depth from 50): the ranks' keyframes bit for bit the same,
     ATE <= 0.03 m, a submap span > 0, no overflow, keyframe positions
     within FUSED_DIST_TOL_M of the one-rank run's checkpoint at that scan,
     and a one-rank run with the submap step off farther than that;
  (i) the optimizer's tabular path with per-point observation weights
     (K1's 12-row layout, then K2 and K3) on the keyframe problem of
     bench_config's 16-keyframe submap (16 x 4,096 points, P = 90), its
     forward returning weights uniform in [0.5, 2], at the pipelines'
     keyframe settings: counters zeroed just before and read just after
     the shipped call, the 12-row branch, K2 and K3 launched, the keyframe
     position error below the start's; K1's 12-row layout on the inputs
     that the optimizer gives it here (65,536 points over 17 table rows,
     both grids), as a phase 2 row (K1's tolerances against its plain
     version, bit for bit call to call); one iteration through the kernels
     within WEIGHTED_ITER_TOL of the same iteration through their plain
     versions on the card, while the weights move that iteration by at
     least WEIGHT_EFFECT_MIN;
  (j) the multi-chip dry run (parallel/dryrun.py, the JAX package's
     __graft_entry__.dryrun_multichip) on MULTICHIP_RANKS spawned ranks
     sharing the card over gloo, on the flagship 32 x 2,048 map: the hash
     and the spatial backend each closer to the truth than the start and
     within 0.02 m of the single-card optimizer, no overflow, the ranks
     bit-identical, K1-K3 launched on every rank; the collectives of one
     iteration of each backend (parallel/mesh.py's counter) printed;
  (h) the long configuration, the JAX package's long bench (bench.py
     run_long): FusedDmsaSlam(long_config()) on long_sequence(3), all
     LONG_SCANS (310) scans of 131,072 raw points over 128 rings, generated
     before the run, with bench.py's stressors (IMU_DROPOUT_SCANS without
     IMU, every 37th scan after scan 20 cut to 25%; a copy of
     bench.py:113-137, apply_long_stressors): a 48-keyframe ring that fills
     and retires, the uncapped submap suffix on 48 slots (P = 282, K2's
     dense-J path).  Counters zeroed just before and read just after:
     K1-K5 launched, K2's dense-J path counted (cuda_lib.BRANCHES) > 0,
     48 keyframes at the end, a retired keyframe in the output ledger,
     max_submap_span >= 17 and ATE <= 0.05 m (bench.py:47-48), a finite
     trajectory of >= 3 poses.  Printed: the scan at which the span first
     reached 17 and the first retirement, the submap solves (all, and
     after the first retirement), wall ms per scan from scan 10 on and on
     keyframe scans, the realtime ratio, peak memory, the ring's masked
     share at the end, the phase's wall; and, from chip_smoke.StepRecorder
     (each step's candidates, overlap counts and min_related, read after
     the scan's timed region), why each keyframe step after the first
     retirement ran no submap solve;
  (k) the host pipeline at the long configuration: DmsaSlam(long_config())
     on the card over the first LONG_HOST_SCANS records of (h)'s data (one
     generation serves both): 131,072 raw points over 128 rings, the
     48-keyframe ring, 4,096-point keyframe clouds, no submap cap, the
     structured optimizer.  Counters zeroed just before and read just
     after: K4 and K5 launched, >= 3 keyframes, at least one submap solve
     (record_submaps), ATE <= 0.05 m over the poses so far, a finite
     trajectory.  Printed: wall ms per scan from scan 10 on and on keyframe
     scans, the launches, peak memory, the solves and the deepest span;
  5. the CUDA kernels one call of each kernel row runs on the card
     (device_launches) and the card's busy time for it (device_ms), from
     torch.profiler over one call after a warm-up, those inside torch ops
     included.  After the pipelines, because CUPTI tracing slows whatever
     runs while it is on;
  (a) pipeline/traceutil.capture around TRACE_SCANS fused window scans
     (the checkpoint loaded, then the next scans through process_scan):
     device_busy_ms per scan and the top 10 of op_totals; the same
     session's events read as _profile reads them: the two busy sums within
     10% of each other, and every csrc kernel that _profile's reading saw,
     and one of each launched wrapper's, with a nonzero time in the trace.
     Last of all: the per-call profiles after a session this large (~10^5
     kernels) came back without their card records.

Depth cut to make room for (h): (a) traces one fused scan (was 3: one
scan holds every check of the phase, and on an H100 (a) takes ~85 s with
one scan against ~3.5 min with three).  (k) is cut in depth to
LONG_HOST_SCANS of the long run's 310 scans (the host pipeline takes
~2.2-3 s per scan there): 7 of the ring's 48 keyframes, spans of 2-4; the
ring's filling and retirement, and the second lap from scan ~100 on, run
in tools/torch_long_host.py, a run of its own; on H100 hosts this script
took 892-940 s with (k) at 60 scans, against its limit of 1,200 s.
No other phase is cut; (i) and (j) take ~1 s and ~35 s on an H100, and
(j)'s map (MULTICHIP_SHAPE) and the host bench phase's HOST_SCANS (at 30
scans it adds 3 keyframes, the least the phase accepts) are the depths to
cut next should the script outgrow its time.

The line before the last is a JSON object with one entry per kernel and
shape (launches: the sum over the fused, fused_resumed, host,
host_resumed, single_card_100kf (g1), distributed ((g2), and (g3) and
(g5) on both ranks), weighted (i), multichip ((j), all ranks), long (h)
and host_long (k) paths, each in launches_by_path; for K1's 12-row rows, the launches of
that layout); the last line is
{"ok": true, "device": {...}}.  Any failed check
raises, so a failing run prints no result.
"""

import contextlib
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
# Share of the window's K1/K3 positions that are masked on the main path:
# 1 - valid / slots over the 880 window-problem K1 calls (n = 28,672) of 50
# fused scans of bench_sequence(3), 0.2998 on an H100 (tools/torch_profile.py
# --pipeline fused --scans 50 --mask-share; PERF.md).  The other kernel rows
# mask 5%.
WINDOW_MASKED_SHARE = 0.3
SAVE_AT = 30  # the fused checkpoint: after scan 30 of N_SCANS (phases a, b)
TRACE_SCANS = 1  # fused window scans under traceutil.capture (phase a; cut from 3 for phase h)
HOST_SAVE_AT, HOST_CK_SCANS = 17, 22  # the host checkpoint run (phase c): a keyframe at ~20
# resumed keyframes against the uninterrupted run's, m and rad.  Both
# pipelines sum in a fixed order on the card (K1-K5; the host pipeline's
# cell sums through ops/voxel.run_sums), and a host checkpoint holds
# the state bit for bit (tests/test_torch_checkpoint_host.py), so the
# host resume must equal the run; the fused one is held to 1e-6, as it
# has been since its checkpoint was ported
FUSED_RESUME_TOL, HOST_RESUME_TOL = 1e-6, 0.0
# phase (g), the distributed keyframe adjustment (parallel/*): the shipped
# 100-keyframe ring at the keyframe cap (409,600 points, P = 594) and
# bench_config's 16-keyframe submap (65,536 points, P = 90), each keyframe
# its own sample of the room scene (tests/torch_dist.keyframe_problem),
# with gravity and odometry terms and normals for the split channel, every
# keyframe pose perturbed by 5 mrad / 2 cm
DIST_SHAPE, DIST_HASH_SHAPE = (100, 4096), (16, 4096)
DIST_SEED, DIST_POSE_NOISE = 21, (0.005, 0.02)
DIST_GRIDS = (0.5, 1.25)  # 2 and 5 x the keyframes' 0.25 m grid
# the pipelines' keyframe settings: Config's num_iter_keyframe_optim,
# min_num_points_gauss_key, alpha_keyframe_optim and epsilon_keyframe_opt,
# and their max_step (checked against Config in dist_phase)
DIST_OPT = dict(num_iter=10, min_points=6, step_length=0.3, max_step=0.01, epsilon=1e-4, use_gravity=True,
                use_odometry=True)
HASH_OPT = dict(num_iter=14, min_points=6, step_length=0.3, max_step=0.1, table_size=65536, use_gravity=True,
                use_odometry=True)
DIST_FUSED_SCANS = SAVE_AT  # (g5): the fused pipeline over 2 ranks to the phase (b) checkpoint
# (g1): the keyframe position RMS error after G1_DESCENT_ITERS iterations at
# most G1_DESCENT_GAIN of the start's, and after the shipped call at most
# G1_SHIPPED_GAIN of it.  On this map the error falls for the first
# iterations and then rises while the valid cells thin out, in the JAX
# package and the port alike (tools/dist_convergence.py --reference;
# PERF.md section 7), so the shipped count is held to what both do
G1_DESCENT_ITERS, G1_DESCENT_GAIN, G1_SHIPPED_GAIN = 6, 0.70, 1.0
G2_PARAM_TOL = 1e-4  # (g2) against (g1): the same K7 tables, exact cells, K2/K3 sums of the same rows
# (g3): one 2-rank iteration from (g1)'s params after each of these counts,
# against (g1)'s next ones: keyframe positions within DIST_STEP_TOL_M, ~3x
# the 0.086 mm the card showed (the rank count changes only the order of the
# K2/K3 block sums; the near-singular chain solve carries that into the step)
DIST_STEP_FROM, DIST_STEP_TOL_M = (0, 9), 3e-4
HASH_GAIN = 0.65  # (g4): parameter error at most this share of the start's, tests/test_keyframe_dist.py:60
# (g5) against the one-rank run, ~3x the 0.18 mm the card showed; the run
# with the submap step off must be farther than this from it (1.24 mm)
FUSED_DIST_TOL_M = 5e-4
DIST_RANK_TIMEOUT_S = 480  # the 2-rank sub-phases (g3)-(g5), start-up included
# phase (h), the JAX package's long bench (bench.py:43-52, 55-67, 113-183):
# FusedDmsaSlam(long_config()) on long_sequence(3), OS-128 raw scans
LONG_SEED, LONG_SCANS, LONG_WARM = 3, 310, 10  # bench.py:52 and run_long's n_warm
LONG_PTS, LONG_RINGS = 131072, 128
LONG_ATE_GATE_M, LONG_MIN_SPAN = 0.05, 17  # bench.py:47-48
# bench.py:113-120's stressors: 2 s without any IMU, and every 37th scan
# after scan 20 cut to 25% of its points
IMU_DROPOUT_SCANS = range(150, 170)
SHORT_SCAN_EVERY, SHORT_SCAN_KEEP = 37, 0.25
# the long configuration's submap problem: 48 keyframe slots x 4,096 points
# (n = 196,608 per grid, Dtab = 49, P = 6 x 47 = 282: K2's dense-J path),
# its K1 input masked at LONG_SUBMAP_MASKED_SHARE: 1 - valid points / slots
# of the full ring at the end of phase (h), 0.2861 on an H100 (PERF.md)
LONG_SUBMAP_SHAPE = (48, 4096)
LONG_SUBMAP_MASKED_SHARE = 0.286
# phase (k): DmsaSlam(long_config()) over the first LONG_HOST_SCANS records
# of phase (h)'s data: 60 took 106-161 s on an H100 (2.2-3.0 s per scan
# from scan 10 on, 5.4-6.1 s on keyframe scans; PERF.md), 40 take about
# two thirds of that
LONG_HOST_SCANS = 40
ROWS12_SEED = 40  # K1's 12-row rows (phase 2)
# K1 at the submap view a solve of span 4 sees (phase 2): the active
# keyframes of LONG_SUBMAP_SHAPE's 48 slots, the others masked
SUBMAP_VIEW_SEED, SUBMAP_VIEW_ACTIVE = 44, 4
K6_SEED = 60  # K6's window (phase 2)
K7_SEED = 70  # K7's submaps (phase 2)
# phase (i): the weights' seed; one iteration through the kernels against
# the same iteration through their plain versions: parameters within
# WEIGHTED_ITER_TOL, a tenth of what the weights themselves move one
# iteration by (1.1e-4 through the plain versions on the CPU) and ~9x the
# gap measured on an H100 (4e-7 to 1.1e-6: K1's f32 moments in another
# order); that effect, measured in the run, must reach WEIGHT_EFFECT_MIN,
# so that the check tells a weighted iteration from an unweighted one
WEIGHTED_SEED, WEIGHTED_ITER_TOL = 41, 1e-5
WEIGHT_EFFECT_MIN = 5 * WEIGHTED_ITER_TOL
# phase (j): the JAX package's dry-run map (__graft_entry__.py:66-96) on
# 4 ranks sharing the card; the depth to cut first if the phase outgrows
# its budget
MULTICHIP_RANKS, MULTICHIP_SHAPE = 4, (32, 2048)
MULTICHIP_TIMEOUT_S = 420  # the 4 ranks, start-up included


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
    warm-up, from torch.profiler (_events_busy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _events_busy(prof.events())


def _events_busy(events):
    """(device ms, kernels {name: (count, device us)}) of a profiler's
    events: device ms is the card's busy time (kernels and copies); copies
    and memsets are not kernels."""
    import torch

    on_card = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != on_card}
    busy_us, kernels = 0.0, {}
    for e in events:
        if e.device_type == on_card and e.name not in host_names:
            busy_us += e.device_time
            if not e.name.startswith(("Memcpy", "Memset")):
                c, us = kernels.get(e.name, (0, 0.0))
                kernels[e.name] = (c + 1, us + e.device_time)
    return busy_us / 1000.0, kernels


def _scene_problem(rng, n, dtab, device, masked=0.05, with_split=False, tidx=None):
    """Points on the synthetic room's surfaces, spread over a pose table:
    world = quat_rotate(q[tidx], xs) + t[tidx] exactly as the kernels read it;
    a share `masked` of them masked.  with_split: also the split channel of
    their surfaces' normals (map.keyframes.normal_split_ids), as a seventh
    value; the draws are the same either way.  tidx: each point's table row
    in place of the drawn ones (the draws unchanged)."""
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.core import rotations as rot
    from dmsa_lidar_slam_tpu_torch.io.synthetic import sample_scene_points
    from dmsa_lidar_slam_tpu_torch.map.keyframes import normal_split_ids

    world, normals = sample_scene_points(rng, n, return_normals=True)
    world = world + 0.01 * rng.standard_normal((n, 3))
    drawn = rng.integers(0, dtab - 1, size=n)
    drawn[:: 9] = dtab - 1  # static points on the identity row
    tidx = drawn if tidx is None else tidx
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
    mask = torch.as_tensor(rng.uniform(size=n) > masked, device=device)
    rings = torch.as_tensor(rng.integers(0, 16, size=n), dtype=torch.int32, device=device)
    pts = rot.quat_rotate(tab_t[ti, 0:4], xs) + tab_t[ti, 4:7]
    if with_split:
        return pts, mask, rings, xs, ti, tab_t, normal_split_ids(torch.as_tensor(normals, device=device))
    return pts, mask, rings, xs, ti, tab_t


def _cand_tables(tab, device):
    """K3's 15 candidate tables: `tab` with its translations moved by 0.002
    k m of noise for candidate k (the first unmoved)."""
    import torch

    tabs = []
    for k in range(15):
        tk = tab.clone()
        tk[:-1, 4:7] += 0.002 * k * torch.randn(tab.shape[0] - 1, 3, device=device,
                                                 generator=torch.Generator(device=device).manual_seed(10 + k))
        tabs.append(tk)
    return torch.stack(tabs)


def _clouds(rng, n_ref, n_q, device):
    """K4's inputs: (ref, ref_valid, queries, query_valid), uniform in a 60 m
    cube, 10% of each masked."""
    import torch

    ref = torch.as_tensor(30 * rng.uniform(-1, 1, (n_ref, 3)), dtype=torch.float32, device=device)
    q = torch.as_tensor(30 * rng.uniform(-1, 1, (n_q, 3)), dtype=torch.float32, device=device)
    rv = torch.as_tensor(rng.uniform(size=n_ref) > 0.1, device=device)
    qv = torch.as_tensor(rng.uniform(size=n_q) > 0.1, device=device)
    return ref, rv, q, qv


def _keyframe_cloud(device):
    """K5's input: one bench scan downsampled at the 0.4 m grid and cut to
    the 4,096-point keyframe cap.  Returns (points [4096, 3], mask, grid);
    the main path's radius is 2 x grid."""
    import torch

    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_sequence
    from dmsa_lidar_slam_tpu_torch.ops import voxel

    grid, n_kf = 0.4, 4096
    scan = torch.as_tensor(bench_sequence(3).scan(20, PTS_PER_SCAN)[0], dtype=torch.float32, device=device)
    prio = torch.randint(-(2**31), 2**31, (scan.shape[0],), dtype=torch.int32, device=device,
                         generator=torch.Generator(device=device).manual_seed(2))
    keep = voxel.random_downsample_mask(scan, torch.ones(scan.shape[0], dtype=torch.bool, device=device), grid, prio)
    idx, kmask = voxel.compact(keep, n_kf)
    kpts = torch.where(kmask[:, None], scan[idx], torch.zeros_like(scan[idx])).contiguous()
    return kpts, kmask, grid


def _record(results, calls, name, src, replaces, err, tol, fn, reps, plain_fn, plain_reps, shape, n_bytes, n_ops):
    """Time one kernel row (ms, plain_ms, ms_steady, host_ms, bound_ms),
    print it, check its error against the tolerance and append it to
    `results` (and its call to `calls`, for the per-call profiles)."""
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


def _k1_build(args):
    """K1 on `args` (build_packed's) against its plain version: the packed
    rows and lamw6's error relative to its scale, after the structural
    checks (counts, xs / w / tidx / run-start rows exact, 1/count rows,
    cell means)."""
    import torch

    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr

    pk, nv, nr = fr.build_packed(*args)
    again = fr.build_packed(*args)
    assert all(torch.equal(a, b) for a, b in zip((pk, nv, nr), again)), "K1: not repeatable"
    pk_r, nv_r, nr_r = fr.build_packed_ref(*args)
    torch.cuda.synchronize()
    assert int(nv) == int(nv_r) and int(nr) == int(nr_r), (int(nv), int(nv_r), int(nr), int(nr_r))
    exact = torch.equal(pk[12:15], pk_r[12:15]) and torch.equal(pk[0:3], pk_r[0:3])
    assert exact, "K1: xs / w / tidx / run-start rows must match exactly"
    sel = pk_r[6:12].abs().sum(0) > 0
    assert bool(sel.any()), "K1: no valid cell to compare"
    assert float((pk[15] - pk_r[15]).abs().max()) <= 1e-6, "K1: 1/count rows differ"
    mu_err = float((pk[3:6][:, sel] - pk_r[3:6][:, sel]).abs().max())
    assert mu_err <= 2e-4, f"K1: cell means differ by {mu_err} m"
    # lamw6: f32 moments in another order (about the run's first member vs
    # two-pass), amplified by the eigenvalue floor; relative to the lamw6
    # scale, as the reference's kernel test
    scale = float(pk_r[6:12][:, sel].abs().max())
    return pk, float((pk[6:12][:, sel] - pk_r[6:12][:, sel]).abs().max()) / scale, int(nr_r)


def _k1_row(results, calls, args_by_grid, label):
    """K1 at each grid of `args_by_grid`, one row timed at the last; returns
    the packed rows of both grids, concatenated as the optimizer does."""
    import torch

    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr

    builds = [_k1_build(args) for args in args_by_grid]
    args = args_by_grid[-1]
    n = args[0].shape[0]
    split, obs = (tuple(args) + (None, None))[8:10]
    rows12 = args[7] is None or obs is not None
    # bytes: points, mask, rings, local points, int64 table index, the
    # split ids and the observation weights where given, and the table in
    # the compact layout (the 12-row one reads no table); the [16, n]
    # packed rows out.  operations: ~45 per point (transform or load,
    # moments), ~200 per occupied cell (floored inverse)
    n_bytes = (101 + 4 * (split is not None) + 4 * (obs is not None)) * n + (0 if rows12 else 32 * args[7].shape[0])
    _record(results, calls, "build_packed", "dmsa_lidar_slam_tpu_torch/csrc/k1_build.cu",
            "dmsa_lidar_slam_tpu/ops/fused_residuals.py:875", max(e for _, e, _ in builds), 2e-2,
            lambda args=args: fr.build_packed(*args), 10, lambda args=args: fr.build_packed_ref(*args), 3,
            label, n_bytes, 45 * n + 200 * builds[-1][2])
    if rows12:  # its launches: the 12-row branch's count (cuda_lib.BRANCHES)
        results[-1].update(layout="12-row", counter="build_rows12",
                           replaces="dmsa_lidar_slam_tpu/ops/fused_residuals.py:875 (dpad = 0, :860-871)")
    return torch.cat([b[0] for b in builds], dim=1)


def _k2_row(results, calls, tab, dtabs, packed, max_cells, label):
    """K2 against its plain version, twice for the bits, and timed."""
    import torch

    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr

    p_dim, m = dtabs.shape[0], packed.shape[1]
    h = fr.gn_system(tab, dtabs, packed, max_cells=max_cells)
    assert torch.equal(h, fr.gn_system(tab, dtabs, packed, max_cells=max_cells)), "K2: not repeatable"
    h_r = fr.gn_system_ref(tab, dtabs, packed, include_mean_term=False)
    torch.cuda.synchronize()
    # f32 sums over ~1e4-1e5 cells in another order
    err = float((h - h_r).abs().max()) / float(h_r.abs().max())
    # operations: per member of a valid cell its cotangent (~40) and the
    # 7P-wide row contraction (14 P); per valid cell the rank-1 update of
    # the [P+1, P+1] system (2 (P+1)^2)
    m_valid = int(((packed[6:12].abs().sum(0) > 0) & (packed[12] > 0)).sum())
    n_cells = int((packed[15] > 0).sum())
    _record(results, calls, "gn_system", "dmsa_lidar_slam_tpu_torch/csrc/k2_gn.cu",
            "dmsa_lidar_slam_tpu/ops/fused_residuals.py:426", err, 1e-3,
            lambda: fr.gn_system(tab, dtabs, packed, max_cells=max_cells), 5,
            lambda: fr.gn_system_ref(tab, dtabs, packed, include_mean_term=False), 2,
            label, 32 * tab.shape[0] * (1 + p_dim) + 64 * m + 4 * (p_dim + 1) ** 2,
            m_valid * (40 + 14 * p_dim) + 2 * n_cells * (p_dim + 1) ** 2)


def _k3_row(results, calls, device, packed, tab, label):
    """K3 at K = 15 candidates against its plain version, twice for the
    bits, and timed."""
    import torch

    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr

    m = packed.shape[1]
    tabs = _cand_tables(tab, device)
    e = fr.cand_errors(tabs, packed)
    assert torch.equal(e, fr.cand_errors(tabs, packed)), "K3: not repeatable"
    e_r = fr.cand_errors_ref(tabs, packed)
    torch.cuda.synchronize()
    # candidate errors are compared with each other: f32-class sums,
    # relative to each candidate's value
    err = float(((e - e_r).abs() / e_r.abs().clamp(min=1e-30)).max())
    # operations: per candidate, ~50 per member of a valid cell (transform,
    # offset, packed quadratic form, run sums), ~20 per cell
    m_valid = int(((packed[6:12].abs().sum(0) > 0) & (packed[12] > 0)).sum())
    n_cells = int((packed[15] > 0).sum())
    _record(results, calls, "cand_errors", "dmsa_lidar_slam_tpu_torch/csrc/k3_cand.cu",
            "dmsa_lidar_slam_tpu/ops/fused_residuals.py:313", err, 2e-4,
            lambda: fr.cand_errors(tabs, packed), 10, lambda: fr.cand_errors_ref(tabs, packed), 3,
            label, 15 * 32 * tab.shape[0] + 64 * m + 60, 15 * (50 * m_valid + 20 * n_cells))


def long_rows(results, calls, device):
    """K1 at the long configuration's submap shape and masked share (both
    grids, split ids as the submap's six normal classes), K2 at P = 282 on
    its packed rows (the dense-J path), K3 at K = 15 on them."""
    import numpy as np
    import torch

    s, ppk = LONG_SUBMAP_SHAPE
    n, dtab, p_dim = s * ppk, s + 1, 6 * (s - 1)
    rng = np.random.default_rng(LONG_SEED)
    pts, mask, rings, xs, ti, tab = _scene_problem(rng, n, dtab, device, LONG_SUBMAP_MASKED_SHARE)
    split = torch.as_tensor(rng.integers(0, 6, size=n), dtype=torch.int32, device=device)
    g = torch.tensor(0.4, dtype=torch.float32, device=device)
    arg_sets = [(pts, mask, rings, xs, ti, f * g, 10, tab, split) for f in (1.0, 2.5)]
    label = f"n={n} long submap, masked={LONG_SUBMAP_MASKED_SHARE}"
    packed = _k1_row(results, calls, arg_sets, label)
    dtabs = 0.1 * torch.randn(p_dim, dtab, 8, device=device, generator=torch.Generator(device=device).manual_seed(3))
    dtabs[:, -1, :] = 0.0
    m = packed.shape[1]
    _k2_row(results, calls, tab, dtabs, packed, m // 10 + 2, f"P={p_dim} M={m} long submap")
    _k3_row(results, calls, device, packed, tab, f"K=15 Dtab={dtab} M={m} long submap")


def submap_view_rows(results, calls, device):
    """K1 at the submap view's shape and masked share, in both layouts:
    48 keyframe slots of 4,096 points (one table row each), the last
    SUBMAP_VIEW_ACTIVE of them active (5% of their points masked) and the
    others masked, as a solve of span 4 sees them (`handheld`), so that the
    masked points form one run of ~92% of n; split ids as the submap's;
    the 12-row layout also with observation weights."""
    import numpy as np
    import torch

    s, ppk = LONG_SUBMAP_SHAPE
    n = s * ppk
    rng = np.random.default_rng(SUBMAP_VIEW_SEED)
    tidx = np.repeat(np.arange(s), ppk)
    pts, mask, rings, xs, ti, tab, split = _scene_problem(rng, n, s + 1, device, 0.05, with_split=True, tidx=tidx)
    mask &= ti >= s - SUBMAP_VIEW_ACTIVE
    obs = torch.as_tensor(rng.uniform(0.5, 2.0, size=n), dtype=torch.float32, device=device)
    g = torch.tensor(0.4, dtype=torch.float32, device=device)
    label = f"n={n} submap view, {s - SUBMAP_VIEW_ACTIVE} of {s} keyframes masked"
    _k1_row(results, calls, [(pts, mask, rings, xs, ti, f * g, 10, tab, split) for f in (1.0, 2.5)], label)
    _k1_row(results, calls, [(pts, mask, rings, xs, ti, f * g, 10, tab, split, obs) for f in (1.0, 2.5)],
            label + ", 12-row, weights")


def rows12_rows(results, calls, device):
    """K1's 12-row layout at n = 28,672 over the 502-row table: observation
    weights uniform in [0.5, 2] and the split channel of the surfaces'
    normals, the world points given with the table (the weights select the
    12-row layout), 5% masked and WINDOW_MASKED_SHARE masked, both grids;
    the same checks and tolerances as the compact rows."""
    import numpy as np
    import torch

    for masked, seed in ((0.05, ROWS12_SEED), (WINDOW_MASKED_SHARE, ROWS12_SEED + 1)):
        rng = np.random.default_rng(seed)
        n = 28672
        pts, mask, rings, xs, ti, tab, split = _scene_problem(rng, n, 502, device, masked, with_split=True)
        obs = torch.as_tensor(rng.uniform(0.5, 2.0, size=n), dtype=torch.float32, device=device)
        g = torch.tensor(0.6, dtype=torch.float32, device=device)
        arg_sets = [(pts, mask, rings, xs, ti, f * g, 10, tab, split, obs) for f in (1.0, 2.5)]
        _k1_row(results, calls, arg_sets, f"n={n} 12-row, weights, split" + (
            "" if masked == 0.05 else f", masked={masked}"))


def _tables_error(got, want, tab_scale=1.0):
    """A pose-table kernel (K6, K7) against its plain version: the largest
    of the tables' absolute error over tab_scale, the f64 residuals' error
    relative to their scale and, in the jacobian mode, each parameter's
    table column relative to its largest entry and the residuals' tangents
    relative to their scale."""
    def rel(g, w):
        return float((g - w).abs().max() / w.abs().max().clamp(min=1e-300)) if w.numel() else 0.0

    errs = [float((got[0] - want[0]).abs().max()) / tab_scale, rel(got[1], want[1])]
    if len(got) == 4:
        dtab, r_dtab = got[2].flatten(1), want[2].flatten(1)
        errs.append(float(((dtab - r_dtab).abs().amax(1) / r_dtab.abs().amax(1).clamp(min=1e-30)).max()))
        errs.append(rel(got[3], want[3]))
    return max(errs)


def k6_rows(results, calls, device):
    """K6 at the window's shape in both modes (the tables and their
    Jacobian at P = 30; the tables at the line search's K = 15 candidates)
    against the torch.func path it replaces, twice for the bits, and
    timed."""
    import torch

    from dmsa_lidar_slam_tpu_torch.trajectory import continuous as ct
    from tests.torch_window import candidates, window_problem

    shapes, data, params = window_problem(K6_SEED, device=device)
    cands = candidates(params, K6_SEED)
    d, c, k, p_dim = shapes.n_dense, shapes.n_ctrl, cands.shape[0], params.shape[0]
    e = c - 1
    # bytes: the constant operators (A, left, right, u) and the IMU
    # factors in, the tables (and the Jacobian) out, each once
    consts = 8 * d * c + 24 * d + 8 * (2 * 3 + 1 + c + 3 + 9 * e + 6 * e + 81 * e + 1)
    for mode, fn, plain, n_bytes, label in (
        ("jacobian", lambda: ct.window_tables(params, data, shapes, True),
         lambda: ct.window_tables_ref(params, data, shapes, True),
         8 * p_dim + consts + 32 * (d + 1) * (1 + p_dim) + 8 * e * (1 + p_dim), f"jacobian P={p_dim} D={d + 1}"),
        ("batch", lambda: ct.window_tables_batch(cands, data, shapes, True),
         lambda: ct.window_tables_batch_ref(cands, data, shapes, True),
         8 * k * p_dim + consts + 32 * (d + 1) * k + 8 * e * k, f"batch K={k} D={d + 1}"),
    ):
        got = fn()
        assert all(torch.equal(a, b) for a, b in zip(got, fn())), f"K6 {mode}: not repeatable"
        want = plain()
        torch.cuda.synchronize()
        _record(results, calls, "window_tables", "dmsa_lidar_slam_tpu_torch/csrc/k6_window_tables.cu",
                "none (port-only): torch.func jacfwd / vmap over trajectory/continuous.py _window_tables",
                _tables_error(got, want), 1e-6, fn, 20, plain, 3, label, n_bytes, 0)


def k7_rows(results, calls, device):
    """K7 at the bench's submap (S = 48, P = 282) and the upstream ring
    (S = 100, P = 594), gravity terms on and odometry off as every bench
    configuration runs it, in both modes (the tables and their Jacobian;
    the tables at the line search's K = 15 candidates) against the
    torch.func path it replaces, twice for the bits, and timed."""
    import torch

    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
    from tests.torch_keyframes import keyframe_problem
    from tests.torch_window import candidates

    for s in (48, 100):
        shapes, data, params = keyframe_problem(K7_SEED, s=s, device=device)
        cands = candidates(params, K7_SEED)
        k, p_dim, e = cands.shape[0], params.shape[0], s
        # bytes: the anchor, the gravity terms' operands in, the tables (and
        # the Jacobian) out, each once
        consts = 8 * (3 + 3 + 3 * s + 3 + 9 + 1) + 2 * s
        # the calls keep this submap's operands (`calls` profiles them later)
        args = (params, data, shapes, True, False)
        cargs = (cands, *args[1:])
        for mode, fn, plain, n_bytes, label in (
            ("jacobian", lambda a=args: kfm.keyframe_tables(*a), lambda a=args: kfm.keyframe_tables_ref(*a),
             8 * p_dim + consts + 32 * (s + 1) * (1 + p_dim) + 8 * e * (1 + p_dim), f"jacobian P={p_dim} S={s}"),
            ("batch", lambda a=cargs: kfm.keyframe_tables_batch(*a), lambda a=cargs: kfm.keyframe_tables_batch_ref(*a),
             8 * k * p_dim + consts + 32 * (s + 1) * k + 8 * e * k, f"batch K={k} S={s}"),
        ):
            got = fn()
            assert all(torch.equal(a, b) for a, b in zip(got, fn())), f"K7 {mode}: not repeatable"
            want = plain()
            torch.cuda.synchronize()
            # the tables' error over their largest entry (translations of
            # tens of metres: an f32 step there is several 1e-6)
            err = _tables_error(got, want, max(1.0, float(want[0].abs().max())))
            _record(results, calls, "keyframe_tables", "dmsa_lidar_slam_tpu_torch/csrc/k7_keyframe_tables.cu",
                    "none (port-only): torch.func jacfwd / vmap over map/keyframes.py _kf_tables",
                    err, 1e-6, fn, 20, plain, 3, label, n_bytes, 0)


def kernel_checks(device):
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib, voxel
    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
    from dmsa_lidar_slam_tpu_torch.ops import nn_bruteforce as nb

    rng = np.random.default_rng(0)
    results, calls = [], []

    def record(*args):
        _record(results, calls, *args)

    packs = {}
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(device)
    assert lib.dmsa_chunk_positions() == fr.CHUNK, "K2/K3: the plain statements' chunk is not the library's"
    # K1 at the window (2 x 28,672 over the 502-row dense table) and the
    # 100-keyframe ring (409,600 points over 101 keyframe rows), then, for
    # the record, at the window's real masked share (its own seed, so that
    # the other rows' inputs stay as they were)
    grid = 0.6
    for n, dtab, masked, prng in ((28672, 502, 0.05, rng), (409600, 101, 0.05, rng),
                                  (28672, 502, WINDOW_MASKED_SHARE, np.random.default_rng(1))):
        pts, mask, rings, xs, ti, tab = _scene_problem(prng, n, dtab, device, masked)
        arg_sets = []
        for factor in (1.0, 2.5):
            # the keys with the grid as a host number and as the optimizer
            # passes it (factor times an f32 scalar on the card); the cells
            # with the latter
            g = factor * torch.tensor(grid, dtype=torch.float32, device=device)
            for gk in (float(g), g):
                key = fr._k1_keys(pts, mask, gk, None, lib, stream)
                want = voxel.combined_key(*voxel.voxel_keys(pts, mask, gk))
                assert torch.equal(key, want), f"K1: keys differ, grid {gk!r}"
            arg_sets.append((pts, mask, rings, xs, ti, g, 10, tab))
        packed = _k1_row(results, calls, arg_sets, f"n={n}" + ("" if masked == 0.05 else f" masked={masked}"))
        packs[n, masked] = (packed, tab)

    # K2 at the window (P=30, M=57,344) and the 100-keyframe submap
    # (P=594, M=819,200); K3 at K=15 candidates on both
    for n, p_dim in ((28672, 30), (409600, 594)):
        packed, tab = packs[n, 0.05]
        dtabs = 0.1 * torch.randn(p_dim, tab.shape[0], 8, device=device,
                                  generator=torch.Generator(device=device).manual_seed(1))
        dtabs[:, -1, :] = 0.0
        m = packed.shape[1]
        _k2_row(results, calls, tab, dtabs, packed, m // 10 + 2, f"P={p_dim} M={m}")
        _k3_row(results, calls, device, packed, tab, f"K=15 Dtab={tab.shape[0]} M={m}")
    packed, tab = packs[28672, WINDOW_MASKED_SHARE]
    _k3_row(results, calls, device, packed, tab,
            f"K=15 Dtab={tab.shape[0]} M={packed.shape[1]} masked={WINDOW_MASKED_SHARE}")

    # K1-K3 at the long configuration's submap (phase h): 2 x 196,608
    # rows over 49 table rows with the split channel, P = 282
    long_rows(results, calls, device)
    submap_view_rows(results, calls, device)

    # K1's 12-row layout (phase i's): the window's shape with observation
    # weights and the split channel, at 5% and at the window's real masked
    # share, each from its own seed (the rows above keep their inputs)
    rows12_rows(results, calls, device)

    # K6 at the window's shape, both modes
    k6_rows(results, calls, device)

    # K7 at the bench's submap and the upstream ring, both modes
    k7_rows(results, calls, device)

    # K4 at the two static-point queries of a bench scan
    for n_ref, n_q in ((20480, 12288), (8192, 20480)):
        ref, rv, q, qv = _clouds(rng, n_ref, n_q, device)
        d = nb.min_sq_dist(ref, rv, q, qv)
        assert torch.equal(d, nb.min_sq_dist(ref, rv, q, qv)), "K4: not repeatable"
        d_r = nb.min_sq_dist_ref(ref, rv, q, qv)
        torch.cuda.synchronize()
        fin = torch.isfinite(d_r)
        assert torch.equal(fin, torch.isfinite(d)), "K4: +inf pattern differs"
        # same f32 difference-of-coordinates formula, another rounding order
        err = float(((d - d_r)[fin].abs() / d_r[fin].clamp(min=1.0)).max())
        # operations: 9 per pair (3 differences, 3 products, 2 sums, the
        # min)
        record("min_sq_dist", "dmsa_lidar_slam_tpu_torch/csrc/k4_nn.cu",
               "dmsa_lidar_slam_tpu/ops/nn_bruteforce.py:86", err, 1e-5,
               lambda a=(ref, rv, q, qv): nb.min_sq_dist(*a), 20,
               lambda a=(ref, rv, q, qv): nb.min_sq_dist_ref(*a), 3,
               f"refs={n_ref} queries={n_q}", 13 * n_ref + 17 * n_q, 9 * n_ref * n_q)

    # K5 at a keyframe cloud, rho = 2 x grid, with the radius as a host
    # number (the host pipeline's form) and as an f32 card scalar (the fused
    # pipeline's); 2 x f32(0.4) is f32(0.8), so both give the same bits
    kpts, kmask, grid = _keyframe_cloud(device)
    n_kf, rho = kpts.shape[0], 2.0 * grid
    rho_card = 2.0 * torch.tensor(grid, dtype=torch.float32, device=device)
    out = nb.radius_neighbor_moments(kpts, kmask, rho)
    again = nb.radius_neighbor_moments(kpts, kmask, rho)
    assert all(torch.equal(a, b) for a, b in zip(out, again)), "K5: not repeatable"
    on_card = nb.radius_neighbor_moments(kpts, kmask, rho_card)
    assert all(torch.equal(a, b) for a, b in zip(out, on_card)), "K5: the card-scalar radius gives other bits"
    out_r = nb.radius_neighbor_moments_ref(kpts, kmask, rho)
    torch.cuda.synchronize()
    cnt, mean, cov = out
    cnt_r, mean_r, cov_r = out_r
    agree = float((cnt == cnt_r).to(torch.float32).mean())
    print(f"  radius_neighbor_moments N={n_kf} valid={int(kmask.sum())} rho={rho} "
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
    for r, label in ((rho, ""), (rho_card, " card-scalar radius")):
        record("radius_neighbor_moments", "dmsa_lidar_slam_tpu_torch/csrc/k5_moments.cu",
               "dmsa_lidar_slam_tpu/ops/nn_bruteforce.py:216", cov_err, 1e-5 * cov_scale,
               lambda r=r: nb.radius_neighbor_moments(kpts, kmask, r), 20,
               lambda r=r: nb.radius_neighbor_moments_ref(kpts, kmask, r), 3,
               f"N={n_kf} rho={rho}{label}", 65 * n_kf, 9 * nv * nv + 20 * int(cnt_r.sum()))
        results[-1].update(count_agreement=agree, mean_max_abs_err=mean_err)
    return results, calls


def sequence_data(seq, n_scans, pts, n_rings=16):
    """The first n_scans scans of `seq`, `pts` points over `n_rings` rings
    each, with their IMU, generated as bench.py:55-67 does:
    [(points, stamps, rings, imu stamps, acc, gyr)]."""
    data = []
    t_imu = seq.t_start - 0.2
    for i in range(n_scans):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(t_imu, t_end)
        data.append((*seq.scan(i, pts, n_rings=n_rings), ts, acc, gyr))
        t_imu = t_end
    return data


def bench_data(n_scans, pts=PTS_PER_SCAN):
    """bench_sequence(3) and its first n_scans scans of `pts` points with
    their IMU: (seq, [(points, stamps, rings, imu stamps, acc, gyr)])."""
    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_sequence

    seq = bench_sequence(3)
    return seq, sequence_data(seq, n_scans, pts)


def apply_long_stressors(data, dropout=IMU_DROPOUT_SCANS, every=SHORT_SCAN_EVERY, after=20, keep=SHORT_SCAN_KEEP):
    """bench.py:123-137: the IMU of the `dropout` scans dropped, and every
    `every`-th scan after scan `after` cut to `keep` of its points.  The
    truth is unchanged: only the sensor stream degrades."""
    out = []
    for i, (pts, stamps, rings, ts, acc, gyr) in enumerate(data):
        if i in dropout:
            ts, acc, gyr = ts[:0], acc[:0], gyr[:0]
        if i > after and i % every == 0:
            n = max(1, int(len(pts) * keep))
            pts, stamps, rings = pts[:n], stamps[:n], rings[:n]
        out.append((pts, stamps, rings, ts, acc, gyr))
    return out


def long_data(n_scans=None, pts=None):
    """long_sequence(LONG_SEED) and its first n_scans (LONG_SCANS) scans of
    `pts` (LONG_PTS) points over LONG_RINGS rings with their IMU, the
    stressors applied (bench.py run_long): (seq, data)."""
    from dmsa_lidar_slam_tpu_torch.io.synthetic import long_sequence

    seq = long_sequence(LONG_SEED)
    return seq, apply_long_stressors(sequence_data(seq, n_scans or LONG_SCANS, pts or LONG_PTS, LONG_RINGS))


def write_truth(seq, est_path, out_path):
    """The analytic truth of `seq` at the stamps of a TUM file, as a TUM
    file."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    rows = []
    for stamp in np.loadtxt(est_path, ndmin=2)[:, 0]:
        p = seq.pose(float(stamp))
        rows.append([stamp, *p.position, *Rotation.from_rotvec(p.rotvec).as_quat()])
    np.savetxt(out_path, np.asarray(rows), fmt="%.9f")
    return len(rows)


def feed(slam, scans):
    """Each scan's IMU, then the scan."""
    for pts, stamps, rings, ts, acc, gyr in scans:
        slam.process_imu_batch(acc, gyr, ts)
        slam.process_scan(pts, stamps, rings)


def pipeline_run(device, seq, data, ckpt_path):
    """The fused pipeline over `data`; saves the phase (b) checkpoint at scan
    SAVE_AT.  Returns (slam, launches)."""
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, bench_config
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import save_fused_checkpoint
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    slam = FusedDmsaSlam(bench_config(), flush_every=20, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    walls = []
    for i, (pts, stamps, rings, ts, acc, gyr) in enumerate(data):
        if i == SAVE_AT:  # phase (b)'s checkpoint, outside the timed scans
            save_fused_checkpoint(slam, ckpt_path)
            assert slam.kf_count >= 1, "no keyframe before the checkpoint"
        t0 = time.perf_counter()
        slam.process_imu_batch(acc, gyr, ts)
        slam.process_scan(pts, stamps, rings)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = cuda_lib.launch_counts()
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
    for k in cuda_lib.LAUNCHES:
        assert launches[k] > 0, f"kernel {k} never launched on the fused path"
    assert slam.kf_count >= 3, slam.kf_count
    assert slam.max_submap_span > 0, slam.max_submap_span
    assert ate <= ATE_GATE_M, f"ATE {ate} above {ATE_GATE_M}"
    return slam, launches


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
        launches = cuda_lib.launch_counts()
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
    for k in ("min_sq_dist", "radius_neighbor_moments", "window_tables", "keyframe_tables"):
        assert launches[k] > 0, f"kernel {k} never launched on the host path"
    assert slam.kf_map.count >= 3, slam.kf_map.count
    assert len(poses) >= 3 and len(pcd) > 500, (len(poses), len(pcd))
    assert np.all(np.isfinite(poses)), "non-finite pose"
    assert ate <= ATE_GATE_M, f"host pipeline ATE {ate} above {ATE_GATE_M}"
    return launches


def _build_dir(name):
    """A fresh directory under the checkout's git-ignored build/."""
    import shutil

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def _kf_positions_diff(a, b):
    """Largest |difference| of two runs' keyframe positions (m) and
    orientations (rad); equal counts required."""
    import numpy as np

    assert a.kf_count == b.kf_count, (a.kf_count, b.kf_count)
    _, ta, oa = a.keyframe_poses()
    _, tb, ob = b.keyframe_poses()
    return float(np.abs(ta - tb).max()), float(np.abs(oa - ob).max())


def fused_resume(device, seq, data, full, ckpt_path):
    """Phase (b): a fresh FusedDmsaSlam on the card loads the checkpoint of
    scan SAVE_AT and replays the rest; its keyframes against the
    uninterrupted run's.  Counters zeroed just before, read just after."""
    import torch

    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, bench_config
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import load_fused_checkpoint
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    slam = load_fused_checkpoint(FusedDmsaSlam(bench_config(), flush_every=20, device=device), ckpt_path)
    kf_updates0 = int(slam.state.kf.num_updates)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    feed(slam, data[SAVE_AT:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    st, tr, _ = slam.all_poses()
    ate = ate_rmse(st, tr, seq)
    dpos, dori = _kf_positions_diff(slam, full)
    new_kf = int(slam.state.kf.num_updates) - kf_updates0
    out = dict(launches=launches, kf_count=slam.kf_count, keyframes_added=new_kf, kf_pos_max_diff_m=dpos,
               kf_orient_max_diff_rad=dori, tolerance=FUSED_RESUME_TOL, ate_m=ate,
               wall_ms_per_scan=1000.0 * wall / (N_SCANS - SAVE_AT))
    print("  fused resumed at scan %d %s" % (SAVE_AT, json.dumps(out)), flush=True)
    assert dpos <= FUSED_RESUME_TOL and dori <= FUSED_RESUME_TOL, (dpos, dori)
    assert ate <= ATE_GATE_M, f"resumed ATE {ate} above {ATE_GATE_M}"
    for k in cuda_lib.LAUNCHES:
        assert launches[k] > 0 or (k in ("radius_neighbor_moments", "keyframe_tables") and new_kf == 0), \
            f"kernel {k} never launched on resume"
    return launches


def _csrc_sources():
    """{kernel function name: source file} of every __global__ in csrc/."""
    import re

    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

    out = {}
    for f in sorted(cuda_lib.SRC_DIR.glob("*.cu")):
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", f.read_text()):
            out[name] = f.name
    return out


def trace_phase(device, data, ckpt_path):
    """Phase (a): traceutil.capture around TRACE_SCANS fused window scans
    (a FusedDmsaSlam loads the scan-SAVE_AT checkpoint, then takes the next
    scans through process_scan, after one warm-up replay).  The session is
    read twice: traceutil from the Chrome trace, _profile's _events_busy
    from the profiler's events.  The two busy sums must agree, and every
    csrc kernel must show."""
    import torch

    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_config
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.pipeline import traceutil
    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import load_fused_checkpoint
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    slam = FusedDmsaSlam(bench_config(), flush_every=20, device=device)
    scans = data[SAVE_AT : SAVE_AT + TRACE_SCANS]

    def replay():
        load_fused_checkpoint(slam, ckpt_path)
        feed(slam, scans)

    replay()
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    trace_dir = _build_dir("chip_smoke_trace")
    t0 = time.perf_counter()
    cap = traceutil.capture(trace_dir)
    with cap:
        replay()
    wall = time.perf_counter() - t0
    launched = {k for k, v in cuda_lib.LAUNCHES.items() if v}
    busy, ops, opn = traceutil.op_totals(trace_dir)
    assert abs(busy - traceutil.device_busy_ms(trace_dir)) <= 1e-9 * max(busy, 1.0)
    profile_busy, profile_kernels = _events_busy(cap.profile.events())
    sources = _csrc_sources()
    in_trace = {}
    for name, us in ops.items():
        k = traceutil.csrc_kernel_name(name)
        if k:
            in_trace[k] = in_trace.get(k, 0.0) + us
    in_profile = {traceutil.csrc_kernel_name(n) for n in profile_kernels} - {None}
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    out = dict(scans=[SAVE_AT, SAVE_AT + TRACE_SCANS], device_busy_ms_per_scan=busy / TRACE_SCANS,
               profile_busy_ms_per_scan=profile_busy / TRACE_SCANS, traced_wall_ms_per_scan=1000.0 * wall / TRACE_SCANS,
               csrc_kernels_us={k: round(v, 3) for k, v in sorted(in_trace.items())},
               top10=[(n[:70], round(us / 1000.0, 4), opn[n]) for n, us in top])
    print("  trace " + json.dumps(out), flush=True)
    gap = abs(busy - profile_busy) / max(profile_busy, 1e-9)
    assert gap <= 0.10, f"traceutil busy {busy} ms vs _profile {profile_busy} ms: {gap:.1%} apart"
    missing = sorted(k for k in in_profile if in_trace.get(k, 0.0) <= 0.0)
    assert not missing, f"csrc kernels with no time in the trace: {missing}"
    wrappers = {"build_packed": "k1_build.cu", "gn_system": "k2_gn.cu", "cand_errors": "k3_cand.cu",
                "min_sq_dist": "k4_nn.cu", "radius_neighbor_moments": "k5_moments.cu",
                "window_tables": "k6_window_tables.cu", "keyframe_tables": "k7_keyframe_tables.cu"}
    for w in launched:
        assert any(sources.get(k) == wrappers[w] for k in in_trace), f"no {wrappers[w]} kernel in the trace"
    assert {"build_packed", "gn_system", "cand_errors", "min_sq_dist", "window_tables"} <= launched, launched
    return busy / TRACE_SCANS


def evaluate_phase(slam, seq):
    """Phase (d): the fused run's trajectory and the analytic truth as TUM
    files under build/, through the evaluate CLI in a subprocess."""
    import numpy as np

    d = _build_dir("chip_smoke_eval")
    est = slam.save_poses(d)
    truth = os.path.join(d, "truth.txt")
    n_poses = write_truth(seq, est, truth)
    res = subprocess.run(
        [sys.executable, "-m", "dmsa_lidar_slam_tpu_torch.pipeline.evaluate", est, truth],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, check=True,
    )
    out = json.loads(res.stdout)
    print("  evaluate " + json.dumps(out), flush=True)
    assert out["ate_rmse"] <= ATE_GATE_M, f"evaluate ATE {out['ate_rmse']} above {ATE_GATE_M}"
    # the printed pairs are RPE's: every pose associated, 1-frame intervals
    assert out["pairs"] == n_poses - 1 and np.isfinite(out["rpe_rmse"]), out


def host_resume(device, data):
    """Phase (c): DmsaSlam on the card over HOST_CK_SCANS scans, saved at
    HOST_SAVE_AT; a fresh DmsaSlam loads the checkpoint and replays the
    rest.  Counters zeroed just before the resumed run, read just after."""
    import torch

    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_config
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import load_checkpoint, save_checkpoint
    from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam

    ckpt = os.path.join(_build_dir("chip_smoke_host_ck"), "host.npz")
    full = DmsaSlam(bench_config(), device=device)
    feed(full, data[:HOST_SAVE_AT])
    save_checkpoint(full, ckpt)
    updates0 = full.kf_map.num_updates
    feed(full, data[HOST_SAVE_AT:HOST_CK_SCANS])
    slam = load_checkpoint(DmsaSlam(bench_config(), device=device), ckpt)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    feed(slam, data[HOST_SAVE_AT:HOST_CK_SCANS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    assert slam.kf_map.count == full.kf_map.count and slam.kf_map.num_updates == full.kf_map.num_updates
    n = slam.kf_map.count
    dpos = float(abs(slam.kf_map.transl_w[:n] - full.kf_map.transl_w[:n]).max())
    dori = float(abs(slam.kf_map.orient_w[:n] - full.kf_map.orient_w[:n]).max())
    out = dict(launches=launches, kf_count=n, keyframes_added=slam.kf_map.num_updates - updates0,
               kf_pos_max_diff_m=dpos, kf_orient_max_diff_rad=dori, tolerance=HOST_RESUME_TOL,
               wall_ms_per_scan=1000.0 * wall / (HOST_CK_SCANS - HOST_SAVE_AT))
    print("  host resumed at scan %d %s" % (HOST_SAVE_AT, json.dumps(out)), flush=True)
    assert dpos <= HOST_RESUME_TOL and dori <= HOST_RESUME_TOL, (dpos, dori)
    assert slam.kf_map.num_updates > updates0, "no keyframe in the resumed scans"
    for k in ("min_sq_dist", "radius_neighbor_moments"):
        assert launches[k] > 0, f"kernel {k} never launched on the resumed host path"
    return launches


def two_scan_phase(device):
    """Phase (e): the two-scan alignment (dmsa.problems) through the
    optimizer's autodiff path on the card, from ~20 cm / ~40 mrad off."""
    import torch

    from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
    from dmsa_lidar_slam_tpu_torch.dmsa import problems
    from tests.torch_scenes import TWO_SCAN_PERTURBATION, pose_errors, two_scan_problem

    arrays, true = two_scan_problem()
    shapes = problems.ScanAlignShapes(n_scans=2, n_pts=arrays[0].shape[1])
    data = problems.ScanAlignData(*(torch.as_tensor(a, device=device) for a in arrays))
    settings = opt.OptimSettings(num_iter=40, step_length_optim=0.3, max_step=0.3, min_num_points_per_set=6,
                                 min_num_gaussians=10, epsilon=1e-7)
    init = torch.as_tensor(true + TWO_SCAN_PERTURBATION, device=device)
    fwd = problems.make_forward(shapes)
    opt.optimize(fwd, init, data, settings, 0.3)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = opt.optimize(fwd, init, data, settings, 0.3)
    torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t0)
    dt, dr = pose_errors(res.params.cpu().numpy(), true)
    dt0, dr0 = pose_errors(true + TWO_SCAN_PERTURBATION, true)
    out = dict(start_err_m=dt0, start_err_rad=dr0, err_m=dt, err_rad=dr, iterations=int(res.num_iters),
               stop_reason=int(res.stop_reason), num_gaussians=int(res.num_gaussians), ms=ms)
    print("  two-scan alignment " + json.dumps(out), flush=True)
    assert dt <= 0.01 and dr <= 0.001, (dt, dr)


def native_phase():
    """Phase (f): the native PointCloud2 decoder, built from the checkout's
    source (a failed build fails the phase), on an Ouster message of one
    bench scan, bit for bit against the numpy decoder."""
    import numpy as np

    from dmsa_lidar_slam_tpu_torch.io import native
    from dmsa_lidar_slam_tpu_torch.io import pointcloud2 as pc2
    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_sequence
    from tests.torch_bag import serialize_ouster_scan

    t0 = time.perf_counter()
    so = native.build()
    build_s = time.perf_counter() - t0
    assert native.available(), "the native decoder does not load"
    pts, stamps, rings = bench_sequence(3).scan(20, PTS_PER_SCAN, n_rings=16)
    msg = pc2.parse_pointcloud2(serialize_ouster_scan(pts, stamps, rings))
    t0 = time.perf_counter()
    got = native.decode_points(msg, "ouster")
    native_ms = 1000.0 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = pc2.decode_points(msg, "ouster")
    numpy_ms = 1000.0 * (time.perf_counter() - t0)
    equal = got is not None and all(
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b) for a, b in zip(got, want)
    )
    out = dict(library=os.path.relpath(so, os.path.dirname(os.path.abspath(__file__))), build_s=build_s,
               points=int(msg.width), bitwise_equal=equal, host_native_ms=native_ms, host_numpy_ms=numpy_ms)
    print("  native decode " + json.dumps(out), flush=True)
    assert equal, "native decode differs from the numpy decoder"


def record_step(slam, step, spans, retired_at):
    """After `slam` (either package's FusedDmsaSlam) ran step `step`: if it
    added a keyframe, its submap span into spans[step] and, if it retired
    one, `step` onto retired_at."""
    import numpy as np

    from dmsa_lidar_slam_tpu_torch.pipeline.fused import EV_KEYFRAME

    ev = slam.state.events[step % slam.shapes.ev_cap]
    ev = ev.cpu().numpy() if hasattr(ev, "cpu") else np.asarray(ev)
    if ev[0] == EV_KEYFRAME:
        spans[step] = int(round(float(ev[7])))
        if ev[8] > 0.5:
            retired_at.append(step)


def span_summary(spans, retired_at):
    """The keyframe steps' record: the first retirement, the first span of
    at least LONG_MIN_SPAN, the steps that ran a submap solve."""
    deep = [k for k, v in sorted(spans.items()) if v >= LONG_MIN_SPAN]
    first_ret = retired_at[0] if retired_at else None
    return dict(keyframe_steps=len(spans), first_retirement_scan=first_ret,
                first_span_scan=deep[0] if deep else None, submap_solves=sum(v > 0 for v in spans.values()),
                submap_solves_after_first_retirement=sum(v > 0 for k, v in spans.items()
                                                         if first_ret is not None and k >= first_ret))


class StepRecorder:
    """Each step's keyframe-map decision in FusedDmsaSlam, from the calls
    its step makes to dmap.closest_candidates and sp.select_static_points
    (wrapped while `installed`; what the step computes does not change) and
    from the step's event row.  The wrappers keep copies on the state's
    device; the host reads them in `collect`, after the step.

    A record: the ring count before the step, the candidate ids, valid
    flags and overlap counts, min_related (the smallest candidate id with
    an overlap, -1 with none), min_related_adj (one less once the ring is
    full: the oldest keyframe retires with the next keyframe), keyframe,
    run_submap, span, and for a keyframe step without a solve, why."""

    DECISION = ("count", "ids", "valid", "min_related", "min_related_adj", "keyframe", "run_submap", "span")

    def __init__(self):
        self.pending = []
        self.records = {}

    @contextlib.contextmanager
    def installed(self):
        from dmsa_lidar_slam_tpu_torch.map import device_map as dmap
        from dmsa_lidar_slam_tpu_torch.map import static_points as sp

        closest, select = dmap.closest_candidates, sp.select_static_points

        def closest_rec(state, pos_w, n_candidates, max_dist):
            ids, valid = closest(state, pos_w, n_candidates, max_dist)
            self.pending.append(dict(count=state.count.clone(), updates=state.num_updates.clone(),
                                     cap=state.orient_w.shape[0], ids=ids.clone(), valid=valid.clone()))
            return ids, valid

        def select_rec(*args, **kw):
            sel = select(*args, **kw)
            self.pending[-1]["overlap"] = sel.overlap_counts.clone()
            return sel

        dmap.closest_candidates, sp.select_static_points = closest_rec, select_rec
        try:
            yield self
        finally:
            dmap.closest_candidates, sp.select_static_points = closest, select

    def collect(self, slam, step):
        """After `slam` ran step `step`: its record (None for a step that
        queried no map, as the first window's)."""
        import numpy as np

        from dmsa_lidar_slam_tpu_torch.pipeline.fused import EV_KEYFRAME

        pending, self.pending = self.pending, []
        if not pending:
            return None
        p = pending[-1]
        ev = slam.state.events[step % slam.shapes.ev_cap].cpu().numpy()
        count = int(p["count"])
        ids = [int(i) for i in p["ids"].cpu().numpy()]
        overlap = [int(o) for o in p["overlap"].cpu().numpy()]
        related = [i for i, o in zip(ids, overlap) if o > 0]
        min_related = min(related) if related else -1
        full = count >= p["cap"]
        keyframe = bool(ev[0] == EV_KEYFRAME)
        span = int(round(float(ev[7]))) if keyframe else 0
        # slot 0 holds the keyframe added (updates - count)-th, counting from 0
        head = int(p["updates"]) - count
        rec = dict(step=step, count=count, ids=ids, valid=[bool(v) for v in p["valid"].cpu().numpy()],
                   overlap=overlap, min_related=min_related, min_related_adj=min_related - (1 if full else 0),
                   full=full, head=head, keyframe=keyframe, run_submap=keyframe and span > 0, span=span, skip=None)
        rec["skip"] = skip_reason(rec)
        assert np.isfinite(ev).all(), ev
        self.records[step] = rec
        return rec


def skip_reason(rec):
    """Why a keyframe step of a StepRecorder record ran no submap solve
    (None for a solve or a step without a keyframe)."""
    if not rec["keyframe"] or rec["run_submap"]:
        return None
    if rec["min_related"] < 0:
        return "no candidate keyframe overlaps the scan"
    if rec["full"] and rec["min_related"] == 0:
        return (f"slot 0 (keyframe #{rec['head']}, retiring with this keyframe) is related: "
                f"{rec['overlap'][rec['ids'].index(0)]} static points")
    return f"min_related_adj {rec['min_related_adj']}"


class HostStepRecorder:
    """StepRecorder's record for DmsaSlam (pipeline/slam.py), each scan's
    keyframe-map decision from the calls its step makes: the candidate ids
    (kf_map.closest_n_ids, filtered by distance as _add_static_points
    filters them), their overlap counts (sp.select_static_points),
    min_related (_add_static_points' third value), the from_id handed to
    _keyframe_optimization (min_related_adj) and whether it ran a solve
    (kf_map.write_back).  Wrapped on the instance while `installed`; what
    the step computes does not change.  The same keys as StepRecorder's,
    without `valid`: the host keeps only the candidates within
    dist_static_points_keyframe."""

    def __init__(self):
        self.pending = {}
        self.records = {}

    @contextlib.contextmanager
    def installed(self, slam):
        import numpy as np

        from dmsa_lidar_slam_tpu_torch.map import static_points as sp

        kf_map, pending = slam.kf_map, self.pending
        add_static, kf_opt, write_back, select = (slam._add_static_points, slam._keyframe_optimization,
                                                  kf_map.write_back, sp.select_static_points)

        def add_static_rec(fwd, params, data, min_grid):
            c = slam.config
            pos = data.anchor_transl.cpu().numpy().astype(float)
            ids = [k for k in kf_map.closest_n_ids(pos, c.closest_k_keyframes_as_static_points)
                   if np.linalg.norm(pos - kf_map.transl_w[k]) < c.dist_static_points_keyframe]
            pending.update(count=kf_map.count, updates=kf_map.num_updates, full=kf_map.is_full, ids=ids,
                           overlap=[0] * len(ids))
            sel, max_key, min_related = add_static(fwd, params, data, min_grid)
            pending["min_related"] = int(min_related)
            return sel, max_key, min_related

        def select_rec(*args, **kw):
            sel = select(*args, **kw)
            pending["overlap"] = [int(o) for o in sel.overlap_counts.cpu().numpy()[: len(pending["ids"])]]
            return sel

        def kf_opt_rec(from_id):
            pending["from_id"] = int(from_id)
            return kf_opt(from_id)

        def write_back_rec(from_id, *args):
            pending["span"] = kf_map.count - int(from_id)
            return write_back(from_id, *args)

        slam._add_static_points, slam._keyframe_optimization, kf_map.write_back = (add_static_rec, kf_opt_rec,
                                                                                   write_back_rec)
        sp.select_static_points = select_rec
        try:
            yield self
        finally:
            sp.select_static_points = select
            slam._add_static_points, slam._keyframe_optimization, kf_map.write_back = add_static, kf_opt, write_back

    def collect(self, slam, step):
        """After `slam` ran scan `step`: its record (None for a scan that
        queried no map)."""
        p = dict(self.pending)
        self.pending.clear()
        if "ids" not in p:
            return None
        keyframe = slam.kf_map.num_updates > p["updates"]
        span = p.get("span", 0)
        min_related = p["min_related"]
        rec = dict(step=step, count=p["count"], ids=p["ids"], overlap=p["overlap"], min_related=min_related,
                   min_related_adj=p.get("from_id", min_related - (1 if p["full"] else 0)), full=p["full"],
                   head=p["updates"] - p["count"], keyframe=keyframe, run_submap=span > 0, span=span, skip=None)
        rec["skip"] = skip_reason(rec)
        self.records[step] = rec
        return rec


def long_phase(device, seq, data):
    """Phase (h): FusedDmsaSlam(long_config()) on the card over `data`
    (long_data: LONG_SCANS scans of long_sequence(LONG_SEED), LONG_PTS raw
    points over LONG_RINGS rings, with bench.py's stressors), generated
    before the run.  Counters zeroed just before and read just after.  Each
    step's event row and its StepRecorder record are read after its scan's
    timed region, for the scan at which the submap span first reaches
    LONG_MIN_SPAN, the first retirement and why each keyframe step after it
    ran no submap solve.  Returns the launches."""
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, long_config
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam, submap_keyframes

    recorder = StepRecorder()
    slam = FusedDmsaSlam(long_config(), flush_every=20, device=device)
    sh = slam.shapes
    s_sub = submap_keyframes(slam.config, sh)
    assert (sh.raw_cap, sh.kf_cap, sh.kf_pts_cap, s_sub) == (LONG_PTS, *LONG_SUBMAP_SHAPE, sh.kf_cap), (sh, s_sub)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    walls, spans, retired_at = [], {}, []
    with recorder.installed():
        for pts, stamps, rings, ts, acc, gyr in data:
            stepped = slam.scan_counter
            t = time.perf_counter()
            slam.process_imu_batch(acc, gyr, ts)
            slam.process_scan(pts, stamps, rings)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if slam.scan_counter > stepped:  # the step of scan `stepped` ran (one scan is buffered)
                record_step(slam, stepped, spans, retired_at)
                recorder.collect(slam, stepped)
        if len(walls) % 50 == 0:
            print(f"    scan {len(walls)}: {slam.kf_count} keyframes, deepest span {max(spans.values(), default=0)}, "
                  f"{1000.0 * sum(walls[-50:]) / 50:.1f} ms per scan over the last 50", flush=True)
    launches, dense_j = cuda_lib.launch_counts(), cuda_lib.BRANCHES["gn_system_dense_j"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    st, tr, _ = slam.all_poses()
    ate = ate_rmse(st, tr, seq) if len(st) >= 3 else float("nan")
    kf = slam.state.kf
    masked = 1.0 - float(kf.pt_mask[: slam.kf_count].sum()) / (sh.kf_cap * sh.kf_pts_cap)
    kf_walls = [walls[k + 1] for k in spans if k + 1 >= LONG_WARM]  # scan k steps while scan k + 1 is fed
    timed = sum(walls[LONG_WARM:])
    out = dict(
        scans=len(data), raw_points=LONG_PTS, rings=LONG_RINGS,
        keyframes=slam.kf_count, retired_to_output=slam.output.num_static_keyframes,
        trajectory_poses=len(st), max_submap_span=slam.max_submap_span, span_gate=LONG_MIN_SPAN,
        **span_summary(spans, retired_at),
        spans_by_scan={k: spans[k] for k in sorted(spans)[:: max(1, len(spans) // 12)]},
        skips_after_first_retirement={k: r["skip"] for k, r in sorted(recorder.records.items())
                                      if r["keyframe"] and not r["run_submap"] and retired_at and k >= retired_at[0]},
        ate_m=ate, ate_gate_m=LONG_ATE_GATE_M,
        wall_ms_per_scan_10_on=1000.0 * timed / (len(data) - LONG_WARM),
        wall_ms_per_keyframe_scan=1000.0 * float(np.mean(kf_walls)) if kf_walls else None,
        data_s_per_wall_s=(len(data) - LONG_WARM) * seq.sweep / timed,
        peak_mem_gib=peak, ring_masked_share=masked, launches=launches, gn_system_dense_j=dense_j,
    )
    print("  long run " + json.dumps(out), flush=True)
    for k in cuda_lib.LAUNCHES:
        assert launches[k] > 0, f"kernel {k} never launched on the long path"
    assert dense_j > 0, "K2's dense-J path never ran in the long run"
    assert slam.kf_count == sh.kf_cap, f"{slam.kf_count} keyframes at the end, not {sh.kf_cap}"
    assert slam.output.num_static_keyframes >= 1 and retired_at, "no keyframe retired to the output"
    assert slam.max_submap_span >= LONG_MIN_SPAN, f"max submap span {slam.max_submap_span} < {LONG_MIN_SPAN}"
    assert len(st) >= 3 and np.all(np.isfinite(tr)), "the output trajectory is short or not finite"
    assert ate <= LONG_ATE_GATE_M, f"long run ATE {ate} above {LONG_ATE_GATE_M}"
    return launches


def record_submaps(slam):
    """Wrap the keyframe map's write_back, which either package's DmsaSlam
    calls once at the end of each submap solve (what it computes does not
    change): returns the list that collects (scan_updates, keyframes added
    so far, from_id, span) of every solve.  A solve after the ring's first
    retirement has more keyframes added than the ring holds."""
    solves = []
    kf_map = slam.kf_map
    write_back = kf_map.write_back

    def recorded(from_id, *args):
        solves.append((slam.scan_updates, kf_map.num_updates, int(from_id), kf_map.count - int(from_id)))
        return write_back(from_id, *args)

    kf_map.write_back = recorded
    return solves


def host_long_phase(device, seq, data):
    """Phase (k): DmsaSlam(long_config()) on the card over the first
    LONG_HOST_SCANS records of phase (h)'s data.  Counters zeroed just
    before and read just after.  Returns the launches."""
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, long_config
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam

    data = data[:LONG_HOST_SCANS]
    slam = DmsaSlam(long_config(), device=device)
    ms, c = slam.map_shapes, slam.config
    assert (c.raw_scan_cap, ms.n_keyframes, ms.n_pts_per_kf, c.submap_max_keyframes) == \
        (LONG_PTS, *LONG_SUBMAP_SHAPE, None), (c, ms)
    solves = record_submaps(slam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    walls, kf_scans = [], []
    for i, (pts, stamps, rings, ts, acc, gyr) in enumerate(data):
        updates = slam.kf_map.num_updates
        t = time.perf_counter()
        slam.process_imu_batch(acc, gyr, ts)
        slam.process_scan(pts, stamps, rings)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if slam.kf_map.num_updates > updates:
            kf_scans.append(i)
    launches = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = slam.kf_map.count
    st, tr, _ = slam.output.dense_poses_list(slam.kf_map.stamps[:n], slam.kf_map.transl_w[:n],
                                             slam.kf_map.orient_w[:n])
    ate = ate_rmse(st, tr, seq) if len(st) >= 3 else float("nan")
    kf_walls = [walls[i] for i in kf_scans if i >= LONG_WARM]
    timed = walls[LONG_WARM:]
    out = dict(
        scans=len(data), raw_points=LONG_PTS, rings=LONG_RINGS, keyframes=n,
        keyframe_scans=kf_scans, submap_solves=len(solves), solves=solves,
        solves_after_first_retirement=sum(u > ms.n_keyframes for _, u, _, _ in solves),
        deepest_span=max((s for *_, s in solves), default=0), trajectory_poses=len(st), ate_m=ate,
        ate_gate_m=LONG_ATE_GATE_M,
        wall_ms_per_scan_10_on=1000.0 * sum(timed) / max(len(timed), 1),
        wall_ms_per_keyframe_scan=1000.0 * float(np.mean(kf_walls)) if kf_walls else None,
        wall_ms_by_scan=[round(1000.0 * w, 1) for w in walls], syncs="not counted in this phase",
        peak_mem_gib=peak, launches=launches, stages_ms=slam.metrics.summary(),
    )
    print("  host long run " + json.dumps(out), flush=True)
    for k in ("min_sq_dist", "radius_neighbor_moments"):
        assert launches[k] > 0, f"kernel {k} never launched on the host long path"
    assert n >= 3, f"{n} keyframes"
    assert solves, "no submap solve in the host long run"
    assert len(st) >= 3 and np.all(np.isfinite(tr)), "the output trajectory is short or not finite"
    assert ate <= LONG_ATE_GATE_M, f"host long run ATE {ate} above {LONG_ATE_GATE_M}"
    return launches


# --------------------------------------------------------------------------
# phase (g): the distributed keyframe adjustment
# --------------------------------------------------------------------------


def _counted(fn):
    """(fn(), wall s, launches): the launch counters zeroed just before and
    read just after, the card synchronized on both sides."""
    import torch

    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, cuda_lib.launch_counts()


def dist_problem(shape, device):
    """(data, params0, params_true) of the synthetic keyframe map at
    `shape` (keyframes, points per keyframe) on the card."""
    import torch

    from tests.torch_dist import as_port, keyframe_problem

    data, p0, pt = keyframe_problem(DIST_SEED, s=shape[0], ppk=shape[1], with_normals=True, extras=True,
                                    shared=False, pose_noise=DIST_POSE_NOISE)
    return as_port(data, device), torch.as_tensor(p0, device=device), torch.as_tensor(pt, device=device)


def kf_positions(data, params, shape):
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm

    return kfm.global_chain(params, data, kfm.MapShapes(*shape))[1].transl.cpu().numpy()


def position_rms(a, b):
    import numpy as np

    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def position_max(a, b):
    import numpy as np

    return float(np.max(np.linalg.norm(a - b, axis=1)))


def spatial_run(mesh, data, params0, shape, num_iter=DIST_OPT["num_iter"]):
    """parallel.spatial over `mesh`: (params, final_error, cells, overflow)."""
    import torch

    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
    from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist, spatial

    sopt = spatial.make_spatial_dist_optimize(mesh, kfm.MapShapes(*shape), use_split=True,
                                              **dict(DIST_OPT, num_iter=num_iter))
    fp, fm, frs, aux = keyframe_dist.flatten_problem(data)
    return sopt(params0, fp, fm, frs, aux, torch.tensor(DIST_GRIDS, device=fp.device),
                flat_normals=data.local_normals.reshape(-1, 3))


def hash_run(mesh, data, params0, shape):
    """parallel.keyframe_dist (the hash backend) over `mesh`: (params,
    iterations, final_error, cells)."""
    import torch

    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
    from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist

    f = keyframe_dist.make_keyframe_dist_optimize(mesh, kfm.MapShapes(*shape), **HASH_OPT)
    fp, fm, frs, aux = keyframe_dist.flatten_problem(data)
    return f(params0, fp, fm, frs, aux, torch.tensor(DIST_GRIDS, device=fp.device))


def _k123_launched(launches, where):
    for k in ("build_packed", "gn_system", "cand_errors"):
        assert launches[k] > 0, f"kernel {k} never launched {where}"


def dist_settings(num_iter):
    """The port's OptimSettings of DIST_OPT with num_iter iterations."""
    from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt

    return opt.OptimSettings(num_iter=num_iter, min_num_points_per_set=DIST_OPT["min_points"],
                             step_length_optim=DIST_OPT["step_length"], max_step=DIST_OPT["max_step"],
                             epsilon=DIST_OPT["epsilon"])


def single_card_phase(device):
    """(g1) The single-card reference: the optimizer's tabular path (K1-K3)
    at the 100-keyframe shape, P = 594 (K2's dense-J path), with the
    pipelines' settings: the shipped call, counters zeroed around it, then
    its iterations again one call each, which must land on the shipped
    call's params bit for bit.  Returns (params after each iteration, the
    start first; launches; the shipped call's params)."""
    import torch

    from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm

    data, p0, pt = dist_problem(DIST_SHAPE, device)
    shapes = kfm.MapShapes(*DIST_SHAPE)
    fwd = kfm.make_forward(shapes, True, True, True)
    tabular = kfm.make_tabular(shapes, True, True)
    res, wall, launches = _counted(
        lambda: opt.optimize(fwd, p0, data, dist_settings(DIST_OPT["num_iter"]), 0.25, tabular_fn=tabular))
    curve, cells = [p0], []
    for _ in range(int(res.num_iters)):
        r = opt.optimize(fwd, curve[-1], data, dist_settings(1), 0.25, tabular_fn=tabular)
        curve.append(r.params)
        cells.append(int(r.num_gaussians))
    truth = kf_positions(data, pt, DIST_SHAPE)
    errs = [position_rms(kf_positions(data, p, DIST_SHAPE), truth) for p in curve]
    # K7's residuals differ from torch.func's in the last f64 bits, which
    # the late iterations amplify (G1_DESCENT_ITERS), so K7's one iteration
    # from the start is held to torch.func's as (g3) holds a reordered sum
    reference = tabular._replace(
        tables_jac=lambda p, d: kfm.keyframe_tables_ref(p, d, shapes, True, True),
        tables_batch=lambda cands, d: kfm.keyframe_tables_batch_ref(cands, d, shapes, True, True))
    tfunc1 = opt.optimize(fwd, p0, data, dist_settings(1), 0.25, tabular_fn=reference).params
    step_gap = position_max(kf_positions(data, curve[1], DIST_SHAPE), kf_positions(data, tfunc1, DIST_SHAPE))
    out = dict(keyframes=DIST_SHAPE[0], points=DIST_SHAPE[0] * DIST_SHAPE[1], params=p0.shape[0],
               iterations=int(res.num_iters), stop_reason=int(res.stop_reason), gaussians=int(res.num_gaussians),
               kf_pos_rms_m=errs, valid_cells=cells, descent_bound=[G1_DESCENT_ITERS, G1_DESCENT_GAIN],
               shipped_bound=G1_SHIPPED_GAIN, wall_s=wall, launches=launches,
               one_iteration_kf_pos_max_diff_vs_torch_func_m=step_gap, one_iteration_tolerance_m=DIST_STEP_TOL_M)
    print("  (g1) single card " + json.dumps(out), flush=True)
    assert step_gap <= DIST_STEP_TOL_M, f"(g1) K7's iteration {step_gap} m from torch.func's"
    assert bool(res.params.isfinite().all()), "non-finite parameters"
    assert torch.equal(curve[-1], res.params), "(g1) one iteration per call left the shipped call's path"
    assert len(errs) > G1_DESCENT_ITERS and errs[G1_DESCENT_ITERS] <= G1_DESCENT_GAIN * errs[0], \
        f"(g1) keyframe position RMS {errs[0]} -> {errs[G1_DESCENT_ITERS:G1_DESCENT_ITERS + 1]}"
    assert errs[-1] <= G1_SHIPPED_GAIN * errs[0], f"(g1) keyframe position RMS {errs[0]} -> {errs[-1]}"
    _k123_launched(launches, "in (g1)")
    return curve, launches, res.params


def dist_kernel_rows(device, results, calls):
    """K1-K3 at the per-rank shapes of the spatial backend at the
    100-keyframe shape, against their plain versions: the rows that rank 0
    receives at 2 ranks (2 x 204,800) and at 1 rank (819,200), both grids."""
    import torch

    from dmsa_lidar_slam_tpu_torch.core import rotations as rot
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
    from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist, spatial
    from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh

    data, p0, _ = dist_problem(DIST_SHAPE, device)
    s, ppk = DIST_SHAPE
    n = s * ppk
    fp, fm, frs, aux = keyframe_dist.flatten_problem(data)
    tab, _, dtabs, _ = kfm.keyframe_tables(p0, aux, kfm.MapShapes(s, ppk), True, True)
    tidx = torch.arange(s, device=device).repeat_interleave(ppk)
    split = kfm.normal_split_ids(rot.quat_rotate(tab[:, 0:4][tidx], data.local_normals.reshape(-1, 3)))
    payload = torch.cat([fp, tidx.float()[:, None], frs.float()[:, None], split.float()[:, None]], dim=1)
    world = spatial.world_points(tab, fp, tidx)
    for n_dev in (2, 1):
        cap = spatial.bucket_cap(n, n_dev)
        arg_sets = []
        for grid in DIST_GRIDS:
            g = torch.tensor(grid, device=device)
            recv, rmask = [], []
            for sender in range(n_dev):  # each sender's bucket for rank 0, as all_to_all delivers it
                sl = slice(sender * n // n_dev, (sender + 1) * n // n_dev)
                owner = spatial.owner_of_voxels(world[sl], fm[sl], g, n_dev)
                r, m, _ = spatial.shuffle_to_owners(payload[sl], owner, n_dev, cap, pmesh.ONE_RANK)
                recv.append(r[:cap])
                rmask.append(m[:cap])
            recv, rmask = torch.cat(recv), torch.cat(rmask)
            r_xs, r_tidx = recv[:, 0:3].contiguous(), recv[:, 3].long()
            arg_sets.append((spatial.world_points(tab, r_xs, r_tidx), rmask, recv[:, 4].int(), r_xs, r_tidx, g,
                             DIST_OPT["min_points"], tab, recv[:, 5].int()))
        rows = arg_sets[0][0].shape[0]
        label = f"rank 0 of {n_dev}, {int(arg_sets[0][1].sum())} of {rows} rows valid"
        packed = _k1_row(results, calls, arg_sets, f"n={rows} distributed, {label}")
        m = packed.shape[1]
        _k2_row(results, calls, tab, dtabs, packed, m // DIST_OPT["min_points"] + 2,
                f"P={dtabs.shape[0]} M={m} distributed, rank 0 of {n_dev}")
        _k3_row(results, calls, device, packed, tab, f"K=15 Dtab={tab.shape[0]} M={m} distributed, rank 0 of {n_dev}")


def one_rank_phase(device, g1_params):
    """(g2) parallel.spatial at world size 1 over NCCL against (g1)'s
    params after the shipped call (both on K7's tables), and (g4, second
    half) the hash backend
    at world size 1 at the 100-keyframe shape.  Returns (g2)'s launches."""
    import torch
    import torch.distributed as dist

    from dmsa_lidar_slam_tpu_torch.parallel import launch, spatial
    from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh

    n_points = DIST_SHAPE[0] * DIST_SHAPE[1]
    store = os.path.join(_build_dir("chip_smoke_nccl"), "store")
    launch.initialize_distributed(backend="nccl", init_method=f"file://{store}", world_size=1, rank=0, device=device)
    try:
        mesh = pmesh.make_mesh()
        assert mesh.backend == "nccl" and mesh.size == 1 and mesh.group is not None, mesh
        data, p0, pt = dist_problem(DIST_SHAPE, device)
        (params, err, cells, ov), wall, launches = _counted(lambda: spatial_run(mesh, data, p0, DIST_SHAPE))
        diff = float((params - g1_params).abs().max())
        gap = position_max(kf_positions(data, params, DIST_SHAPE), kf_positions(data, g1_params, DIST_SHAPE))
        out = dict(backend=mesh.backend, ranks=mesh.size, cap=spatial.bucket_cap(n_points, 1), overflow=int(ov),
                   cells=int(cells), final_error=float(err), params_max_diff_vs_g1=diff, tolerance=G2_PARAM_TOL,
                   kf_pos_max_diff_vs_g1_m=gap, wall_s=wall, launches=launches)
        print("  (g2) spatial, 1 rank " + json.dumps(out), flush=True)
        assert int(ov) == 0, "(g2) bucket overflow"
        assert diff <= G2_PARAM_TOL, f"(g2) parameters {diff} from (g1)'s"
        _k123_launched(launches, "in (g2)")
        assert launches["keyframe_tables"] > 0, "kernel keyframe_tables never launched in (g2)"

        (ph, iters, eh, ch), wall, hl = _counted(lambda: hash_run(mesh, data, p0, DIST_SHAPE))
        e0, e1 = float((p0 - pt).norm()), float((ph - pt).norm())
        out = dict(backend=mesh.backend, ranks=mesh.size, table_size=HASH_OPT["table_size"], iterations=int(iters),
                   cells=int(ch), param_err_start=e0, param_err=e1, bound=HASH_GAIN,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, wall_s=wall)
        print("  (g4) hash backend, 1 rank, 100 keyframes " + json.dumps(out), flush=True)
        assert e1 < HASH_GAIN * e0, f"(g4) parameter error {e0} -> {e1}"
        assert not any(hl.values()), f"the hash backend launched a kernel: {hl}"
    finally:
        dist.destroy_process_group()
    return launches


def _rank_main(rank, world, out_dir, device, step_from):
    """One of the 2 ranks of (g3)-(g5), sharing the card `device` over
    gloo; step_from: (g1)'s params (on the CPU) to take one (g3) iteration
    from."""
    import torch
    import torch.distributed as dist

    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, bench_config
    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
    from dmsa_lidar_slam_tpu_torch.parallel import launch
    from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    device = launch.initialize_distributed(backend="gloo", init_method=f"file://{out_dir}/store", world_size=world,
                                           rank=rank, device=device)
    try:
        cuda_lib.library()
        mesh = pmesh.make_mesh()
        out = dict(mesh=(mesh.size, mesh.rank, mesh.backend))
        data, p0, pt = dist_problem(DIST_SHAPE, device)
        (params, err, cells, ov), wall, launches = _counted(lambda: spatial_run(mesh, data, p0, DIST_SHAPE))
        out["g3"] = dict(params=params.cpu(), overflow=int(ov), cells=int(cells), final_error=float(err),
                         wall_s=wall, launches=launches)
        steps = [spatial_run(mesh, data, p.to(device), DIST_SHAPE, num_iter=1) for p in step_from]
        out["g3"]["steps"] = [r[0].cpu() for r in steps]
        out["g3"]["step_overflow"] = [int(r[3]) for r in steps]
        del data, p0, pt
        data, p0, pt = dist_problem(DIST_HASH_SHAPE, device)
        (ph, iters, eh, ch), wall, hl = _counted(lambda: hash_run(mesh, data, p0, DIST_HASH_SHAPE))
        out["g4"] = dict(params=ph.cpu(), iterations=int(iters), cells=int(ch), param_err_start=float((p0 - pt).norm()),
                         param_err=float((ph - pt).norm()), wall_s=wall, launches=hl)
        del data, p0, pt
        seq, scans = bench_data(DIST_FUSED_SCANS)
        slam = FusedDmsaSlam(bench_config(distributed_keyframe_opt=True), flush_every=20, device=device)
        _, wall, launches = _counted(lambda: feed(slam, scans))
        st, tr, _ = slam.all_poses()
        _, transl, orient = slam.keyframe_poses()
        out["g5"] = dict(mesh=slam.mesh.size, kf_count=slam.kf_count, transl=transl, orient=orient,
                         ate_m=ate_rmse(st, tr, seq), max_submap_span=slam.max_submap_span,
                         shuffle_overflow=slam.shuffle_overflow, wall_ms_per_scan=1000.0 * wall / len(scans),
                         launches=launches)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def two_rank_phase(device, g1_curve, ckpt_path):
    """(g3) parallel.spatial on 2 ranks sharing the card over gloo: the
    shipped call, and one iteration from (g1)'s params after each count of
    DIST_STEP_FROM against (g1)'s next ones; (g4) the hash backend on them
    at bench_config's 16-keyframe submap; (g5) FusedDmsaSlam with
    distributed_keyframe_opt on them over the first DIST_FUSED_SCANS bench
    scans, against the one-rank run's checkpoint at that scan and against
    a one-rank run with the submap step off, which this process runs while
    the ranks do.  Returns the ranks' summed launches of (g3) and (g5)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from dmsa_lidar_slam_tpu_torch.io.synthetic import bench_config
    from dmsa_lidar_slam_tpu_torch.parallel import spatial
    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import load_fused_checkpoint
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    out_dir = _build_dir("chip_smoke_ranks")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step_from = [g1_curve[k].cpu() for k in DIST_STEP_FROM]
    ctx = mp.start_processes(_rank_main, args=(2, out_dir, str(device), step_from), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DIST_RANK_TIMEOUT_S
    try:
        seq, scans = bench_data(DIST_FUSED_SCANS)
        off = FusedDmsaSlam(bench_config(optimize_sliding_window_keyframes=False), flush_every=20, device=device)
        feed(off, scans)
        _, off_t, _ = off.keyframe_poses()
        del off
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            assert time.monotonic() < deadline, "the 2 ranks did not finish in time"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    print(f"  2 ranks on one card over gloo: {time.perf_counter() - t0:.1f} s, start-up included", flush=True)
    assert [r["mesh"] for r in ranks] == [(2, 0, "gloo"), (2, 1, "gloo")], [r["mesh"] for r in ranks]

    data, p0, pt = dist_problem(DIST_SHAPE, device)

    def positions(params):
        return kf_positions(data, params.to(device), DIST_SHAPE)

    g3 = [r["g3"] for r in ranks]
    same = all(torch.equal(g3[0]["params"], g["params"]) for g in g3)
    same = same and all(torch.equal(a, b) for g in g3 for a, b in zip(g3[0]["steps"], g["steps"]))
    truth = positions(pt)
    step_gaps = [position_max(positions(p), positions(g1_curve[k + 1]))
                 for k, p in zip(DIST_STEP_FROM, g3[0]["steps"])]
    out = dict(backend="gloo", ranks=2, cap=spatial.bucket_cap(DIST_SHAPE[0] * DIST_SHAPE[1], 2),
               overflow=[g["overflow"] for g in g3], step_overflow=[g["step_overflow"] for g in g3],
               cells=g3[0]["cells"], final_error=g3[0]["final_error"], ranks_bit_identical=same,
               kf_pos_rms_start_m=position_rms(positions(p0), truth),
               kf_pos_rms_m=position_rms(positions(g3[0]["params"]), truth),
               kf_pos_max_diff_vs_g1_m=position_max(positions(g3[0]["params"]), positions(g1_curve[-1])),
               one_step_from=list(DIST_STEP_FROM), one_step_kf_pos_max_diff_vs_g1_m=step_gaps,
               tolerance_m=DIST_STEP_TOL_M, wall_s=[g["wall_s"] for g in g3],
               launches=[g["launches"] for g in g3])
    print("  (g3) spatial, 2 ranks " + json.dumps(out), flush=True)
    assert same, "(g3) the ranks' parameters differ"
    assert all(g["overflow"] == 0 and not any(g["step_overflow"]) for g in g3), "(g3) bucket overflow"
    assert max(step_gaps) <= DIST_STEP_TOL_M, f"(g3) one iteration {step_gaps} m from (g1)'s"
    for g in g3:
        _k123_launched(g["launches"], "on a rank in (g3)")

    g4 = [r["g4"] for r in ranks]
    same = all(torch.equal(g4[0]["params"], g["params"]) for g in g4)
    out = {k: v for k, v in g4[0].items() if k != "params"}
    out.update(backend="gloo", ranks=2, table_size=HASH_OPT["table_size"], ranks_bit_identical=same, bound=HASH_GAIN)
    print("  (g4) hash backend, 2 ranks, 16 keyframes " + json.dumps(out), flush=True)
    assert same, "(g4) the ranks' parameters differ"
    assert g4[0]["param_err"] < HASH_GAIN * g4[0]["param_err_start"], "(g4) the error did not fall"
    assert not any(v for g in g4 for v in g["launches"].values()), "the hash backend launched a kernel"

    g5 = [r["g5"] for r in ranks]
    one = load_fused_checkpoint(FusedDmsaSlam(bench_config(), flush_every=20, device=device), ckpt_path)
    _, one_t, _ = one.keyframe_poses()
    same = all(np.array_equal(g5[0][k], g[k]) for g in g5 for k in ("transl", "orient"))

    def kf_gap(a, b):
        return position_max(a, b) if len(a) == len(b) else float("inf")

    gap, gap_off = kf_gap(g5[0]["transl"], one_t), kf_gap(off_t, one_t)
    out = {k: v for k, v in g5[0].items() if k not in ("transl", "orient")}
    out.update(scans=DIST_FUSED_SCANS, one_rank_kf_count=len(one_t), ranks_bit_identical=same,
               kf_pos_max_diff_vs_one_rank_m=gap, tolerance_m=FUSED_DIST_TOL_M,
               submap_off_kf_pos_max_diff_vs_one_rank_m=gap_off, launches=[g["launches"] for g in g5])
    print("  (g5) fused pipeline, 2 ranks " + json.dumps(out), flush=True)
    assert all(g["mesh"] == 2 for g in g5), "(g5) the submap was not distributed"
    assert same, "(g5) the ranks' keyframes differ"
    assert g5[0]["ate_m"] <= ATE_GATE_M, f"(g5) ATE {g5[0]['ate_m']} above {ATE_GATE_M}"
    assert g5[0]["max_submap_span"] > 0 and all(g["shuffle_overflow"] == 0 for g in g5), g5[0]
    assert gap <= FUSED_DIST_TOL_M, f"(g5) keyframe positions {gap} m from the one-rank run's"
    assert gap_off > FUSED_DIST_TOL_M, f"(g5) the submap step moves the keyframes only {gap_off} m"
    for g in g5:
        _k123_launched(g["launches"], "on a rank in (g5)")
    total = {}
    for g in g3 + g5:
        for k, v in g["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def dist_phase(device, ckpt_path, results, calls):
    """Phase (g).  Returns the launches of (g1) and of the distributed runs
    ((g2), and (g3) and (g5) on both ranks)."""
    def sub(title, fn, *args):
        print(title, flush=True)
        t = time.perf_counter()
        out = fn(*args)
        print(f"  ({time.perf_counter() - t:.1f} s)", flush=True)
        return out

    from dmsa_lidar_slam_tpu_torch.config import Config

    c = Config()
    assert (DIST_OPT["num_iter"], DIST_OPT["min_points"], DIST_OPT["step_length"], DIST_OPT["epsilon"]) == (
        c.num_iter_keyframe_optim, c.min_num_points_gauss_key, c.alpha_keyframe_optim, c.epsilon_keyframe_opt)
    g1_curve, g1_launches, g1_params = sub("(g1) the single-card optimizer at 100 keyframes x 4,096 points:",
                                          single_card_phase, device)
    sub("(g) K1-K3 at the spatial backend's per-rank shapes:", dist_kernel_rows, device, results, calls)
    dist_launches = sub("(g2, g4) parallel.spatial and the hash backend at world size 1 over NCCL:",
                        one_rank_phase, device, g1_params)
    two = sub("(g3, g4, g5) 2 ranks on the one card over gloo:", two_rank_phase, device, g1_curve, ckpt_path)
    for k, v in two.items():
        dist_launches[k] += v
    return g1_launches, dist_launches


# --------------------------------------------------------------------------
# phase (i): the weighted tabular optimize; phase (j): the multi-chip dry run
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _plain_kernels():
    """The optimizer's K1-K3 calls go to their plain versions (on the card)
    inside."""
    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr

    saved = fr.build_packed, fr.gn_system, fr.cand_errors
    fr.build_packed = fr.build_packed_ref
    fr.gn_system = lambda tab, dtabs, packed, max_cells=None: fr.gn_system_ref(tab, dtabs, packed,
                                                                               include_mean_term=False)
    fr.cand_errors = fr.cand_errors_ref
    try:
        yield
    finally:
        fr.build_packed, fr.gn_system, fr.cand_errors = saved


@contextlib.contextmanager
def _recorded_builds(builds):
    """Inside, each of the optimizer's K1 calls appends its arguments to
    `builds` in _k1_row's order (points, mask, rings, xs, tidx, grid, min
    points, table, split ids, weights)."""
    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr

    shipped = fr.build_packed

    def recorded(*args, split_ids=None, obs_weight=None):
        builds.append(tuple(args) + (split_ids, obs_weight))
        return shipped(*args, split_ids=split_ids, obs_weight=obs_weight)

    fr.build_packed = recorded
    try:
        yield
    finally:
        fr.build_packed = shipped


def weighted_phase(device, results, calls):
    """(i) The optimizer's tabular path with per-point observation weights
    (K1's 12-row layout, then K2 and K3) on the keyframe problem of
    bench_config's 16-keyframe submap (DIST_HASH_SHAPE, P = 90), its
    forward returning weights uniform in [0.5, 2] (seed WEIGHTED_SEED), at
    the pipelines' keyframe settings: the shipped call, counters zeroed
    just before and read just after.  Then one iteration through the
    kernels, whose K1 inputs (both grids) become a K1 row against the
    plain version (_k1_row: K1's tolerances, bit for bit call to call);
    that iteration against the same one through the plain versions on the
    card, and against one without the weights.  Returns the shipped call's
    launches."""
    import numpy as np
    import torch

    from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm

    data, p0, pt = dist_problem(DIST_HASH_SHAPE, device)
    shapes = kfm.MapShapes(*DIST_HASH_SHAPE)
    n = shapes.n_keyframes * shapes.n_pts_per_kf
    obs = torch.as_tensor(np.random.default_rng(WEIGHTED_SEED).uniform(0.5, 2.0, size=n), dtype=torch.float32,
                          device=device)
    unweighted = kfm.make_forward(shapes, True, True, True)

    def forward(params, d):
        return unweighted(params, d)._replace(obs_weight=obs)

    tabular = kfm.make_tabular(shapes, True, True)

    def run(fwd, num_iter):
        return opt.optimize(fwd, p0, data, dist_settings(num_iter), 0.25, tabular_fn=tabular)

    res, wall, launches = _counted(lambda: run(forward, DIST_OPT["num_iter"]))
    builds = []
    with _recorded_builds(builds):
        one = run(forward, 1)
    assert len(builds) == 2 and all(b[9] is obs for b in builds), "(i): K1 not called once per grid with the weights"
    _k1_row(results, calls, builds, f"n={n} Dtab={builds[0][7].shape[0]} 12-row, (i)'s own inputs")
    with _plain_kernels():
        one_plain = run(forward, 1)
    diff = float((one.params - one_plain.params).abs().max())
    effect = float((one.params - run(unweighted, 1).params).abs().max())
    truth = kf_positions(data, pt, DIST_HASH_SHAPE)
    e0 = position_rms(kf_positions(data, p0, DIST_HASH_SHAPE), truth)
    e1 = position_rms(kf_positions(data, res.params, DIST_HASH_SHAPE), truth)
    out = dict(keyframes=shapes.n_keyframes, points=n, params=p0.shape[0], iterations=int(res.num_iters),
               stop_reason=int(res.stop_reason), gaussians=int(res.num_gaussians), kf_pos_rms_start_m=e0,
               kf_pos_rms_m=e1, one_iteration_params_max_diff_vs_plain=diff, tolerance=WEIGHTED_ITER_TOL,
               one_iteration_weight_effect=effect, weight_effect_min=WEIGHT_EFFECT_MIN, wall_s=wall,
               launches=launches)
    print("  (i) weighted tabular optimize " + json.dumps(out), flush=True)
    assert bool(res.params.isfinite().all()), "non-finite parameters"
    assert launches["build_rows12"] > 0, "K1's 12-row layout never ran in (i)"
    _k123_launched(launches, "in (i)")
    assert diff <= WEIGHTED_ITER_TOL, f"(i) one iteration {diff} from the plain versions'"
    assert effect >= WEIGHT_EFFECT_MIN, f"(i) the weights move one iteration by {effect} only"
    assert e1 < e0, f"(i) keyframe position RMS {e0} -> {e1}"
    return launches


def multichip_phase(device):
    """(j) The multi-chip dry run (parallel/dryrun.py, the JAX package's
    dryrun_multichip) on MULTICHIP_RANKS spawned ranks sharing the card
    over gloo, on the flagship map (MULTICHIP_SHAPE): both backends within
    0.02 m of the single-card optimizer and closer to the truth than the
    start, no overflow (dryrun_multichip's own checks, on every rank), the
    ranks bit-identical, K1-K3 launched on each rank (the spatial
    backend).  Prints the spatial backend's collectives per iteration.
    Returns the ranks' summed launches."""
    import torch

    from dmsa_lidar_slam_tpu_torch.parallel import dryrun, launch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.run_local_ranks(dryrun.dryrun_rank, MULTICHIP_RANKS, _build_dir("chip_smoke_multichip"),
                                   *MULTICHIP_SHAPE, device=device, timeout_s=MULTICHIP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    assert [r["mesh"] for r in ranks] == [(MULTICHIP_RANKS, k, "gloo") for k in range(MULTICHIP_RANKS)]
    same = all(torch.equal(r[k], ranks[0][k]) for r in ranks for k in ("params_hash", "params_spatial"))
    coll = ranks[0]["collectives"]
    out = {k: v for k, v in ranks[0].items() if not k.startswith("params_") and k not in ("collectives", "launches")}
    out.update(ranks_bit_identical=same, wall_s_with_start_up=wall, rank_wall_s=[r["wall_s"] for r in ranks],
               launches=[r["launches"] for r in ranks],
               iterations={k: c["iterations"] for k, c in coll.items()})
    print(f"  (j) dryrun_multichip, {MULTICHIP_RANKS} ranks " + json.dumps(out), flush=True)
    for name in ("spatial", "hash"):
        c = coll[name]
        it = max(c["iterations"], 1)
        print(f"  (j) {name} backend, collectives per iteration on rank 0 ({c['iterations']} iterations):", flush=True)
        for r in c["rows"]:
            print(f"    {r['primitive']:10s} {r['dtype']}[{'x'.join(map(str, r['shape']))}] "
                  f"{r['calls'] / it:g} per iteration, {r['bytes']:,} bytes each", flush=True)
        total = sum(r["calls"] * r["bytes"] for r in c["rows"]) / it
        print(f"    total {sum(r['calls'] for r in c['rows']) / it:g} calls, {total:,.0f} bytes per iteration; "
              f"set-up {[(r['primitive'], r['shape'], r['calls']) for r in c['setup']]}", flush=True)
    assert same, "(j) the ranks' parameters differ"
    total = {}
    for r in ranks:
        _k123_launched(r["launches"], f"on rank {r['mesh'][1]} in (j)")
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # the SM clock's maximum, to turn a kernel's time into a share of the
    # card's issue rate
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"SM clock max, now: {clocks}", flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {cuda_lib.BUILD_SECONDS} s) "
          f"-> {cuda_lib.library_path()}", flush=True)

    def phase(title, fn, *args):
        print(title, flush=True)
        t = time.perf_counter()
        out = fn(*args)
        print(f"  ({time.perf_counter() - t:.1f} s)", flush=True)
        return out

    results, calls = phase("kernels vs plain versions:", kernel_checks, device)
    seq, data = bench_data(N_SCANS)
    ckpt = os.path.join(_build_dir("chip_smoke_fused_ck"), "fused.npz")
    paths = {}
    full, paths["fused"] = phase("main path, fused pipeline:", pipeline_run, device, seq, data, ckpt)
    paths["fused_resumed"] = phase(f"(b) fused pipeline resumed from its checkpoint at scan {SAVE_AT}:",
                                   fused_resume, device, seq, data, full, ckpt)
    phase("(d) the fused trajectory through the evaluate CLI:", evaluate_phase, full, seq)
    del full
    paths["host"] = phase("main path, host pipeline (CLI runner):", host_run, device)
    paths["host_resumed"] = phase(f"(c) host pipeline resumed from its checkpoint at scan {HOST_SAVE_AT}:",
                                  host_resume, device, data)
    phase("(e) two-scan alignment, autodiff optimizer path:", two_scan_phase, device)
    phase("(f) native PointCloud2 decode:", native_phase)
    paths["single_card_100kf"], paths["distributed"] = phase(
        "(g) the distributed keyframe adjustment (parallel/*):", dist_phase, device, ckpt, results, calls)
    paths["weighted"] = phase("(i) the weighted tabular optimize (K1's 12-row layout):", weighted_phase, device,
                              results, calls)
    paths["multichip"] = phase(f"(j) the multi-chip dry run, {MULTICHIP_RANKS} ranks on the one card over gloo:",
                               multichip_phase, device)
    t0 = time.perf_counter()
    long_seq, long_records = long_data()
    print(f"long_sequence({LONG_SEED}) data for (h) and (k): {time.perf_counter() - t0:.1f} s", flush=True)
    paths["long"] = phase(f"(h) the long configuration, {LONG_SCANS} scans of {LONG_PTS:,} points:", long_phase,
                          device, long_seq, long_records)
    paths["host_long"] = phase(f"(k) the host pipeline at the long configuration, {LONG_HOST_SCANS} scans:",
                               host_long_phase, device, long_seq, long_records)
    del long_records
    print("CUDA kernels per call (torch.profiler):", flush=True)
    for r, fn in zip(results, calls):
        device_ms, kernels = _profile(fn)
        r["device_ms"], r["device_launches"] = device_ms, sum(c for c, _ in kernels.values())
        print(f"  {r['name']:55s} kernels={r['device_launches']} device={device_ms:.4f} ms", flush=True)
    # after the per-call profiles: on an H100 the profiles taken after a
    # session this large (~10^5 kernels) lacked their card records
    # (PERF.md section 6)
    phase(f"(a) {TRACE_SCANS} fused window scans under traceutil.capture:", trace_phase, device, data, ckpt)
    for r in results:
        k = r.pop("counter", r["name"].split()[0])
        r["launches"] = sum(p[k] for p in paths.values())
        r["launches_by_path"] = {name: p[k] for name, p in paths.items()}
    print(f"script wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
