"""One run of one cell: set-up, the measured window, the traced scans, and
the check that decides `correct`.

A cell `<config>.<mix>` is found by its name in BENCHMARK.json: the
configuration's file (bench_port/configs/<config>.json: the stream's width,
the pipeline's keys, and the sensor rig that generator.rig reads from both)
and the mix's (bench_port/traffic/<mix>.json: the trajectory, stressors,
warm-up, segment and checks).  Per-layer metrics are read by
bench_port/metrics/<metric>.py, one reader each.

The program is driven as the CLI runner drives it (pipeline/runner.py,
the fused default): FusedDmsaSlam.process_imu_batch, then process_scan,
each scan fed once the one before has ended in torch.cuda.synchronize().
Set-up builds or loads the kernels, generates the stream from the seed,
feeds the warm-up scans, saves a checkpoint, feeds the first scans of the
segment (so that every path the window takes has run once) and restores
the checkpoint.  The window replays the segment, restoring the checkpoint
after each pass, until its seconds have passed; the scan that is running
then completes and counts.

The check reads only what the wrapper exposes: FusedDmsaSlam.state between
two scans (the state each checked step starts from and ends in), and the
trajectory it outputs (all_poses) at the end of the first pass.
"""

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dmsa_lidar_slam_tpu")
SWEEP_S = 0.1


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ------------------------------------------------------------------- cells
def load_manifest(root):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(root, name):
    """(workload entry, configuration file, traffic file, manifest)."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(Path(root) / cfg_entry["file"]) as f:
        cfg = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, cfg, traffic, manifest


def metrics_for(manifest, cell_name, kind):
    """The manifest's metrics of `kind` ("end_to_end" / "per_layer") that
    this cell reports."""
    return [m for m in manifest[kind] if cell_name in m.get("workloads", [cell_name])]


def read_metric(name, run):
    """The metric's own reader, bench_port/metrics/<name>.py: read(run) ->
    a number, or None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


# ------------------------------------------------------------ arithmetic
def quantile(values, q):
    """The q-quantile of `values`, linear between order statistics
    (numpy's default)."""
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def realtime_x(n_scans, window_s):
    """Sensor seconds of the scans completed over the window's wall."""
    return n_scans * SWEEP_S / window_s


# ------------------------------------------------------------- recording
def feed(slam, rec):
    pts, stamps, rings, ts, acc, gyr = rec
    slam.process_imu_batch(acc, gyr, ts)
    slam.process_scan(pts, stamps, rings)


def feed_recorded(slam, rec, records, tag):
    """feed, keeping under `tag` the program's state before and after the
    step the scan dispatched (the reference's host half knows which scans
    the wrapper only buffers).  The state is functional (every step returns
    new tensors), so a reference is a snapshot."""
    before = slam.state
    feed(slam, rec)
    if tag is not None:
        records[tag] = dict(before=before, after=slam.state)


def to_host(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_host(v) for v in x])
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


# ------------------------------------------------------------------- run
def run_cell(root, name, seed, seconds, trace, device="cuda", t_start=None, fault=None, loaded=None, control=None):
    """One run; returns (the result line's dict, extras: the compared
    numbers and the run's own readings).  For the tests: `loaded` replaces
    load_cell's files, and `fault(slam)`, called once the program is
    built, returns a callable that breaks it once set-up is done.
    With `control` (a pose dtype) extras also hold the control's numbers
    and the planted faults' (judge)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, traffic, manifest = loaded or load_cell(root, name)
    import torch

    from dmsa_lidar_slam_tpu_torch.config import Config
    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as program_fr
    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import load_fused_checkpoint, save_fused_checkpoint
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

    from bench_port import generator
    from bench_port import tracing

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    st = cfg["stream"]
    seg_lo, seg_hi = traffic["segment"]
    warm = traffic["warmup_scans"]
    prewarm = min(traffic.get("prewarm_scans", 0), seg_hi - seg_lo)
    rig = generator.rig(cfg)
    t_gen = time.perf_counter()
    data = generator.stream(seed, traffic["sequence"], seg_hi, st["points_per_scan"], st["rings"], st["imu_rate_hz"],
                            traffic.get("stressors", {}), rig=rig)
    gen_s = time.perf_counter() - t_gen

    pipeline = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg["pipeline"].items()}
    slam = FusedDmsaSlam(Config(**pipeline), device=dev)
    arm = fault(slam) if fault is not None else None
    records = {}
    for i in range(warm):
        feed_recorded(slam, data[i], records, ("warm", i))
    sync()
    tmp = tempfile.TemporaryDirectory(prefix="bench_port_")
    ckpt = os.path.join(tmp.name, "segment_start.npz")
    save_fused_checkpoint(slam, ckpt)
    saved_state = slam.state
    for i in range(seg_lo, seg_lo + prewarm):
        feed(slam, data[i])
    sync()
    t_r = time.perf_counter()
    load_fused_checkpoint(slam, ckpt)
    sync()
    log(f"bench_port: restore {1e3 * (time.perf_counter() - t_r):.3f} ms (in set-up)")
    if arm is not None:
        arm()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    slam.metrics.reset_stages()
    gc.collect()
    setup_s = time.perf_counter() - t_start

    # ---------------------------------------------------------- window
    scan_s, is_kf, restore_s = [], [], []
    passes = 0
    trajectory = None
    t_win = time.perf_counter()
    deadline = t_win + seconds
    done = False
    while not done:
        passes += 1
        for i in range(seg_lo, seg_hi):
            kf0 = slam.state.kf.num_updates
            t0 = time.perf_counter()
            feed_recorded(slam, data[i], records, (passes, i) if passes == 1 or i == seg_lo else None)
            sync()
            t1 = time.perf_counter()
            scan_s.append(t1 - t0)
            is_kf.append(bool(slam.state.kf.num_updates != kf0))
            if t1 >= deadline:
                done = True
                break
        if passes == 1:
            trajectory = slam.all_poses()
        if not done:
            t0 = time.perf_counter()
            load_fused_checkpoint(slam, ckpt)
            sync()
            restore_s.append(time.perf_counter() - t0)
    window_s = time.perf_counter() - t_win
    stages = slam.metrics.summary()
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    log(f"bench_port: {len(scan_s)} scans in {window_s:.3f} s over {passes} passes; restores "
        + ", ".join(f"{1e3 * s:.3f}" for s in restore_s) + " ms")

    # ------------------------------------------------------------ trace
    run = dict(cell=cell, scan_s=scan_s, is_kf=is_kf, window_s=window_s, stages=stages, profile=None,
               rooflines=None, passes=passes)
    profiled = None
    if trace:
        profiled = profile_scans(slam, ckpt, data, traffic, seg_lo, is_kf, program_fr, load_fused_checkpoint, sync,
                                 tracing)
        run["profile"], run["rooflines"] = profiled

    # ---------------------------------------------------------- correct
    # the checked steps move to the host and the program's state is freed
    # before the reference runs on the card
    restore, kept = pick(records, saved_state, traffic, seed)
    del slam, records, saved_state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, checked, *ctl = judge(kept, restore, cfg, traffic, data, dev, sync, control=control)
    tmp.cleanup()
    from bench_port import compare

    truth = generator.truth(traffic["sequence"], rig)
    stamps, positions = np.asarray(trajectory[0], dtype=np.float64), np.asarray(trajectory[1], dtype=np.float64)
    numbers["ate_m"] = compare.ate_m(stamps, positions, truth)

    e2e = {m["name"]: m for m in metrics_for(manifest, name, "end_to_end")}
    values = dict(realtime_x=realtime_x(len(scan_s), window_s), scan_ms_p90=1e3 * quantile(scan_s, 0.9),
                  setup_s=setup_s)
    result = dict(correct=False, attempted=len(scan_s), failed=0, metrics={}, device=device_info(dev))
    if trace:
        for m in metrics_for(manifest, name, "per_layer"):
            v = read_metric(m["name"], run)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        prof = run["profile"]
        if prof is not None:
            result["device"].update(busy_s=prof["busy_s"], window_s=prof["wall_s"])
            result["breakdown"] = dict(device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
    else:
        for k, m in e2e.items():
            result["metrics"][k] = {"value": float(values[k]), "unit": m["unit"]}
    ok, checks = compare.verdict(numbers, traffic["limits"])
    result["correct"] = bool(ok)
    result["checks"] = checks
    extras = dict(gen_s=gen_s, passes=passes, restore_ms=[1e3 * s for s in restore_s], checked_steps=checked,
                  numbers=numbers, window_s=window_s, keyframe_scans=int(sum(is_kf)), poses=len(stamps))
    if ctl:
        ctl_numbers, fault_numbers = ctl[0]
        ctl_numbers["ate_m"] = numbers["ate_m"]  # the control replaces single steps; the trajectory is the program's
        # a trajectory that stops where the segment starts: the program's poses
        # from then on replaced by its last pose before
        seg_t0 = float(np.min(data[seg_lo][1]))
        frozen = positions.copy()
        before_seg = np.nonzero(stamps < seg_t0)[0]
        if len(before_seg):
            frozen[stamps >= seg_t0] = positions[before_seg[-1]]
        fault_numbers["ate_m"] = compare.ate_m(stamps, frozen, truth)
        extras.update(control_numbers=ctl_numbers, fault_numbers=fault_numbers)
    return result, extras


def device_info(dev):
    import torch

    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))


def profile_scans(slam, ckpt, data, traffic, seg_lo, is_kf, fr_module, load_ckpt, sync, tracing):
    """Profile the traffic's scans under torch.profiler: in a loop mix the
    first keyframe scan of the window's first pass and the scans after it,
    else the segment's first scans.  The checkpoint is restored and the
    scans before them replayed unprofiled.  Returns (summary, (K1 bound s,
    K2 bound s)) or (None, None) when nothing is profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    want = traffic.get("profile", {})
    n_prof = want.get("keyframe", 0) + want.get("window", 0)
    if n_prof <= 0:
        return None, None
    seg_hi = traffic["segment"][1]
    first = seg_lo
    if want.get("keyframe", 0):
        kf_idx = [seg_lo + j for j, k in enumerate(is_kf[: seg_hi - seg_lo]) if k]
        if kf_idx:
            first = kf_idx[0]
    first = min(first, seg_hi - n_prof)
    load_ckpt(slam, ckpt)
    for i in range(seg_lo, first):
        feed(slam, data[i])
    sync()
    calls = tracing.KernelCalls(fr_module)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with calls.installed():
        calls.on = True
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(first, first + n_prof):
                feed(slam, data[i])
                sync()
            wall = time.perf_counter() - t0
        calls.on = False
    t_read = time.perf_counter()
    summary = tracing.summarize(prof.profiler.kineto_results.events(), n_prof, wall)
    summary["scans_profiled"] = [first, first + n_prof]
    bounds = calls.bounds()
    log(f"bench_port: profiled scans {first}-{first + n_prof - 1} in {wall:.3f} s, read in "
        f"{time.perf_counter() - t_read:.3f} s")
    return summary, bounds


def pick(records, saved_state, traffic, seed):
    """(restore, kept): the leaves that differ between the state a pass
    starts from and the one saved in set-up (the largest over the passes),
    and the checked steps' records on the host: a sample of the window's
    first pass drawn from the seed (the traffic's "check" counts, uniform
    and among the steps that added a keyframe) and the map's
    initialisation from the warm-up."""
    from bench_port import compare

    seg_lo = traffic["segment"][0]
    # the state each pass starts from against the one saved in set-up
    restore = max([compare.restore_diff(r["before"], saved_state) for (p, i), r in records.items()
                   if p != "warm" and i == seg_lo] or [0])
    first = sorted(i for (p, i) in records if p == 1)
    kf = [i for i in first if int(records[(1, i)]["after"].kf.num_updates) > int(records[(1, i)]["before"].kf.num_updates)]
    rng = np.random.default_rng([seed, 0x5EED])
    want = traffic["check"]
    picks = list(rng.choice(first, size=min(want["uniform"], len(first)), replace=False)) if first else []
    rest = [i for i in kf if i not in picks]
    picks += list(rng.choice(rest, size=min(want["keyframe"], len(rest)), replace=False)) if rest else []
    chosen = [(1, int(i)) for i in sorted(picks)]
    # the map's initialisation, a branch of its own, from the warm-up
    inits = [k for k, r in records.items() if k[0] == "warm" and int(r["before"].kf.count) == 0
             and int(r["after"].kf.count) == 1]
    chosen = inits[:1] + chosen
    kept = {k: to_host(records[k]) for k in chosen}
    records.clear()
    return restore, kept


def judge(kept, restore, cfg, traffic, data, dev, sync, control=None):
    """(numbers, checked steps): the compared numbers of the kept steps
    (compare.py).  With `control` (a pose dtype) also (the control's
    numbers, the planted faults' numbers): the control is the reference
    computed in that dtype, with TF32 matmuls, in the program's place, from
    the same states and inputs; the faults are the reference with its
    submap write-back left out (keyframe poses written back unmoved) and
    K5's normals taken over half the radius."""
    import torch

    from bench_port import compare
    from bench_port.reference import Reference
    from bench_port.reference.map import device_map as ref_dmap

    seg_hi = traffic["segment"][1]
    t_judge = time.perf_counter()
    ref = Reference(cfg["pipeline"], dev)
    host = ref.host()
    inputs = {}
    for i in range(seg_hi):
        pts, stamps, rings, ts, acc, gyr = data[i]
        host.imu_batch(acc, gyr, ts)
        out = host.scan(pts, stamps, rings)
        if out is not None:
            inputs[i] = out
    ctl = None if control is None else Reference(cfg["pipeline"], dev, pdt=control)

    def normals(reference, before, after, radius_scale=1.0):
        slot = compare.new_keyframe(before, after)
        if slot is None:
            return 0.0
        pts, mask, grid = compare.keyframe_cloud(after, slot)
        ref_n = ref.normals(pts, mask, grid)
        got = after.kf.local_normals[slot] if reference is None else reference.normals(pts, mask, grid, radius_scale)
        return compare.normals_share(got.to(dev), ref_n, mask.to(dev))

    rows, ctl_rows, fault_rows = [], [], []
    for key, r in kept.items():
        pack, aux, step_seed = inputs[key[1]]
        before, after = r["before"], to_dev(r["after"], dev)
        ref_after = ref.run(before, pack, aux, step_seed)
        rows.append(compare.step_numbers(after, ref_after, normals(None, before, after)))
        if ctl is not None:
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ctl_after = ctl.run(before, pack, aux, step_seed)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
            ctl_rows.append(compare.step_numbers(ctl_after, ref_after, normals(None, before, ctl_after)))
            write_back = ref_dmap.write_back_capped
            ref_dmap.write_back_capped = lambda kf, from_id, params: kf
            try:
                unmoved = ref.run(before, pack, aux, step_seed)
            finally:
                ref_dmap.write_back_capped = write_back
            row = compare.step_numbers(unmoved, ref_after)
            fault_rows.append(dict(keyframe_m=row["keyframe_m"], keyframe_rad=row["keyframe_rad"],
                                   normals=normals(ref, before, after, radius_scale=0.5)))
        sync()
    numbers = compare.merge(rows)
    numbers["restore"] = float(restore)
    log(f"bench_port: judged {len(rows)} steps in {time.perf_counter() - t_judge:.3f} s")
    checked = [list(map(str, k)) for k in kept]
    if ctl is None:
        return numbers, checked
    ctl_numbers = compare.merge(ctl_rows)
    ctl_numbers["restore"] = 0.0
    return numbers, checked, (ctl_numbers, compare.merge(fault_rows))


def to_dev(x, dev):
    import torch

    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return type(x)(*[to_dev(v, dev) for v in x])


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"
