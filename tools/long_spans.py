#!/usr/bin/env python3
"""The long configuration's keyframe record on a CUDA card, with the
keyframe normals from either branch of map/normals.py, and a fork of the
card's run onto the CPU from one saved state.

    python3 tools/long_spans.py [--normals radius|knn6] [--scans 310] [--priorities card|cpu]
    python3 tools/long_spans.py --priorities cpu --fork-at 197 --fork-scans 25

Runs FusedDmsaSlam(long_config()) on the card over chip_smoke.long_data
(long_sequence(3), 131,072 raw points over 128 rings, bench.py's
stressors).  --normals radius keeps the card's branch (K5's radius
moments); knn6 takes the normals from the 6-nearest-neighbour branch, the
one CPU runs of either package take, computed on a host copy of each cloud.
The normals feed the static points' visibility test and so the submap's
related keyframes.  --priorities cpu draws every step's priorities as a
CPU run of the port does (draw_priorities(seed, shapes, "cpu"), the same
pack seeds) and moves them to the card; card (the default) draws them on
the card.

Each step's keyframe-map decision is recorded by chip_smoke.StepRecorder
(the ring count, the candidates and their overlap counts, min_related,
min_related_adj, run_submap, the span, and why a keyframe step ran no
submap solve).

Without --fork-at: one JSON line with ATE, keyframes, retired,
chip_smoke.span_summary, each keyframe step's span from scan 150 on and the
keyframe steps' records from the first retirement on.

With --fork-at K --fork-scans N: the card runs to scan K, saves a
checkpoint (pipeline/checkpoint.save_fused_checkpoint) under
build/long_spans/, and runs N more scans.  The same checkpoint then loads
into FusedDmsaSlam(long_config(), device="cpu") (the plain versions, the
CPU's 6-NN normals), which runs the same N scans with the same priorities.
Prints both records step by step ("fork step" lines), the first step whose
decision differs and the first whose overlap counts differ.  If the
decisions differ, the card's half runs again from
the checkpoint once for each plain version put in place of the card's
(k4: nn_bruteforce.min_sq_dist_ref; k5: the 6-NN normals; k1, k2, k3:
build_packed_ref, gn_system_ref, cand_errors_ref; all: every one of them),
each printed with its first differing step against the CPU's record.  The
last line is one JSON summary.
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SUBSTITUTIONS = ("k4", "k5", "k1", "k2", "k3", "all")


@contextlib.contextmanager
def plain(names):
    """The plain versions of the named kernels in place of the card's while
    the context is open (k5: the CPU's 6-NN normal branch on a host copy of
    each cloud)."""
    import torch

    from dmsa_lidar_slam_tpu_torch.map import normals as nrm
    from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
    from dmsa_lidar_slam_tpu_torch.ops import nn_bruteforce as nb

    names = set(SUBSTITUTIONS[:-1]) if "all" in names else set(names)
    saved = []

    def put(mod, attr, fn):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    if "k4" in names:
        put(nb, "min_sq_dist", nb.min_sq_dist_ref)
    if "k5" in names:
        card_normals = nrm.estimate_normals

        def host_knn_normals(points, mask, grid_size, viewpoint=None):
            host = [x.cpu() if torch.is_tensor(x) else x for x in (points, mask, grid_size, viewpoint)]
            return card_normals(*host).to(points.device)

        put(nrm, "estimate_normals", host_knn_normals)
    if "k1" in names:
        put(fr, "build_packed", fr.build_packed_ref)
    if "k2" in names:
        put(fr, "gn_system", lambda tab, dtabs, packed, max_cells=None:
            fr.gn_system_ref(tab, dtabs, packed, include_mean_term=False))
    if "k3" in names:
        put(fr, "cand_errors", fr.cand_errors_ref)
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def run_records(slam, data, recorder):
    """Feed `data` to `slam` with `recorder` installed; the records of the
    steps that ran, by step."""
    from chip_smoke import feed

    out = {}
    with recorder.installed():
        for rec in data:
            stepped = slam.scan_counter
            feed(slam, [rec])
            if slam.scan_counter > stepped:
                r = recorder.collect(slam, stepped)
                if r is not None:
                    out[stepped] = r
    return out


def first_difference(a, b, keys):
    """The first step (of those both records hold) whose `keys` differ."""
    for step in sorted(set(a) & set(b)):
        if any(a[step][k] != b[step][k] for k in keys):
            return step
    return None


def summary(records):
    kf = {s: r for s, r in records.items() if r["keyframe"]}
    return dict(keyframe_steps=len(kf), submap_solves=sum(r["run_submap"] for r in kf.values()),
                skips={s: r["skip"] for s, r in kf.items() if not r["run_submap"]},
                first_retirement_step=next((s for s, r in sorted(kf.items()) if r["full"]), None))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--normals", choices=["radius", "knn6"], default="radius")
    ap.add_argument("--scans", type=int, default=310)
    ap.add_argument("--priorities", choices=["card", "cpu"], default="card")
    ap.add_argument("--fork-at", type=int, default=None)
    ap.add_argument("--fork-scans", type=int, default=25)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("long_spans: needs a CUDA card")
    from chip_smoke import StepRecorder, feed, long_data, record_step, span_summary
    from dmsa_lidar_slam_tpu_torch.io.synthetic import ate_rmse, long_config
    from dmsa_lidar_slam_tpu_torch.pipeline.checkpoint import load_fused_checkpoint, save_fused_checkpoint
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam, StepPriorities, draw_priorities

    dev = torch.device("cuda", 0)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(smi, flush=True)

    def card_slam():
        slam = FusedDmsaSlam(long_config(), flush_every=20, device=dev)
        if args.priorities == "cpu":
            slam.priorities = lambda seed: StepPriorities(
                *(p.to(dev) for p in draw_priorities(seed, slam.shapes, "cpu")))
        return slam

    normals = plain(["k5"]) if args.normals == "knn6" else contextlib.nullcontext()
    if args.fork_at is None:
        seq, data = long_data(args.scans)
        slam = card_slam()
        spans, retired_at = {}, []
        recorder = StepRecorder()
        t0 = time.perf_counter()
        with normals, recorder.installed():
            for rec in data:
                stepped = slam.scan_counter
                feed(slam, [rec])
                if slam.scan_counter > stepped:
                    record_step(slam, stepped, spans, retired_at)
                    recorder.collect(slam, stepped)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st, tr, _ = slam.all_poses()
        first_ret = retired_at[0] if retired_at else None
        print(json.dumps(dict(
            normals=args.normals, priorities=args.priorities, scans=args.scans,
            device=torch.cuda.get_device_name(0), wall_s=wall,
            ate_m=ate_rmse(st, tr, seq), keyframes=slam.kf_count, max_submap_span=slam.max_submap_span,
            retired=slam.output.num_static_keyframes, **span_summary(spans, retired_at),
            spans_from_150=[(k, v) for k, v in sorted(spans.items()) if k >= 150],
            keyframe_records_from_first_retirement=[
                r for s, r in sorted(recorder.records.items())
                if r["keyframe"] and first_ret is not None and s >= first_ret],
        )), flush=True)
        return

    K, N = args.fork_at, args.fork_scans
    seq, data = long_data(K + N)
    ck_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "long_spans")
    shutil.rmtree(ck_dir, ignore_errors=True)
    os.makedirs(ck_dir)
    ckpt = os.path.join(ck_dir, f"fork_{K}.npz")
    t0 = time.perf_counter()
    with normals:
        slam = card_slam()
        pre = run_records(slam, data[:K], StepRecorder())
        save_fused_checkpoint(slam, ckpt)
        t_card = time.perf_counter()
        card = run_records(slam, data[K:], StepRecorder())
        torch.cuda.synchronize()
        card_wall = time.perf_counter() - t_card
    st, tr, _ = slam.all_poses()
    card_ate = ate_rmse(st, tr, seq)
    t_cpu = time.perf_counter()
    cpu_slam = load_fused_checkpoint(FusedDmsaSlam(long_config(), flush_every=20, device="cpu"), ckpt)
    cpu = run_records(cpu_slam, data[K:], StepRecorder())
    cpu_wall = time.perf_counter() - t_cpu
    st, tr, _ = cpu_slam.all_poses()
    cpu_ate = ate_rmse(st, tr, seq)

    keys = StepRecorder.DECISION
    for s in sorted(set(card) | set(cpu)):
        print("fork step " + json.dumps(dict(step=s, card=card.get(s), cpu=cpu.get(s))), flush=True)
    diff = first_difference(card, cpu, keys)
    diff_overlap = first_difference(card, cpu, ("overlap",))
    print(f"first step whose decision differs: {diff}; whose overlap counts differ: {diff_overlap}", flush=True)

    subs = {}
    for name in SUBSTITUTIONS if diff is not None else ():
        t = time.perf_counter()
        with plain([name]):
            s_slam = load_fused_checkpoint(card_slam(), ckpt)
            rec = run_records(s_slam, data[K:], StepRecorder())
        d = first_difference(rec, cpu, keys)
        subs[name] = dict(first_difference=d, matches_cpu=d is None, wall_s=time.perf_counter() - t,
                          **summary(rec))
        print(f"substitution {name}: " + json.dumps(subs[name]), flush=True)
        for s in sorted(rec):
            if rec[s]["keyframe"]:
                print(f"  {name} keyframe step " + json.dumps(rec[s]), flush=True)

    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi, priorities=args.priorities, normals=args.normals,
        fork_at=K, fork_scans=N, wall_s=time.perf_counter() - t0, card_half_wall_s=card_wall,
        cpu_half_wall_s=cpu_wall, before_fork=summary(pre),
        before_fork_keyframe_steps=[(s, r["span"], r["count"]) for s, r in sorted(pre.items()) if r["keyframe"]][-6:],
        card=summary(card), cpu=summary(cpu), card_ate_m=card_ate, cpu_ate_m=cpu_ate,
        first_decision_difference=diff, first_overlap_difference=diff_overlap, substitutions=subs,
    )), flush=True)


if __name__ == "__main__":
    main()
