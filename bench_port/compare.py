"""What decides `correct`: the program's steps held against the plain
reference (bench_port/reference), step by step, and the program's
trajectory held against the stream's analytic poses.

For each checked step the reference starts from the program's state
before it (read from FusedDmsaSlam.state between two scans), works out
again the step's inputs (the wire pack, the aux block and the priorities,
from the stream) and the step itself, and its results are set beside the
program's state after the step.  The numbers compared, each the largest
over the checked steps:

  restore         leaves of the state a pass starts from that differ from
                  the state saved in set-up (exact);
  ring            the preprocessed scan ring's mask, rings and scan count:
                  entries that differ (exact);
  ring_m          the ring's points, largest gap, m (exact);
  decisions       steps whose event type, keyframe count or keyframe
                  updates differ (exact);
  window_m/_rad   the window optimiser's control poses (ow_transl,
                  ow_orient), largest gap;
  keyframe_m      the active keyframes' positions after the step, the
                  submap solve's write-back included, largest gap, m;
  normals         K5: on a step that adds a keyframe, the share of the new
                  keyframe's valid points whose normal lies more than
                  NORMAL_TOL from the reference's normal on the same points
                  and radius, as 1 - |n . n_ref| (a normal's sign is a
                  convention);
  static          K4's static selection, through the step's event row: the
                  larger of the overlap fraction's gap and the relative gap
                  of the number of static points;
  ate_m           the trajectory the program outputs (FusedDmsaSlam.all_poses)
                  over the warm-up and the window's first pass, against
                  the stream's analytic positions after a rigid alignment:
                  RMSE, m.  It reads the program's outputs alone, so it
                  witnesses what the step-by-step check cannot: error that
                  builds up over many steps.

Read and printed, not compared: keyframe_rad, the keyframes' orientations'
largest gap.  No limit separates it: the program's rounding reads as much
as the control or a write-back left out (PERF.md); a solve's fault shows
in keyframe_m.

Each mix's file (bench_port/traffic/<mix>.json) holds the limits; PERF.md
gives the readings they were set from.
"""

import numpy as np
import torch

# the numbers compared; each mix's file gives their limits ("limits"), the
# exact ones 0
COMPARED = ("restore", "ring", "ring_m", "decisions", "window_m", "window_rad", "keyframe_m", "normals", "static",
            "ate_m")
NORMAL_TOL = 0.01  # 1 - |cos|: about 8 degrees
EV_OVERLAP, EV_NUM_STATIC = 15, 18  # the event row's overlap fraction and static point count


def _leaves(state):
    out = []
    for v in state:
        if isinstance(v, tuple):
            out.extend(_leaves(v))
        else:
            out.append(v)
    return out


def restore_diff(start, saved):
    """Leaves of `start` that differ from `saved` (two program states)."""
    return sum(not torch.equal(a, b) for a, b in zip(_leaves(start), _leaves(saved)))


def _gap(a, b):
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def new_keyframe(before, after):
    """The slot of the keyframe a step added, or None."""
    if int(after.kf.num_updates) == int(before.kf.num_updates):
        return None
    return int(after.kf.count) - 1


def keyframe_cloud(state, slot):
    """(local points, mask, grid size) of a keyframe, the inputs of its
    normals."""
    kf = state.kf
    return kf.local_pts[slot], kf.pt_mask[slot], kf.grid_size[slot]


def normals_share(normals, ref_normals, mask):
    """Share of the valid points whose normals differ by more than
    NORMAL_TOL in 1 - |cos|."""
    if not bool(mask.any()):
        return 0.0
    a = normals[mask].to(torch.float64)
    b = ref_normals[mask].to(torch.float64)
    cos = torch.sum(a * b, dim=1) / torch.clamp(a.norm(dim=1) * b.norm(dim=1), min=1e-30)
    return float(((1.0 - cos.abs()) > NORMAL_TOL).to(torch.float64).mean())


def step_numbers(after, ref_after, normals=0.0):
    """The numbers of one step: the program's (or the control's) state
    after it against the reference's.  `normals`: the step's K5 reading
    (normals_share), 0 where it added no keyframe."""
    ring = (int((after.scan_mask != ref_after.scan_mask).sum()) + int((after.scan_rings != ref_after.scan_rings).sum())
            + int((after.num_scans != ref_after.num_scans).sum()))
    ev_i = (int(after.ev_index) - 1) % after.events.shape[0]
    ev, rev = after.events[ev_i].to(torch.float64), ref_after.events[ev_i].to(torch.float64)
    kf, rkf = after.kf, ref_after.kf
    decisions = int(ev[0] != rev[0]) + int(kf.count != rkf.count) + int(kf.num_updates != rkf.num_updates)
    n = int(min(int(kf.count), int(rkf.count)))
    static = max(float((ev[EV_OVERLAP] - rev[EV_OVERLAP]).abs()),
                 float((ev[EV_NUM_STATIC] - rev[EV_NUM_STATIC]).abs() / max(float(rev[EV_NUM_STATIC]), 1.0)))
    return dict(
        ring=ring,
        ring_m=_gap(after.scan_pts, ref_after.scan_pts),
        decisions=decisions,
        window_m=_gap(after.ow_transl, ref_after.ow_transl),
        window_rad=_gap(after.ow_orient, ref_after.ow_orient),
        keyframe_m=_gap(kf.transl_w[:n], rkf.transl_w[:n]),
        keyframe_rad=_gap(kf.orient_w[:n], rkf.orient_w[:n]),
        normals=float(normals),
        static=static,
    )


def ate_m(stamps, positions, truth):
    """RMSE of `positions` [n, 3] against truth.pose(stamp).position after
    a rigid (rotation and translation, no scale) Umeyama alignment: the
    estimator's frame is anchored at its unknown starting pose.  A copy of
    the arithmetic of the port's io/synthetic.py ate_rmse."""
    est = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    if len(est) < 3:
        return float("nan")
    gt = np.asarray([truth.pose(float(s)).position for s in stamps], dtype=np.float64)
    mu_e, mu_g = est.mean(axis=0), gt.mean(axis=0)
    U, _, Vt = np.linalg.svd((est - mu_e).T @ (gt - mu_g))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    est = (est - mu_e) @ R.T + mu_g
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def merge(rows):
    """The largest of each number over the checked steps; a NaN stays."""
    out = {}
    for r in rows:
        for k, v in r.items():
            prev, v = out.get(k), float(v)
            if prev is None or np.isnan(v) or (not np.isnan(prev) and v > prev):
                out[k] = v
    return out


def verdict(numbers, limits):
    """(correct, [[name, value, limit], ...]) over the compared numbers."""
    checks = [[k, float(numbers[k]), float(limits[k])] for k in COMPARED if k in numbers]
    ok = len(checks) == len(COMPARED) and all(np.isfinite(v) and v <= lim for _, v, lim in checks)
    return ok, checks
