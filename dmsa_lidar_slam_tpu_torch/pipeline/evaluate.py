# Copy of dmsa_lidar_slam_tpu/pipeline/evaluate.py; only the CLI's module path differs.
"""Trajectory evaluation: ATE / RPE between TUM-format pose files.

The reference evaluates externally against dataset ground truth
(README.md:93-95); this makes the evaluation first-class: load two TUM
files (`stamp tx ty tz qx qy qz qw`), associate by timestamp, align SE(3)
(Umeyama, no scale), report ATE RMSE and relative pose errors.

CLI:  python -m dmsa_lidar_slam_tpu_torch.pipeline.evaluate est.txt ref.txt
"""

import argparse
import json
from typing import Tuple

import numpy as np


def load_tum(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (stamps [N], positions [N,3], quaternions [N,4] xyzw)."""
    data = np.loadtxt(path, comments="#", ndmin=2)
    if data.shape[1] < 8:
        raise ValueError(f"{path}: expected TUM format with 8 columns")
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def associate(stamps_a, stamps_b, max_diff: float = 0.02):
    """Index pairs (ia, ib) with |t_a - t_b| <= max_diff, nearest match."""
    ib = np.searchsorted(stamps_b, stamps_a)
    ib = np.clip(ib, 0, len(stamps_b) - 1)
    ib_left = np.maximum(ib - 1, 0)
    use_left = np.abs(stamps_a - stamps_b[ib_left]) < np.abs(stamps_a - stamps_b[ib])
    ib = np.where(use_left, ib_left, ib)
    ok = np.abs(stamps_a - stamps_b[ib]) <= max_diff
    return np.nonzero(ok)[0], ib[ok]


def umeyama_align(src: np.ndarray, dst: np.ndarray):
    """Rigid (R, t) minimizing ||R src + t - dst||^2."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    return R, t


def ate(est_path: str, ref_path: str, max_diff: float = 0.02) -> dict:
    ts_e, p_e, _ = load_tum(est_path)
    ts_r, p_r, _ = load_tum(ref_path)
    ia, ib = associate(ts_e, ts_r, max_diff)
    if len(ia) < 3:
        raise ValueError(f"only {len(ia)} associated pairs")
    R, t = umeyama_align(p_e[ia], p_r[ib])
    aligned = p_e[ia] @ R.T + t
    err = np.linalg.norm(aligned - p_r[ib], axis=1)
    return {
        "pairs": int(len(ia)),
        "ate_rmse": float(np.sqrt(np.mean(err**2))),
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
        "ate_max": float(err.max()),
    }


def rpe(est_path: str, ref_path: str, delta: int = 1, max_diff: float = 0.02) -> dict:
    """Relative pose (translation) error over `delta`-frame intervals."""
    ts_e, p_e, _ = load_tum(est_path)
    ts_r, p_r, _ = load_tum(ref_path)
    ia, ib = associate(ts_e, ts_r, max_diff)
    if len(ia) < delta + 1:
        raise ValueError("too few pairs for RPE")
    d_e = np.linalg.norm(p_e[ia][delta:] - p_e[ia][:-delta], axis=1)
    d_r = np.linalg.norm(p_r[ib][delta:] - p_r[ib][:-delta], axis=1)
    err = np.abs(d_e - d_r)
    return {
        "pairs": int(len(d_e)),
        "rpe_rmse": float(np.sqrt(np.mean(err**2))),
        "rpe_mean": float(err.mean()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="TUM trajectory evaluation")
    ap.add_argument("est")
    ap.add_argument("ref")
    ap.add_argument("--max-diff", type=float, default=0.02)
    args = ap.parse_args(argv)
    out = ate(args.est, args.ref, args.max_diff)
    out.update(rpe(args.est, args.ref, max_diff=args.max_diff))
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
