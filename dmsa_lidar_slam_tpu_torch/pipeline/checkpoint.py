"""Checkpoint / resume of the full SLAM state (counterpart of
dmsa_lidar_slam_tpu/pipeline/checkpoint.py).

The complete estimator state (keyframe map, output ledger, previous-window
poses, scan and IMU buffers, counters) serializes to a single .npz, so a
run can resume exactly where it stopped.  The files are the reference's:
the same version, .npz keys and `meta` JSON, so a checkpoint written by
either package loads into the other.

  - save_checkpoint / load_checkpoint: pipeline.slam.DmsaSlam, whose state
    is numpy on the host, as the reference's;
  - save_fused_checkpoint / load_fused_checkpoint: pipeline.fused.
    FusedDmsaSlam.  The device state goes in as leaf{i} in the order
    jax.tree.flatten gives the reference's FusedState
    (convert.state_leaves), and comes back onto the resumed object's own
    device.

Both pipelines draw their priorities from a torch.Generator seeded with a
counter that the checkpoint carries (the fused pack seed is scan_counter +
1, DmsaSlam's _prng_counter), so a resumed run draws exactly what the run
it was saved from would have drawn.
"""

import json
import os

import numpy as np

from dmsa_lidar_slam_tpu_torch.imu.buffer import BIAS_ESTIMATION_SAMPLES

# v2: fused checkpoints carry stamp_base + meaningful device stamps
# (kf_stamp_queue removed); v1 fused checkpoints are rejected on load.
CHECKPOINT_VERSION = 3  # event ledger width 24 -> 25 (shuffle overflow)


def _stack(rows):
    return np.stack(rows) if rows else np.zeros((0, 3))


def _output_arrays(out) -> dict:
    """The output ledger's arrays (out_* keys)."""
    return {
        "out_order_is_key": np.asarray(out.order_is_key, dtype=bool),
        "out_static_stamps": np.asarray([s for s, _, _ in out.static_keyframes]),
        "out_static_transl": _stack([t for _, t, _ in out.static_keyframes]),
        "out_static_orient": _stack([o for _, _, o in out.static_keyframes]),
        "out_nk_transl": _stack([nk.transl for nk in out.non_keyframes]),
        "out_nk_orient": _stack([nk.orient for nk in out.non_keyframes]),
        "out_nk_stamp": np.asarray([nk.stamp for nk in out.non_keyframes]),
        "out_nk_rel": np.asarray([nk.relative for nk in out.non_keyframes], dtype=bool),
        "out_nk_kfid": np.asarray([nk.related_keyframe_id for nk in out.non_keyframes], dtype=np.int64),
    }


def _restore_output(out, z):
    from dmsa_lidar_slam_tpu_torch.pipeline.output import _NonKeyframePose

    out.order_is_key = [bool(v) for v in z["out_order_is_key"]]
    out.static_keyframes = [
        (float(s), t.copy(), o.copy())
        for s, t, o in zip(z["out_static_stamps"], z["out_static_transl"], z["out_static_orient"])
    ]
    out.non_keyframes = []
    for t, o, s, rel, kid in zip(
        z["out_nk_transl"], z["out_nk_orient"], z["out_nk_stamp"], z["out_nk_rel"], z["out_nk_kfid"]
    ):
        nk = _NonKeyframePose(t, o, float(s), int(kid))
        nk.relative = bool(rel)
        out.non_keyframes.append(nk)


def _imu_arrays(buf) -> dict:
    return {"imu_acc": buf.acc, "imu_gyr": buf.gyr, "imu_stamps": buf.stamps, "imu_bias": buf.bias_gyr}


def _restore_imu(buf, z, meta):
    buf.acc[...] = z["imu_acc"]
    buf.gyr[...] = z["imu_gyr"]
    buf.stamps[...] = z["imu_stamps"]
    buf.bias_gyr[...] = z["imu_bias"]
    buf.next_idx = meta["imu_next_idx"]
    buf.num_updates = meta["imu_num_updates"]
    if buf.num_updates >= BIAS_ESTIMATION_SAMPLES:
        # static-start mean acc (gravity init) is derivable from the stored
        # ring: the first 50 samples sit at the buffer head until wrap (and
        # after a wrap the value is no longer consulted)
        buf.acc_init = buf.acc[:BIAS_ESTIMATION_SAMPLES].mean(axis=0)


def _buffered_arrays(buffered) -> dict:
    if buffered is None:
        return {}
    p, s, r = buffered
    return {"buffered_points": p, "buffered_stamps": s, "buffered_rings": r}


def _write(path, meta, arrays):
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, meta=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def _read(path):
    z = np.load(path, allow_pickle=False)
    return z, json.loads(str(z["meta"]))


_KF_KEYS = [
    ("kf_local_pts", "local_pts"),
    ("kf_local_normals", "local_normals"),
    ("kf_pt_mask", "pt_mask"),
    ("kf_pt_ring", "pt_ring"),
    ("kf_grid_size", "grid_size"),
    ("kf_orient_w", "orient_w"),
    ("kf_transl_w", "transl_w"),
    ("kf_stamps", "stamps"),
    ("kf_grav_meas", "grav_meas"),
    ("kf_grav_plausible", "grav_plausible"),
    ("kf_odom_rel_orient", "odom_rel_orient"),
    ("kf_odom_rel_transl", "odom_rel_transl"),
]


def save_checkpoint(slam, path: str):
    """Serialize a pipeline.slam.DmsaSlam to `path` (.npz)."""
    kf = slam.kf_map
    arrays = {key: getattr(kf, attr) for key, attr in _KF_KEYS}
    arrays.update(_imu_arrays(slam.imu_buffer))
    arrays.update(_output_arrays(slam.output))
    if slam.old_window is not None:
        ow = slam.old_window
        arrays.update(
            ow_orient=ow.orient_w,
            ow_transl=ow.transl_w,
            ow_stamps=ow.ctrl_stamps,
            ow_scalars=np.asarray([ow.t0, ow.horizon]),
        )
    # scan buffer (ragged -> per-scan arrays)
    for i, scan in enumerate(slam.scan_buffer):
        arrays[f"scan{i}_points"] = scan.points
        arrays[f"scan{i}_stamps"] = scan.stamps
        arrays[f"scan{i}_rings"] = scan.rings
        arrays[f"scan{i}_grid"] = np.asarray(scan.grid_size)
    arrays.update(_buffered_arrays(slam.buffered_scan))

    meta = {
        "version": CHECKPOINT_VERSION,
        "kf_count": kf.count,
        "kf_num_updates": kf.num_updates,
        "imu_next_idx": slam.imu_buffer.next_idx,
        "imu_num_updates": slam.imu_buffer.num_updates,
        "scan_updates": slam.scan_updates,
        "n_scans_in_buffer": len(slam.scan_buffer),
        "time_initialized": slam.time_initialized,
        "submap_initialized": slam.submap_initialized,
        "received_imu": slam.received_imu,
        "use_imu": slam.config.use_imu,
        "prng_counter": slam._prng_counter,
        "has_old_window": slam.old_window is not None,
        "has_buffered_scan": slam.buffered_scan is not None,
    }
    _write(path, meta, arrays)


def load_checkpoint(slam, path: str):
    """Restore state saved by save_checkpoint (either package's) into a
    freshly-constructed DmsaSlam (same Config/shapes required)."""
    from dmsa_lidar_slam_tpu_torch.pipeline.slam import OldWindow
    from dmsa_lidar_slam_tpu_torch.trajectory.builder import HostScan

    z, meta = _read(path)
    if meta["version"] != CHECKPOINT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != {CHECKPOINT_VERSION}")

    kf = slam.kf_map
    for key, attr in _KF_KEYS:
        getattr(kf, attr)[...] = z[key]
    kf.count = meta["kf_count"]
    kf.num_updates = meta["kf_num_updates"]
    _restore_imu(slam.imu_buffer, z, meta)
    _restore_output(slam.output, z)

    if meta["has_old_window"]:
        t0, horizon = z["ow_scalars"]
        slam.old_window = OldWindow(
            orient_w=z["ow_orient"],
            transl_w=z["ow_transl"],
            ctrl_stamps=z["ow_stamps"],
            t0=float(t0),
            horizon=float(horizon),
        )
    slam.scan_buffer = [
        HostScan(
            points=z[f"scan{i}_points"],
            stamps=z[f"scan{i}_stamps"],
            rings=z[f"scan{i}_rings"],
            grid_size=float(z[f"scan{i}_grid"]),
        )
        for i in range(meta["n_scans_in_buffer"])
    ]
    if meta["has_buffered_scan"]:
        slam.buffered_scan = (z["buffered_points"], z["buffered_stamps"], z["buffered_rings"])

    slam.scan_updates = meta["scan_updates"]
    slam.time_initialized = meta["time_initialized"]
    slam.submap_initialized = meta["submap_initialized"]
    slam.received_imu = meta["received_imu"]
    slam.config.use_imu = meta["use_imu"]
    slam._prng_counter = meta["prng_counter"]
    return slam


# ---------------------------------------------------------------- fused
def save_fused_checkpoint(slam, path: str):
    """Serialize a pipeline.fused.FusedDmsaSlam: flush the event ledger,
    then download the device state (one transfer per leaf)."""
    from dmsa_lidar_slam_tpu_torch import convert

    slam._flush_events()
    leaves = convert.state_leaves(convert.state_to_numpy(slam.state))
    arrays = {f"leaf{i}": leaf for i, leaf in enumerate(leaves)}
    arrays.update(_imu_arrays(slam.imu_buffer))
    arrays.update(
        scan_minmax=np.asarray(slam._scan_minmax, dtype=np.float64).reshape(-1, 2)
        if slam._scan_minmax
        else np.zeros((0, 2)),
        window_t0_history=np.asarray(slam._window_t0_history),
    )
    arrays.update(_output_arrays(slam.output))
    arrays.update(_buffered_arrays(slam.buffered_scan))
    meta = {
        "version": CHECKPOINT_VERSION,
        "kind": "fused",
        "num_leaves": len(leaves),
        "scan_counter": slam.scan_counter,
        "flushed_upto": slam._flushed_upto,
        "time_initialized": slam.time_initialized,
        "received_imu": slam.received_imu,
        "use_imu": slam.config.use_imu,
        "imu_next_idx": slam.imu_buffer.next_idx,
        "imu_num_updates": slam.imu_buffer.num_updates,
        "prev_window_t0": slam._prev_window_t0,
        "stamp_base": slam._stamp_base,
        "has_buffered_scan": slam.buffered_scan is not None,
    }
    _write(path, meta, arrays)


def load_fused_checkpoint(slam, path: str):
    """Restore a checkpoint of either package's fused pipeline into a
    freshly-constructed FusedDmsaSlam (same Config), its state on the
    object's own device with each leaf's dtype as the object has it."""
    import torch

    from dmsa_lidar_slam_tpu_torch import convert

    z, meta = _read(path)
    if meta.get("kind") != "fused":
        raise ValueError("not a fused-pipeline checkpoint")
    if meta.get("version") != CHECKPOINT_VERSION:
        raise ValueError(f"fused checkpoint version {meta.get('version')} != {CHECKPOINT_VERSION}")

    dtypes = [torch.empty((), dtype=t.dtype).numpy().dtype for t in convert.state_leaves(slam.state)]
    if meta["num_leaves"] != len(dtypes):
        raise ValueError(f"checkpoint has {meta['num_leaves']} state leaves, the pipeline {len(dtypes)}")
    leaves = [np.asarray(z[f"leaf{i}"], dtype=dt) for i, dt in enumerate(dtypes)]
    slam.state = convert.state_from_numpy(convert.state_from_leaves(leaves), device=slam.device)

    _restore_imu(slam.imu_buffer, z, meta)
    slam._scan_minmax = [tuple(row) for row in z["scan_minmax"]]
    slam._window_t0_history = list(z["window_t0_history"])
    slam.scan_counter = meta["scan_counter"]
    slam._flushed_upto = meta["flushed_upto"]
    slam.time_initialized = meta["time_initialized"]
    slam.received_imu = meta["received_imu"]
    slam.config.use_imu = meta["use_imu"]
    slam._prev_window_t0 = meta["prev_window_t0"]
    slam._stamp_base = meta.get("stamp_base")
    if meta["has_buffered_scan"]:
        slam.buffered_scan = (z["buffered_points"], z["buffered_stamps"], z["buffered_rings"])
    _restore_output(slam.output, z)
    return slam
