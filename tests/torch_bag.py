"""A rosbag of the synthetic sequence, written without jax: interleaved
sensor_msgs/Imu and sensor_msgs/PointCloud2 (ouster layout) messages, as
tests/test_runner_e2e.py writes one, vectorized with a numpy record dtype so
that full-width scans (20,000 points) write in milliseconds.

Imports only numpy and the port's numpy-only io modules, so chip_smoke.py
can use it on a machine that has no jax.
"""

import struct

import numpy as np

from dmsa_lidar_slam_tpu_torch.io import rosbag

_OUSTER_FIELDS = [
    ("x", 0, 7, 1),
    ("y", 4, 7, 1),
    ("z", 8, 7, 1),
    ("intensity", 12, 7, 1),
    ("t", 16, 6, 1),
    ("reflectivity", 20, 4, 1),
    ("ring", 22, 2, 1),
]
_POINT_STEP = 24
_OUSTER_DTYPE = np.dtype(
    {
        "names": ["x", "y", "z", "t", "ring"],
        "formats": ["<f4", "<f4", "<f4", "<u4", "u1"],
        "offsets": [0, 4, 8, 16, 22],
        "itemsize": _POINT_STEP,
    }
)


def serialize_header(stamp: float, frame_id=b"map") -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    return struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", len(frame_id)) + frame_id


def serialize_imu(stamp, ang, acc) -> bytes:
    raw = serialize_header(stamp, b"imu")
    raw += struct.pack("<4d", 0, 0, 0, 1)
    raw += struct.pack("<9d", *([0.0] * 9))
    raw += struct.pack("<3d", *ang)
    raw += struct.pack("<9d", *([0.0] * 9))
    raw += struct.pack("<3d", *acc)
    raw += struct.pack("<9d", *([0.0] * 9))
    return raw


def serialize_ouster_scan(pts, stamps, rings) -> bytes:
    """PointCloud2 bytes in the ouster layout: header stamp = scan start,
    per-point t = ns offset."""
    t0 = float(stamps.min())
    n = len(pts)
    rec = np.zeros(n, dtype=_OUSTER_DTYPE)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    rec["t"] = np.round((stamps - t0) * 1e9).astype(np.uint32)
    rec["ring"] = (np.asarray(rings).astype(np.int64) & 0xFF).astype(np.uint8)
    buf = rec.tobytes()
    raw = serialize_header(t0)
    raw += struct.pack("<II", 1, n)
    raw += struct.pack("<I", len(_OUSTER_FIELDS))
    for name, off, dt, cnt in _OUSTER_FIELDS:
        nb = name.encode()
        raw += struct.pack("<I", len(nb)) + nb + struct.pack("<IBI", off, dt, cnt)
    raw += struct.pack("<B", 0)
    raw += struct.pack("<II", _POINT_STEP, n * _POINT_STEP)
    raw += struct.pack("<I", len(buf)) + buf
    raw += struct.pack("<B", 1)
    return raw


def write_sequence_bag(path, seq, n_scans: int, pts_per_scan: int):
    """Bag of `n_scans` scans of `seq` (a SyntheticSequence) on /points and
    its IMU on /imu, in time order."""
    msgs = []
    imu_cursor = seq.t_start - 0.2
    for i in range(n_scans):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(imu_cursor, t_end)
        for j in range(len(ts)):
            msgs.append(("/imu", float(ts[j]), serialize_imu(float(ts[j]), gyr[j], acc[j])))
        imu_cursor = t_end
        pts, stamps, rings = seq.scan(i, pts_per_scan)
        msgs.append(("/points", float(stamps.min()), serialize_ouster_scan(pts, stamps, rings)))
    msgs.sort(key=lambda m: m[1])
    rosbag.write_bag(path, msgs, {"/points": "sensor_msgs/PointCloud2", "/imu": "sensor_msgs/Imu"})
    return seq


def bag_overrides(bag_path, result_dir, **overrides):
    """Config overrides that point the runner at the bag."""
    return {
        "bag_dirs": [bag_path],
        "lidar_topic": "/points",
        "imu_topic": "/imu",
        "sensor": "ouster",
        "result_dir": result_dir,
        **overrides,
    }
