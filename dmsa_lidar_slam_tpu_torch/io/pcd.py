# Copy of dmsa_lidar_slam_tpu/io/pcd.py; only this line differs.
"""PCD point-cloud file writer / reader.

The reference saves the map as ASCII PCD every 20 clouds and at the end
(reference: src/dmsa_slam_ros.cpp:286-294,495-506 via
pcl::io::savePCDFileASCII).  Binary mode is added because ASCII PCD of a
multi-million-point map is pathological.
"""

from typing import Optional, Tuple

import numpy as np


def save_pcd(path: str, points: np.ndarray, normals: Optional[np.ndarray] = None, binary: bool = True):
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    if normals is not None:
        fields = "x y z normal_x normal_y normal_z"
        sizes = "4 4 4 4 4 4"
        types = "F F F F F F"
        counts = "1 1 1 1 1 1"
        data = np.concatenate([points, np.asarray(normals, np.float32)], axis=1)
    else:
        fields = "x y z"
        sizes = "4 4 4"
        types = "F F F"
        counts = "1 1 1"
        data = points
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def load_pcd(path: str) -> Tuple[np.ndarray, dict]:
    """Read x/y/z (+ any float fields) from an ascii or binary PCD."""
    with open(path, "rb") as f:
        header = {}
        fields, sizes, types, counts = [], [], [], []
        while True:
            line = f.readline().decode(errors="replace").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "FIELDS":
                fields = val.split()
            elif key == "SIZE":
                sizes = [int(v) for v in val.split()]
            elif key == "TYPE":
                types = val.split()
            elif key == "COUNT":
                counts = [int(v) for v in val.split()]
            elif key == "DATA":
                mode = val
                break
        n = int(header["POINTS"])
        np_types = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4", ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4"}
        dtype = np.dtype(
            [
                (name, np_types[(t, s)], (c,) if c > 1 else ())
                for name, t, s, c in zip(fields, types, sizes, counts)
            ]
        )
        if mode == "binary":
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        elif mode == "ascii":
            arr = np.loadtxt(f, dtype=np.float64, max_rows=n)
            arr = np.rec.fromarrays(
                [arr[:, i] for i in range(arr.shape[1])], names=",".join(fields)
            )
        else:
            raise ValueError(f"unsupported PCD data mode {mode}")
        pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)
        return pts, {name: np.asarray(arr[name]) for name in fields}
