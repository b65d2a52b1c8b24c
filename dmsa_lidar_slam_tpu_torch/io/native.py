"""ctypes loader for the native IO fast path (counterpart of
dmsa_lidar_slam_tpu/io/native.py).

The port keeps its own copy of the decoder source (native/src/dmsa_io.cpp)
and builds it at first use with g++ into the git-ignored build/native/,
named by a hash of the source and flags (a changed source rebuilds).  When
the library cannot be built or loaded, decode_points logs and returns None
and the caller keeps the numpy decoder of io.pointcloud2.  This is host C++
for bag decoding, not a card kernel.
"""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("dmsa_io_native")

SRC = Path(__file__).resolve().parents[1] / "native" / "src" / "dmsa_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native (the reference's Makefile has it): build/ may travel to
# another machine with the checkout, and the loop is memory-bound
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_SENSOR_CODES = {
    "hesai": 0,
    "ouster": 1,
    "robosense": 2,
    "velodyne": 3,
    "livoxXYZRTLT_s": 4,
    "livoxXYZRTLT_ns": 5,
    "sick": 6,
    "unknown": 7,
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libdmsa_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder into the hashed library if it is not there yet.
    Raises RuntimeError if there is no g++ or the compile fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("native IO: no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, so.name)
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC)], capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"native IO build failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    return so


@lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        log.warning("native IO unavailable (%s); using numpy fallback", e)
        return None
    lib.decode_pointcloud2.restype = ctypes.c_int
    lib.decode_pointcloud2.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.range_mask.restype = ctypes.c_int64
    lib.range_mask.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_char_p,
    ]
    return lib


def available() -> bool:
    return _load() is not None


# (stamp_field_index, ring_field_index or None) per sensor — must mirror
# io.pointcloud2.decode_points / dmsa_slam_ros.cpp:399-486
_FIELD_IDX = {
    "hesai": (4, 5),
    "ouster": (4, 6),
    "robosense": (5, 4),
    "velodyne": (5, 4),
    "livoxXYZRTLT_s": (6, None),
    "livoxXYZRTLT_ns": (6, None),
    "sick": (8, 11),
    "unknown": (None, None),
}


def decode_points(msg, sensor: str, last_msg_stamp: Optional[float] = None):
    """Native-path equivalent of io.pointcloud2.decode_points; returns None
    if the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None or sensor not in _FIELD_IDX:
        return None
    n = msg.height * msg.width
    if len(msg.data) < n * msg.point_step:
        raise ValueError(f"PointCloud2 data holds {len(msg.data)} bytes, {n} points of {msg.point_step} need more")
    f = msg.fields
    stamp_i, ring_i = _FIELD_IDX[sensor]
    off_stamp = f[stamp_i].offset if stamp_i is not None else -1
    off_ring = f[ring_i].offset if ring_i is not None else -1
    delta = 0.1 if last_msg_stamp is None else max(msg.stamp - last_msg_stamp, 1e-6)

    xyz = np.empty((n, 3), dtype=np.float32)
    stamps = np.empty(n, dtype=np.float64)
    rings = np.empty(n, dtype=np.int32)
    rc = lib.decode_pointcloud2(
        msg.data,
        n,
        msg.point_step,
        f[0].offset,
        f[1].offset,
        f[2].offset,
        off_stamp,
        off_ring,
        _SENSOR_CODES[sensor],
        msg.stamp,
        delta,
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rings.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        return None
    return xyz, stamps, rings
