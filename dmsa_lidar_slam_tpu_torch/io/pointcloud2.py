# Copy of dmsa_lidar_slam_tpu/io/pointcloud2.py; only this line differs.
"""sensor_msgs/PointCloud2 + sensor_msgs/Imu deserialization and per-vendor
point decoding.

Mirrors the reference's per-sensor field extraction (reference:
src/dmsa_slam_ros.cpp:374-486): each supported sensor has its own stamp
semantics (absolute double, nanosecond offset, second-offset float) and
ring-id field; "unknown" synthesizes stamps linearly over the scan and
ring = index % 1000.

Decoding is vectorized numpy over the raw byte buffer (strided views), with
an optional C++ fast path (io.native) for the hot copy.
"""

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np

SUPPORTED_SENSORS = (
    "hesai",
    "ouster",
    "robosense",
    "velodyne",
    "livoxXYZRTLT_s",
    "livoxXYZRTLT_ns",
    "sick",
    "unknown",
)


class PointField(NamedTuple):
    name: str
    offset: int
    datatype: int
    count: int


class PointCloud2(NamedTuple):
    stamp: float
    height: int
    width: int
    fields: Tuple[PointField, ...]
    point_step: int
    row_step: int
    data: bytes


class ImuMsg(NamedTuple):
    stamp: float
    angular_velocity: np.ndarray
    linear_acceleration: np.ndarray


def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    s = buf[off : off + n].decode(errors="replace")
    return s, off + n


def _read_header(buf: bytes, off: int) -> Tuple[float, int]:
    # std_msgs/Header: seq, stamp(secs, nsecs), frame_id
    seq, secs, nsecs = struct.unpack_from("<III", buf, off)
    off += 12
    _, off = _read_string(buf, off)
    return secs + 1e-9 * nsecs, off


def parse_pointcloud2(raw: bytes) -> PointCloud2:
    stamp, off = _read_header(raw, 0)
    height, width = struct.unpack_from("<II", raw, off)
    off += 8
    (nfields,) = struct.unpack_from("<I", raw, off)
    off += 4
    fields = []
    for _ in range(nfields):
        name, off = _read_string(raw, off)
        foffset, datatype, count = struct.unpack_from("<IBI", raw, off)
        off += 9
        fields.append(PointField(name, foffset, datatype, count))
    (is_bigendian,) = struct.unpack_from("<B", raw, off)
    off += 1
    point_step, row_step = struct.unpack_from("<II", raw, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", raw, off)
    off += 4
    data = raw[off : off + dlen]
    return PointCloud2(stamp, height, width, tuple(fields), point_step, row_step, data)


def parse_imu(raw: bytes) -> ImuMsg:
    stamp, off = _read_header(raw, 0)
    off += 4 * 8 + 9 * 8  # orientation + its covariance
    ang = np.frombuffer(raw, dtype="<f8", count=3, offset=off).copy()
    off += 3 * 8 + 9 * 8
    acc = np.frombuffer(raw, dtype="<f8", count=3, offset=off).copy()
    return ImuMsg(stamp, ang, acc)


def _field_view(msg: PointCloud2, byte_offset: int, dtype, n: int) -> np.ndarray:
    """Strided view of one field across all points."""
    itemsize = np.dtype(dtype).itemsize
    buf = np.frombuffer(msg.data, dtype=np.uint8)
    view = np.lib.stride_tricks.as_strided(
        buf[byte_offset:].view(np.uint8),
        shape=(n, itemsize),
        strides=(msg.point_step, 1),
    )
    return np.ascontiguousarray(view).view(dtype)[:, 0]


def decode_points(
    msg: PointCloud2,
    sensor: str,
    last_msg_stamp: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode (points [n,3] f32, stamps [n] f64, rings [n] i32) per the
    vendor layouts of dmsa_slam_ros.cpp:399-486."""
    n = msg.height * msg.width
    f = msg.fields
    x = _field_view(msg, f[0].offset, "<f4", n)
    y = _field_view(msg, f[1].offset, "<f4", n)
    z = _field_view(msg, f[2].offset, "<f4", n)
    pts = np.stack([x, y, z], axis=1).astype(np.float32)

    idx = np.arange(n)
    if sensor == "hesai":
        stamps = _field_view(msg, f[4].offset, "<f8", n).astype(np.float64)
        rings = _field_view(msg, f[5].offset, "<u2", n).astype(np.int32)
    elif sensor == "ouster":
        rel_ns = _field_view(msg, f[4].offset, "<u4", n).astype(np.float64)
        rings = _field_view(msg, f[6].offset, "<u1", n).astype(np.int32)
        stamps = msg.stamp + 1e-9 * rel_ns
    elif sensor == "robosense":
        stamps = _field_view(msg, f[5].offset, "<f8", n).astype(np.float64)
        rings = _field_view(msg, f[4].offset, "<u2", n).astype(np.int32)
    elif sensor == "velodyne":
        rel_s = _field_view(msg, f[5].offset, "<f4", n).astype(np.float64)
        rings = _field_view(msg, f[4].offset, "<u2", n).astype(np.int32)
        stamps = msg.stamp + rel_s
    elif sensor == "livoxXYZRTLT_s":
        stamps = _field_view(msg, f[6].offset, "<f8", n).astype(np.float64)
        rings = (idx % 1000).astype(np.int32)
    elif sensor == "livoxXYZRTLT_ns":
        # livox2 driver bug workaround: stamps come in nanoseconds
        stamps = 1e-9 * _field_view(msg, f[6].offset, "<f8", n).astype(np.float64)
        rings = (idx % 1000).astype(np.int32)
    elif sensor == "sick":
        rel_s = _field_view(msg, f[8].offset, "<f4", n).astype(np.float64)
        rings = _field_view(msg, f[11].offset, "<i1", n).astype(np.int32)
        stamps = msg.stamp + rel_s
    elif sensor == "unknown":
        delta = 0.1 if last_msg_stamp is None else max(msg.stamp - last_msg_stamp, 1e-6)
        stamps = msg.stamp + delta * idx / max(n, 1)
        rings = (idx % 1000).astype(np.int32)
    else:
        raise ValueError(f"unsupported sensor type {sensor!r}; known: {SUPPORTED_SENSORS}")
    return pts, stamps, rings
