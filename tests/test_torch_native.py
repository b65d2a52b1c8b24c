"""Port vs reference: the native PointCloud2 decoder (io/native.py, built
with g++ from the port's own copy of the source into build/native/).

For every sensor layout that the decoder handles, a message crafted from a
numpy seed (stamps, rings and coordinates of each field's type, fields of
other types in between, a point step with padding) is decoded by the
port's native path, the port's numpy path (io/pointcloud2.decode_points)
and the reference's native path.  The three are the same loads and the
same f64 formulas, so they must agree bit for bit: tolerance 0.
"""

import numpy as np
import pytest

from dmsa_lidar_slam_tpu.io import native as jnative
from dmsa_lidar_slam_tpu_torch.io import native as tnative
from dmsa_lidar_slam_tpu_torch.io import pointcloud2 as pc2
from tests.torch_bag import serialize_ouster_scan

# field name, numpy type per sensor, in io/pointcloud2.decode_points' order
# of field indices (PointField datatypes: 1 i8, 2 u8, 4 u16, 6 u32, 7 f32,
# 8 f64)
_XYZ = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
_LAYOUTS = {
    "hesai": _XYZ + [("intensity", "<f4"), ("timestamp", "<f8"), ("ring", "<u2")],
    "ouster": _XYZ + [("intensity", "<f4"), ("t", "<u4"), ("reflectivity", "<u2"), ("ring", "u1")],
    "robosense": _XYZ + [("intensity", "u1"), ("ring", "<u2"), ("timestamp", "<f8")],
    "velodyne": _XYZ + [("intensity", "<f4"), ("ring", "<u2"), ("time", "<f4")],
    "livoxXYZRTLT_s": _XYZ + [("reflectivity", "u1"), ("tag", "u1"), ("line", "u1"), ("timestamp", "<f8")],
    "livoxXYZRTLT_ns": _XYZ + [("reflectivity", "u1"), ("tag", "u1"), ("line", "u1"), ("timestamp", "<f8")],
    "sick": _XYZ + [("i", "<f4"), ("range", "<f4"), ("azimuth", "<f4"), ("elevation", "<f4"), ("echo", "u1"),
                    ("t", "<f4"), ("ts", "<u4"), ("reflector", "u1"), ("ring", "i1")],
    "unknown": _XYZ + [("intensity", "<f4")],
}
_DATATYPE = {"i1": 1, "u1": 2, "<u2": 4, "<u4": 6, "<f4": 7, "<f8": 8}


def crafted_cloud(sensor, rng, n=300, stamp=1234.5):
    """A PointCloud2 of n points in `sensor`'s field layout, fields packed
    without alignment and each point padded by 3 bytes."""
    layout = _LAYOUTS[sensor]
    offsets = np.cumsum([0] + [np.dtype(t).itemsize for _, t in layout])
    point_step = int(offsets[-1]) + 3
    dt = np.dtype({"names": [f for f, _ in layout], "formats": [t for _, t in layout],
                   "offsets": [int(o) for o in offsets[:-1]], "itemsize": point_step})
    rec = np.zeros(n, dtype=dt)
    for name, t in layout:
        kind = np.dtype(t).kind
        if name in ("x", "y", "z"):
            rec[name] = 30 * rng.standard_normal(n)
        elif name in ("timestamp",):
            rec[name] = (stamp * 1e9 if sensor == "livoxXYZRTLT_ns" else stamp) + rng.uniform(0, 0.1, n)
        elif sensor == "ouster" and name == "t":
            rec[name] = rng.integers(0, 100_000_000, n)
        elif kind == "f":
            rec[name] = rng.uniform(0, 0.1, n)
        else:
            info = np.iinfo(np.dtype(t))
            rec[name] = rng.integers(info.min, info.max, n, endpoint=True)
    fields = tuple(pc2.PointField(name, int(o), _DATATYPE[t], 1) for (name, t), o in zip(layout, offsets))
    return pc2.PointCloud2(stamp, 1, n, fields, point_step, n * point_step, rec.tobytes())


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("sensor", sorted(_LAYOUTS))
def test_native_decode_matches_numpy_and_reference(sensor):
    assert tnative.available()
    assert jnative.available()
    msg = crafted_cloud(sensor, np.random.default_rng(len(sensor)))
    last = msg.stamp - 0.05 if sensor == "unknown" else None
    want = pc2.decode_points(msg, sensor, last)
    got = tnative.decode_points(msg, sensor, last)
    assert got is not None
    _equal(got, want)
    _equal(got, jnative.decode_points(msg, sensor, last))


def test_native_decode_of_a_serialized_ouster_scan():
    """The bag writer's ouster bytes (chip_smoke.py decodes the same),
    through parse_pointcloud2."""
    rng = np.random.default_rng(7)
    n = 2000
    pts = (10 * rng.standard_normal((n, 3))).astype(np.float32)
    stamps = 100.0 + np.sort(rng.uniform(0, 0.1, n))
    msg = pc2.parse_pointcloud2(serialize_ouster_scan(pts, stamps, rng.integers(0, 64, n)))
    got = tnative.decode_points(msg, "ouster")
    _equal(got, pc2.decode_points(msg, "ouster"))
    np.testing.assert_array_equal(got[0], pts)


def test_builds_into_build_dir_from_the_ports_source():
    so = tnative.build()
    assert so == tnative.library_path() and so.exists()
    assert so.parent.name == "native" and so.parent.parent.name == "build"
    assert tnative.SRC.parts[-4:] == ("dmsa_lidar_slam_tpu_torch", "native", "src", "dmsa_io.cpp")


def test_failed_build_falls_back_to_none(monkeypatch, tmp_path, caplog):
    """No compiler: decode_points logs and returns None, as the reference
    does, and the caller keeps the numpy decoder."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler-dmsa")
    tnative._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            tnative.build()
        assert tnative.decode_points(crafted_cloud("ouster", np.random.default_rng(0)), "ouster") is None
        assert "numpy fallback" in caplog.text
    finally:
        tnative._load.cache_clear()
