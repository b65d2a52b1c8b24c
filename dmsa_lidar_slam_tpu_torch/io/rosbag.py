# Copy of dmsa_lidar_slam_tpu/io/rosbag.py; only this line differs.
"""Minimal pure-Python rosbag1 (v2.0) reader — no ROS required.

Replaces the reference's direct rosbag iteration (reference:
src/dmsa_slam_ros.cpp:240-307, which uses rosbag::View over the lidar and
imu topics in bag order).  Supports uncompressed and bz2 chunks (lz4 if the
lz4 package is importable).  Only the record types needed for message
iteration are parsed.

A C++ fast path for the inner PointCloud2 field extraction lives in
native/ (loaded via ctypes); this module is the canonical fallback.
"""

import bz2
import os
import struct
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


class Connection(NamedTuple):
    conn_id: int
    topic: str
    msg_type: str


class BagMessage(NamedTuple):
    topic: str
    msg_type: str
    stamp: float  # record receive time (seconds)
    raw: bytes  # serialized message body


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        kv = buf[off : off + flen]
        off += flen
        eq = kv.index(b"=")
        fields[kv[:eq]] = kv[eq + 1 :]
    return fields


def _records(buf: bytes, offset: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    n = len(buf)
    while offset < n:
        (hlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        header = _parse_header(buf[offset : offset + hlen])
        offset += hlen
        (dlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        data = buf[offset : offset + dlen]
        offset += dlen
        yield header, data


def read_messages(
    path: str, topics: Optional[List[str]] = None
) -> Iterator[BagMessage]:
    """Iterate messages in bag order, optionally filtered by topic."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a rosbag v2.0 file")
        buf = f.read()

    connections: Dict[int, Connection] = {}
    topic_set = set(topics) if topics else None

    def handle_connection(header, data):
        conn_id = struct.unpack("<I", header[b"conn"])[0]
        data_fields = _parse_header(data)
        topic = data_fields.get(b"topic", header.get(b"topic", b"")).decode()
        msg_type = data_fields.get(b"type", b"").decode()
        connections[conn_id] = Connection(conn_id, topic, msg_type)

    def iter_record(header, data):
        op = header[b"op"][0]
        if op == OP_CONNECTION:
            handle_connection(header, data)
        elif op == OP_MSG:
            conn_id = struct.unpack("<I", header[b"conn"])[0]
            conn = connections.get(conn_id)
            if conn is None:
                return
            if topic_set is not None and conn.topic not in topic_set:
                return
            secs, nsecs = struct.unpack("<II", header[b"time"])
            yield BagMessage(conn.topic, conn.msg_type, secs + 1e-9 * nsecs, data)
        elif op == OP_CHUNK:
            compression = header.get(b"compression", b"none").decode()
            if compression == "none":
                chunk = data
            elif compression == "bz2":
                chunk = bz2.decompress(data)
            elif compression == "lz4":
                try:
                    import lz4.frame  # type: ignore
                except ImportError as e:  # pragma: no cover
                    raise RuntimeError("bag uses lz4 compression; lz4 package unavailable") from e
                chunk = lz4.frame.decompress(data)
            else:  # pragma: no cover
                raise ValueError(f"unknown chunk compression {compression}")
            for h2, d2 in _records(chunk):
                yield from iter_record(h2, d2)

    for header, data in _records(buf):
        yield from iter_record(header, data)


def read_messages_multi(paths: List[str], topics: Optional[List[str]] = None) -> Iterator[BagMessage]:
    """Iterate several bags sequentially (bag_dirs may list multiple;
    dmsa_slam_ros.cpp:242-253)."""
    for p in paths:
        yield from read_messages(p, topics)


# --------------------------------------------------------------- writing
def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    parts = []
    for k, v in fields.items():
        kv = k + b"=" + v
        parts.append(struct.pack("<I", len(kv)) + kv)
    return b"".join(parts)


def _encode_record(header: Dict[bytes, bytes], data: bytes) -> bytes:
    h = _encode_header(header)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def write_bag(path: str, messages, topic_types: Dict[str, str]):
    """Write a minimal uncompressed rosbag v2.0 (for tests and tooling).

    messages: iterable of (topic, stamp_seconds, raw_bytes).
    """
    conn_ids = {topic: i for i, topic in enumerate(topic_types)}
    with open(path, "wb") as f:
        f.write(_MAGIC)
        # bag header record, padded to 4096 bytes per the format spec
        bh = _encode_record(
            {
                b"op": bytes([OP_BAG_HEADER]),
                b"index_pos": struct.pack("<Q", 0),
                b"conn_count": struct.pack("<I", len(conn_ids)),
                b"chunk_count": struct.pack("<I", 0),
            },
            b" " * 4096,
        )
        f.write(bh)
        for topic, cid in conn_ids.items():
            conn_data = _encode_header(
                {
                    b"topic": topic.encode(),
                    b"type": topic_types[topic].encode(),
                    b"md5sum": b"0" * 32,
                    b"message_definition": b"",
                }
            )
            f.write(
                _encode_record(
                    {
                        b"op": bytes([OP_CONNECTION]),
                        b"conn": struct.pack("<I", cid),
                        b"topic": topic.encode(),
                    },
                    conn_data,
                )
            )
        for topic, stamp, raw in messages:
            secs = int(stamp)
            nsecs = int(round((stamp - secs) * 1e9))
            f.write(
                _encode_record(
                    {
                        b"op": bytes([OP_MSG]),
                        b"conn": struct.pack("<I", conn_ids[topic]),
                        b"time": struct.pack("<II", secs, nsecs),
                    },
                    raw,
                )
            )
