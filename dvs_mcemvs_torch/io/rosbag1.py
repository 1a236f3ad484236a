"""Minimal pure-Python ROS1 bag (v2.0) reader -- no ROS installation needed.

Port of dvs_mcemvs_tpu/io/rosbag1.py (numpy only; the port keeps its own
copy).  It reads the ROS1 bag container (records with length-prefixed
key=value headers; chunk records holding nested connection and
message-data records) and deserializes the message types of the
reference (mapper_emvs_stereo/src/data_loading.cpp:33-468):

  - geometry_msgs/PoseStamped              (data_loading.cpp:372-399)
  - geometry_msgs/PoseWithCovarianceStamped (:401-430)
  - nav_msgs/Odometry                      (:432-463)
  - vicon/Subject                          (:334-370)
  - dvs_msgs/EventArray                    (:61-97)

sensor_msgs/CameraInfo and the topic listing of the JAX module have no
caller in the port yet (ROADMAP Queue 1 item 2).

Uncompressed and bz2 chunks are read; an lz4 chunk, or a file that is not
a v2.0 bag, raises.
"""

from __future__ import annotations

import bz2
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_OP_MSG = b"\x02"
_OP_CHUNK = b"\x05"
_OP_CONNECTION = b"\x07"


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        flen = struct.unpack_from("<I", buf, off)[0]
        off += 4
        fld = buf[off:off + flen]
        off += flen
        k, _, v = fld.partition(b"=")
        fields[k.decode()] = v
    return fields


def _records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    n = len(buf)
    while off + 4 <= n:
        hlen = struct.unpack_from("<I", buf, off)[0]
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        dlen = struct.unpack_from("<I", buf, off)[0]
        off += 4
        yield header, buf[off:off + dlen]
        off += dlen


class Connection:
    def __init__(self, cid: int, topic: str, msg_type: str):
        self.id = cid
        self.topic = topic
        self.type = msg_type


def read_messages(path: str, topic: str = ""
                  ) -> Iterator[Tuple[Connection, float, bytes]]:
    """Yield (connection, bag_time_seconds, raw_message_bytes) for every
    message on `topic` ("" = all topics), walking chunks in file order."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"{path}: not a ROS1 v2.0 bag ({magic!r})")
        data = f.read()

    conns: Dict[int, Connection] = {}

    def handle(records):
        for header, payload in records:
            op = header.get("op")
            if op == _OP_CONNECTION:
                cid = struct.unpack("<I", header["conn"])[0]
                info = _parse_header(payload)
                conns[cid] = Connection(
                    cid, header.get("topic", b"").decode(),
                    info.get("type", b"").decode())
            elif op == _OP_CHUNK:
                comp = header.get("compression", b"none")
                if comp == b"none":
                    inner = payload
                elif comp == b"bz2":
                    inner = bz2.decompress(payload)
                else:
                    raise ValueError(
                        f"{path}: unsupported chunk compression {comp!r} "
                        "(lz4 bags: rewrite with `rosbag decompress`)")
                yield from handle(_records(inner))
            elif op == _OP_MSG:
                cid = struct.unpack("<I", header["conn"])[0]
                sec, nsec = struct.unpack("<II", header["time"])
                conn = conns.get(cid)
                if conn is None:
                    continue
                if topic and conn.topic != topic:
                    continue
                yield conn, sec + 1e-9 * nsec, payload

    yield from handle(_records(data))


def topics(path: str) -> Dict[str, str]:
    """{topic: message type} map of the bag."""
    out = {}
    for conn, _, _ in read_messages(path):
        out.setdefault(conn.topic, conn.type)
    return out


# ---------------------------------------------------------------------------
# Message deserializers (ROS1 little-endian wire format)
# ---------------------------------------------------------------------------


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def f64(self, n: int = 1):
        v = struct.unpack_from(f"<{n}d", self.buf, self.off)
        self.off += 8 * n
        return v[0] if n == 1 else np.asarray(v)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s.decode(errors="replace")

    def time(self) -> float:
        sec, nsec = struct.unpack_from("<II", self.buf, self.off)
        self.off += 8
        return sec + 1e-9 * nsec

    def header(self) -> float:
        self.u32()          # seq
        t = self.time()
        self.string()       # frame_id
        return t


def _pose(c: _Cursor):
    """geometry_msgs/Pose -> (t_xyz, q_wxyz)."""
    px, py, pz = c.f64(), c.f64(), c.f64()
    qx, qy, qz, qw = c.f64(), c.f64(), c.f64(), c.f64()
    return (px, py, pz), (qw, qx, qy, qz)


def parse_pose_msg(msg_type: str, raw: bytes, bag_time: float
                   ) -> Tuple[float, Tuple, Tuple]:
    """(stamp_seconds, t_xyz, q_wxyz) for any of the four pose message
    types the reference dispatches on (data_loading.cpp:334-463)."""
    c = _Cursor(raw)
    if msg_type == "geometry_msgs/PoseStamped":
        stamp = c.header()
        t, q = _pose(c)
    elif msg_type == "geometry_msgs/PoseWithCovarianceStamped":
        stamp = c.header()
        t, q = _pose(c)              # covariance (36 f64) ignored
    elif msg_type == "nav_msgs/Odometry":
        stamp = c.header()
        c.string()                   # child_frame_id
        t, q = _pose(c)
    elif msg_type == "vicon/Subject":
        # Header, translation (Vector3), rotation (Quaternion xyzw), then
        # occlusion/marker fields the reference ignores.
        stamp = c.header()
        t = (c.f64(), c.f64(), c.f64())
        qx, qy, qz, qw = c.f64(), c.f64(), c.f64(), c.f64()
        q = (qw, qx, qy, qz)
    else:
        raise ValueError(f"unsupported pose message type {msg_type!r}")
    return (stamp if stamp > 0 else bag_time), t, q


def parse_event_array(raw: bytes):
    """dvs_msgs/EventArray -> (x u16, y u16, t f64 s, p u8) arrays.

    Wire layout: Header, height u32, width u32, events[] of
    {x u16, y u16, ts time, polarity u8} (13 bytes packed each).
    """
    c = _Cursor(raw)
    c.header()
    c.u32()  # height
    c.u32()  # width
    n = c.u32()
    rec = np.frombuffer(c.buf, dtype=np.dtype([
        ("x", "<u2"), ("y", "<u2"), ("sec", "<u4"), ("nsec", "<u4"),
        ("p", "u1")]), count=n, offset=c.off)
    t = rec["sec"].astype(np.float64) + 1e-9 * rec["nsec"]
    return (rec["x"].astype(np.int32), rec["y"].astype(np.int32),
            t, rec["p"].astype(np.int8))


def parse_camera_info(raw: bytes) -> Dict[str, np.ndarray]:
    """sensor_msgs/CameraInfo -> dict with K (3,3), D (N,), R (3,3),
    P (3,4), width, height, distortion_model."""
    c = _Cursor(raw)
    c.header()
    height = c.u32()
    width = c.u32()
    model = c.string()
    nd = c.u32()
    D = c.f64(nd) if nd else np.zeros(0)
    K = np.asarray(c.f64(9)).reshape(3, 3)
    R = np.asarray(c.f64(9)).reshape(3, 3)
    P = np.asarray(c.f64(12)).reshape(3, 4)
    return {"K": K, "D": np.atleast_1d(D), "R": R, "P": P,
            "width": width, "height": height, "distortion_model": model}


def read_pose_bag(path: str, topic: str = ""):
    """(ts, q_wxyz (N,4), t_xyz (N,3)) arrays from a pose bag, sorted by
    stamp.  Auto-detects the topic when unique."""
    ts: List[float] = []
    qs: List[Tuple] = []
    ps: List[Tuple] = []
    for conn, bag_t, raw in read_messages(path, topic):
        try:
            stamp, t, q = parse_pose_msg(conn.type, raw, bag_t)
        except ValueError:
            continue
        ts.append(stamp)
        qs.append(q)
        ps.append(t)
    if not ts:
        raise ValueError(f"{path}: no pose messages"
                         + (f" on topic {topic!r}" if topic else ""))
    order = np.argsort(ts, kind="stable")
    return (np.asarray(ts, np.float64)[order],
            np.asarray(qs, np.float64)[order],
            np.asarray(ps, np.float64)[order])


def read_event_bag(path: str, topic: str):
    """Concatenated (x, y, t, p) arrays of every EventArray on `topic`."""
    xs, ys, tss, pss = [], [], [], []
    for conn, _, raw in read_messages(path, topic):
        if conn.type != "dvs_msgs/EventArray":
            continue
        x, y, t, p = parse_event_array(raw)
        xs.append(x)
        ys.append(y)
        tss.append(t)
        pss.append(p)
    if not xs:
        raise ValueError(f"{path}: no dvs_msgs/EventArray on {topic!r}")
    return (np.concatenate(xs), np.concatenate(ys),
            np.concatenate(tss), np.concatenate(pss))


def read_camera_info_bag(path: str, topic: str) -> Dict[str, np.ndarray]:
    """First sensor_msgs/CameraInfo on `topic` (the reference reads one and
    stops, data_loading.cpp:112-208)."""
    for conn, _, raw in read_messages(path, topic):
        if conn.type == "sensor_msgs/CameraInfo":
            return parse_camera_info(raw)
    raise ValueError(f"{path}: no sensor_msgs/CameraInfo on {topic!r}")
