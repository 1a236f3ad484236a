"""Synthetic stereo event-camera rig: analytic scenes with exact ground truth.

Port of dvs_mcemvs_tpu/utils/synthetic.py (pure numpy, float64, so the two
packages generate identical events from one seed): a rigid two-plane point
scene observed by a rig translating along +x produces one event per
(point, sample time) visibility.  `write_fixture` writes such a rig as a
dataset the CLI reads; `write_bag_fixture` records it in a ROS1 bag
(`write_rosbag`), the way MVSEC ships its sequences.
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np

from ..mapper import Events
from ..ops.camera import PinholeCamera


@dataclasses.dataclass(frozen=True)
class SyntheticRig:
    """ESIM-like stereo rig moving along +x with two scene planes."""

    cam: PinholeCamera
    baseline: float
    travel: float        # total +x translation over [0, 1] s
    plane_depths: Tuple[float, float]
    split_x: float = 0.0  # world-x boundary between the two planes

    def camera_position(self, t, cam_index: int = 0) -> np.ndarray:
        """Camera `cam_index` sits at +cam_index*baseline along the rig's x."""
        t = np.asarray(t, np.float64)
        off = self.baseline * cam_index
        return np.stack([self.travel * t + off, 0.0 * t, 0.0 * t], axis=-1)


def esim_like_rig(travel: float = 0.4) -> SyntheticRig:
    """240x180, f=200, baseline 0.2 m: the reference's ESIM calibration."""
    cam = PinholeCamera(width=240, height=180, fx=200.0, fy=200.0, cx=120.0, cy=90.0)
    return SyntheticRig(cam=cam, baseline=0.2, travel=travel, plane_depths=(1.5, 2.5))


def make_scene(rig: SyntheticRig, rng: np.random.Generator, n_pts: int = 4000) -> np.ndarray:
    """Random points on two fronto-parallel planes split at `split_x`."""
    x = rng.uniform(-1.2, 1.2 + rig.travel, n_pts)
    y = rng.uniform(-0.9, 0.9, n_pts)
    z = np.where(x < rig.split_x, rig.plane_depths[0], rig.plane_depths[1])
    return np.stack([x, y, z], axis=-1)


def simulate_events(
    rig: SyntheticRig,
    pts_w: np.ndarray,
    cam_index: int,
    n_samples: int = 40,
    t_range: Tuple[float, float] = (0.05, 0.95),
    rng: Optional[np.random.Generator] = None,
) -> Events:
    """One event per visible (point, sample time); integer pixels, sorted t."""
    rng = rng or np.random.default_rng(0)
    cam = rig.cam
    t_samples = np.linspace(t_range[0], t_range[1], n_samples)
    xs, ys, ts, ps = [], [], [], []
    for tk in t_samples:
        p = rig.camera_position(tk, cam_index)
        rel = pts_w - p[None, :]
        z = rel[:, 2]
        u = cam.fx * rel[:, 0] / z + cam.cx
        v = cam.fy * rel[:, 1] / z + cam.cy
        ok = (z > 0.1) & (u >= 0) & (u < cam.width - 1) & (v >= 0) & (v < cam.height - 1)
        xs.append(np.round(u[ok]).astype(np.int32))
        ys.append(np.round(v[ok]).astype(np.int32))
        ts.append(np.full(int(ok.sum()), tk))
        ps.append((rng.uniform(size=int(ok.sum())) > 0.5).astype(np.int8))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    t = np.concatenate(ts)
    p = np.concatenate(ps)
    order = np.argsort(t + rng.uniform(0, 1e-4, t.shape), kind="stable")
    return Events(x[order], y[order], t[order], p[order])


def rig_poses(rig: SyntheticRig, n: int = 50,
              duration: float = 1.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t, q_wxyz, p_xyz) of the left camera over [0, duration] s."""
    ts = np.linspace(0.0, duration, n)
    q = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    p = rig.camera_position(ts, 0)
    return ts, q, p


def ground_truth_depth(
    rig: SyntheticRig, vcam: PinholeCamera, rv_x: float,
    xs: np.ndarray, ys: np.ndarray, depth: np.ndarray,
) -> np.ndarray:
    """Analytic depth per pixel: plane membership from the world-x of each
    pixel's ray at the recovered depth."""
    x_w = (xs - vcam.cx) / vcam.fx * depth + rv_x
    return np.where(x_w < rig.split_x, rig.plane_depths[0], rig.plane_depths[1])


def _simulate_cameras(rig: SyntheticRig, rng: np.random.Generator, n_pts: Optional[int],
                      n_samples: int, n_cameras: int, duration: float = 1.0) -> list:
    """Events of each camera over [0.05, 0.95] x `duration` s of one scene
    of `n_pts` points (None: make_scene's default)."""
    pts = make_scene(rig, rng) if n_pts is None else make_scene(rig, rng, n_pts)
    return [simulate_events(rig, pts, i, n_samples=n_samples,
                            t_range=(0.05 * duration, 0.95 * duration), rng=rng)
            for i in range(n_cameras)]


def _write_rig_yaml(path: str, rig: SyntheticRig, n_cameras: int) -> None:
    """A 'cameras:' YAML (calib_type 'yaml') of `n_cameras` cameras spaced
    by the baseline along x, modelling an inline evimo2-style rig."""
    with open(path, "w") as f:
        f.write("cameras:\n")
        for i in range(n_cameras):
            T = np.eye(4)
            T[0, 3] = rig.baseline * i  # T_B_C: cam i in the body frame
            row = ", ".join(f"{v}" for v in T.reshape(-1))
            f.write(
                f"  - camera:\n"
                f"      image_width: {rig.cam.width}\n"
                f"      image_height: {rig.cam.height}\n"
                f"      intrinsics:\n"
                f"        data: [{rig.cam.fx}, {rig.cam.fy}, "
                f"{rig.cam.cx}, {rig.cam.cy}]\n"
                f"    T_B_C:\n"
                f"      data: [{row}]\n")


def write_camchain(path: str, rig: SyntheticRig) -> None:
    """A kalibr camchain YAML of the rig's two cameras, as MVSEC ships its
    calibration (calib_type 'yaml_mvsec'): pinhole intrinsics, zero radtan
    distortion, the rectified projection matrix, and cam1's T_cn_cnm1
    (cam0 -> cam1 points: a shift of -baseline along x)."""
    c = rig.cam
    proj = f"[[{c.fx}, 0.0, {c.cx}, 0.0], [0.0, {c.fy}, {c.cy}, 0.0], [0.0, 0.0, 1.0, 0.0]]"
    with open(path, "w") as f:
        for i in range(2):
            f.write(f"cam{i}:\n")
            if i == 1:
                f.write(f"  T_cn_cnm1:\n  - [1.0, 0.0, 0.0, {-rig.baseline}]\n"
                        "  - [0.0, 1.0, 0.0, 0.0]\n  - [0.0, 0.0, 1.0, 0.0]\n"
                        "  - [0.0, 0.0, 0.0, 1.0]\n")
            f.write(f"  camera_model: pinhole\n"
                    f"  distortion_coeffs: [0.0, 0.0, 0.0, 0.0]\n"
                    f"  distortion_model: radtan\n"
                    f"  intrinsics: [{c.fx}, {c.fy}, {c.cx}, {c.cy}]\n"
                    f"  projection_matrix: {proj}\n"
                    f"  resolution: [{c.width}, {c.height}]\n"
                    f"  rostopic: /davis/{('left', 'right')[i]}/events\n")


def write_fixture(
    out_dir: str, rig: Optional[SyntheticRig] = None, n_pts: int = 3000,
    n_samples: int = 30, seed: int = 7, n_cameras: int = 2,
) -> dict:
    """Write a self-contained CLI-drivable dataset: events npz per camera +
    TUM pose file.  Pairs with calib_type='esim' (stereo); with n_cameras=3
    it also writes a 3-camera 'cameras:' YAML (pairs with calib_type='yaml',
    key 'calib') modelling an inline evimo2-style rig."""
    import os

    from ..io import events as eventsmod

    rig = rig or esim_like_rig()
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    # As in the JAX package's write_fixture, the scene has make_scene's
    # default point count whatever `n_pts` says, so both write equal events.
    for i, ev in enumerate(_simulate_cameras(rig, rng, None, n_samples, n_cameras)):
        paths[f"events{i}"] = os.path.join(out_dir, f"events_{i}.npz")
        eventsmod.write_events_npz(paths[f"events{i}"], ev)
    if n_cameras >= 3:
        paths["calib"] = os.path.join(out_dir, "rig.yaml")
        _write_rig_yaml(paths["calib"], rig, n_cameras)
    ts, q, p = rig_poses(rig)
    pose_path = os.path.join(out_dir, "poses_tum.txt")
    with open(pose_path, "w") as f:
        f.write("# t x y z qx qy qz qw\n")
        for k in range(len(ts)):
            f.write(f"{ts[k]} {p[k,0]} {p[k,1]} {p[k,2]} "
                    f"{q[k,1]} {q[k,2]} {q[k,3]} {q[k,0]}\n")
    paths["poses"] = pose_path
    paths["rig"] = rig
    return paths


# ---------------------------------------------------------------------------
# ROS1 bags: the container (format 2.0) and the messages io/rosbag1.py reads
# ---------------------------------------------------------------------------

# The topics of an MVSEC recording, and the rate of its poses (Hz).
EVENT_TOPICS = ("/davis/left/events", "/davis/right/events", "/davis/third/events")
POSE_TOPIC = "/davis/left/pose"
POSE_RATE = 50.0
# Messages are packed into chunk records of about this many bytes, as the
# rosbag recorder does by default.
CHUNK_BYTES = 768 * 1024
_EVENT_DTYPE = np.dtype([("x", "<u2"), ("y", "<u2"), ("sec", "<u4"), ("nsec", "<u4"),
                         ("p", "u1")])


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _time(t: float) -> bytes:
    """A ROS time: seconds and nanoseconds, u32 each."""
    sec = int(np.floor(t))
    nsec = int(round((t - sec) * 1e9))
    return struct.pack("<II", *((sec + 1, 0) if nsec >= 1_000_000_000 else (sec, nsec)))


def _string(s: str) -> bytes:
    b = s.encode()
    return _u32(len(b)) + b


def _fields(fields: dict) -> bytes:
    """Length-prefixed `name=value` fields (values are bytes)."""
    return b"".join(_u32(len(k) + 1 + len(v)) + k.encode() + b"=" + v
                    for k, v in fields.items())


def rosbag_record(fields: dict, data: bytes) -> bytes:
    """One bag record: the length-prefixed header of `fields`, then the
    length-prefixed data."""
    header = _fields(fields)
    return _u32(len(header)) + header + _u32(len(data)) + data


def ros_header(stamp: float, frame_id: str = "") -> bytes:
    """std_msgs/Header: seq (0), stamp, frame_id."""
    return _u32(0) + _time(stamp) + _string(frame_id)


def _pose(t_xyz, q_wxyz) -> bytes:
    w, x, y, z = q_wxyz
    return struct.pack("<7d", *t_xyz, x, y, z, w)


def pose_msg(msg_type: str, stamp: float, t_xyz, q_wxyz) -> bytes:
    """One pose message of the four types the reference reads."""
    if msg_type == "geometry_msgs/PoseStamped":
        return ros_header(stamp, "world") + _pose(t_xyz, q_wxyz)
    if msg_type == "geometry_msgs/PoseWithCovarianceStamped":
        return ros_header(stamp, "world") + _pose(t_xyz, q_wxyz) + bytes(8 * 36)
    if msg_type == "nav_msgs/Odometry":
        return (ros_header(stamp, "world") + _string("base") + _pose(t_xyz, q_wxyz)
                + bytes(8 * 36) + bytes(8 * 6 + 8 * 36))
    if msg_type == "vicon/Subject":
        w, x, y, z = q_wxyz
        return ros_header(stamp) + struct.pack("<7d", *t_xyz, x, y, z, w) + b"\x00"
    raise ValueError(f"unknown pose message type {msg_type!r}")


def event_array_msg(stamp: float, x, y, t, p, width: int, height: int) -> bytes:
    """dvs_msgs/EventArray: header, height, width, then 13 packed bytes an
    event (x u16, y u16, t sec/nsec u32, polarity u8)."""
    rec = np.empty(len(x), _EVENT_DTYPE)
    rec["x"], rec["y"] = x, y
    sec = np.floor(t)
    nsec = np.rint((t - sec) * 1e9)
    carry = nsec >= 1e9
    rec["sec"] = sec + carry
    rec["nsec"] = np.where(carry, 0, nsec)
    rec["p"] = p
    return (ros_header(stamp) + _u32(height) + _u32(width) + _u32(len(x))
            + rec.tobytes())


def camera_info_msg(stamp: float, width: int, height: int, K, D=(), R=None, P=None,
                    distortion_model: str = "plumb_bob") -> bytes:
    """sensor_msgs/CameraInfo: header, height, width, distortion model, D
    (f64 a coefficient), K (3x3), R (3x3, identity by default) and P (3x4,
    [K | 0] by default), row-major f64; binning and ROI are zero."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    R = np.eye(3) if R is None else np.asarray(R, np.float64).reshape(3, 3)
    P = np.hstack([K, np.zeros((3, 1))]) if P is None else np.asarray(P, np.float64)
    D = np.asarray(D, "<f8").ravel()
    return (ros_header(stamp) + _u32(height) + _u32(width) + _string(distortion_model)
            + _u32(D.size) + D.tobytes() + K.astype("<f8").tobytes()
            + R.astype("<f8").tobytes() + P.reshape(3, 4).astype("<f8").tobytes()
            + bytes(2 * 4 + 4 * 4 + 1))


def write_rosbag(path: str, messages, compression: str = "none") -> None:
    """Write `messages`, (topic, message type, bag time s, payload bytes) in
    time order, as a ROS1 v2.0 bag: the bag header record, chunk records
    of about CHUNK_BYTES (each holding the connection records of its
    topics' first messages, then message data records), and the
    connection records again after the last chunk, where the bag header's
    index position points.  `compression` is "none" or "bz2".  No index
    data or chunk info records are written: readers of this repository
    walk the chunks."""
    if compression not in ("none", "bz2"):
        raise ValueError(f"compression must be 'none' or 'bz2', got {compression!r}")
    conns: dict = {}
    chunks, body, n = [], [], 0

    def close_chunk():
        nonlocal body, n
        if not body:
            return
        raw = b"".join(body)
        data = raw if compression == "none" else bz2.compress(raw)
        chunks.append(rosbag_record({"op": b"\x05", "compression": compression.encode(),
                                     "size": _u32(len(raw))}, data))
        body, n = [], 0

    def connection(cid, topic, msg_type):
        info = _fields({"topic": topic.encode(), "type": msg_type.encode(),
                        "md5sum": b"*", "message_definition": b""})
        return rosbag_record({"op": b"\x07", "conn": _u32(cid), "topic": topic.encode()},
                             info)

    for topic, msg_type, t, payload in messages:
        if (topic, msg_type) not in conns:
            conns[(topic, msg_type)] = len(conns)
            rec = connection(conns[(topic, msg_type)], topic, msg_type)
            body.append(rec)
            n += len(rec)
        rec = rosbag_record({"op": b"\x02", "conn": _u32(conns[(topic, msg_type)]),
                             "time": _time(t)}, payload)
        body.append(rec)
        n += len(rec)
        if n >= CHUNK_BYTES:
            close_chunk()
    close_chunk()
    # The bag header record is padded to 4096 bytes, as rosbag writes it.
    magic = b"#ROSBAG V2.0\n"
    index_pos = len(magic) + 4096 + sum(len(c) for c in chunks)
    fields = {"op": b"\x03", "index_pos": struct.pack("<Q", index_pos),
              "conn_count": _u32(len(conns)), "chunk_count": _u32(len(chunks))}
    pad = 4096 - len(rosbag_record(fields, b""))
    with open(path, "wb") as f:
        f.write(magic)
        f.write(rosbag_record(fields, b" " * pad))
        for c in chunks:
            f.write(c)
        for (topic, msg_type), cid in conns.items():
            f.write(connection(cid, topic, msg_type))


def write_bag_fixture(
    out_dir: str, rig: Optional[SyntheticRig] = None, n_pts: int = 3000,
    n_samples: int = 30, seed: int = 7, n_cameras: int = 2, duration: float = 1.0,
    t0: float = 1_500_000_000.0, events_per_msg: int = 4096, compression: str = "none",
) -> dict:
    """The rig recorded the way MVSEC ships a sequence: one ROS1 bag
    (`rig.bag`) holding a dvs_msgs/EventArray topic a camera (EVENT_TOPICS)
    and geometry_msgs/PoseStamped of the left camera on POSE_TOPIC at
    POSE_RATE Hz over `duration` s, stamped from `t0` (epoch seconds); a
    kalibr camchain for calib_type 'yaml_mvsec' (`camchain.yaml`), and with
    three cameras a 'cameras:' YAML (`rig.yaml`, calib_type 'yaml').  With
    `duration` 1 and 4,000 points the events are `write_fixture`'s.
    Returns the paths, the topics, the rig and the events."""
    import os

    rig = rig or esim_like_rig()
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    events = _simulate_cameras(rig, rng, n_pts, n_samples, n_cameras, duration)
    ts, q, p = rig_poses(rig, n=int(round(POSE_RATE * duration)) + 1, duration=duration)
    msgs = [(POSE_TOPIC, "geometry_msgs/PoseStamped", t0 + t,
             pose_msg("geometry_msgs/PoseStamped", t0 + t, p[k], q[k]))
            for k, t in enumerate(ts)]
    for i, ev in enumerate(events):
        for lo in range(0, ev.num, events_per_msg):
            sl = slice(lo, lo + events_per_msg)
            stamp = t0 + float(ev.t[lo])
            msgs.append((EVENT_TOPICS[i], "dvs_msgs/EventArray", stamp, event_array_msg(
                stamp, ev.x[sl], ev.y[sl], t0 + ev.t[sl], ev.p[sl], rig.cam.width,
                rig.cam.height)))
    msgs.sort(key=lambda m: m[2])
    paths = {"bag": os.path.join(out_dir, "rig.bag"),
             "camchain": os.path.join(out_dir, "camchain.yaml")}
    write_rosbag(paths["bag"], msgs, compression)
    write_camchain(paths["camchain"], rig)
    if n_cameras >= 3:
        paths["calib"] = os.path.join(out_dir, "rig.yaml")
        _write_rig_yaml(paths["calib"], rig, n_cameras)
    paths.update(topics=EVENT_TOPICS[:n_cameras], pose_topic=POSE_TOPIC, rig=rig,
                 events=events)
    return paths
