"""ROS1 bag ingest of the PyTorch port against the JAX package on the CPU.

Bags come from the port's fixture writer (`utils.synthetic.write_rosbag`,
`write_bag_fixture`); the JAX reader reads each of them too, so the writer
is held to the format.  Then the CLI of both packages runs an MVSEC-style
flagfile on one bag (both event topics and the pose topic in it, a kalibr
camchain for `yaml_mvsec`) and the artifacts are held as
tests/test_torch_cli.py holds them.
"""

import os

import numpy as np
import pytest
from _torch_util import assert_same_cli_artifacts, to_np

from dvs_mcemvs_tpu import cli as jcli
from dvs_mcemvs_tpu.io import events as jevents, poses as jposes, rosbag1 as jbag
from dvs_mcemvs_tpu.utils import synthetic as jsynth
from dvs_mcemvs_torch import cli as tcli
from dvs_mcemvs_torch.io import events as tevents, poses as tposes, rosbag1 as tbag
from dvs_mcemvs_torch.utils import synthetic as tsynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_506_117_000.0   # bag stamps in epoch seconds, as an MVSEC recording's
POSE_TYPES = ["geometry_msgs/PoseStamped", "geometry_msgs/PoseWithCovarianceStamped",
              "nav_msgs/Odometry", "vicon/Subject"]


def _poses(n=12, seed=30):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return T0 + np.sort(rng.uniform(0, 2, n)), q, rng.normal(size=(n, 3))


@pytest.mark.parametrize("msg_type", POSE_TYPES)
def test_pose_bags_match_jax(tmp_path, msg_type):
    """Every pose type, shuffled in bag time, one message with a zero stamp
    (read at its bag time), and a message of another type on the topic
    (skipped)."""
    ts, q, p = _poses()
    msgs = [("/pose", msg_type, float(t) + 0.01, tsynth.pose_msg(msg_type, float(t), p[k], q[k]))
            for k, t in enumerate(ts)]
    msgs[3] = ("/pose", msg_type, float(ts[3]), tsynth.pose_msg(msg_type, 0.0, p[3], q[3]))
    msgs.append(("/pose", "std_msgs/String", float(ts[0]), tsynth.ros_header(0.0)))
    path = str(tmp_path / "poses.bag")
    tsynth.write_rosbag(path, [msgs[k] for k in np.random.default_rng(1).permutation(len(msgs))])
    want = jbag.read_pose_bag(path, "/pose")
    got = tbag.read_pose_bag(path, "/pose")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], ts, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], q[np.argsort(ts)])
    jo, to = jevents.TimeOrigin(), tevents.TimeOrigin()
    jt = jposes.read_poses(path, topic="/pose", t_start=0.2, t_stop=1.5, origin=jo)
    tt = tposes.read_poses(path, topic="/pose", t_start=0.2, t_stop=1.5, origin=to, device="cpu")
    assert to.t0 == jo.t0
    np.testing.assert_array_equal(to_np(tt.ts), np.asarray(jt.ts))
    np.testing.assert_allclose(to_np(tt.poses.q), np.asarray(jt.poses.q), atol=1.2e-7, rtol=0)
    np.testing.assert_array_equal(to_np(tt.poses.t), np.asarray(jt.poses.t))


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_event_bags_match_jax(tmp_path, compression):
    """dvs_msgs/EventArray over several messages and chunks on two topics,
    with a pose topic between them; the readers' window, offset and shared
    time origin."""
    paths = tsynth.write_bag_fixture(str(tmp_path), n_pts=800, n_samples=12, t0=T0,
                                     events_per_msg=1000, compression=compression)
    bag = paths["bag"]
    assert jbag.topics(bag) == {**{t: "dvs_msgs/EventArray" for t in paths["topics"]},
                                paths["pose_topic"]: "geometry_msgs/PoseStamped"}
    for i, topic in enumerate(paths["topics"]):
        want = jbag.read_event_bag(bag, topic)
        got = tbag.read_event_bag(bag, topic)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        ev = paths["events"][i]
        np.testing.assert_array_equal(got[0], ev.x)
        np.testing.assert_allclose(got[2] - T0, ev.t, rtol=0, atol=1e-6)
    jo, to = jevents.TimeOrigin(), tevents.TimeOrigin()
    for i, topic in enumerate(paths["topics"]):
        want = jevents.read_events_rosbag(bag, topic, t_start=0.1, t_stop=0.8, offset=0.01 * i,
                                          origin=jo)
        got = tevents.read_events_rosbag(bag, topic, t_start=0.1, t_stop=0.8, offset=0.01 * i,
                                         origin=to)
        for f in ("x", "y", "t", "p"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.num > 0
    assert to.t0 == jo.t0


def test_bag_writer_records_write_fixture_events(tmp_path):
    """With duration 1 the bag holds write_fixture's events (the same seed;
    write_fixture's scene has 4,000 points), and both packages' simulators
    agree on them."""
    npz = tsynth.write_fixture(str(tmp_path / "npz"), n_samples=10)
    jnpz = jsynth.write_fixture(str(tmp_path / "jnpz"), n_samples=10)
    bag = tsynth.write_bag_fixture(str(tmp_path / "bag"), n_pts=4000, n_samples=10)
    for i in range(2):
        a = tevents.read_events(npz[f"events{i}"])
        b = jevents.read_events(jnpz[f"events{i}"])
        c = tevents.read_events_rosbag(bag["bag"], bag["topics"][i])
        for f in ("x", "y", "p"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(getattr(c, f), getattr(a, f))
        np.testing.assert_allclose(c.t - 1.5e9, a.t, rtol=0, atol=1e-6)


def test_unreadable_bags_raise(tmp_path):
    """An lz4 chunk and a file that is not a ROS1 v2.0 bag raise in both
    packages, with the same message."""
    lz4 = str(tmp_path / "lz4.bag")
    with open(lz4, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(tsynth.rosbag_record({"op": b"\x05", "compression": b"lz4",
                                      "size": (4).to_bytes(4, "little")}, b"\x00" * 4))
    text = str(tmp_path / "text.bag")
    with open(text, "w") as f:
        f.write("0.1 1 2 1\n")
    for path, match in ((lz4, "lz4"), (text, "not a ROS1")):
        for mod in (jbag, tbag):
            with pytest.raises(ValueError, match=match):
                mod.read_event_bag(path, "/davis/left/events")


@pytest.mark.parametrize("model,nd", [("plumb_bob", 5), ("equidistant", 4), ("", 0)],
                         ids=["plumb_bob", "equidistant", "no-distortion"])
def test_camera_info_bags_match_jax(tmp_path, model, nd):
    """CameraInfo from the port's writer (`camera_info_msg`), beside an
    event topic and a second CameraInfo topic: both packages read equal
    dicts and the same topic map, and a topic with no CameraInfo raises in
    both."""
    rng = np.random.default_rng(31)
    K = np.array([[200.0, 0.0, 170.5], [0.0, 201.5, 130.25], [0.0, 0.0, 1.0]])
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    P = np.hstack([K * 0.9, rng.normal(size=(3, 1))])
    D = rng.normal(size=nd) * 0.1
    msgs = [
        ("/davis/left/camera_info", "sensor_msgs/CameraInfo", T0,
         tsynth.camera_info_msg(T0, 346, 260, K, D, R, P, distortion_model=model)),
        ("/davis/left/events", "dvs_msgs/EventArray", T0 + 0.1,
         tsynth.event_array_msg(T0 + 0.1, [1, 2], [3, 4], np.array([T0, T0 + 0.05]),
                                [1, 0], 346, 260)),
        ("/davis/right/camera_info", "sensor_msgs/CameraInfo", T0 + 0.2,
         tsynth.camera_info_msg(T0 + 0.2, 346, 260, K)),
    ]
    bag = str(tmp_path / "ci.bag")
    tsynth.write_rosbag(bag, msgs)
    assert tbag.topics(bag) == jbag.topics(bag) == {
        "/davis/left/camera_info": "sensor_msgs/CameraInfo",
        "/davis/left/events": "dvs_msgs/EventArray",
        "/davis/right/camera_info": "sensor_msgs/CameraInfo"}
    for topic in ("/davis/left/camera_info", "/davis/right/camera_info"):
        got, want = tbag.read_camera_info_bag(bag, topic), jbag.read_camera_info_bag(bag, topic)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    got = tbag.read_camera_info_bag(bag, "/davis/left/camera_info")
    assert got["distortion_model"] == model and (got["width"], got["height"]) == (346, 260)
    np.testing.assert_array_equal(got["K"], K)
    np.testing.assert_array_equal(got["D"], D)
    np.testing.assert_array_equal(got["R"], R)
    np.testing.assert_array_equal(got["P"], P)
    right = tbag.read_camera_info_bag(bag, "/davis/right/camera_info")
    np.testing.assert_array_equal(right["R"], np.eye(3))
    np.testing.assert_array_equal(right["P"], np.hstack([K, np.zeros((3, 1))]))
    for mod in (jbag, tbag):
        with pytest.raises(ValueError, match="CameraInfo"):
            mod.read_camera_info_bag(bag, "/davis/left/events")


# ---------------------------------------------------------------------------
# The CLI on a bag: an MVSEC preset's flags with the fixture's paths
# ---------------------------------------------------------------------------

MVSEC_ALG1 = os.path.join(REPO, "configs", "upenn_mvsec", "flying1_full", "alg1",
                          "flying1.conf")
BAG_RUNS = {
    # process_1 single-shot, the exact scatter.
    "p1": ["--full_seq=false", "--ts=0.5", "--save_dsi", "--save_mono",
           "--splat_backend=scatter"],
    # The preset's own sliding window (2 chunks here) on a one-hot-engine
    # spec.
    "fs": ["--duration=0.5", "--out_skip=0.4", "--save_dsi", "--nosave_pointcloud",
           "--splat_backend=hist:g8,seg4"],
    # Three cameras: the third event topic of the same bag.
    "3cam": ["--full_seq=false", "--ts=0.5", "--save_dsi", "--save_mono",
             "--nosave_pointcloud", "--splat_backend=scatter", "--calib_type=yaml"],
}


@pytest.fixture(scope="module")
def bag_runs(tmp_path_factory):
    """{run: (jax out dir, port out dir)} of every BAG_RUNS configuration
    on the esim fixture recorded in one bag with three event topics."""
    d = str(tmp_path_factory.mktemp("bag_fixture"))
    paths = tsynth.write_bag_fixture(d, rig=tsynth.esim_like_rig(travel=0.4), n_pts=1200,
                                     n_samples=25, n_cameras=3)
    out = {}
    for name, extra in BAG_RUNS.items():
        calib = paths["calib"] if name == "3cam" else paths["camchain"]
        dirs = []
        for pkg, mod in (("jax", jcli), ("torch", tcli)):
            o = os.path.join(d, f"{pkg}_{name}")
            args = [f"--flagfile={MVSEC_ALG1}", f"--bag_filename={paths['bag']}",
                    f"--calib_path={calib}", f"--out_path={o}/", "--start_time_s=0",
                    "--stop_time_s=1", "--dimZ=32", "--packet_size=256", "--platform=cpu"]
            if name == "3cam":
                args.append(f"--event_topic2={paths['topics'][2]}")
            assert mod.main(args + extra) == 0
            dirs.append(o)
        out[name] = tuple(dirs)
    return out


@pytest.mark.parametrize("name", list(BAG_RUNS))
def test_cli_on_a_bag_writes_the_jax_artifacts(bag_runs, name):
    jdir, tdir = bag_runs[name]
    assert_same_cli_artifacts(jdir, tdir)
    files = os.listdir(tdir)
    if name == "fs":
        assert len([f for f in files if f.endswith("depth_points_fused.txt")]) == 2
    if name == "3cam":
        assert {"events_2.png", "dsi_camera2.npy"} <= set(files)


def test_cli_on_a_bag_puts_depth_on_the_planes(bag_runs):
    """process_1 from the bag: the fused depth lies on the 1.5 / 2.5 m planes."""
    _, tdir = bag_runs["p1"]
    f = [x for x in os.listdir(tdir) if x.endswith("depth_points_fused.txt")][0]
    d = np.loadtxt(os.path.join(tdir, f))[:, 2]
    assert d.size > 100
    assert np.median(np.minimum(np.abs(d - 1.5), np.abs(d - 2.5))) < 0.2
