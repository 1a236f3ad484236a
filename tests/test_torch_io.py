"""The PyTorch port's host modules -- config, calibration, event and pose
readers, output writers, checkpoint, save pool -- against the JAX
package's on the same inputs."""

import dataclasses
import json
import logging
import os
import threading

import numpy as np
import pytest
import torch
from _torch_util import to_np
from test_calib import DSEC_MOCAP_YAML, DSEC_YAML, KALIBR_YAML, TUMVIE_JSON

from dvs_mcemvs_tpu import checkpoint as jckpt, config as jconfig, mapper as jmapper
from dvs_mcemvs_tpu.io import calib as jcalib, events as jevents, outputs as joutputs
from dvs_mcemvs_tpu.io import poses as jposes
from dvs_mcemvs_tpu.utils import synthetic as jsynth
from dvs_mcemvs_torch import checkpoint as tckpt, config as tconfig, mapper as tmapper
from dvs_mcemvs_torch.io import calib as tcalib, events as tevents, outputs as toutputs
from dvs_mcemvs_torch.io import poses as tposes
from dvs_mcemvs_torch.utils import synthetic as tsynth
from dvs_mcemvs_torch.utils.writers import SaveWorkerPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [
    [],
    ["--flagfile", os.path.join(REPO, "configs", "synthetic", "esim_stereo.conf")],
    [f"--flagfile={os.path.join(REPO, 'configs', 'evimo2', 'evimo2.conf')}",
     "--noforward_looking", "--ts", "1.25", "--full_seq", "--platform=cpu"],
    ["--process_method=5", "--num_intervals=8", "--temporal_fusion=2", "--nosave_dense",
     "--splat_backend=hist:g4,seg8,bf,pl", "--dimZ=64", "--offset1=-0.003"],
])
def test_config_to_flagfile_matches_jax(argv):
    want = jconfig.config_to_flagfile(jconfig.parse_args(argv))
    got = tconfig.config_to_flagfile(tconfig.parse_args(argv))
    assert got == want
    assert [f.name for f in dataclasses.fields(tconfig.RunConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.RunConfig)]


def test_config_refuses_unknown_flag():
    with pytest.raises(KeyError):
        tconfig.parse_args(["--no_such_flag=1"])


def _rig_fields(rig):
    return {"cams": [dataclasses.asdict(c) for c in rig.cams],
            "T_1_0": rig.T_1_0, "T_hand_eye": rig.T_hand_eye, "T_2_0": rig.T_2_0}


def _same_rig(got, want):
    g, w = _rig_fields(got), _rig_fields(want)
    assert g["cams"] == w["cams"]
    for k in ("T_1_0", "T_hand_eye", "T_2_0"):
        if w[k] is None:
            assert g[k] is None
        else:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("calib_type", ["esim", "eccv18", "dvsgen3", "slider", "hkust",
                                        "evimo2", "dsec_zurich04a", "dsec_interlaken00b"])
def test_builtin_calibrations_match_jax(calib_type):
    _same_rig(tcalib.load_calibration(calib_type), jcalib.load_calibration(calib_type))


CAMERAS_YAML = """\
cameras:
  - camera:
      image_width: 240
      image_height: 180
      intrinsics:
        data: [200.0, 201.0, 120.0, 90.0]
    T_B_C:
      data: [1, 0, 0, 0.0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]
  - camera:
      image_width: 240
      image_height: 180
      intrinsics:
        data: [200.0, 201.0, 120.0, 90.0]
    T_B_C:
      data: [1, 0, 0, 0.2, 0, 1, 0, 0.01, 0, 0, 1, 0, 0, 0, 0, 1]
"""

SONY_MOCAP_JSON = json.dumps({"rotation": {"w": 0.9, "i": 0.1, "j": -0.2, "k": 0.3},
                              "translation": {"x": 0.01, "y": -0.02, "z": 0.03}})


@pytest.mark.parametrize("calib_type", ["yaml", "yaml_mvsec", "yaml_m3ed", "sony", "json",
                                        "dsec_yaml"])
def test_file_calibrations_match_jax(tmp_path, calib_type):
    files = {"yaml": CAMERAS_YAML, "yaml_mvsec": KALIBR_YAML, "yaml_m3ed": KALIBR_YAML,
             "sony": KALIBR_YAML, "json": TUMVIE_JSON, "dsec_yaml": DSEC_YAML}
    path = tmp_path / "calib"
    path.write_text(files[calib_type])
    mocap = ""
    if calib_type in ("sony", "dsec_yaml"):
        m = tmp_path / "mocap"
        m.write_text(SONY_MOCAP_JSON if calib_type == "sony" else DSEC_MOCAP_YAML)
        mocap = str(m)
    _same_rig(tcalib.load_calibration(calib_type, str(path), mocap),
              jcalib.load_calibration(calib_type, str(path), mocap))


def test_unknown_calibration_raises():
    with pytest.raises(ValueError, match="unknown calib_type"):
        tcalib.load_calibration("no_such_rig")


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(11)
    rig = jsynth.esim_like_rig()
    pts = jsynth.make_scene(rig, rng, 400)
    return jsynth.simulate_events(rig, pts, 0, n_samples=10, rng=rng)


def _same_events(got, want):
    for f in ("x", "y", "t", "p"):
        a, b = getattr(want, f), getattr(got, f)
        if a is None:
            assert b is None
        else:
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("fmt", ["npz", "npz_us", "txt", "h5", "h5_us"])
@pytest.mark.parametrize("window", [(0.0, 1e19, 0.0), (0.3, 0.7, 0.05)])
def test_event_readers_match_jax(tmp_path, stream, fmt, window):
    """Each reader under a window and offset, with a run origin shared by
    two reads, exactly as the JAX package reads it."""
    t_start, t_stop, offset = window
    t0 = 1.5e9 if fmt.endswith("_us") else 12.5
    ev = stream
    if fmt.startswith("npz"):
        path = str(tmp_path / "ev.npz")
        t = (np.round((ev.t + t0) * 1e6).astype(np.int64) if fmt == "npz_us" else ev.t + t0)
        np.savez(path, x=ev.x, y=ev.y, t=t, p=ev.p)
    elif fmt == "txt":
        path = str(tmp_path / "ev.txt")
        np.savetxt(path, np.stack([ev.t + t0, ev.x, ev.y, ev.p], 1), fmt="%.9f %d %d %d")
    else:
        h5py = pytest.importorskip("h5py")
        path = str(tmp_path / "ev.h5")
        with h5py.File(path, "w") as f:
            g = f.create_group("events")
            g["x"], g["y"], g["p"] = ev.x, ev.y, ev.p
            if fmt == "h5_us":
                g["t"] = np.round(ev.t * 1e6).astype(np.int64)
                f["t_offset"] = np.int64(t0 * 1e6)
            else:
                g["t"] = ev.t + t0
    jorigin, torigin = jevents.TimeOrigin(), tevents.TimeOrigin()
    for _ in range(2):
        want = jevents.read_events(path, t_start=t_start, t_stop=t_stop, offset=offset,
                                   origin=jorigin)
        got = tevents.read_events(path, t_start=t_start, t_stop=t_stop, offset=offset,
                                  origin=torigin)
        _same_events(got, want)
        assert torigin.t0 == jorigin.t0


def test_h5_source_and_npz_writer_match_jax(tmp_path, stream):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "ev.h5")
    with h5py.File(path, "w") as f:
        f["t"], f["x"], f["y"], f["p"] = stream.t + 3.0, stream.x, stream.y, stream.p
    with jevents.H5EventSource(path) as a, tevents.H5EventSource(path) as b:
        assert b.count == a.count and b.time_at(7) == a.time_at(7)
        for ca, cb in zip(a.read(10, 90), b.read(10, 90)):
            np.testing.assert_array_equal(cb, ca)
    jevents.write_events_npz(str(tmp_path / "j.npz"), stream)
    tevents.write_events_npz(str(tmp_path / "t.npz"), stream)
    _same_events(tevents.read_events(str(tmp_path / "t.npz")),
                 jevents.read_events(str(tmp_path / "j.npz")))


def test_bag_inputs_match_jax(tmp_path):
    """A bag's events need their topic (`read_events_rosbag`), as in the JAX
    package; its poses read through `read_poses` as the JAX package's do."""
    from dvs_mcemvs_torch.utils import synthetic as tsynth

    for mod in (jevents, tevents):
        with pytest.raises(ValueError, match="read_events_rosbag"):
            mod.read_events("events.bag")
    paths = tsynth.write_bag_fixture(str(tmp_path), n_pts=300, n_samples=4)
    jo, to = jevents.TimeOrigin(), tevents.TimeOrigin()
    want = jposes.read_poses(paths["bag"], topic=paths["pose_topic"], origin=jo)
    got = tposes.read_poses(paths["bag"], topic=paths["pose_topic"], origin=to, device="cpu")
    assert to.t0 == jo.t0 and got.ts.shape[0] == 51
    np.testing.assert_array_equal(to_np(got.ts), np.asarray(want.ts))
    np.testing.assert_array_equal(to_np(got.poses.t), np.asarray(want.poses.t))


@pytest.mark.parametrize("fmt", ["tum", "npz_qp", "npz_T"])
def test_pose_readers_match_jax(tmp_path, fmt):
    rng = np.random.default_rng(12)
    n = 30
    ts = np.sort(rng.uniform(5.0, 8.0, n))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 0] < 0] *= -1
    p = rng.normal(size=(n, 3))
    if fmt == "tum":
        path = str(tmp_path / "poses.txt")
        np.savetxt(path, np.column_stack([ts, p, q[:, 1:], q[:, :1]]), header="t x y z qx qy qz qw")
    elif fmt == "npz_qp":
        path = str(tmp_path / "poses.npz")
        np.savez(path, t=ts, q=q, p=p)
    else:
        from dvs_mcemvs_tpu.ops import se3 as jse3

        path = str(tmp_path / "poses.npz")
        T = np.tile(np.eye(4), (n, 1, 1))
        T[:, :3, :3] = np.asarray(jse3.quat_to_matrix(np.asarray(q, np.float32)))
        T[:, :3, 3] = p
        np.savez(path, t=ts, T=T)
    jo, to = jevents.TimeOrigin(), tevents.TimeOrigin()
    want = jposes.read_poses(path, t_start=0.5, t_stop=2.5, origin=jo)
    got = tposes.read_poses(path, t_start=0.5, t_stop=2.5, origin=to, device="cpu")
    assert to.t0 == jo.t0
    np.testing.assert_array_equal(to_np(got.ts), np.asarray(want.ts))
    # The normalisation of the quaternions rounds in another order (one f32
    # step); the matrix path also converts in f32 on both sides.
    atol = 2e-6 if fmt == "npz_T" else 1.2e-7
    np.testing.assert_allclose(to_np(got.poses.q), np.asarray(want.poses.q), atol=atol, rtol=0)
    np.testing.assert_array_equal(to_np(got.poses.t), np.asarray(want.poses.t))


def test_pose_reader_defaults_to_the_card(tmp_path, monkeypatch):
    path = str(tmp_path / "poses.npz")
    np.savez(path, t=np.arange(3.0), q=np.tile([1.0, 0, 0, 0], (3, 1)), p=np.zeros((3, 3)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tposes.read_poses(path)


@pytest.fixture(scope="module")
def depth_maps():
    rng = np.random.default_rng(13)
    H, W = 60, 80
    depth = rng.uniform(1.0, 4.0, (H, W)).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.7).astype(np.uint8)
    conf = (rng.gamma(0.5, 3.0, (H, W)) * (rng.uniform(size=(H, W)) > 0.2)).astype(np.float32)
    return depth, conf, mask


def test_depth_map_artifacts_match_jax(tmp_path, depth_maps):
    """Point lists byte for byte; PNGs pixel for pixel as cv2 reads them."""
    cv2 = pytest.importorskip("cv2")
    depth, conf, mask = depth_maps
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    joutputs.save_depth_maps(depth, conf, mask, 1.0, 4.0, "fused", str(jdir) + "/x")
    toutputs.save_depth_maps(depth, conf, mask, 1.0, 4.0, "fused", str(tdir) + "/x")
    joutputs.save_dense_depth_png(str(jdir / "dense.png"), depth, 1.0, 4.0)
    toutputs.save_dense_depth_png(str(tdir / "dense.png"), depth, 1.0, 4.0)
    joutputs.write_dsi_slices_png(str(jdir / "slices"), np.stack([depth, conf]))
    toutputs.write_dsi_slices_png(str(tdir / "slices"), np.stack([depth, conf]))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in names:
        if name.endswith(".txt"):
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    pngs = [n for n in names if n.endswith(".png")]
    pngs += [f"slices/{n}" for n in sorted(os.listdir(jdir / "slices"))]
    assert len(pngs) == 5
    for name in pngs:
        for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
            a = cv2.imread(str(jdir / name), flag)
            b = cv2.imread(str(tdir / name), flag)
            assert a is not None and b is not None and a.shape == b.shape, name
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_colour_map_and_dilation_match_opencv():
    cv2 = pytest.importorskip("cv2")
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)
    np.testing.assert_array_equal(toutputs.JET_BGR, lut[:, 0, :])
    img = (np.random.default_rng(14).uniform(size=(9, 11, 3)) > 0.8).astype(np.uint8) * 200
    element = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
    np.testing.assert_array_equal(toutputs.dilate_cross(img), cv2.dilate(img, element))


def test_events_png_and_conf_stats_match_jax(tmp_path, stream):
    cv2 = pytest.importorskip("cv2")
    joutputs.save_events_png(str(tmp_path / "j.png"), stream, 240, 180)
    toutputs.save_events_png(str(tmp_path / "t.png"), tmapper.Events(*stream), 240, 180)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))
    for mod, name in ((joutputs, "j.txt"), (toutputs, "t.txt")):
        mod.save_conf_stats(str(tmp_path / name), 0.125, 7.5)
        mod.save_conf_stats(str(tmp_path / name), 1.0, 2.0)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert toutputs.timestamp_prefix("d", 0.5) == joutputs.timestamp_prefix("d", 0.5)


def test_png_encoder_refuses_other_images():
    with pytest.raises(TypeError):
        toutputs.encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        toutputs.encode_png(np.zeros((2, 2, 4), np.uint8))


def test_fixture_writer_matches_jax(tmp_path):
    """write_fixture writes the JAX package's dataset, file for file."""
    jp = jsynth.write_fixture(str(tmp_path / "j"), n_pts=300, n_samples=6, n_cameras=3)
    tp = tsynth.write_fixture(str(tmp_path / "t"), n_pts=300, n_samples=6, n_cameras=3)
    for key in ("events0", "events1", "events2"):
        _same_events(tevents.read_events(tp[key]), jevents.read_events(jp[key]))
    for key in ("poses", "calib"):
        assert open(tp[key]).read() == open(jp[key]).read()


def test_checkpoint_matches_jax(tmp_path):
    text = tconfig.config_to_flagfile(tconfig.parse_args(["--full_seq", "--out_path=a/"]))
    other = tconfig.config_to_flagfile(tconfig.parse_args(["--full_seq", "--out_path=b/"]))
    assert tckpt.config_fingerprint(text) == jckpt.config_fingerprint(text)
    assert tckpt.config_fingerprint(other) == tckpt.config_fingerprint(text)
    path = str(tmp_path / "checkpoint.json")
    c = tckpt.RunCheckpoint(path, fingerprint="abc")
    c.mark_done(2, 0.5)
    c.mark_done(0, 0.25)
    assert jckpt.RunCheckpoint(path, fingerprint="abc").is_done(2)
    again = tckpt.RunCheckpoint(path, fingerprint="abc")
    assert again.num_done == 2 and again.is_done(0) and not again.is_done(1)
    assert tckpt.RunCheckpoint(path, fingerprint="other").num_done == 0


def test_save_pool_reports_every_failed_save(caplog):
    """On the error path the pool waits for its running saves and logs the
    exception of every one that failed; none is dropped."""
    release = threading.Event()

    def fail(tag):
        release.wait(timeout=10)
        raise OSError(f"disk full on {tag}")

    with caplog.at_level(logging.ERROR):
        with pytest.raises(RuntimeError, match="chunk loop"):
            with SaveWorkerPool(workers=2, max_inflight=4) as pool:
                pool.submit(fail, "chunk-0")
                pool.submit(fail, "chunk-1")
                release.set()
                raise RuntimeError("chunk loop failed")
    assert "disk full on chunk-0" in caplog.text
    assert "disk full on chunk-1" in caplog.text


def test_save_pool_reports_every_failed_save_on_a_clean_exit(caplog):
    """When the loop ends cleanly, leaving the pool re-raises the first
    failed save, logs every failure and still joins its workers."""
    release = threading.Event()

    def fail(tag):
        release.wait(timeout=10)
        raise OSError(f"disk full on {tag}")

    with caplog.at_level(logging.ERROR):
        with pytest.raises(OSError, match="disk full on chunk-0"):
            with SaveWorkerPool(workers=2, max_inflight=4) as pool:
                pool.submit(fail, "chunk-0")
                pool.submit(fail, "chunk-1")
                release.set()
    assert "disk full on chunk-0" in caplog.text
    assert "disk full on chunk-1" in caplog.text
    assert pool._ex._shutdown and not pool._pending


def test_save_pool_reraises_on_drain():
    def fail():
        raise OSError("write failed")

    pool = SaveWorkerPool(workers=1)
    pool.submit(fail)
    with pytest.raises(OSError, match="write failed"):
        pool.drain()
    pool.shutdown()


def test_mapper_events_slicing_matches_jax(stream):
    tev = tmapper.Events(*stream)
    for t0, t1 in ((0.2, 0.5), (0.0, 2.0), (0.5, 0.5), (0.7, 0.6)):
        _same_events(tev.time_window(t0, t1), jmapper.Events(*stream).time_window(t0, t1))
    _same_events(tev.slice(3, 40), stream.slice(3, 40))
