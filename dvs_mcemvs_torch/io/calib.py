"""Dataset calibration registry -> `RigCalibration`.

Port of dvs_mcemvs_tpu/io/calib.py (host-side numpy, copied so the port
imports nothing of the JAX package): the reference's 14 dataset calibration
loaders (reference: mapper_emvs_stereo/src/calib.cpp:31-1055), dispatched by
`calib_type` exactly as main.cpp:117-142 does.  OpenCV (for the default
projection of some rigs) and PyYAML (for the YAML files) are imported only
by the loaders that need them.  All loaders follow the reference's two rig
conventions:

  * **Shared P**: every camera of a rig adopts camera 0's rectified
    projection matrix so all DSIs share intrinsics (calib.cpp:106-108,
    411-413, 886; rationale at :981-982).
  * Outputs are (cam0, cam1[, cam2], T_1_0[, T_2_0], T_hand_eye) where
    T_1_0 maps cam0-frame points into the cam1 frame and trajectories chain
    as traj_i = poses ∘ T_hand_eye ∘ T_i_0⁻¹ (main.cpp:317-334).
"""

from __future__ import annotations

import dataclasses
import json as jsonlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.camera import FISHEYE, NONE, PLUMB_BOB, PinholeCamera


@dataclasses.dataclass(frozen=True)
class RigCalibration:
    """Multi-camera rig: cameras (shared rectified P), chained extrinsics."""

    cams: Tuple[PinholeCamera, ...]
    T_1_0: np.ndarray                    # 4x4, cam0 -> cam1
    T_hand_eye: np.ndarray               # 4x4, body/marker -> cam0
    T_2_0: Optional[np.ndarray] = None   # 4x4, cam0 -> cam2 (trinocular)

    @property
    def num_cameras(self) -> int:
        return len(self.cams)

    def extrinsics(self, i: int) -> np.ndarray:
        """T_i_0 for camera i (identity for camera 0)."""
        if i == 0:
            return np.eye(4)
        if i == 1:
            return self.T_1_0
        if i == 2 and self.T_2_0 is not None:
            return self.T_2_0
        raise IndexError(f"no extrinsics for camera {i}")


def _optimal_new_K(K: np.ndarray, D: Sequence[float], width: int, height: int) -> np.ndarray:
    """cv::getOptimalNewCameraMatrix(alpha=0) — the reference's default P when
    none is given in the file (calib.cpp e.g. :92-100, :404-410)."""
    import cv2

    P, _ = cv2.getOptimalNewCameraMatrix(
        np.asarray(K, np.float64), np.asarray(D, np.float64),
        (int(width), int(height)), 0,
    )
    return np.asarray(P, np.float64)


def _cam(width, height, K, D=(), model=NONE, R=None, P=None) -> PinholeCamera:
    K = np.asarray(K, np.float64).reshape(3, 3)
    kwargs = dict(
        width=int(width), height=int(height),
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
        distortion_model=model, D=tuple(float(d) for d in D),
    )
    if R is not None:
        kwargs["R"] = tuple(np.asarray(R, np.float64).reshape(9))
    if P is not None:
        P = np.asarray(P, np.float64).reshape(3, -1)
        kwargs.update(P_fx=float(P[0, 0]), P_fy=float(P[1, 1]),
                      P_cx=float(P[0, 2]), P_cy=float(P[1, 2]))
    return PinholeCamera(**kwargs)


def _share_p(cams: List[PinholeCamera]) -> List[PinholeCamera]:
    return [cams[0]] + [c.with_projection(cams[0]) for c in cams[1:]]


def _rpy_to_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """tf::Quaternion::setRPY convention: R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _pose_rpy(x, y, z, roll, pitch, yaw) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _rpy_to_matrix(roll, pitch, yaw)
    T[:3, 3] = [x, y, z]
    return T


# ---------------------------------------------------------------------------
# Hard-coded rigs (calib.cpp:591-632, 635-676, 678-807, 901-933, 939-1006,
# 1011-1054)
# ---------------------------------------------------------------------------


def calib_esim() -> RigCalibration:
    """Synthetic ESIM stereo rig (calib.cpp:901-933)."""
    cam = _cam(240, 180, [[200, 0, 120], [0, 200, 90], [0, 0, 1]],
               D=(0, 0, 0, 0, 0), model=PLUMB_BOB,
               P=[[200, 0, 120], [0, 200, 90], [0, 0, 1]])
    T_1_0 = np.eye(4)
    T_1_0[0, 3] = -0.2
    return RigCalibration(cams=tuple(_share_p([cam, cam])), T_1_0=T_1_0,
                          T_hand_eye=np.eye(4))


def calib_eccv18() -> RigCalibration:
    """rpg DAVIS stereo (Zhou ECCV'18) rig (calib.cpp:939-1006)."""
    P = [[156.925, 0, 108.167], [0, 156.925, 78.4205], [0, 0, 1]]
    cam0 = _cam(240, 180,
                [[196.63936292910697, 0, 105.06412666477927],
                 [0, 196.7329768429481, 72.47170071387173], [0, 0, 1]],
                D=(-0.3367326394292646, 0.11178850939644308,
                   -0.0014005281258491276, -0.00045959441440687044, 0.0),
                model=PLUMB_BOB, P=P)
    cam1 = _cam(240, 180,
                [[196.42564072599785, 0, 110.74517642512458],
                 [0, 196.56440793223533, 88.11310058123058], [0, 0, 1]],
                D=(-0.3462937629552321, 0.12772002965572962,
                   -0.00027205054024332645, -0.00019580078540073353, 0.0),
                model=PLUMB_BOB, P=P)
    T_1_0 = np.array([
        [0.9991089760393723, -0.04098010198963204, 0.010093821797214667, -0.1479883582369969],
        [0.04098846609277917, 0.9991594254283246, -0.000623077121092687, -0.003289908601915284],
        [-0.010059803423311134, 0.0010362522169301642, 0.9999488619606629, 0.0026798262366239016],
        [0, 0, 0, 1],
    ])
    T_he = np.array([
        [5.363262328777285e-01, -1.748374625145743e-02, -8.438296573030597e-01, -7.009849865398374e-02],
        [8.433577587813513e-01, -2.821937531845164e-02, 5.366109927684415e-01, 1.881333563905305e-02],
        [-3.319431623758162e-02, -9.994488408486204e-01, -3.897382049768972e-04, -6.966829200678797e-02],
        [0, 0, 0, 1],
    ])
    return RigCalibration(cams=tuple(_share_p([cam0, cam1])), T_1_0=T_1_0,
                          T_hand_eye=T_he)


def calib_dvsgen3() -> RigCalibration:
    """Samsung DVS Gen3 stereo (calib.cpp:1011-1054); fisheye distortion,
    upside-down mount hand-eye."""
    P = [[229.308843, 0, 360.397785], [0, 229.308843, 240.487692], [0, 0, 1]]
    cam0 = _cam(640, 480,
                [[312.792763, 0, 332.917834], [0, 312.783965, 243.939008], [0, 0, 1]],
                D=(-0.0725278887080172, -0.016272832786070585,
                   0.018086976118303524, -0.006273794980217994),
                model=FISHEYE, P=P)
    cam1 = _cam(640, 480,
                [[313.830823, 0, 315.546105], [0, 313.574021, 236.394256], [0, 0, 1]],
                D=(-0.08882686690699892, 0.01577827485517159,
                   -0.0052555366228499815, -0.0013447832389448702),
                model=FISHEYE, P=P)
    T_1_0 = np.array([
        [0.9998198591825752, -0.007121797657941711, 0.017593441455644072, 0.09996202759173385],
        [0.00713950571971245, 0.9999740679095885, -0.0009439101790861793, -0.0002694072525916161],
        [-0.017586262883626885, 0.001069348618236941, 0.999844777878706, -0.0011054303261930172],
        [0, 0, 0, 1],
    ])
    T_he = np.diag([-1.0, -1.0, 1.0, 1.0])
    return RigCalibration(cams=tuple(_share_p([cam0, cam1])), T_1_0=T_1_0,
                          T_hand_eye=T_he)


def calib_slider(calib_path: str = "") -> RigCalibration:
    """TU Berlin slider sequence rig (calib.cpp:591-632); note the per-camera
    rectification rotations R."""
    P = [[193.4488673170594, 0, 137.1049880981445], [0, 193.4488673170594, 108.951057434082], [0, 0, 1]]
    cam0 = _cam(240, 180,
                [[198.9035679113487, 0, 139.8751842835105], [0, 198.8472302496314, 104.0170363461823], [0, 0, 1]],
                D=(-0.3693817071651257, 0.1677750957297015, 0.0007676172676998043, -0.001200264930281811, 0),
                model=PLUMB_BOB,
                R=[0.9997156212398773, 0.02379292338064179, 0.001604196362382244,
                   -0.02378757584963585, 0.9997116745775861, -0.003273980524687744,
                   -0.001681631399562056, 0.003234889531517614, 0.9999933537806914],
                P=P)
    cam1 = _cam(240, 180,
                [[198.1315372343827, 0, 132.4194623418875], [0, 198.0677328525099, 111.1773834719834], [0, 0, 1]],
                D=(-0.3425648318682812, 0.1238467273033616, 0.0004063467878750188, 0.0004690582572504908, 0),
                model=PLUMB_BOB,
                R=[0.9999365173339012, 0.007076042854404519, 0.008768746756027635,
                   -0.007104545173989656, 0.999969566560146, 0.003223568113795293,
                   -0.008745669786783357, -0.003285661430544528, 0.9999563578921555],
                P=P)
    T_1_0 = np.eye(4)
    T_1_0[0, 3] = -0.15
    return RigCalibration(cams=tuple(_share_p([cam0, cam1])), T_1_0=T_1_0,
                          T_hand_eye=np.eye(4))


def calib_hkust(calib_path: str = "") -> RigCalibration:
    """HKUST DAVIS346 stereo rig (calib.cpp:635-676).

    The reference feeds cam1 a malformed K whose third row is not (0,0,1) —
    image_geometry only reads fx/fy/cx/cy from it, so we extract those.
    """
    P = [[189.705, 0, 165.382], [0, 189.705, 121.295], [0, 0, 1]]
    cam0 = _cam(346, 260,
                [[263.796, 0, 176.994], [0, 263.738, 124.373], [0, 0, 1]],
                D=(-0.386589, 0.157241, 0.000322143, 6.13759e-06),
                model=PLUMB_BOB, P=P)
    cam1 = _cam(346, 260,
                [[263.485, 0, 162.942], [0, 263.276, 118.029], [0, 0, 1]],
                D=(-0.383425, 0.152823, -0.000257745, 0.000268432),
                model=PLUMB_BOB, P=P)
    T_1_0 = np.array([
        [9.99990798e-01, -6.32492385e-04, -4.24307214e-03, -7.30597639e-02],
        [6.44736387e-04, 9.99995631e-01, 2.88489843e-03, -1.23275257e-03],
        [4.24122892e-03, -2.88760755e-03, 9.99986837e-01, -1.10420407e-03],
        [0, 0, 0, 1.0],
    ])
    return RigCalibration(cams=tuple(_share_p([cam0, cam1])), T_1_0=T_1_0,
                          T_hand_eye=np.eye(4))


def calib_evimo2(calib_path: str = "") -> RigCalibration:
    """EVIMO2 trinocular rig: Samsung mono DVS + 2 Prophesee cams
    (calib.cpp:678-807); extrinsics given as x,y,z + RPY w.r.t. the rig body."""
    K0 = [[519.638, 0, 321.661], [0, 519.384, 240.727], [0, 0, 1]]
    D0 = (0.108306, -0.154485, 0.00103538, -0.000401824)
    P = _optimal_new_K(np.asarray(K0), D0, 640, 480)
    cam0 = _cam(640, 480, K0, D=D0, model=PLUMB_BOB, P=P)
    cam1 = _cam(640, 480,
                [[558.417, 0, 324.905], [0, 557.475, 225.3], [0, 0, 1]],
                D=(-0.115993, 0.204851, -0.00217161, 0.000676025),
                model=PLUMB_BOB, P=P)
    cam2 = _cam(640, 480,
                [[556.184, 0, 326.875], [0, 555.632, 202.887], [0, 0, 1]],
                D=(-0.110194, 0.205049, 0.00206719, -0.00040706),
                model=PLUMB_BOB, P=P)
    T_B_0 = _pose_rpy(0.135419, -0.0214639, -0.0715952, -0.00748326, 0.0496968, -1.79144)
    T_B_1 = _pose_rpy(0.118804, 0.0850843, -0.0194297, 0.018838, 0.00459314, -0.195708)
    T_B_2 = _pose_rpy(0.0754507, -0.119035, -0.0336873, -0.0122178, -0.00473387, 2.93835)
    return RigCalibration(
        cams=tuple(_share_p([cam0, cam1, cam2])),
        T_1_0=np.linalg.inv(T_B_1) @ T_B_0,
        T_2_0=np.linalg.inv(T_B_2) @ T_B_0,
        T_hand_eye=T_B_0,
    )


# ---------------------------------------------------------------------------
# File-driven loaders
# ---------------------------------------------------------------------------


def _load_yaml(path: str):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _kalibr_cam(node: Dict, fallback_P: bool = True) -> PinholeCamera:
    """Parse one kalibr-style camN block (resolution/intrinsics/
    distortion_model/distortion_coeffs[/projection_matrix])."""
    w, h = node["resolution"]
    fx, fy, cx, cy = node["intrinsics"]
    K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]
    dist = node.get("distortion_model", "none")
    if dist == "none":
        model, D = PLUMB_BOB, (0.0,) * 5
    elif dist == "equidistant":
        model, D = FISHEYE, tuple(node["distortion_coeffs"])
    elif dist == "radtan":
        model, D = PLUMB_BOB, tuple(node["distortion_coeffs"])
    else:
        raise ValueError(f"unknown distortion model {dist!r}")
    if "projection_matrix" in node:
        P = np.asarray(node["projection_matrix"], np.float64)[:3, :3]
    elif fallback_P:
        P = _optimal_new_K(np.asarray(K), D, w, h)
    else:
        P = None
    return _cam(w, h, K, D=D, model=model, P=P)


def calib_yaml(calib_path: str) -> RigCalibration:
    """Generic 'cameras:' YAML with per-camera T_B_C (calib.cpp:231-268).
    All cameras share camera 0's intrinsics, as the reference does.

    Generalization over the reference: a third `cameras:` entry (if present)
    yields a trinocular rig via T_2_0 — the reference's yaml loader is
    stereo-only and its trinocular path is the hard-coded evimo2 rig
    (calib.cpp:678-807)."""
    info = _load_yaml(calib_path)
    cameras = info["cameras"]
    camL = cameras[0]["camera"]
    h, w = camL["image_height"], camL["image_width"]
    fx, fy, cx, cy = camL["intrinsics"]["data"]
    K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]
    cam = _cam(w, h, K, D=(0.0,) * 5, model=PLUMB_BOB, P=K)
    T_B = [np.asarray(c["T_B_C"]["data"], np.float64).reshape(4, 4)
           for c in cameras]
    T_1_0 = np.linalg.inv(T_B[1]) @ T_B[0]
    if len(cameras) >= 3:
        return RigCalibration(cams=(cam,) * len(cameras), T_1_0=T_1_0,
                              T_2_0=np.linalg.inv(T_B[2]) @ T_B[0],
                              T_hand_eye=np.eye(4))
    return RigCalibration(cams=(cam, cam), T_1_0=T_1_0, T_hand_eye=np.eye(4))


def calib_yaml_kalibr(calib_path: str, invert_extrinsics: bool = False) -> RigCalibration:
    """kalibr camchain YAML: cam0/cam1 blocks + cam1.T_cn_cnm1.

    Covers yaml_mvsec (calib.cpp:811-898) and yaml_m3ed (:141-228) — they are
    byte-identical loaders in the reference — and, with
    `invert_extrinsics=True`, the sony loader's T_cn_cnm1.inverse()
    (calib.cpp:113-117; it also swaps the returned camera order, reproduced
    here).
    """
    info = _load_yaml(calib_path)
    cam0 = _kalibr_cam(info["cam0"])
    cam1 = _kalibr_cam(info["cam1"])
    T = np.asarray(info["cam1"]["T_cn_cnm1"], np.float64).reshape(4, 4)
    if invert_extrinsics:
        T = np.linalg.inv(T)
        cam0, cam1 = cam1, cam0
    return RigCalibration(cams=tuple(_share_p([cam0, cam1])), T_1_0=T,
                          T_hand_eye=np.eye(4))


def calib_yaml_mvsec(calib_path: str) -> RigCalibration:
    return calib_yaml_kalibr(calib_path)


def calib_yaml_m3ed(calib_path: str) -> RigCalibration:
    return calib_yaml_kalibr(calib_path)


def calib_sony(calib_path: str, mocap_calib_path: str = "") -> RigCalibration:
    """Sony prototype stereo rig (calib.cpp:31-136): kalibr chain with
    inverted extrinsics + optional JSON/OpenCV-FS hand-eye."""
    rig = calib_yaml_kalibr(calib_path, invert_extrinsics=True)
    T_he = np.eye(4)
    if mocap_calib_path:
        with open(mocap_calib_path) as f:
            m = jsonlib.load(f)
        q = m["rotation"]
        t = m["translation"]
        T_he[:3, :3] = _quat_to_matrix(float(q["w"]), float(q["i"]),
                                       float(q["j"]), float(q["k"]))
        T_he[:3, 3] = [float(t["x"]), float(t["y"]), float(t["z"])]
    return dataclasses.replace(rig, T_hand_eye=T_he)


def _quat_to_matrix(w, x, y, z) -> np.ndarray:
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def calib_json_tumvie(calib_path: str, mocap_calib_path: str = "") -> RigCalibration:
    """TUM-VIE 'camera-calibrationA.json' (calib.cpp:271-361): kb4 fisheye
    event cameras at indices 2 and 3; virtual P = 0.8 * (fx, fy)."""
    with open(calib_path) as f:
        data = jsonlib.load(f)
    v = data["value0"]
    cams, T_imu_cam = [], []
    for i in (2, 3):
        w, h = v["resolution"][i]
        intr = v["intrinsics"][i]["intrinsics"]
        K = [[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]]
        cam_type = v["intrinsics"][i]["camera_type"]
        if cam_type == "kb4":
            model = FISHEYE
            D = (intr["k1"], intr["k2"], intr["k3"], intr["k4"])
        else:
            model, D = NONE, ()
        P = [[0.8 * intr["fx"], 0, intr["cx"]], [0, 0.8 * intr["fy"], intr["cy"]], [0, 0, 1]]
        cams.append(_cam(w, h, K, D=D, model=model, P=P))
        e = v["T_imu_cam"][i]
        T = np.eye(4)
        T[:3, :3] = _quat_to_matrix(e["qw"], e["qx"], e["qy"], e["qz"])
        T[:3, 3] = [e["px"], e["py"], e["pz"]]
        T_imu_cam.append(T)
    T_1_0 = np.linalg.inv(T_imu_cam[1]) @ T_imu_cam[0]
    if mocap_calib_path:
        with open(mocap_calib_path) as f:
            m = jsonlib.load(f)["value0"]["T_imu_marker"]
        T_imu_m = np.eye(4)
        T_imu_m[:3, :3] = _quat_to_matrix(m["qw"], m["qx"], m["qy"], m["qz"])
        T_imu_m[:3, 3] = [m["px"], m["py"], m["pz"]]
        T_he = np.linalg.inv(T_imu_m) @ T_imu_cam[0]
    else:
        T_he = T_imu_cam[0]
    return RigCalibration(cams=tuple(_share_p(cams)), T_1_0=T_1_0, T_hand_eye=T_he)


def calib_dsec_yaml(calib_path: str, mocap_calib_path: str) -> RigCalibration:
    """DSEC cam_to_cam.yaml + LiDAR hand-eye (calib.cpp:365-457): event
    cameras are cam0 and cam3; rig chain T_3_0 = T_32 T_21 T_10; hand-eye
    = T_lidar_camRect1 * R_rect1 * T_10."""
    info = _load_yaml(calib_path)
    cams = []
    for cam_id in (0, 3):
        node = info["intrinsics"][f"cam{cam_id}"]
        w, h = node["resolution"]
        fx, fy, cx, cy = node["camera_matrix"]
        K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]
        dist = node["distortion_model"]
        if dist == "none":
            model, D = PLUMB_BOB, (0.0,) * 5
        elif dist == "radtan":
            model, D = PLUMB_BOB, tuple(node["distortion_coeffs"][:4])
        else:
            raise ValueError(f"unexpected DSEC distortion model {dist!r}")
        P = _optimal_new_K(np.asarray(K), D, w, h)
        cams.append(_cam(w, h, K, D=D, model=model, P=P))
    ext = info["extrinsics"]
    T_32 = np.asarray(ext["T_32"], np.float64)
    T_21 = np.asarray(ext["T_21"], np.float64)
    T_10 = np.asarray(ext["T_10"], np.float64)
    T_rect1_1 = np.eye(4)
    T_rect1_1[:3, :3] = np.asarray(ext["R_rect1"], np.float64)
    mocap = _load_yaml(mocap_calib_path)
    T_lidar_camRect1 = np.asarray(mocap["T_lidar_camRect1"], np.float64)
    return RigCalibration(
        cams=tuple(_share_p(cams)),
        T_1_0=T_32 @ T_21 @ T_10,
        T_hand_eye=T_lidar_camRect1 @ T_rect1_1 @ T_10,
    )


def _calib_dsec_hardcoded(K0, D0, K1, D1, T_10, T_21, T_32,
                          T_lidar_camRect1, T_rect1_1) -> RigCalibration:
    """Common body of the two per-sequence hard-coded DSEC rigs
    (calib.cpp:459-522, 525-587): cam0's optimal-K P is shared, rig chain
    T_32 T_21 T_10, LiDAR hand-eye T_lidar_camRect1 T_rect1_1 T_10."""
    P = _optimal_new_K(np.asarray(K0), D0, 640, 480)
    cam0 = _cam(640, 480, K0, D=D0, model=PLUMB_BOB, P=P)
    cam1 = _cam(640, 480, K1, D=D1, model=PLUMB_BOB, P=P)
    T_10, T_21, T_32 = (np.asarray(t, np.float64).reshape(4, 4)
                        for t in (T_10, T_21, T_32))
    T_lidar_camRect1 = np.asarray(T_lidar_camRect1, np.float64).reshape(4, 4)
    T_rect1_1 = np.asarray(T_rect1_1, np.float64).reshape(4, 4)
    return RigCalibration(
        cams=tuple(_share_p([cam0, cam1])),
        T_1_0=T_32 @ T_21 @ T_10,
        T_hand_eye=T_lidar_camRect1 @ T_rect1_1 @ T_10,
    )


def calib_dsec_zurich04a() -> RigCalibration:
    """Hard-coded DSEC zurich_city_04_a rig (calib.cpp:459-522).

    Unreachable from the reference's own main (no calib_type dispatches to
    it, main.cpp:117-142); exposed here as calib_type=dsec_zurich04a so the
    shipped constants are usable without the dataset's yaml files."""
    return _calib_dsec_hardcoded(
        K0=[[553.4686750102932, 0, 346.65339162053317],
            [0, 553.3994078799127, 216.52092103243012], [0, 0, 1]],
        D0=(-0.09356476362537607, 0.19445779814646236,
            7.642434980998821e-05, 0.0019563864604273664),
        K1=[[552.1819422959984, 0, 336.87432177064744],
            [0, 551.4454720096484, 226.32630571403274], [0, 0, 1]],
        D1=(-0.09493681546997375, 0.2021148065491477,
            0.0005821287651820125, 0.0014552921745527136),
        T_10=[[0.9997329831508507, 0.00994674446197701, 0.020857245142004693, -0.043722240320426424],
              [-0.01003579267550241, 0.999940949009329, 0.004169095789442527, 0.0010155694745410755],
              [-0.020814544570561252, -0.004377301558648307, 0.9997737713930034, -0.013372668558381158],
              [0, 0, 0, 1]],
        T_21=[[0.9998379578286035, -0.017926384876108554, 0.0016440226264295469, -0.5092603987305321],
              [0.017914084504235202, 0.9998135043384297, 0.007214022378586629, -0.0022179629729152214],
              [-0.0017730373650056029, -0.007183402242479184, 0.9999726271607238, 0.0042971588717280644],
              [0, 0, 0, 1]],
        T_32=[[0.9999876185667624, -0.0034167786978265787, -0.0036177806040117192, -0.046041759529914676],
              [0.0033579259589126046, 0.9998639316478117, -0.016150619896091543, -0.0011068440180470077],
              [0.0036724714325840242, 0.01613827168886575, 0.9998630251891839, 0.012672727774474509],
              [0, 0, 0, 1]],
        T_lidar_camRect1=[[0.006502250714427837, 0.0016414391549515739, 0.9999775129537399, 0.448],
                          [-0.9996294044397522, 0.026445536238290795, 0.006456577459882262, 0.255],
                          [-0.026434343477244382, -0.999648908012493, 0.0018127863517872211, -0.215],
                          [0, 0, 0, 1]],
        T_rect1_1=[[0.9998858610925897, -0.013510711178262034, -0.006762061119800281, 0],
                   [0.013535205789223095, 0.9999019509726164, 0.0035897974036225495, 0],
                   [0.00671289739037555, -0.0036809135568848755, 0.9999706935125713, 0],
                   [0, 0, 0, 1]],
    )


def calib_dsec_interlaken00b() -> RigCalibration:
    """Hard-coded DSEC interlaken_00_b rig (calib.cpp:525-587); see
    `calib_dsec_zurich04a` for reachability notes."""
    return _calib_dsec_hardcoded(
        K0=[[555.6627242364661, 0, 342.5725306057865],
            [0, 555.8306341927942, 215.26831427862848], [0, 0, 1]],
        D0=(-0.09094341408134071, 0.18339771556281387,
            -0.0006982341741678465, 0.00041396758898911876),
        K1=[[553.800041834315, 0, 333.21860953836267],
            [0, 553.7026022383894, 226.01033624096638], [0, 0, 1]],
        D1=(-0.09492592983896557, 0.20394312250370014,
            0.00033282360055722797, -0.001101242451777801),
        T_10=[[0.9996874046885865, 0.009652146488870916, 0.023063585478994113, -0.04410263392688484],
              [-0.009722042371104245, 0.9999484753460813, 0.0029203673010648615, 0.0005281285423087664],
              [-0.023034209322743096, -0.0031436795631953228, 0.9997297347181744, -0.01229891454144492],
              [0, 0, 0, 1]],
        T_21=[[0.9998543808844597, -0.01706309861700861, -0.00026017635946350924, -0.5094961871754736],
              [0.017064416377671962, 0.9998338346058513, 0.00641162000174109, -0.002022496204233391],
              [0.0001507310227716978, -0.006415126105036775, 0.9999794115066636, 0.005365297617411473],
              [0, 0, 0, 1]],
        T_32=[[0.9999880111304372, -0.003533401537847065, -0.003390083916194203, -0.04551026028184807],
              [0.003476600244706753, 0.9998558803824363, -0.016617211420558598, -0.001048727690114844],
              [0.0034483106189848347, 0.016605226232405814, 0.999856177465359, 0.013554100781902953],
              [0, 0, 0, 1]],
        T_lidar_camRect1=[[0.01539728189227399, -0.0012823052573279758, 0.9998806325774878, 0.448],
                          [-0.9996610000153124, 0.020978176075891836, 0.015420803380972237, 0.255],
                          [-0.02099544614233234, -0.9997791115150167, -0.0009588636652390625, -0.215],
                          [0, 0, 0, 1]],
        T_rect1_1=[[0.9998572179847892, -0.013025778024398856, -0.010764420587133948, 0],
                   [0.013060715513432202, 0.9999096430275752, 0.003181743349841093, 0],
                   [0.01072200326407413, -0.0033218800890692088, 0.9999369998948329, 0],
                   [0, 0, 0, 1]],
    )


# ---------------------------------------------------------------------------
# Registry (the main.cpp:117-142 dispatch)
# ---------------------------------------------------------------------------


def load_calibration(
    calib_type: str, calib_path: str = "", mocap_calib_path: str = ""
) -> RigCalibration:
    t = calib_type
    if t == "eccv18":
        return calib_eccv18()
    if t == "esim":
        return calib_esim()
    if t == "dvsgen3":
        return calib_dvsgen3()
    if t == "yaml":
        return calib_yaml(calib_path)
    if t == "yaml_mvsec":
        return calib_yaml_mvsec(calib_path)
    if t == "slider":
        return calib_slider(calib_path)
    if t == "hkust":
        return calib_hkust(calib_path)
    if t == "evimo2":
        return calib_evimo2(calib_path)
    if t == "json":
        return calib_json_tumvie(calib_path, mocap_calib_path)
    if t == "dsec_yaml":
        return calib_dsec_yaml(calib_path, mocap_calib_path)
    if t == "dsec_zurich04a":
        return calib_dsec_zurich04a()
    if t == "dsec_interlaken00b":
        return calib_dsec_interlaken00b()
    if t == "yaml_m3ed":
        return calib_yaml_m3ed(calib_path)
    if t == "sony":
        return calib_sony(calib_path, mocap_calib_path)
    raise ValueError(f"unknown calib_type {calib_type!r}")
