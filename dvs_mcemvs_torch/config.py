"""Run configuration: every flag of the reference, gflags-flagfile compatible.

Port of dvs_mcemvs_tpu/config.py: the same fields in the same order, with
the same defaults, so one preset (`configs/**/*.conf`) or argv gives both
packages the same configuration and the same `run_flags.conf`.  The fields
that name a platform, a profiler or a process group mean the port's:
`platform` '' or 'cuda' is the card and 'cpu' the CPU, `profile_dir`
receives a torch.profiler trace, and the multi-process fields are refused
by the CLI (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import List, Optional, Sequence

from .ops.depth_vector import LINEAR


@dataclasses.dataclass
class RunConfig:
    # I/O paths (main.cpp:37-41); 'bag' kept for name parity, any supported
    # event/pose container works (h5/npz/txt/bag).
    bag_filename: str = ""
    bag_filename_left: str = "input.bag"
    bag_filename_right: str = "input.bag"
    # Camera-2 event source for file-based trinocular rigs.  The reference
    # only reads cam2 from the single shared bag (main.cpp:49-55 topics); with
    # per-file containers (npz/h5) the third stream needs its own path.
    # Empty = fall back to --bag_filename.
    bag_filename2: str = ""
    bag_filename_pose: str = "input.bag"
    out_path: str = "./"

    # Calibration (main.cpp:44-46)
    calib_type: str = "yaml"
    calib_path: str = "stereo_pinhole.yaml"
    mocap_calib_path: str = ""

    # Topics (main.cpp:49-55) — used only for rosbag inputs
    event_topic0: str = "/davis_left/events"
    event_topic1: str = "/davis_right/events"
    event_topic2: str = ""
    camera_info_topic0: str = "/davis_left/camera_info"
    camera_info_topic1: str = "/davis_right/camera_info"
    camera_info_topic2: str = ""
    pose_topic: str = "/optitrack/davis_stereo"

    # Per-camera time offsets (main.cpp:57-59)
    offset0: float = 0.0
    offset1: float = 0.0
    offset2: float = 0.0

    # Time window (main.cpp:61-62)
    start_time_s: float = 0.0
    stop_time_s: float = 1000.0

    # DSI shape (main.cpp:65-70); dimZ<=256 was a uint8 storage artifact of
    # the reference (main.cpp:156) — not a constraint here.
    dimX: int = 0
    dimY: int = 0
    dimZ: int = 100
    fov_deg: float = 0.0
    min_depth: float = 0.3
    max_depth: float = 5.0

    # Depth-map extraction (main.cpp:73-77)
    adaptive_threshold_kernel_size: int = 5
    adaptive_threshold_c: float = 5.0
    median_filter_size: int = 5
    save_mono: bool = False
    save_dsi: bool = False
    # Telea-inpainted dense depth map (the reference computes it on every
    # extraction, mapper_emvs_stereo.cpp:429-436; --nosave_dense skips it).
    save_dense: bool = True

    # Point cloud (main.cpp:80-82)
    radius_search: float = 0.05
    min_num_neighbors: int = 3
    late_fusion: bool = False

    # Algorithm selection (main.cpp:84-91)
    process_method: int = 1
    num_intervals: int = 4
    ts: Optional[float] = None  # None = midpoint of [start, stop] (main.cpp:86)
    rv_pos: float = 0.0
    forward_looking: bool = False
    stereo_fusion: int = 2
    temporal_fusion: int = 4

    # Full-sequence processing (main.cpp:94-97)
    full_seq: bool = False
    save_conf_stats: bool = False
    duration: float = 3.0
    out_skip: float = 10.0
    max_confidence: float = 0.0

    # --- Extensions (no reference counterpart) ---
    platform: str = ""                    # '' or 'cuda' = the card; 'cpu'
    depth_sampling: str = LINEAR          # 'linear' | 'inverse' (runtime USE_INVERSE_DEPTH)
    splat_backend: str = "auto"           # 'auto' | 'scatter' | 'sort' | 'hist[:g8,ss2,...]'
    use_event_store: bool = True          # native mmap store + prefetch in full_seq
    # full_seq chunk saves run on this many writer threads with bounded
    # depth (utils/writers.SaveWorkerPool) so host serialization overlaps
    # device compute of later chunks; 0 = serial reference behavior.
    save_workers: int = 2
    packet_size: int = 1024               # events per shared-pose packet (cpp:88)
    plane_block: int = 8                  # depth planes per voting block
    collapse_method: int = -1             # -1 argmax; 0-4 focus measures
    num_devices: int = 0                  # 0 = all visible devices
    save_pointcloud: bool = True
    checkpoint: bool = True               # full_seq chunk ledger + resume
    profile_dir: str = ""                 # torch.profiler chrome-trace output dir
    # Multi-process launch: every process runs the same CLI with the same
    # flags plus its own --process_id, one rank a process.
    coordinator: str = ""                 # host:port of process 0
    num_processes: int = 0                # total process count (0 = auto)
    process_id: int = -1                  # this process's index (-1 = auto)
    # Every Nth mesh/multihost chunk, block on the device and log a
    # device-true Mev/s (read by the JAX package's mesh step only).
    timing_sync_every: int = 16

    def resolved_ts(self) -> float:
        if self.ts is not None:
            return self.ts
        return 0.5 * (self.start_time_s + self.stop_time_s)

    def apply(self, key: str, value: str) -> None:
        key = key.lstrip("-")
        if not hasattr(self, key):
            raise KeyError(f"unknown flag --{key}")
        current = getattr(self, key)
        if key == "ts":
            setattr(self, "ts", float(value))
            return
        if isinstance(current, bool):
            setattr(self, key, value.lower() in ("1", "true", "yes", "on", ""))
        elif isinstance(current, int):
            setattr(self, key, int(value))
        elif isinstance(current, float):
            setattr(self, key, float(value))
        else:
            setattr(self, key, value)


def parse_flagfile(path: str, cfg: Optional[RunConfig] = None) -> RunConfig:
    """Read a gflags-style flagfile: one `--key=value` (or `--key value`,
    `--nokey`, comment, or nested `--flagfile=...`) per line."""
    cfg = cfg or RunConfig()
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    tokens: List[str] = []
    for ln in lines:
        if not ln or ln.startswith("#"):
            continue
        tokens.extend(shlex.split(ln))
    parse_args(tokens, cfg)
    return cfg


def parse_args(argv: Sequence[str], cfg: Optional[RunConfig] = None) -> RunConfig:
    """gflags-compatible argument parsing, including --flagfile recursion and
    --noflag boolean negation."""
    cfg = cfg or RunConfig()
    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        i += 1
        if not tok.startswith("-"):
            raise ValueError(f"unexpected argument {tok!r}")
        body = tok.lstrip("-")
        if "=" in body:
            key, value = body.split("=", 1)
        elif i < len(argv) and not argv[i].startswith("-"):
            key, value = body, argv[i]
            i += 1
        else:
            key, value = body, ""
        if key == "flagfile":
            parse_flagfile(value, cfg)
            continue
        if key.startswith("no") and not hasattr(cfg, key) and hasattr(cfg, key[2:]):
            setattr(cfg, key[2:], False)
            continue
        cfg.apply(key, value)
    return cfg


def config_to_flagfile(cfg: RunConfig) -> str:
    """Serialize back to a flagfile (for provenance next to outputs)."""
    out = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if v is None:
            continue
        if isinstance(v, bool):
            v = "true" if v else "false"
        out.append(f"--{f.name}={v}")
    return "\n".join(out) + "\n"
