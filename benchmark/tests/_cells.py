"""Cells cut to a size the CPU tests can run: a sensor 96 pixels wide (or
`width`), 16 planes, a few thousand events a window, the MVSEC segment cut
to 2 s.  Also the EVIMO2 trinocular fixture (`evimo2/`), a calibrated rig
of three distorted cameras that is not a cell of BENCHMARK.json."""

import copy
import os

from benchmark import harness

EVIMO2 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "evimo2")
CELL = "evimo2_trinocular.replay_1m"


def evimo2() -> harness.Cell:
    """The EVIMO2 fixture's one cell, at its own size."""
    return harness.load_cell(CELL, os.path.join(EVIMO2, "spec.json"))


def _scale_rig(r: dict, width: int) -> None:
    """Focal lengths scaled; camera 0's principal point moved to the centre
    of its scaled sensor, every other principal point (and P's) kept at its
    scaled offset from camera 0's."""
    cam0 = r["cameras"][0]
    scale = width / cam0["width"]
    height = int(round(cam0["height"] * scale))
    cx0, cy0 = cam0["K"][2], cam0["K"][3]

    def scaled(K):
        fx, fy, cx, cy = K
        return [fx * scale, fy * scale, (width - 1) / 2 + (cx - cx0) * scale,
                (height - 1) / 2 + (cy - cy0) * scale]

    for c in r["cameras"]:
        c.update(width=int(round(c["width"] * scale)), height=int(round(c["height"] * scale)),
                 K=scaled(c["K"]))
    r["P"] = scaled(r["P"])


def tiny(cell, width: int = 96) -> harness.Cell:
    """`cell` (a name of BENCHMARK.json, or a Cell) cut to size."""
    c = copy.deepcopy(harness.load_cell(cell) if isinstance(cell, str) else cell)
    cfg = c.config
    scale = width / cfg["rig"]["cameras"][0]["width"]
    cfg["flags"] = [f if not f.startswith("--dimZ") else "--dimZ=16" for f in cfg["flags"]]
    if cfg["name"].startswith("mvsec"):
        cfg["flags"] = [f if not f.startswith("--stop_time_s") else "--stop_time_s=12"
                        for f in cfg["flags"]]
    _scale_rig(cfg["rig"], width)
    cfg["scene"]["points_per_stripe"] = 300
    cfg["scene"]["pad_px"] *= scale
    c.mix["events_per_window"] = (8192 if not cfg["name"].startswith(("mvsec", "tumvie"))
                                  else 20 * 410) * (width // 96) ** 2
    return c
