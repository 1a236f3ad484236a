"""Cells of BENCHMARK.json cut to a size the CPU tests can run: a sensor 96
pixels wide (or `width`), 16 planes, a few thousand events a window, the
MVSEC segment cut to 2 s."""

import copy

from benchmark import harness


def tiny(name: str, width: int = 96) -> harness.Cell:
    c = copy.deepcopy(harness.load_cell(name))
    cfg = c.config
    cfg["flags"] = [f if not f.startswith("--dimZ") else "--dimZ=16" for f in cfg["flags"]]
    if cfg["name"].startswith("mvsec"):
        cfg["flags"] = [f if not f.startswith("--stop_time_s") else "--stop_time_s=12"
                        for f in cfg["flags"]]
    r = cfg["rig"]
    scale = width / r["width"]
    r.update(width=width, height=int(round(r["height"] * scale)), fx=r["fx"] * scale,
             fy=r["fy"] * scale)
    r["cx"], r["cy"] = (r["width"] - 1) / 2, (r["height"] - 1) / 2
    cfg["scene"]["points_per_stripe"] = 300
    cfg["scene"]["pad_px"] *= scale
    c.mix["events_per_window"] = (8192 if c.config["name"].startswith("dsec") else 20 * 410) \
        * (width // 96) ** 2
    return c
