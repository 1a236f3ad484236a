"""Multi-camera fusion at a reference view: the process_1 pipeline.

Port of `process_1` of dvs_mcemvs_tpu/pipeline.py (the reference's
process1.cpp): place the reference view on the left camera's trajectory,
vote one DSI per camera, fuse them.  Temporal fusion (process_2/5) and the
full-sequence scheduler are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import mapper as mappermod
from .mapper import Events, Mapper
from .ops import grid as gridops, se3, trajectory as trajmod, voting
from .ops.se3 import SE3

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class VotingOptions:
    packet_size: int = voting.DEFAULT_PACKET_SIZE
    backend: str = "scatter"
    plane_block: int = 8
    # "bucket" pads chunks to power-of-two packet capacities so the trailing
    # partial packet votes; "none" drops it, as the reference does.
    pad_policy: str = "bucket"


@dataclasses.dataclass
class ProcessResult:
    """Fused DSI plus named intermediates, timings, and the RV placement."""

    fused_dsi: torch.Tensor
    T_rv_w: SE3
    ts: float
    dsis: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    mev_per_s: Optional[float] = None


def place_reference_view(traj0: trajmod.Trajectory, ts: float,
                         rv_pos: float = 0.0) -> SE3:
    """RV at the left camera pose at `ts`, optionally shifted along the
    stereo baseline by `rv_pos` metres.  Returns T_rv_w."""
    T_w_l, valid = trajmod.pose_at(traj0, ts)
    if not bool(valid):
        raise ValueError(f"reference-view time {ts} outside trajectory")
    dev = traj0.device
    shift = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                torch.tensor([rv_pos, 0.0, 0.0], device=dev))
    return se3.inverse(se3.compose(T_w_l, shift))


def _evaluate_all(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
    vopts: VotingOptions,
) -> Tuple[List[Optional[torch.Tensor]], float, int]:
    """Per-camera DSIs, host time and total events voted.  The DSIs may
    still be in flight on the device: the time covers the enqueue."""
    t0 = time.perf_counter()
    dsis = []
    n_ev = 0
    for m, ev, trj in zip(mappers, events, trajs):
        dsi = mappermod.evaluate_dsi(
            m, ev, trj, T_rv_w, packet_size=vopts.packet_size,
            backend=vopts.backend, plane_block=vopts.plane_block,
            pad=vopts.pad_policy)
        if dsi is not None:
            n_ev += ev.num
        dsis.append(dsi)
    return dsis, time.perf_counter() - t0, n_ev


def process_1(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    ts: float,
    stereo_fusion: int,
    rv_pos: float = 0.0,
    vopts: VotingOptions = VotingOptions(),
) -> ProcessResult:
    """Algorithm 1: fuse per-camera DSIs at a common reference view."""
    T_rv_w = place_reference_view(trajs[0], ts, rv_pos)
    dsis, dt, n_ev = _evaluate_all(mappers, events, trajs, T_rv_w, vopts)
    live = [d for d in dsis if d is not None]
    if not live:
        raise ValueError("no camera produced a DSI (all chunks too small)")
    fused = gridops.fuse_many(live, stereo_fusion)
    res = ProcessResult(
        fused_dsi=fused, T_rv_w=T_rv_w, ts=ts,
        timings={"dsi_voting_s": dt},
        mev_per_s=(n_ev / dt / 1e6) if dt > 0 else None,
    )
    for i, d in enumerate(dsis):
        if d is not None:
            res.dsis[f"camera{i}"] = d
    log.info("process_1: %d events, %.3f s, %.3f Mev/s",
             n_ev, dt, res.mev_per_s or 0.0)
    return res
