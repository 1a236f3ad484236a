"""Fusion pipelines and the streaming scheduler.

Port of dvs_mcemvs_tpu/pipeline.py: host-side orchestration of the device
work, over (Z, H, W) float32 DSIs on the trajectories' device.

  - `process_1`  -- multi-camera fusion at a reference view;
  - `process_2`  -- camera x time fusion, both fusion orders;
  - `process_5`  -- time fusion with the right camera's sub-intervals
                    rotated by half the count;
  - `run_full_seq`, `run_full_seq_stores` -- the sliding-window chunk
                    scheduler over events held in RAM or in native stores.

The temporal pipelines take an `evaluate_pair` hook, through which the CLI
votes each sub-interval on the sharded mesh step (`parallel.sharded`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import mapper as mappermod
from .mapper import Events, Mapper
from .ops import grid as gridops, se3, trajectory as trajmod, voting
from .ops.se3 import SE3

log = logging.getLogger(__name__)

# Temporal-fusion enum of the `temporal_fusion` flag: 2 = harmonic mean,
# 4 = arithmetic mean.
TEMPORAL_HM = 2
TEMPORAL_AM = 4


@dataclasses.dataclass(frozen=True)
class VotingOptions:
    packet_size: int = voting.DEFAULT_PACKET_SIZE
    backend: str = "scatter"
    plane_block: int = 8
    # "bucket" pads chunks to power-of-two packet capacities so the trailing
    # partial packet votes; "none" drops it, as the reference does.
    pad_policy: str = "bucket"
    # True waits for the device after each chunk's voting, so the voting
    # time and Mev/s cover the device work; False (default) returns once the
    # work is queued, so host preparation of the next chunk overlaps it.
    sync: bool = False


@dataclasses.dataclass
class ProcessResult:
    """Fused DSI plus named intermediates, timings, and the RV placement."""

    fused_dsi: torch.Tensor
    T_rv_w: SE3
    ts: float
    dsis: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    mev_per_s: Optional[float] = None
    # A depth map (extract.DepthMapResult) its producer already extracted,
    # which the CLI saves instead of extracting again; the pipelines here
    # leave it None.
    extracted: Optional[object] = None


def place_reference_view(traj0: trajmod.Trajectory, ts: float,
                         rv_pos: float = 0.0) -> SE3:
    """RV at the left camera pose at `ts`, optionally shifted along the
    stereo baseline by `rv_pos` metres.  Returns T_rv_w.  Raises where
    `pose_at` calls `ts` invalid, decided on the host (`valid_at`)."""
    if not trajmod.valid_at(traj0, ts):
        raise ValueError(f"reference-view time {ts} outside trajectory")
    T_w_l, _ = trajmod.pose_at(traj0, ts)
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
    """Per-camera DSIs, seconds and total events voted.  Without
    `vopts.sync` the DSIs may still be in flight on the device and the time
    covers the enqueue; with it, the time ends in a device synchronise."""
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
    live = [d for d in dsis if d is not None]
    if vopts.sync and live:
        _synchronize(live[0])
    return dsis, time.perf_counter() - t0, n_ev


def _synchronize(t: torch.Tensor) -> None:
    """Wait for the work queued on `t`'s device (nothing to wait for on the
    CPU), then raise if a chunk voted refused weights
    (`mapper.check_faults`)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    mappermod.check_faults()


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


def split_subintervals(ev: Events, n: int) -> List[Events]:
    """`n` sub-intervals of equal event count; the remainder past
    n * (E // n) is dropped, as the reference does."""
    per = ev.num // n
    return [ev.slice(k * per, (k + 1) * per) for k in range(n)]


def split_subintervals_shifted(ev: Events, n: int, shift: int) -> List[Events]:
    """process_5's split of the right camera: start at sub-interval `shift`
    and wrap around the end of the stream."""
    per = ev.num // n
    out = []
    start = shift * per
    for _ in range(n):
        stop = start + per
        if stop >= ev.num:
            head = ev.slice(start, ev.num)
            stop = stop - ev.num
            tail = ev.slice(0, stop)
            p = None if ev.p is None else np.concatenate([head.p, tail.p])
            out.append(Events(np.concatenate([head.x, tail.x]),
                              np.concatenate([head.y, tail.y]),
                              np.concatenate([head.t, tail.t]), p))
        else:
            out.append(ev.slice(start, stop))
        start = stop
    return out


@dataclasses.dataclass
class TemporalResult(ProcessResult):
    """process_2/5 output: `fused_dsi` fuses the cameras within each
    sub-interval, then across time; `dsis` holds the per-camera temporal
    fusions ('left_temporal', 'right_temporal') and the converse order
    ('camera_time': time per camera, then across cameras)."""


def _temporal_accumulate(acc, dsi, method: int):
    """Add one sub-interval's DSI into the running accumulator, in place.
    `acc` None starts it from this DSI's term alone: the JAX package adds
    that term to zeros, and 0 + x == x, so the sums keep its bits without a
    zero plane per sub-interval."""
    if method == TEMPORAL_HM:
        return gridops.inverse(dsi) if acc is None else gridops.add_inverse_(acc, dsi)
    if method == TEMPORAL_AM:
        return dsi.clone() if acc is None else gridops.fuse_add_(acc, dsi)
    raise ValueError(f"temporal_fusion must be {TEMPORAL_HM} (HM) or {TEMPORAL_AM} (AM)")


def _temporal_finalize(acc, n: int, method: int):
    if method == TEMPORAL_HM:
        return gridops.hm_from_sum_of_inv(acc, n)
    return gridops.am_from_sum(acc, n)


def process_time_fusion(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    ts: float,
    stereo_fusion: int,
    temporal_fusion: int,
    num_intervals: int,
    shuffle: bool = False,
    rv_pos: float = 0.0,
    vopts: VotingOptions = VotingOptions(),
    on_subinterval: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
    evaluate_pair: Optional[Callable] = None,
) -> TemporalResult:
    """Algorithm 2: camera x time fusion with streaming accumulators.

    `shuffle=False` is process_2; `shuffle=True` is process_5, whose right
    camera's sub-intervals start half-way round.  Both fusion orders are
    computed (see TemporalResult).  `stereo_fusion` means the same function
    in both orders (the reference swaps AM and GM in its converse order; the
    JAX package treats that as a bug, and so does the port).  A sub-interval
    of at most one packet is skipped, and the accumulators are normalised by
    the count of sub-intervals that voted.  `on_subinterval(k, dsis)` sees
    each sub-interval's 'camera0', 'camera1' and 'fused' DSIs.
    `evaluate_pair(mappers, [ev0, ev1], trajs, T_rv_w) -> (d0, d1)` replaces
    the per-camera voting (None for a DSI marks the sub-interval too small);
    the fault flags are read after each pair (`mapper.check_faults`).
    """
    if len(mappers) != 2:
        raise ValueError("time fusion is defined for stereo rigs (2 cameras)")
    T_rv_w = place_reference_view(trajs[0], ts, rv_pos)

    subs0 = split_subintervals(events[0], num_intervals)
    if shuffle:
        subs1 = split_subintervals_shifted(events[1], num_intervals, num_intervals // 2)
    else:
        subs1 = split_subintervals(events[1], num_intervals)

    acc_fused = acc_left = acc_right = None
    total_ev = 0
    n_live = 0
    t_start = time.perf_counter()
    for k in range(num_intervals):
        if evaluate_pair is not None:
            d0, d1 = evaluate_pair(mappers, [subs0[k], subs1[k]], trajs, T_rv_w)
            total_ev += subs0[k].num + subs1[k].num
            # The pair's refused binning weights, if any, raise here (one read
            # of the fault flags a sub-interval pair).
            mappermod.check_faults()
        else:
            (d0, d1), _, n_ev = _evaluate_all(mappers, [subs0[k], subs1[k]], trajs,
                                              T_rv_w, vopts)
            total_ev += n_ev
        if d0 is None or d1 is None:
            log.warning("sub-interval %d too small, skipped", k)
            continue
        n_live += 1
        fused_k = gridops.fuse_pair(d0, d1, stereo_fusion)
        if on_subinterval is not None:
            on_subinterval(k, {"camera0": d0, "camera1": d1, "fused": fused_k})
        acc_fused = _temporal_accumulate(acc_fused, fused_k, temporal_fusion)
        acc_left = _temporal_accumulate(acc_left, d0, temporal_fusion)
        acc_right = _temporal_accumulate(acc_right, d1, temporal_fusion)
        # Free this sub-interval's planes before the next one votes.
        d0 = d1 = fused_k = None

    if acc_fused is None:
        raise ValueError("no sub-interval produced a DSI")
    fused = _temporal_finalize(acc_fused, n_live, temporal_fusion)
    left = _temporal_finalize(acc_left, n_live, temporal_fusion)
    right = _temporal_finalize(acc_right, n_live, temporal_fusion)
    camera_time = gridops.fuse_pair(left, right, stereo_fusion)
    if vopts.sync:
        _synchronize(fused)
    dt_all = time.perf_counter() - t_start

    res = TemporalResult(
        fused_dsi=fused, T_rv_w=T_rv_w, ts=ts,
        timings={"total_s": dt_all},
        mev_per_s=(total_ev / dt_all / 1e6) if dt_all > 0 else None,
    )
    res.dsis["left_temporal"] = left
    res.dsis["right_temporal"] = right
    res.dsis["camera_time"] = camera_time
    return res


def process_2(*args, **kwargs) -> TemporalResult:
    """process_2: camera-then-time and the converse order."""
    return process_time_fusion(*args, shuffle=False, **kwargs)


def process_5(*args, **kwargs) -> TemporalResult:
    """process_5: process_2 with the right camera's sub-intervals rotated."""
    return process_time_fusion(*args, shuffle=True, **kwargs)


# ---------------------------------------------------------------------------
# Sliding-window scheduler (full_seq)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FullSeqOptions:
    start_time: float
    stop_time: float
    duration: float  # chunk length, seconds
    out_skip: float  # stride between chunk starts, seconds
    forward_looking: bool = False  # RV at chunk end instead of midpoint


def full_seq_windows(opts: FullSeqOptions) -> Iterator[Tuple[float, float, float]]:
    """(t0, t1, ts_rv) of each chunk."""
    t0 = opts.start_time
    while t0 + opts.duration <= opts.stop_time + 1e-12:
        t1 = t0 + opts.duration
        ts = t1 if opts.forward_looking else 0.5 * (t0 + t1)
        yield t0, t1, ts
        t0 += opts.out_skip


def run_full_seq(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    opts: FullSeqOptions,
    process: Callable[..., ProcessResult],
    skip: Optional[Callable[[int], bool]] = None,
    **process_kwargs,
) -> Iterator[Tuple[int, float, ProcessResult]]:
    """Run `process` over sliding windows of host-resident event arrays,
    each chunk a binary-searched slice.  Yields (chunk index, RV time,
    result); a chunk whose `process` raises ValueError (too few events) is
    skipped with a warning.  `skip(k)` is asked before chunk k is computed,
    so a resumed chunk costs no device work."""
    for k, (t0, t1, ts) in enumerate(full_seq_windows(opts)):
        if skip is not None and skip(k):
            log.info("chunk %d @ ts=%.3f already complete; skipped", k, ts)
            continue
        chunk = [ev.time_window(t0, t1) for ev in events]
        try:
            res = process(mappers, chunk, trajs, ts, **process_kwargs)
        except ValueError as e:
            log.warning("chunk %d [%.3f, %.3f): skipped (%s)", k, t0, t1, e)
            continue
        yield k, ts, res


def run_full_seq_stores(
    mappers: Sequence[Mapper],
    stores: Sequence,
    trajs: Sequence[trajmod.Trajectory],
    opts: FullSeqOptions,
    process: Callable[..., ProcessResult],
    skip: Optional[Callable[[int], bool]] = None,
    **process_kwargs,
) -> Iterator[Tuple[int, float, ProcessResult]]:
    """`run_full_seq` over native event stores (io.evstore.EventStore or
    NormalizedStore, one a camera): the same chunks and `skip`, windows by
    the store's binary search, and chunk k+1's pages warmed by each store's
    prefetch thread while chunk k computes."""
    windows = list(full_seq_windows(opts))
    for k, (t0, t1, ts) in enumerate(windows):
        if skip is not None and skip(k):
            log.info("chunk %d @ ts=%.3f already complete; skipped", k, ts)
            continue
        if k + 1 < len(windows):
            n0, n1, _ = windows[k + 1]
            for s in stores:
                s.prefetch(n0, n1)
        chunk = [s.window(t0, t1) for s in stores]
        try:
            res = process(mappers, chunk, trajs, ts, **process_kwargs)
        except ValueError as e:
            log.warning("chunk %d [%.3f, %.3f): skipped (%s)", k, t0, t1, e)
            continue
        yield k, ts, res
