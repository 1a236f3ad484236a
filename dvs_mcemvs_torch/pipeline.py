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

On a CUDA device outside `mapper.eager()` the device work between the
votes runs as programs (`graphs.Captured`, one CUDA graph each), the
counterparts of the fusion and temporal steps that `bench.py`'s
`full_chunk` and `alg2_chunk` jit: process_1's fusion (`fuse_dsis`, a
program per `fusion_key`), process_2/5's per-sub-interval fusion and
accumulation, finalisation and converse fusion (`TemporalProgram`, per
`temporal_key`), and the reference view's pose (`place_reference_view`).
On the CPU, and inside `eager()`, the same bodies run eagerly.

The tracer (`tracing`) sees a chunk's slicing (`full_seq.window`), each
pipeline call (`process`), its programs' calls (`replay.reference_view`,
`replay.fusion`, `replay.temporal`) and the wait for the device
(`wait.sync`).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import graphs, mapper as mappermod, tracing
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
    # True waits for the device after each chunk's voting (and a temporal
    # pipeline's fusion), so that the call's host time covers the device
    # work; False (default) returns once the work is queued, so host
    # preparation of the next chunk overlaps it.
    sync: bool = False


@dataclasses.dataclass
class ProcessResult:
    """Fused DSI plus named intermediates and the RV placement."""

    fused_dsi: torch.Tensor
    T_rv_w: SE3
    ts: float
    dsis: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # A depth map (extract.DepthMapResult) its producer already extracted,
    # which the CLI saves instead of extracting again; the pipelines here
    # leave it None.
    extracted: Optional[object] = None


def _placement(traj0: trajmod.Trajectory, ts, shift: SE3) -> SE3:
    """T_rv_w of the left camera's pose at `ts` (a float, or a 0-d tensor
    of ts's dtype on its device) composed with `shift`.  The query is a
    batch of one: indexing by a 0-d index tensor reads it on the host, which
    a capture refuses."""
    t = torch.as_tensor(ts, dtype=traj0.ts.dtype, device=traj0.device).reshape(1)
    T_w_l, _ = trajmod.pose_at(traj0, t)
    T = se3.inverse(se3.compose(T_w_l, shift))
    return SE3(T.q[0], T.t[0])


# Reference-view programs kept (all devices): a run's left trajectory under
# its rv_pos.  Each holds a scalar input and its pose.
PLACEMENT_CACHE_SIZE = 4
_PLACEMENTS = graphs.ProgramCache(PLACEMENT_CACHE_SIZE)


def place_reference_view(traj0: trajmod.Trajectory, ts: float,
                         rv_pos: float = 0.0) -> SE3:
    """RV at the left camera pose at `ts`, optionally shifted along the
    stereo baseline by `rv_pos` metres.  Returns T_rv_w.  Raises where
    `pose_at` calls `ts` invalid, decided on the host (`valid_at`).  On a
    CUDA device outside `mapper.eager()` the pose interpolation replays a
    program per trajectory and `rv_pos` (`ts` copied into its scalar
    input), so that it queues one graph launch instead of ~200 kernels."""
    if not trajmod.valid_at(traj0, ts):
        raise ValueError(f"reference-view time {ts} outside trajectory")
    dev = traj0.device
    if not graphs.use_programs(dev):
        shift = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                    torch.tensor([rv_pos, 0.0, 0.0], device=dev))
        return _placement(traj0, ts, shift)
    def make():
        static = torch.empty((), dtype=traj0.ts.dtype, device=dev)
        shift = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                    torch.tensor([rv_pos, 0.0, 0.0], device=dev))
        return graphs.Captured(dev, [static], functools.partial(_placement, traj0, static,
                                                                shift),
                               kind="reference_view")

    # The key holds the trajectory's tensors by id; the program's body holds
    # the trajectory, so no other tensor takes those ids while it lives.
    key = (dev, id(traj0.ts), id(traj0.poses.q), id(traj0.poses.t), traj0.n, rv_pos)
    return _PLACEMENTS.call(key, make, torch.tensor(ts, dtype=traj0.ts.dtype))


def _evaluate_all(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
    vopts: VotingOptions,
) -> List[Optional[torch.Tensor]]:
    """Per-camera DSIs (None for a chunk of at most one packet).  Without
    `vopts.sync` the DSIs may still be in flight on the device; with it,
    the call ends in a device synchronise."""
    dsis = [mappermod.evaluate_dsi(m, ev, trj, T_rv_w, packet_size=vopts.packet_size,
                                   backend=vopts.backend, plane_block=vopts.plane_block,
                                   pad=vopts.pad_policy)
            for m, ev, trj in zip(mappers, events, trajs)]
    live = [d for d in dsis if d is not None]
    if vopts.sync and live:
        _synchronize(live[0])
    return dsis


def _synchronize(t: torch.Tensor) -> None:
    """Wait for the work queued on `t`'s device (nothing to wait for on the
    CPU; the tracer's `wait.sync`), then raise if a chunk voted refused
    weights (`mapper.check_faults`)."""
    if t.device.type == "cuda":
        with tracing.span("wait.sync"):
            torch.cuda.synchronize(t.device)
    mappermod.check_faults()


# Fusion programs kept (all devices): a rig's camera count and DSI shape
# under its fusion method; each holds its cameras' static DSIs and the fused
# one (3 x 123 MB at 640x480x100 for two cameras).
FUSION_CACHE_SIZE = 4
_FUSIONS = graphs.ProgramCache(FUSION_CACHE_SIZE)


def fusion_key(grids: Sequence[torch.Tensor], method: int) -> tuple:
    """The key of the program that fuses `grids`: device, camera count,
    shape, dtype and method."""
    g = grids[0]
    return (g.device, len(grids), tuple(g.shape), g.dtype, method)


def fusion_programs() -> list:
    """The fusion programs held, least recently used first."""
    return _FUSIONS.values()


def fuse_dsis(grids: Sequence[torch.Tensor], method: int) -> torch.Tensor:
    """`gridops.fuse_many(grids, method)` as a fresh DSI: on a CUDA device
    outside `mapper.eager()` the program of `fusion_key` (the grids copied
    into its static inputs on the card), else eagerly.  One grid is
    returned as it is."""
    grids = list(grids)
    if len(grids) == 1 or not graphs.use_programs(grids[0].device):
        return gridops.fuse_many(grids, method)
    def make():
        static = [torch.empty_like(g) for g in grids]
        return graphs.Captured(grids[0].device, static,
                               functools.partial(gridops.fuse_many, static, method),
                               kind="fusion")

    return _FUSIONS.call(fusion_key(grids, method), make, *grids)


@tracing.traced("process")
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
    dsis = _evaluate_all(mappers, events, trajs, T_rv_w, vopts)
    live = [d for d in dsis if d is not None]
    if not live:
        raise ValueError("no camera produced a DSI (all chunks too small)")
    res = ProcessResult(fused_dsi=fuse_dsis(live, stereo_fusion), T_rv_w=T_rv_w, ts=ts)
    for i, d in enumerate(dsis):
        if d is not None:
            res.dsis[f"camera{i}"] = d
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


def _temporal_accumulate(acc, dsi, method: int, first: bool) -> None:
    """Add one sub-interval's DSI into the running accumulator `acc`, in
    place.  `first` sets it to this DSI's term alone: the JAX package adds
    that term to zeros, and 0 + x == x, so the sums keep its bits without a
    zero plane per sub-interval."""
    if method == TEMPORAL_HM:
        term = gridops.inverse(dsi)
    elif method == TEMPORAL_AM:
        term = dsi
    else:
        raise ValueError(f"temporal_fusion must be {TEMPORAL_HM} (HM) or {TEMPORAL_AM} (AM)")
    if first:
        acc.copy_(term)
    else:
        acc.add_(term)


def _temporal_finalize(acc, n: int, method: int):
    if method == TEMPORAL_HM:
        return gridops.hm_from_sum_of_inv(acc, n)
    return gridops.am_from_sum(acc, n)


def temporal_step(acc: Sequence[torch.Tensor], d0: torch.Tensor, d1: torch.Tensor,
                  stereo_fusion: int, temporal_fusion: int, first: bool) -> torch.Tensor:
    """One sub-interval's device work (`bench.py:150-154`): the pair's fused
    DSI, and its term, d0's and d1's added into the accumulators `acc`
    (fused, left, right), in place.  Returns the fused DSI."""
    fused_k = gridops.fuse_pair(d0, d1, stereo_fusion)
    for a, dsi in zip(acc, (fused_k, d0, d1)):
        _temporal_accumulate(a, dsi, temporal_fusion, first)
    return fused_k


def temporal_final(acc: Sequence[torch.Tensor], n: int, stereo_fusion: int,
                   temporal_fusion: int) -> Dict[str, torch.Tensor]:
    """The accumulators (fused, left, right) normalised by the `n`
    sub-intervals that voted, and the converse order's fusion of left and
    right: {"fused", "left", "right", "camera_time"}."""
    fused, left, right = (_temporal_finalize(a, n, temporal_fusion) for a in acc)
    return {"fused": fused, "left": left, "right": right,
            "camera_time": gridops.fuse_pair(left, right, stereo_fusion)}


# Temporal programs kept (all devices): a DSI shape under its fusion and
# temporal methods.  Each holds 2 static inputs and 3 accumulators (5 x 123
# MB at 640x480x100) and its graphs' outputs.
TEMPORAL_CACHE_SIZE = 4
_TEMPORAL = graphs.ProgramCache(TEMPORAL_CACHE_SIZE)


def temporal_key(like: torch.Tensor, stereo_fusion: int, temporal_fusion: int) -> tuple:
    """The key of the temporal program for sub-interval DSIs like `like`:
    device, shape, dtype and the two methods."""
    return (like.device, tuple(like.shape), like.dtype, stereo_fusion, temporal_fusion)


def temporal_programs() -> list:
    """The temporal programs held, least recently used first."""
    return _TEMPORAL.values()


class TemporalProgram:
    """process_time_fusion's device work for one `temporal_key`: the
    accumulators (fused, left, right) and, on programs, `temporal_step`
    captured as two graphs (the first sub-interval's, which sets the
    accumulators, and the later ones', which add) over two static inputs,
    and `temporal_final` as a graph per sub-interval count.  With
    `captured` False (the CPU, `mapper.eager()`) the same bodies run
    eagerly on the caller's DSIs.  One pipeline call uses it at a time."""

    def __init__(self, like: torch.Tensor, stereo_fusion: int, temporal_fusion: int,
                 captured: bool):
        self.methods = (stereo_fusion, temporal_fusion)
        self.acc = [torch.empty_like(like) for _ in range(3)]
        self.captured = captured
        if captured:
            self.inputs = [torch.empty_like(like) for _ in range(2)]
            self.steps = {first: graphs.Captured(like.device, self.inputs, functools.partial(
                temporal_step, self.acc, *self.inputs, *self.methods, first), kind="temporal")
                for first in (True, False)}
            self.finals: Dict[int, graphs.Captured] = {}

    def step(self, d0: torch.Tensor, d1: torch.Tensor, first: bool,
             fresh: bool) -> torch.Tensor:
        """Fuse and accumulate a sub-interval; the fused DSI, a fresh tensor
        when `fresh` (else valid until the next replay)."""
        if not self.captured:
            return temporal_step(self.acc, d0, d1, *self.methods, first)
        return self.steps[first](d0, d1, fresh_out=fresh)

    def final(self, n: int) -> Dict[str, torch.Tensor]:
        """`temporal_final` over `n` sub-intervals, as fresh tensors."""
        if not self.captured:
            return temporal_final(self.acc, n, *self.methods)
        if n not in self.finals:
            self.finals[n] = graphs.Captured(self.acc[0].device, [], functools.partial(
                temporal_final, self.acc, n, *self.methods), kind="temporal")
        return self.finals[n]()

    def close(self) -> None:
        if self.captured:
            for prog in (*self.steps.values(), *self.finals.values()):
                prog.close()


def clear_programs() -> None:
    """Close every reference-view, fusion and temporal program held."""
    for cache in (_PLACEMENTS, _FUSIONS, _TEMPORAL):
        cache.clear()


def _temporal_program(like: torch.Tensor, stereo_fusion: int,
                      temporal_fusion: int) -> TemporalProgram:
    """The temporal program of `temporal_key` (made on first use and kept)
    on programs; a fresh eager one elsewhere."""
    if not graphs.use_programs(like.device):
        return TemporalProgram(like, stereo_fusion, temporal_fusion, captured=False)
    key = temporal_key(like, stereo_fusion, temporal_fusion)
    prog = _TEMPORAL.get(key)
    if prog is None:
        prog = TemporalProgram(like, stereo_fusion, temporal_fusion, captured=True)
        _TEMPORAL.put(key, prog)
    return prog


@tracing.traced("process")
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

    temporal = None
    n_live = 0
    for k in range(num_intervals):
        if evaluate_pair is not None:
            d0, d1 = evaluate_pair(mappers, [subs0[k], subs1[k]], trajs, T_rv_w)
            # The pair's refused binning weights, if any, raise here (one read
            # of the fault flags a sub-interval pair).
            mappermod.check_faults()
        else:
            d0, d1 = _evaluate_all(mappers, [subs0[k], subs1[k]], trajs, T_rv_w, vopts)
        if d0 is None or d1 is None:
            log.warning("sub-interval %d too small, skipped", k)
            continue
        if temporal is None:
            temporal = _temporal_program(d0, stereo_fusion, temporal_fusion)
        fused_k = temporal.step(d0, d1, first=n_live == 0,
                                fresh=on_subinterval is not None)
        n_live += 1
        if on_subinterval is not None:
            on_subinterval(k, {"camera0": d0, "camera1": d1, "fused": fused_k})
        # Free this sub-interval's planes before the next one votes.
        d0 = d1 = fused_k = None

    if temporal is None:
        raise ValueError("no sub-interval produced a DSI")
    out = temporal.final(n_live)
    fused, left, right = out["fused"], out["left"], out["right"]
    camera_time = out["camera_time"]
    if vopts.sync:
        _synchronize(fused)

    res = TemporalResult(fused_dsi=fused, T_rv_w=T_rv_w, ts=ts)
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
    so a resumed chunk costs no device work.  The arrays are page-locked in
    place for the card's programs (`mapper.page_lock`, once a process), so
    that the chunks sliced from them are copied by DMA; they must not
    change until the run's device work is done."""
    mappermod.page_lock(events, trajs[0].device)
    for k, (t0, t1, ts) in enumerate(full_seq_windows(opts)):
        if skip is not None and skip(k):
            log.info("chunk %d @ ts=%.3f already complete; skipped", k, ts)
            continue
        with tracing.span("full_seq.window"):
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
        with tracing.span("full_seq.window"):
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
