"""Roofline of the PyTorch port's chunk on an NVIDIA GPU: the counterpart of
scripts/roofline.py.

On chip_smoke.build_workload's headline chunk (2 x 1 Mi events, 640x480x100)
under `--spec` (a butterfly spec on the kernel engine, default
`hist:g16,seg16,bf,pl`) it takes these stages: one camera's warp, binning
(kernel A), butterfly merge (kernel B through `banded_resample_sum`) and
plane sweep (kernel B through `banded_resample_fanin`); the fusion of both
cameras' DSIs; the extraction (collapse, threshold, median, border); and
the whole chunk (both cameras' warp and vote, fusion, extraction).  For each
it reports:

  1. the device time by CUDA graph (scripts/probe_gpu.py's `cuda_graph_ms`:
     the stage's calls on its own inputs captured in one graph, best of
     three replays);
  2. an analytic work model: bytes moved (each input read once, each output
     written once) and operations, from the spec and the chunk's real group,
     event and item counts (the kernel wrappers' calls recorded on one eager
     run of the stage);
  3. the bound, max(bytes / 3.35 TB/s, operations / 67 TFLOP/s) (NVIDIA's
     H100 SXM data sheet; float32 outside the tensor cores), and beside it
     the same with the HBM rate that the `hbm_stream` probe reaches on this
     card;
  4. the share of the bound (bound / time) and the headroom (time / bound).

The whole chunk's row adds the host-clock seconds of process_1 +
get_depth_map on its programs (median after a warm-up).  chip_smoke.py
phase 3 takes its kernel bounds from this file's work model (`bound`,
`binning_work`, `resample_sum_work`, `resample_fanin_work`), so its rows and
the kernel stages here count the same bytes and operations.  Prints one JSON
object on its last line, with the card's name and power limit (`--json PATH`
also writes it); without a CUDA device it raises.

    python3 scripts/roofline_torch.py [--spec hist:g16,seg16,bf,pl] [--json out.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# ---------------------------------------------------------------------------
# The work model
# ---------------------------------------------------------------------------

# The least time for a stage's work on an H100 SXM (NVIDIA's data sheet): its
# bytes over the HBM3 rate, or its operations over the float32 rate outside
# the tensor cores -- every kernel of the chunk runs on the CUDA cores --
# whichever is larger.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The warp's operations an event: rectification, the packet's homography and
# the z0 projection (scripts/roofline.py:171 counts 30).
WARP_OPS_PER_EVENT = 30
# Elementwise operations a voxel of each `stereo_fusion` method of a pair
# (min, HM 2ab/(a+b+eps), GM, AM, RMS, max).
FUSION_OPS = {1: 1, 2: 5, 3: 2, 4: 2, 5: 4, 6: 1}
# Bytes a pixel of the extraction's maps: depth, confidence and indices in
# 4 bytes, the mask in 1.
MAP_BYTES = 4 + 4 + 4 + 1


def bound(moved: float, ops: float, hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> dict:
    """The least time for `moved` bytes and `ops` operations, and which of
    the two sets it."""
    t_bytes, t_ops = moved / hbm_bytes_per_s * 1e3, ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def resample_ops(n_item_k: int, out_h: int, ws: int, out_w: int) -> int:
    """Multiply-adds of the banded resample, two taps a value in each stage:
    y stage (out_h, ws), x stage (out_h, out_w), per (item, source)."""
    return n_item_k * 4 * (out_h * ws + out_h * out_w)


def binning_work(G: int, E: int, hs: int, ws: int, out_itemsize: int,
                 live: int) -> Tuple[int, int]:
    """Kernel A binning G groups of E events into (G, hs, ws): the float32
    hx, hy and w read once, the histograms written once; four tap products
    and adds for each live (nonzero-weight) event."""
    return 3 * 4 * G * E + G * hs * ws * out_itemsize, 8 * live


def resample_sum_work(n_src: int, hs: int, ws: int, in_itemsize: int, N: int, K: int,
                      out_h: int, out_w: int, out_itemsize: int,
                      maps: int = 3) -> Tuple[int, int]:
    """Kernel B through `banded_resample_sum`: N items of K sources each from
    a stack of n_src (hs, ws) planes into (N, out_h, out_w).  The stack, the
    `maps` distinct (N, K) float32 maps (3 where one scale serves both axes)
    and the int32 source table read once, the output written once."""
    moved = n_src * hs * ws * in_itemsize + (maps + 1) * N * K * 4 + \
        N * out_h * out_w * out_itemsize
    return moved, resample_ops(N * K, out_h, ws, out_w)


def resample_fanin_work(S: int, K: int, hs: int, ws: int, in_itemsize: int, M: int,
                        n_items: int, n_out: int, out_h: int, out_w: int,
                        maps: int = 4, out_itemsize: int = 4) -> Tuple[int, int]:
    """Kernel B through `banded_resample_fanin`: S blocks of K (hs, ws)
    sources, each swept into M output rows (S x M int32 plane indices), of
    which `n_items` distinct planes are written into (n_out, out_h, out_w).
    The blocks, the (S, M, K) float32 maps and the indices read once, the
    output written once."""
    moved = S * K * hs * ws * in_itemsize + maps * S * M * K * 4 + S * M * 4 + \
        n_out * out_h * out_w * out_itemsize
    return moved, resample_ops(n_items * K, out_h, ws, out_w)


def warp_work(n_events: int) -> Tuple[int, int]:
    """The warp of n events: x, y (int32) and t (float32) read once, the z0
    locations (two float32) written once."""
    return 3 * 4 * n_events + 2 * 4 * n_events, WARP_OPS_PER_EVENT * n_events


def fusion_work(n_grids: int, voxels: int, method: int) -> Tuple[int, int]:
    """Fusing n float32 grids of `voxels`: each read once, the fused grid
    written once; FUSION_OPS an element of each of the n - 1 pairs."""
    return (n_grids + 1) * voxels * 4, FUSION_OPS[method] * (n_grids - 1) * voxels


def extraction_work(Z: int, H: int, W: int, agt_kernel: int = 5, median: int = 5,
                    levels: int = 256) -> Tuple[int, int]:
    """The extraction of a (Z, H, W) float32 DSI: the DSI read once, the
    four 2D maps written once.  Operations: a compare a voxel for the
    collapse; a pixel, the min-max normalisation (4), the Gaussian mean's
    taps (2 k^2 for a k x k kernel) and the rank search of the median (a
    count over the m^2 neighbours for each of ceil(log2 levels) steps, and
    one to count them)."""
    per_pixel = 4 + 2 * agt_kernel ** 2 + \
        median ** 2 * 2 * (1 + math.ceil(math.log2(max(levels, 2))))
    return Z * H * W * 4 + H * W * MAP_BYTES, Z * H * W + H * W * per_pixel


# ---------------------------------------------------------------------------
# The chunk's stages on the card
# ---------------------------------------------------------------------------


def _probe_gpu():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_probe_gpu", os.path.join(REPO, "scripts", "probe_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def recorded_work(records: List[Tuple[str, int, int]]):
    """Inside, each call of the kernel wrappers that the voting path makes
    appends (wrapper, bytes, operations) of its work model to `records`.
    (The binning's live events are counted on the host: run it eagerly.)"""
    from dvs_mcemvs_torch.ops import voting_hist as vh

    real = (vh.bin_events, vh.banded_resample_sum, vh.banded_resample_fanin)

    def bin_events(hx, hy, w, *, hs, ws, out_dtype=None, **kw):
        item = torch.finfo(out_dtype or torch.float32).bits // 8
        records.append(("bin_events", *binning_work(hx.shape[0], hx.shape[1], hs, ws, item,
                                                    int((w != 0).sum()))))
        return real[0](hx, hy, w, hs=hs, ws=ws, out_dtype=out_dtype, **kw)

    def resample_sum(hist, sy, ty, sx, tx, *, out_h, out_w, out_dtype=None, **kw):
        N, K = sy.shape
        item = torch.finfo(out_dtype or torch.float32).bits // 8
        records.append(("banded_resample_sum", *resample_sum_work(
            hist.shape[0], hist.shape[1], hist.shape[2], hist.element_size(), N, K, out_h,
            out_w, item, maps=3 if sx is sy else 4)))
        return real[1](hist, sy, ty, sx, tx, out_h=out_h, out_w=out_w, out_dtype=out_dtype,
                       **kw)

    def resample_fanin(blocks, sy, ty, sx, tx, out_idx, *, n_out, out_h, out_w,
                       out_dtype=None):
        S, K, hs, ws = blocks.shape
        item = torch.finfo(out_dtype or torch.float32).bits // 8
        records.append(("banded_resample_fanin", *resample_fanin_work(
            S, K, hs, ws, blocks.element_size(), sy.shape[1], int(out_idx.out_idx.numel()),
            n_out, out_h, out_w, maps=3 if sx is sy else 4, out_itemsize=item)))
        return real[2](blocks, sy, ty, sx, tx, out_idx, n_out=n_out, out_h=out_h,
                       out_w=out_w, out_dtype=out_dtype)

    vh.bin_events, vh.banded_resample_sum, vh.banded_resample_fanin = (
        bin_events, resample_sum, resample_fanin)
    try:
        yield records
    finally:
        vh.bin_events, vh.banded_resample_sum, vh.banded_resample_fanin = real


class Stages:
    """The headline chunk's stages under a butterfly `spec`, each a function
    of device tensors made ready here (nothing read back, nothing copied
    from the host): `fns` by name, and the inputs they share.  `check()`
    holds the stages, run in turn, to the mapper's body."""

    def __init__(self, workload, spec: str, ts: float = 0.5, packet: int = 1024):
        from dvs_mcemvs_torch import mapper as mappermod, pipeline
        from dvs_mcemvs_torch.ops import extract, grid as gridops, voting
        from dvs_mcemvs_torch.ops import voting_hist as vh

        mappers, events, trajs, _ = workload
        kw = getattr(voting.resolve_backend(spec), "keywords", {})
        if kw.get("merge_mode") != "butterfly" or kw.get("engine") != "pallas":
            raise ValueError(f"{spec}: the stages model a butterfly spec on the kernel "
                             "engine (tokens bf and pl)")
        self.spec, self.mappers, self.trajs = spec, mappers, trajs
        m = mappers[0]
        self.T_rv_w = pipeline.place_reference_view(trajs[0], ts)
        self.body = mappermod._setup(m, packet, spec, 8, "device")
        dev = trajs[0].device
        self.consts = mappermod._constants(m, self.body, dev)
        self.inputs = [mappermod._host_events(ev, packet, "bucket", dev) for ev in events]
        self.flag = torch.zeros(1, dtype=torch.int32, device=dev)
        fx, fy, cx, cy = vp = self.body.vcam_params
        H, W, z0 = m.height, m.width, self.body.z0
        g, ss = kw.get("group_size", 32), kw.get("supersample", vh.SUPERSAMPLE)
        px, py = kw.get("pad_x", vh.PAD_X), kw.get("pad_y", vh.PAD_Y)
        dtype = kw.get("dtype", torch.bfloat16)
        bin_dtype = kw.get("bin_dtype") or dtype
        hs, ws = (H + 2 * py) * ss, (W + 2 * px) * ss
        ws += -ws % 128
        hs += -hs % 64
        depths = self.consts.depths
        Z = depths.shape[0]
        segments = kw.get("segments", 1)
        bounds = [round(s * Z / segments) for s in range(segments + 1)]
        u = 1.0 / depths
        corr = (z0, fx, fy, cx, cy, 0.5 * (torch.min(u) + torch.max(u))) \
            if kw.get("correct", True) else None
        self.opts = extract.DepthMapOptions()
        dv = m.depth_vec

        def warp():
            return mappermod._warp(self.body, self.consts, *self.inputs[0], trajs[0],
                                   self.T_rv_w)

        self.packets = warp()

        def binning():
            return vh.build_group_histograms(self.packets, g, hs, ws, px, py, ss,
                                             dtype=bin_dtype, correction=corr,
                                             out_dtype=dtype)

        self.hist, self.centers = binning()

        def merge():
            return vh._merge_butterfly(self.hist, self.centers, depths, bounds, z0, vp,
                                       px, py, ss, dtype)

        self.hist_seg, self.centers_s = merge()

        def sweep():
            return vh._sweep_planes_fanin(self.hist_seg, self.centers_s, depths, bounds, z0,
                                          vp, W, H, px, py, ss)

        self.dsis = [self.vote(c) for c in range(len(self.inputs))]

        def fusion():
            return gridops.fuse_many(self.dsis, 2)

        self.fused = fusion()

        def extraction():
            return extract.extraction_body(self.fused, dv, self.opts)

        def chunk():
            dsis = [self.vote(c) for c in range(len(self.inputs))]
            return extract.extraction_body(gridops.fuse_many(dsis, 2), dv, self.opts)

        self.sweep_out = sweep()
        self.fns: Dict[str, Callable] = dict(warp=warp, binning=binning, merge=merge,
                                             sweep=sweep, fusion=fusion,
                                             extraction=extraction, chunk=chunk)
        self.shape, self.n_events = (Z, H, W), [int(i[0].shape[0]) for i in self.inputs]
        self.extract_levels = dv.n

    def vote(self, c: int) -> torch.Tensor:
        """Camera c's body, warp and vote (`mapper._vote`)."""
        from dvs_mcemvs_torch import mapper as mappermod

        return mappermod._vote(self.body, self.consts, *self.inputs[c], self.trajs[c],
                               self.T_rv_w)

    def check(self) -> None:
        """The stages in turn equal the mapper's body on camera 0: raise
        otherwise."""
        if not torch.equal(self.sweep_out, self.dsis[0]):
            raise AssertionError(f"{self.spec}: the stages in turn differ from the body")

    def deferred(self, fn: Callable) -> Callable:
        """fn under deferred weight checks, so that no call reads the card."""
        from dvs_mcemvs_torch.kernels import binning

        def run():
            with binning.deferred_weight_checks(self.flag):
                return fn()
        return run

    def work(self) -> Dict[str, Tuple[int, int]]:
        """Each stage's (bytes, operations) by the model, from the kernel
        calls of one eager run of it (the whole chunk's: both cameras'
        stages, the fusion and the extraction)."""
        Z, H, W = self.shape
        out = {}
        for name in ("binning", "merge", "sweep"):
            records: list = []
            with recorded_work(records):
                self.fns[name]()
            out[name] = (sum(r[1] for r in records), sum(r[2] for r in records))
        out["warp"] = warp_work(self.n_events[0])
        out["fusion"] = fusion_work(len(self.dsis), Z * H * W, 2)
        out["extraction"] = extraction_work(
            Z, H, W, self.opts.adaptive_threshold_kernel_size, self.opts.median_filter_size,
            self.extract_levels)
        records = []
        with recorded_work(records):
            self.fns["chunk"]()
        out["chunk"] = tuple(
            sum(r[i] for r in records) + sum(warp_work(n)[i - 1] for n in self.n_events)
            + out["fusion"][i - 1] + out["extraction"][i - 1] for i in (1, 2))
        return out


def hbm_rate(dev, min_time: float) -> float:
    """Bytes a second that the `hbm_stream` probe reads on this card (256
    blocks of 576 x 896 bf16, by CUDA graph, as scripts/probe_gpu.py)."""
    from dvs_mcemvs_torch.kernels import probes

    gpu = _probe_gpu()
    big = torch.ones((gpu.G, gpu.H, gpu.W), dtype=torch.bfloat16, device=dev)
    ms = gpu.cuda_graph_ms(lambda: probes.hbm_stream(big), min_time)
    return big.numel() * 2 / ms * 1e3


def run(workload, spec: str = "hist:g16,seg16,bf,pl", min_time: float = 0.3,
        chunk_runs: int = 5, log=print) -> dict:
    """The report of one spec on `workload` (chip_smoke.build_workload's),
    on the card."""
    import chip_smoke as cs

    dev = workload[2][0].device
    gpu = _probe_gpu()
    smi = gpu.nvidia_smi_line()
    st = Stages(workload, spec)
    st.check()
    work = st.work()
    measured = hbm_rate(dev, min_time)
    rows = {}
    for name, fn in st.fns.items():
        ms = gpu.cuda_graph_ms(st.deferred(fn), min_time)
        moved, ops = work[name]
        b, bm = bound(moved, ops), bound(moved, ops, measured)
        rows[name] = dict(ms=ms, bytes=moved, ops=ops, bound_ms=b["bound_ms"],
                          bound_by=b["bound_by"], share=b["bound_ms"] / ms,
                          headroom_x=ms / b["bound_ms"], bound_measured_ms=bm["bound_ms"],
                          share_measured=bm["bound_ms"] / ms)
        log(f"  {name:10s} {ms:9.4f} ms by graph; {moved / 1e6:10.3f} MB, {ops / 1e9:8.3f} "
            f"Gop; bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bound_ms'] / ms:.1%};"
            f" headroom {ms / b['bound_ms']:.2f}x); at hbm_stream's rate "
            f"{bm['bound_ms']:.4f} ms ({bm['bound_ms'] / ms:.1%})  [{smi}]")
    for _ in range(2):
        cs.run_chunk(workload, spec)
    walls = []
    for _ in range(chunk_runs):
        t0 = time.perf_counter()
        cs.run_chunk(workload, spec)
        walls.append(time.perf_counter() - t0)
    rows["chunk"]["programs_wall_s"] = float(np.median(walls))
    rows["chunk"]["programs_wall_samples_s"] = walls
    log(f"  chunk on programs (process_1 + get_depth_map, host clock, median of "
        f"{chunk_runs}): {rows['chunk']['programs_wall_s']:.6f} s; its device work by graph "
        f"{rows['chunk']['ms']:.4f} ms  [{smi}]")
    kernels = ("binning", "merge", "sweep")
    return {
        "device": torch.cuda.get_device_name(dev), "nvidia_smi": smi, "spec": spec,
        "workload": {"events": st.n_events, "dsi": list(st.shape),
                     "hist": list(st.hist.shape), "hist_seg": list(st.hist_seg.shape)},
        "peaks": {"hbm_bytes_per_s": HBM_BYTES_PER_S, "f32_ops_per_s": F32_OPS_PER_S,
                  "hbm_stream_bytes_per_s": measured,
                  "source": "NVIDIA H100 SXM data sheet; hbm_stream measured here"},
        "stages": rows,
        "summary": {"camera_vote_ms": sum(rows[k]["ms"] for k in ("warp", *kernels)),
                    "camera_vote_bound_ms": sum(rows[k]["bound_ms"]
                                                for k in ("warp", *kernels)),
                    "chunk_ms": rows["chunk"]["ms"],
                    "chunk_bound_ms": rows["chunk"]["bound_ms"],
                    "chunk_programs_wall_s": rows["chunk"]["programs_wall_s"]},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spec", default="hist:g16,seg16,bf,pl")
    parser.add_argument("--min-time", type=float, default=0.3,
                        help="seconds of each graph timing (a third captured)")
    parser.add_argument("--json", default="", help="also write the report here")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    from dvs_mcemvs_torch.device import require_cuda

    dev = require_cuda()
    import chip_smoke as cs

    report = run(cs.build_workload(dev), args.spec, args.min_time,
                 log=lambda m: print(m, file=sys.stderr, flush=True))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
