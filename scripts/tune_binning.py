"""Time variants of the binning kernel (csrc/binning.cu) side by side on one
GPU, at the shapes of chip_smoke.py phase 3.

A variant is a source (the committed one, or it with the threads a block or
the ring's stages replaced) built into build/tune/<source>/, and the cluster
size C of its launch plan (`kernels.binning.plan`, which gives the ring's
shared memory to the accumulator's rows when the ring is smaller).  The
ablations (noscan, noadd, nowrite) remove one phase of the kernel and are
timed only, to show where its time goes.  Every other variant is checked
against the plain version (the bf16-tap and int8 windowed rows).  Each is
timed with CUDA events on the windowed bf16 row, the int8 windowed row
(kernel only, without the wrapper's weight check), the dense f32 row and
the ss2 grid.  The variants run in the order given, then again in reverse,
so that drift on the card shows as a difference between a variant's two
rows.

    python3 scripts/tune_binning.py [--variants C1,C2,s3/C1,...] [--iters 20]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

ABLATIONS = {  # timing only: each removes one phase of the kernel
    "noscan": ("  for (int k = rank; k < n_chunks; k += C, ++it) {",
               "  for (int k = n_chunks; k < n_chunks; k += C, ++it) {"),
    "noadd": ("  const int band_hi = min(band_lo + C * rows, hs);",
              "  const int band_hi = band_lo;"),
    "nowrite": ("  const int n = (row_hi - row_lo) * ws;", "  const int n = 0;"),
}


def _replacements(threads: int, stages: int, ablation: str = "") -> tuple:
    """Replacements that set the source's threads a block and ring stages,
    and remove the phase `ablation` names."""
    out = tuple((f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")
                for name, old, new in (("kThreads", 1024, threads), ("kStages", 2, stages))
                if new != old)
    return out + ((ABLATIONS[ablation],) if ablation else ())


# source -> (threads a block, ring stages[, ablation])
SOURCES = {"as_built": (1024, 2), "s3": (1024, 3), "s4": (1024, 4), "t512s4": (512, 4),
           **{a: (1024, 2, a) for a in ABLATIONS}}
# variant -> (source, cluster size)
VARIANTS = {f"C{c}": ("as_built", c) for c in (8, 4, 2, 1)}
VARIANTS.update({f"{src}/C1": (src, 1) for src in SOURCES if src != "as_built"})


def source_dir(name: str) -> Path:
    src = (Path(REPO) / "dvs_mcemvs_torch" / "csrc" / "binning.cu").read_text()
    for old, new in _replacements(*SOURCES[name]):
        if old not in src:
            raise ValueError(f"source {name}: {old!r} not in csrc/binning.cu")
        src = src.replace(old, new)
    out = Path(REPO) / "build" / "tune" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "binning.cu").write_text(src)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    import chip_smoke as cs
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.kernels import _build, binning

    dev = require_cuda()
    smi = cs.nvidia_smi_line()
    print(smi)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    G, E = 64, 16384

    def events(h, w_cols):
        hx = torch.as_tensor(rng.uniform(0, w_cols - 1, (G, E)), **f32)
        hy = torch.as_tensor(np.sort(rng.normal(h / 2, h / 5, (G, E)).clip(0, h - 1)), **f32)
        w = torch.as_tensor(rng.uniform(0, 1, (G, E)) * (rng.uniform(size=(G, E)) > 0.1), **f32)
        return hx, hy, w

    # name -> (events, hs, ws, int8, output dtype)
    rows = {"windowed": (events(cs.HS, cs.WS), cs.HS, cs.WS, False, torch.bfloat16),
            "int8": (events(cs.HS, cs.WS), cs.HS, cs.WS, True, torch.bfloat16),
            "dense": (events(cs.HS_DENSE, cs.WS), cs.HS_DENSE, cs.WS, False, torch.float32),
            "ss2": (events(2 * cs.HS, 2 * cs.WS), 2 * cs.HS, 2 * cs.WS, False, torch.float32)}
    want = {}
    for name in ("windowed", "int8"):
        (hx, hy, w), h, w_cols, int8, out_dtype = rows[name]
        plain = binning.bin_events_int8_reference if int8 else binning.bin_events_reference
        want[name] = plain(hx, hy, w, h, w_cols).to(out_dtype)

    names = args.variants.split(",")
    dirs = {src: source_dir(src) for src in {VARIANTS[n][0] for n in names}}
    stage_bytes = binning.STAGE_BYTES
    print(f"{'variant':>12} " + " ".join(f"{r + ' ms':>13}" for r in rows))
    for i, name in enumerate(names + names[::-1]):
        src, cluster = VARIANTS[name]
        threads, stages = SOURCES[src][:2]
        _build.CSRC_DIR = dirs[src]
        _build._LIBS.pop("binning", None)
        binning._MAX_CLUSTERS.clear()
        binning.STAGE_BYTES = stages * 3 * threads * 4
        binning.plan.cache_clear()
        try:
            binning._library()
        except RuntimeError as err:  # a variant that does not build
            print(f"  {name}: build failed: {str(err)[-2000:]}")
            continue
        plans = {r: binning.plan(h, w_cols, E, int8, cluster=cluster)
                 for r, (_, h, w_cols, int8, _) in rows.items()}
        calls = {r: (lambda ev=ev, p=plans[r], o=o: binning.launch(*ev, p, o))
                 for r, (ev, _, _, _, o) in rows.items()}
        if i < len(names):
            p = plans["windowed"]
            lines = [ln.strip() for ln in _build.BUILD_INFO["binning"][1].splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"  {name}: windowed plan C={p.cluster} R={p.rows} {p.bands} bands "
                  f"{p.smem_bytes} bytes, max active clusters "
                  f"{binning.max_active_clusters(p, True)}; ptxas: " + " | ".join(lines))
            if src in ABLATIONS:
                print(f"  {name}: an ablation, timed only")
            else:
                cs.compare(f"{name} windowed", calls["windowed"](), want["windowed"])
                cs.compare_exact(f"{name} int8", calls["int8"](), want["int8"])
        times = [cs.cuda_ms(fn, args.iters) for fn in calls.values()]
        print(f"{name:>12} " + " ".join(f"{t:13.4f}" for t in times), flush=True)
    binning.STAGE_BYTES = stage_bytes
    binning.plan.cache_clear()
    print(smi)


if __name__ == "__main__":
    main()
