"""Time variants of the banded resample kernel (csrc/resample.cu) side by
side on one GPU, at the headline shapes of chip_smoke.py phase 3.

Each variant is the committed source with some constants replaced; it is
built into build/tune/<variant>/ with the port's nvcc flags, checked
against the plain version on the merge level and the plane sweep, and
timed (CUDA events) on the merge level, the plane sweep, the flat merge and
the non-segmented sweep form.  The variants run in the order given, then
again in reverse, so that drift on the card shows as a difference between
a variant's two rows.

    python3 scripts/tune_resample.py [--variants as_built,three_blocks,...]
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

# name -> (old, new) replacements in csrc/resample.cu.
VARIANTS = {
    "as_built": (),
    # 3 bf16 blocks an SM: 85 registers a thread instead of 64, no spills.
    "three_blocks": (("sizeof(Tin) == 2 ? 4 : 2", "sizeof(Tin) == 2 ? 3 : 2"),),
    # 32 x 64 output tiles: half the column taps and twice the row taps a
    # step; the staged band of a scale-0.4 map still fits (88 x 184 values).
    "tile_32x64": (("constexpr int TV = 16;", "constexpr int TV = 32;"),
                   ("constexpr int TU = 128;", "constexpr int TU = 64;"),
                   ("constexpr int NP_MAX = 352;", "constexpr int NP_MAX = 192;")),
}
VARIANTS["tile_32x64_three_blocks"] = VARIANTS["tile_32x64"] + VARIANTS["three_blocks"]


def variant_dir(name: str) -> Path:
    src = (Path(REPO) / "dvs_mcemvs_torch" / "csrc" / "resample.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    out = Path(REPO) / "build" / "tune" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "resample.cu").write_text(src)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    import chip_smoke as cs
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.kernels import _build, resample

    dev = require_cuda()
    smi = cs.nvidia_smi_line()
    print(smi)
    rng = np.random.default_rng(0)
    hist, sy, ty, tx, src = cs._merge_level_inputs(dev, 64, cs.HS, cs.WS, rng)
    blocks, fsy, fty, fsx, ftx, out_idx = cs._sweep_inputs(dev, 16, 4, cs.DIM_Z, cs.HS,
                                                           cs.WS, rng)
    _, s_sy, s_ty, s_sx, s_tx, _ = cs._sweep_inputs(dev, 1, 64, cs.DIM_Z, cs.HS, cs.WS, rng)
    sweep_maps = [m.reshape(cs.DIM_Z, 64) for m in (s_sy, s_ty, s_sx, s_tx)]
    flat_maps = [m.reshape(-1)[:64].reshape(4, 16).contiguous() for m in (sy, ty, tx)]
    calls = {
        "merge": lambda: resample.banded_resample_sum(
            hist, sy, ty, sy, tx, out_h=cs.HS, out_w=cs.WS, blocked=True, src=src,
            out_dtype=torch.bfloat16),
        "sweep": lambda: resample.banded_resample_fanin(
            blocks, fsy, fty, fsx, ftx, out_idx, n_out=cs.DIM_Z, out_h=cs.HEIGHT,
            out_w=cs.WIDTH),
        "flat": lambda: resample.banded_resample_sum(
            hist, flat_maps[0], flat_maps[1], flat_maps[0], flat_maps[2], out_h=cs.HS,
            out_w=cs.WS, blocked=True, out_dtype=torch.bfloat16),
        "sweep_form": lambda: resample.banded_resample_sum(
            hist, *sweep_maps, out_h=cs.HEIGHT, out_w=cs.WIDTH, blocked=False),
    }
    # The plain versions once; every variant is held to them.
    sources, src_idx, maps, items = resample.fanin_items(blocks, fsy, fty, fsx, ftx, out_idx,
                                                         cs.DIM_Z)
    want = {
        "merge": resample.banded_resample_reference(
            hist, torch.as_tensor(src, dtype=torch.long, device=dev), sy, ty, sy, tx,
            torch.arange(src.shape[0], device=dev), n_out=src.shape[0], out_h=cs.HS,
            out_w=cs.WS, out_dtype=torch.bfloat16),
        "sweep": resample.banded_resample_reference(
            sources, torch.as_tensor(src_idx, device=dev), *maps,
            torch.as_tensor(items, dtype=torch.long, device=dev), n_out=cs.DIM_Z,
            out_h=cs.HEIGHT, out_w=cs.WIDTH),
    }

    names = args.variants.split(",")
    dirs = {name: variant_dir(name) for name in names}
    print(f"{'variant':>14} " + " ".join(f"{c + ' ms':>14}" for c in calls))
    for i, name in enumerate(names + names[::-1]):
        _build.CSRC_DIR = dirs[name]
        _build._LIBS.pop("resample", None)
        _build.build("resample")
        if i < len(names):
            lines = [ln.strip() for ln in _build.BUILD_INFO["resample"][1].splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"  {name} ptxas: " + " | ".join(lines))
        for call, ref in want.items():
            cs.compare(f"{name} {call}", calls[call](), ref)
        times = [cs.cuda_ms(fn, 2 if c == "sweep_form" else args.iters)
                 for c, fn in calls.items()]
        print(f"{name:>14} " + " ".join(f"{t:14.4f}" for t in times), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
