"""Time ring sizes of the hbm_stream probe (csrc/probes.cu) side by side on
one GPU, at the probe's shape: (256, 576, 896) bf16 summed over its 256
blocks.

Each variant is the committed source with the ring's stage count replaced;
a ring above 48 KB takes dynamic shared memory, which the variant opts in
to at each launch.  It is built into build/tune/<variant>/ with the port's
nvcc flags, held exactly to the plain version, and timed on the device
alone by scripts/probe_gpu.py's `cuda_graph_ms`.  The variants run in the
order given, then again in reverse, so that drift on the card shows as a
difference between a variant's two rows; torch.sum over the same stream is
timed first and last.

    python3 scripts/tune_probes.py [--variants stages_2,as_built,...]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

TILE_BYTES = 512 * 16        # kTileVec vectors of 16 bytes
STATIC_SMEM = 48 * 1024      # a kernel's static shared memory, at most


def ring(stages: int) -> tuple:
    """Replacements in csrc/probes.cu for a ring of `stages` tiles."""
    reps = (("constexpr int kStages = 4;", f"constexpr int kStages = {stages};"),)
    if stages * TILE_BYTES + 64 > STATIC_SMEM:
        smem = "kStages * kTileVec * 16"
        reps += (("__shared__ __align__(128) uint4 ring[S * kTileVec];",
                  "extern __shared__ __align__(128) uint4 ring[];"),
                 ("  hbm_stream_kernel<<<n_slices, kStreamThreads, 0, s>>>(",
                  f"  cudaFuncSetAttribute(hbm_stream_kernel,\n"
                  f"      cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});\n"
                  f"  hbm_stream_kernel<<<n_slices, kStreamThreads, {smem}, s>>>("))
    return reps


# name -> (old, new) replacements in csrc/probes.cu.
VARIANTS = {"as_built": (), **{f"stages_{n}": ring(n) for n in (2, 3, 6, 8)}}


def variant_dir(name: str) -> Path:
    src = (Path(REPO) / "dvs_mcemvs_torch" / "csrc" / "probes.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    out = Path(REPO) / "build" / "tune" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "probes.cu").write_text(src)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default="stages_2,stages_3,as_built,stages_6,stages_8")
    parser.add_argument("--min-time", type=float, default=1.5,
                        help="seconds of calls in each CUDA graph, times 3 (default 1.5)")
    args = parser.parse_args()
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.kernels import _build, probes
    from scripts.probe_gpu import G, H, HBM_BYTES_PER_S, W, cuda_graph_ms, nvidia_smi_line

    dev = require_cuda()
    smi = nvidia_smi_line()
    print(smi)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = (torch.rand((G, H, W), generator=gen, device=dev) * 8 - 4).to(torch.bfloat16)
    want = probes.hbm_stream_reference(stream)
    read = stream.numel() * 2

    def row(name: str, ms: float) -> None:
        print(f"{name:>10} {ms:10.4f} ms {read / ms / 1e6:9.1f} GB/s "
              f"{read / ms * 1e3 / HBM_BYTES_PER_S:7.1%} of 3.35 TB/s", flush=True)

    def torch_sum() -> None:
        row("torch.sum", cuda_graph_ms(
            lambda: torch.sum(stream, 0, keepdim=True, dtype=torch.float32), args.min_time))

    names = args.variants.split(",")
    dirs = {name: variant_dir(name) for name in names}
    torch_sum()
    for name in names + names[::-1]:
        _build.CSRC_DIR = dirs[name]
        _build._LIBS.pop("probes", None)
        _build.build("probes")
        got = probes.hbm_stream(stream)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: max abs error "
                                 f"{(got - want).abs().max().item()} against the plain version")
        row(name, cuda_graph_ms(lambda: probes.hbm_stream(stream), args.min_time))
    torch_sum()
    print(smi)


if __name__ == "__main__":
    main()
