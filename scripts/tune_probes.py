"""Time variants of the platform probes (csrc/probes.cu) side by side on one
GPU, at the probes' shapes:

  hbm_stream  ring sizes: (256, 576, 896) bf16 summed over its 256 blocks.
              Each variant is the committed source with the ring's stage
              count replaced (a ring above 48 KB takes dynamic shared
              memory, which the variant opts in to at each launch), built
              into build/tune/<variant>/ with the port's nvcc flags.
  dyn_slice   items of strip float4 columns x band output rows, each the
              plan of `probes.dyn_slice_plan` at those items, launched as
              the wrapper launches its own: (1, 576, 896) f32, 64 steps of
              20 offsets; loads issued ahead of their adds (`kGroup`
              replaced in the source, as the rings); and the built items at
              other step counts, which split a call's fixed cost from its
              loop's rate on the busiest SM.

Every variant is held exactly to the plain version and timed on the device
alone by scripts/probe_gpu.py's `cuda_graph_ms`.  The variants of a probe
run in the order given, then again in reverse, so that drift on the card
shows as a difference between a variant's two rows; torch.sum over the HBM
stream is timed first and last.  dyn_slice prints its share of the on-chip
ceiling (probe_gpu.py's).

    python3 scripts/tune_probes.py [--probes dyn_slice,hbm_stream]
        [--rings stages_2,as_built,...] [--items 1x42,2x42,...]
        [--groups group_2,as_built,group_8] [--steps 1,16,64]
"""

from __future__ import annotations

import argparse
import functools
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


# name -> (old, new) replacements in csrc/probes.cu: hbm_stream's rings and
# dyn_slice's loads issued ahead of their adds.
VARIANTS = {"as_built": (), **{f"stages_{n}": ring(n) for n in (2, 3, 6, 8)},
            **{f"group_{n}": (("constexpr int kGroup = 4;", f"constexpr int kGroup = {n};"),)
               for n in (2, 8)}}


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


def in_turns(names: list, prepare, run, want, row, min_time: float) -> None:
    """`prepare(name)` each variant in the order given and then reversed,
    hold `run()` exactly to `want`, and `row(name, ms)` its graph time."""
    from scripts.probe_gpu import cuda_graph_ms

    for name in names + names[::-1]:
        prepare(name)
        got = run()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: max abs error "
                                 f"{(got - want).abs().max().item()} against the plain version")
        row(name, cuda_graph_ms(run, min_time))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--probes", default="dyn_slice,hbm_stream")
    parser.add_argument("--rings", default="stages_2,stages_3,as_built,stages_6,stages_8",
                        help="hbm_stream's variants")
    parser.add_argument("--items", default="1x24,1x42,1x84,2x12,2x21,2x24,2x42,4x6,4x12",
                        help="dyn_slice's items, strip (float4) x band (rows)")
    parser.add_argument("--groups", default="group_2,as_built,group_8",
                        help="dyn_slice's variants of loads issued ahead")
    parser.add_argument("--steps", default="1,16,64", help="dyn_slice's step counts")
    parser.add_argument("--min-time", type=float, default=1.5,
                        help="seconds of calls in each CUDA graph, times 3 (default 1.5)")
    args = parser.parse_args()
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.kernels import _build, probes
    from scripts.probe_gpu import (G, H, HBM_BYTES_PER_S, SMEM_BYTES_PER_CLOCK, W,
                                   ceiling_ms, cuda_graph_ms, dyn_slice_bytes,
                                   nvidia_smi_line, sm_clocks_mhz)

    dev = require_cuda()
    smi = nvidia_smi_line()
    print(smi)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    probe_names = args.probes.split(",")

    a32 = torch.rand((1, H, W), generator=gen, device=dev) * 4 - 2

    def build(name: str) -> None:
        _build.CSRC_DIR = variant_dir(name)
        _build._LIBS.pop("probes", None)
        _build.build("probes")

    if "dyn_slice" in probe_names:
        print("dyn_slice: items of strip (float4 columns) x band (rows)")
        onchip_bytes = dyn_slice_bytes(W, probes.QV, probes.N_OFFSETS, probes.STEPS)
        ceiling = ceiling_ms(onchip_bytes, n_sms, sm_clocks_mhz()[1])

        def dyn_row(name: str, ms: float) -> None:
            print(f"{name:>10} {ms:10.4f} ms {onchip_bytes / ms / 1e9:9.3f} TB/s "
                  f"{ceiling / ms:7.1%} of the on-chip ceiling {ceiling:.4f} ms", flush=True)

        want = probes.dyn_slice_reference(a32)
        out = torch.empty_like(a32)
        plan_args = {}

        def items(name: str) -> None:
            strip, band = map(int, name.split("x"))
            plan_args["at"] = probes._dyn_slice_args(H, W, probes.QV, probes.N_OFFSETS, n_sms,
                                                     strip, band)

        def at_items() -> torch.Tensor:
            probes._dyn_slice_kernel(a32, out, probes.STEPS, plan_args["at"])
            return out

        in_turns(args.items.split(","), items, at_items, want, dyn_row, args.min_time)
        print(f"dyn_slice: loads issued ahead of their adds, items "
              f"{probes.DYN_STRIP}x{probes.DYN_BAND}")
        in_turns(args.groups.split(","), build, lambda: probes.dyn_slice(a32), want, dyn_row,
                 args.min_time)
        build("as_built")
        plan = probes.dyn_slice_plan(H, W, probes.QV, probes.offsets(H), n_sms)
        busiest = max(sum(len(plan.rows(i)) for i in range(b0, b1)) * plan.strip
                      for b0, b1 in zip(plan.starts, plan.starts[1:]))
        steps = sorted(map(int, args.steps.split(",")))
        ms = {}
        for n in steps:
            run = functools.partial(probes.dyn_slice, a32, steps=n)
            if not torch.equal(run(), probes.dyn_slice_reference(a32, steps=n)):
                raise AssertionError(f"dyn_slice at {n} steps differs from the plain version")
            ms[n] = cuda_graph_ms(run, args.min_time)
            print(f"{n:>7} steps {ms[n]:10.4f} ms", flush=True)
        if len(steps) > 1:
            # a step's loads on the busiest SM, over the time a step adds
            step_s = (ms[steps[-1]] - ms[steps[0]]) / 1e3 / (steps[-1] - steps[0])
            per_clock = busiest * probes.N_OFFSETS * 16 / step_s / (sm_clocks_mhz()[1] * 1e6)
            print(f"  loop: {per_clock:.1f} B a clock on the busiest SM ({busiest} float4 "
                  f"outputs), {per_clock / SMEM_BYTES_PER_CLOCK:.1%} of "
                  f"{SMEM_BYTES_PER_CLOCK}", flush=True)

    if "hbm_stream" in probe_names:
        print("hbm_stream: ring sizes")
        stream = (torch.rand((G, H, W), generator=gen, device=dev) * 8 - 4).to(torch.bfloat16)
        read = stream.numel() * 2

        def row(name: str, ms: float) -> None:
            print(f"{name:>10} {ms:10.4f} ms {read / ms / 1e6:9.1f} GB/s "
                  f"{read / ms * 1e3 / HBM_BYTES_PER_S:7.1%} of 3.35 TB/s", flush=True)

        def torch_sum() -> None:
            row("torch.sum", cuda_graph_ms(
                lambda: torch.sum(stream, 0, keepdim=True, dtype=torch.float32), args.min_time))

        names = args.rings.split(",")
        torch_sum()
        in_turns(names, build, lambda: probes.hbm_stream(stream),
                 probes.hbm_stream_reference(stream), row, args.min_time)
        torch_sum()
    print(smi)


if __name__ == "__main__":
    main()
