#!/usr/bin/env python3
"""The PyTorch port's sharded step over the cards of one host.

H100 counterpart of scripts/scaling_bench.py: one rank a card, NCCL.  Every
rank builds the headline chunk (`chip_smoke.build_workload`: 2 x 1 Mi
events, 640 x 480 x 100, `hist:g16,seg16,bf,pl`) and runs it through the
sharded step on each (event, plane) mesh of all the cards ((n, 1), (1, n),
and (2, n / 2) when n > 2 is even), against process_1 + get_depth_map on
its own card: fused-DSI relative L1, vote mass and equal depth indices (per
plane block), the launches of kernels A and B from zero, and the seconds a
chunk (median after a warm-up) beside process_1's; then each rank's
programs against the same steps under `mapper.eager()` and the seconds a
chunk of both in turns (`chip_smoke.sharded_programs_phase`, phase 10's
checks).  Then the all-reduce of
one fused-DSI-sized tensor over all ranks, and the CLI's `--num_devices=n`
on the esim fixture against `--num_devices=1`.  Prints one JSON line last.

    python3 scripts/scaling_gpu.py          # every card of the host (>= 2)
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

RUNS = 5


def meshes(world: int, dim_z: int):
    """The meshes of `world` ranks: all events, all planes, and 2 x n/2."""
    shapes = [(world, 1)]
    if dim_z % world == 0:
        shapes.append((1, world))
    if world > 2 and world % 2 == 0 and dim_z % (world // 2) == 0:
        shapes.append((2, world // 2))
    return shapes


def _rank(rank, world, coordinator, out_dir, dev_type, size, spec, runs, needed):
    import torch.distributed as dist

    from dvs_mcemvs_torch.parallel import mesh as meshmod, sharded

    dev = torch.device("cpu") if dev_type == "cpu" else torch.device("cuda", rank)
    meshmod.init_distributed(coordinator, world, rank, dev)
    try:
        workload = cs.build_workload(dev, **size)
        tables = sharded.device_step_tables(workload[0], workload[2], dev)
        ref, dm = cs.run_chunk(workload, spec)
        one, _ = cs.median_seconds(lambda: cs.run_chunk(workload, spec), runs)
        res = {"backend": dist.get_backend(), "process_1_s": one}
        for shape in meshes(world, ref.fused_dsi.shape[0]):
            mesh = meshmod.make_mesh(*shape, device=dev)
            mesh_needs = cs.KERNELS_A_B if shape[1] == 1 else cs.DIST_MESHES[(1, 2)]
            what = f"rank {rank} of {world}, mesh {shape}"
            out, launches, median = cs.timed_sharded(
                dev, what, workload, mesh, cs.make_headline_step(workload, mesh, spec), tables,
                runs, tuple(n for n in mesh_needs if n in needed))
            stats = cs.compare_sharded(what, out, mesh, ref.fused_dsi, dm.depth_indices)
            progs = cs.sharded_programs_phase(dev, what, workload, mesh, tables, spec, runs)
            sharded.clear_programs()
            res[f"{shape[0]}x{shape[1]}"] = dict(launches=launches, seconds=median,
                                                 programs=progs, **stats)
        t = torch.ones_like(ref.fused_dsi)

        def reduce():
            dist.all_reduce(t)
            cs._sync(dev)

        reduce()
        res["all_reduce_s"], _ = cs.median_seconds(reduce, runs)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        meshmod.shutdown_distributed()


def cli_num_devices(dev_type, world, workdir) -> dict:
    """`--num_devices=world` against `--num_devices=1` on the esim fixture
    cut to `cs.CLI_PACKETS` packets a camera: seconds, the fused depth's
    distance to the planes and the extraction's equal depth indices."""
    from dvs_mcemvs_torch import cli
    from dvs_mcemvs_torch.utils import synthetic

    paths = synthetic.write_fixture(os.path.join(workdir, "data"),
                                    rig=synthetic.esim_like_rig(travel=0.4))
    cs.truncate_fixture(paths, cs.CLI_PACKETS)
    base = [f"--flagfile={os.path.join(HERE, 'configs', 'synthetic', 'esim_stereo.conf')}",
            f"--bag_filename_left={paths['events0']}",
            f"--bag_filename_right={paths['events1']}",
            f"--bag_filename_pose={paths['poses']}", f"--platform={dev_type}",
            f"--packet_size={cs.PACKET_CLI}", "--save_dsi", "--nosave_pointcloud",
            "--process_method=1"]
    out = {}
    for n in (1, world):
        t0 = time.perf_counter()
        if cli.main(base + [f"--num_devices={n}", f"--out_path={workdir}/n{n}/"]) != 0:
            raise AssertionError(f"--num_devices={n} failed")
        out[n] = time.perf_counter() - t0
    a, b = (cs.cli_depth_indices(os.path.join(workdir, f"n{n}", "dsi_fused.npy"), base)
            for n in (1, world))
    fused = [f for f in os.listdir(f"{workdir}/n{world}") if f.endswith("_fused.txt")]
    res = dict(seconds_one=out[1], seconds_all=out[world],
               equal=float((a == b).double().mean()),
               distance=cs._plane_distance(os.path.join(workdir, f"n{world}", fused[0])))
    cs.log(f"  cli --num_devices={world}: {res}")
    if res["equal"] < cs.DIST_EQUAL or res["distance"] >= cs.PLANE_DIST_M:
        raise AssertionError(f"cli --num_devices={world} disagrees with one device: {res}")
    return res


def scaling(dev_type="cuda", world=None, size=None, spec=cs.HEADLINE_SPEC, runs=RUNS,
            needed=cs.KERNELS_A_B) -> dict:
    from dvs_mcemvs_torch.parallel.mesh import spawn_ranks

    if world is None:
        world = torch.cuda.device_count()
    if world < 2:
        raise RuntimeError(f"scaling needs two or more devices, found {world}")
    with tempfile.TemporaryDirectory(prefix="scaling_gpu_") as out_dir:
        spawn_ranks(_rank, world, (out_dir, dev_type, size or {}, spec, runs, needed),
                    timeout=900)
        ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(world)]
        cli_res = cli_num_devices(dev_type, world, out_dir)
    return {"world": world, "spec": spec, "ranks": ranks, "cli": cli_res}


def main() -> int:
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.kernels import _build

    require_cuda()
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    _build.build("binning", "resample")
    report = scaling()
    r0 = report["ranks"][0]
    cs.log(f"rank 0 over {r0['backend']}: process_1 {r0['process_1_s']:.6f} s; " + "; ".join(
        f"mesh {k} {v['seconds']:.6f} s (in turns: programs {v['programs']['programs_s']:.6f}, "
        f"eager {v['programs']['eager_s']:.6f})" for k, v in r0.items() if "x" in k)
        + f"; all_reduce {r0['all_reduce_s']:.6f} s; {smi}")
    report["device"] = {"kind": torch.cuda.get_device_name(0),
                        "count": torch.cuda.device_count(), "nvidia_smi": smi}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
