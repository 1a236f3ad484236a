#!/usr/bin/env python3
"""Sharding overhead of the PyTorch port's sharded step, on ranks that share
one card.

Port of scripts/scaling_bench.py.  That script runs a fixed workload on
meshes of virtual CPU devices that share the host's cores; this one runs
the same workload, made from the same seed, on the same meshes of ranks
that share one card (`parallel.mesh.spawn_ranks`, every rank on
`--device`).  The total work is fixed and the one-rank run already has the
whole card, so the ideal sharded time equals the one-rank time and any
slowdown is the overhead that sharding adds: event-shard padding, the
partial-DSI all-reduce, the all-gather of the collapsed maps, and the
launches of every rank.  Two ranks cannot share a card over NCCL, so the
collectives between them are gloo's, staged through the host: the rows
with more than one rank measure that path.  On n cards of their own the
compute term drops by n while the collectives remain, so a row's
`projected_efficiency_floor` bounds n-card efficiency from below, as in
the JAX script.

Protocol (the JAX script's): meshes (1,1), (2,1), (4,1), (8,1) event
shards, (1,8) plane shards and (2,4); the shipped default of
`pick_mesh_shape(8, DIM_Z, backend=BACKEND)` is one of them.  One spawn of
8 ranks runs every row, a row's mesh over ranks 0 .. n-1 (the others wait
at the row's barriers), so the (1,1) row takes the path the others take.
Each rank builds its step as the CLI does (`make_sharded_step`, on its
programs on the card) and its inputs once (`sharded_step_inputs`); each
step re-cuts and stages the same host arrays, as the jit re-transfers its
numpy arguments.  One step captures and settles; then 6 runs of 3 steps,
each run starting after a barrier and ending in a device sync.  Each rank
times itself; a run's time is the max over the row's ranks, and the row
reports the min over the 6 runs and their relative spread.

The spec is the JAX script's `hist:g16,seg8`, so that the two tables
measure the same step.  The JAX script kept the butterfly merge ("bf") and
its Pallas engine out because the Pallas CPU interpreter is not
timing-honest.  On the card the reason is what the rows compare: the
collectives and padding around the binning and the resample are the same
under either merge (the splat is local to a shard), and the flat merge
still runs both kernels, the one-hot engine's binning on kernel A
(`bin_events`, csrc/binning.cu) and the flat merge and the sweep on
kernel B (`banded_resample_sum`, csrc/resample.cu).  Both kernels' launches
are counted from zero on rank 0 of the (1,1) row; the script raises if
either was not launched.

Writes SCALING_TORCH.json at the repository root (`--out` to change it)
and prints the report as one JSON line last.  Runs on the card and raises
without one; `--device cpu` runs the ranks on gloo CPU with the kernels'
plain versions.

    python3 scripts/scaling_bench_torch.py            # one CUDA device
    python3 scripts/scaling_bench_torch.py --device cpu --out /tmp/s.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

WIDTH, HEIGHT, DIM_Z = 320, 240, 64
N_EVENTS = 262_144
PACKET = 512
BACKEND = "hist:g16,seg8"
# The workload's constants, which the spawned ranks take from the caller.
WORKLOAD = ("WIDTH", "HEIGHT", "DIM_Z", "N_EVENTS", "PACKET", "BACKEND")

MESHES = [(1, 1), (2, 1), (4, 1), (8, 1), (1, 8), (2, 4)]
RUNS, STEPS = 6, 3
TARGET = 0.8
# Kernels A and B: the kernels of this spec's path on the card.
KERNELS = ("bin_events", "banded_resample_sum")


def build(device):
    """The JAX script's workload on `device`: (mapper, events, traj,
    T_rv_w).  The events are host arrays made by numpy from the same seed,
    equal to the JAX script's to the bit."""
    from dvs_mcemvs_torch import pipeline
    from dvs_mcemvs_torch.mapper import DsiShape, Events, make_mapper
    from dvs_mcemvs_torch.ops import trajectory as trajmod
    from dvs_mcemvs_torch.ops.camera import PinholeCamera
    from dvs_mcemvs_torch.utils import synthetic

    cam = PinholeCamera(width=WIDTH, height=HEIGHT, fx=WIDTH * 0.9,
                        fy=WIDTH * 0.9, cx=WIDTH / 2, cy=HEIGHT / 2)
    rig = synthetic.SyntheticRig(cam=cam, baseline=0.6, travel=0.3,
                                 plane_depths=(4.0, 12.0))
    mapper = make_mapper(cam, DsiShape(dim_z=DIM_Z, min_depth=2.0, max_depth=40.0))
    rng = np.random.default_rng(3)
    pts = synthetic.make_scene(rig, rng, 20_000)
    ev = synthetic.simulate_events(rig, pts, 0, n_samples=24, rng=rng)
    reps = -(-N_EVENTS // ev.num)
    x = np.tile(ev.x, reps)[:N_EVENTS].astype(np.int32)
    y = np.tile(ev.y, reps)[:N_EVENTS].astype(np.int32)
    t = np.sort(np.tile(ev.t, reps)[:N_EVENTS], kind="stable").astype(np.float32)
    events = Events(x=x, y=y, t=t, p=np.ones_like(x, np.int8))

    ts, q, p = synthetic.rig_poses(rig)
    traj = trajmod.from_arrays(ts, q, p, device=device)
    T_rv_w = pipeline.place_reference_view(traj, 0.5)
    return mapper, events, traj, T_rv_w


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_mesh(mapper, events, traj, T_rv_w, ne, npl, device):
    """The (ne, npl) row, called by every rank of the group (the ranks
    outside the mesh only join its barriers).  Returns (seconds a step:
    min over the runs of the max over the mesh's ranks, relative spread of
    the runs, this rank's last step output or None outside the mesh)."""
    import torch.distributed as dist

    from dvs_mcemvs_torch.parallel import make_mesh, sharded

    mesh = make_mesh(ne, npl, device=device)
    inside = mesh.get_coordinate() is not None
    out = None
    if inside:
        spec = sharded.ShardedRigSpec(
            n_cameras=1, width=mapper.width, height=mapper.height,
            dim_z=mapper.depth_vec.n, z0=float(mapper.depth_vec.depths()[0]),
            vcam_params=(float(mapper.vcam.fx), float(mapper.vcam.fy),
                         float(mapper.vcam.cx), float(mapper.vcam.cy)),
            depth_vec=mapper.depth_vec)
        cfg = sharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET,
                                        backend=BACKEND)
        step = sharded.make_sharded_step(mesh, spec, cfg)
        args = sharded.sharded_step_inputs(
            [mapper], [events], [traj], T_rv_w, ne, PACKET)
        out = step(*sharded.local_inputs(mesh, args))
        _sync(device)  # capture + settle
    runs = []
    for _ in range(RUNS):
        dist.barrier()
        if inside:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                out = step(*sharded.local_inputs(mesh, args))
            _sync(device)
            runs.append((time.perf_counter() - t0) / STEPS)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, runs)
    per_run = [max(r[i] for r in every if r) for i in range(RUNS)]
    if inside:
        sharded.clear_programs()
    return min(per_run), (max(per_run) - min(per_run)) / min(per_run), out


def _rank(rank, world, coordinator, device, workload, meshes, out_dir):
    """One rank of the spawned group: every row of `meshes` in turn; rank 0
    writes the rows (with its kernel launches and its depth indices' share
    equal to the (1,1) row's) to <out_dir>/rows.json and each row's step
    output (its DSI block and the maps) to <out_dir>/<ne>x<npl>.npz."""
    torch.set_num_threads(1)
    globals().update(workload)
    import torch.distributed as dist

    from dvs_mcemvs_torch.kernels import binning, resample
    from dvs_mcemvs_torch.parallel import mesh as meshmod

    dev = torch.device(device)
    counters = {"bin_events": binning.bin_events,
                "banded_resample_sum": resample.banded_resample_sum}
    meshmod.init_distributed(coordinator, world, rank, dev)
    try:
        mapper, events, traj, T_rv_w = build(dev)
        rows, base_idx = [], None
        for ne, npl in meshes:
            for fn in counters.values():
                fn.launches = 0
            dt, spread, out = time_mesh(mapper, events, traj, T_rv_w, ne, npl, dev)
            if rank != 0:
                continue
            out = {k: v.cpu().numpy() for k, v in out.items()}
            if base_idx is None:
                base_idx = out["depth_indices"]
            np.savez(os.path.join(out_dir, f"{ne}x{npl}.npz"), **out)
            rows.append({"mesh": [ne, npl], "seconds_per_step": dt, "run_spread_rel": spread,
                         "backend": dist.get_backend(), "ranks": ne * npl,
                         "launches": {k: fn.launches for k, fn in counters.items()},
                         "equal_to_1x1": float(np.mean(out["depth_indices"] == base_idx))})
        if rank == 0:
            with open(os.path.join(out_dir, "rows.json"), "w") as f:
                json.dump(rows, f)
    finally:
        meshmod.shutdown_distributed()


@contextlib.contextmanager
def _importable():
    """The spawned ranks import this file by its module name: its
    directory on the path they inherit while they start."""
    added = __name__ != "__main__" and HERE not in sys.path
    if added:
        sys.path.insert(0, HERE)
    try:
        yield
    finally:
        if added:
            sys.path.remove(HERE)


def run(meshes=MESHES, device="cuda:0", timeout=900.0) -> list:
    """Every row of `meshes` on one spawn of as many ranks as the largest
    mesh needs, all on `device`.  Returns rank 0's rows (mesh, seconds a
    step, spread, backend, ranks, launches, the share of depth indices
    equal to the first row's), each with rank 0's step output under
    "out"."""
    from dvs_mcemvs_torch.parallel.mesh import spawn_ranks

    world = max(ne * npl for ne, npl in meshes)
    workload = {name: globals()[name] for name in WORKLOAD}
    with tempfile.TemporaryDirectory(prefix="scaling_bench_torch_") as out_dir:
        with _importable():
            spawn_ranks(_rank, world, (str(device), workload, list(meshes), out_dir),
                        timeout=timeout)
        with open(os.path.join(out_dir, "rows.json")) as f:
            rows = json.load(f)
        for row in rows:
            with np.load(os.path.join(out_dir, "{}x{}.npz".format(*row["mesh"]))) as z:
                row["out"] = {k: z[k] for k in z.files}
    return rows


def report(rows, default_mesh, where: str) -> dict:
    """The JAX script's report of `rows` (each with mesh, seconds_per_step,
    run_spread_rel, backend, ranks; the first the (1,1) row), measured on
    `where` (the card's name and power limit)."""
    t_base = rows[0]["seconds_per_step"]
    results = []
    for r in rows:
        dt = r["seconds_per_step"]
        results.append({
            "mesh": list(r["mesh"]),
            "seconds_per_step": dt,
            "run_spread_rel": r["run_spread_rel"],
            "overhead_vs_1dev": dt / t_base - 1.0,
            "projected_efficiency_floor": min(1.0, t_base / dt),
            "is_shipped_default": list(r["mesh"]) == list(default_mesh),
            "backend": r["backend"],
            "ranks": r["ranks"],
        })
    # The multi-host axis is "event" (its only communication is the DSI
    # all-reduce), so the two-host floor is the (2,1) row's.
    two_host = next(r for r in results if r["mesh"] == [2, 1])
    eight_way = next(r for r in results if r["mesh"] == [8, 1])
    return {
        "protocol": "fixed workload, ranks sharing one card: ideal sharded time == "
                    "one-rank time; slowdown == sharding overhead (collectives + padding "
                    "+ launches), the term that bounds multi-card scaling efficiency "
                    "from below; the collectives between ranks that share a card are "
                    "gloo's, staged through the host",
        "workload": {"events": N_EVENTS, "dsi": [DIM_Z, HEIGHT, WIDTH],
                     "backend": BACKEND, "packet": PACKET},
        "host_cores": os.cpu_count(),
        "results": results,
        "target": {"two_host_weak_scaling_efficiency": TARGET},
        "summary": {
            "two_host_efficiency_floor": two_host["projected_efficiency_floor"],
            "eight_shard_efficiency_floor": eight_way["projected_efficiency_floor"],
            "shipped_default_mesh_8dev": list(default_mesh),
            "meets_target": two_host["projected_efficiency_floor"] >= TARGET,
            "caveat": f"measured on {where}, the ranks of a row sharing it; each row is "
                      f"a min over {RUNS} independent {STEPS}-step runs, each run's time "
                      "the max over the row's ranks (per-row run_spread_rel)",
            "note": "multi-host axis is 'event' (DSI all-reduce only); for hist:* "
                    "backends plane shards re-bin the whole event stream, so "
                    "pick_mesh_shape ships event-only meshes for them; scatter keeps "
                    "the plane preference",
        },
    }


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_rows(rows, meshes=MESHES, device="cuda:0") -> None:
    """Raise unless every mesh has a row with a finite positive time and, on
    the card, kernels A and B ran on the (1,1) row."""
    got = [tuple(r["mesh"]) for r in rows]
    if got != [tuple(m) for m in meshes]:
        raise AssertionError(f"rows {got} != meshes {meshes}")
    for r in rows:
        if not (math.isfinite(r["seconds_per_step"]) and r["seconds_per_step"] > 0
                and math.isfinite(r["run_spread_rel"])):
            raise AssertionError(f"row {r['mesh']}: not a finite time")
    base = rows[0]
    missing = [k for k in KERNELS if base["launches"][k] == 0]
    if torch.device(device).type == "cuda" and missing:
        raise AssertionError(f"row (1, 1): kernels not launched: {missing}")


def main(argv=None) -> dict:
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.parallel import pick_mesh_shape

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0",
                    help="the card every rank runs on (default cuda:0), or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "SCALING_TORCH.json"),
                    help="where to write the report")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cpu":
        where = f"the CPU ({os.cpu_count()} host cores)"
    else:
        require_cuda()
        from dvs_mcemvs_torch.kernels import _build

        where = nvidia_smi_line()
        _build.build("binning", "resample")
    # The shipped default decomposition for this backend family must be a
    # measured row, so the report covers what the CLI runs.
    default_mesh = pick_mesh_shape(8, DIM_Z, backend=BACKEND)
    assert tuple(default_mesh) in MESHES, default_mesh
    rows = run(MESHES, args.device)
    check_rows(rows, MESHES, args.device)
    for r in rows:
        print(f"mesh {tuple(r['mesh'])} over {r['ranks']} {r['backend']} rank(s): "
              f"{r['seconds_per_step'] * 1e3:9.3f} ms/step  overhead "
              f"{r['seconds_per_step'] / rows[0]['seconds_per_step'] - 1.0:+.1%}  spread "
              f"{r['run_spread_rel']:.1%}  launches {r['launches']}", file=sys.stderr)
    rep = report(rows, default_mesh, where)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
