"""Rank bodies of the PyTorch port's multi-rank tests, each run in a process
of its own by `parallel.mesh.spawn_ranks` under a deadline (a hung
rendezvous or collective kills the ranks and fails the test; a failed rank
raises with its traceback).  They run gloo CPU ranks with one torch thread
each, and import torch and the port, never JAX.
"""

import os

import numpy as np
import torch


def sharded_steps(rank, world, coordinator, jobs, out_dir):
    """Every job {name: (mesh shape, "step" or "voting", spec, cfg, global
    step arguments)} on its mesh; each rank saves its outputs as
    <out_dir>/<name>.rank<r>.npz."""
    torch.set_num_threads(1)
    from dvs_mcemvs_torch.parallel import mesh as meshmod, sharded

    meshmod.init_distributed(coordinator, world, rank, "cpu")
    try:
        meshes = {}
        for name, (shape, kind, spec, cfg, args) in jobs.items():
            if shape not in meshes:
                meshes[shape] = meshmod.make_mesh(*shape, device="cpu")
            mesh = meshes[shape]
            make = sharded.make_sharded_step if kind == "step" else \
                sharded.make_sharded_voting_step
            out = make(mesh, spec, cfg)(*sharded.local_inputs(mesh, args))
            if kind != "step":
                out = {"dsi": out}
            np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
                     **{k: v.numpy() for k, v in out.items()})
    finally:
        meshmod.shutdown_distributed()
