"""Process groups and the ("event", "plane") device mesh on torch.distributed.

Port of dvs_mcemvs_tpu/parallel/mesh.py.  The JAX package runs one process
per host over a mesh of its devices; the port runs one rank per device, as
PyTorch does, and the same 2D logical mesh maps onto the ranks in row-major
order:

  - axis "event": data parallelism over the event stream.  Voting is a sum
    over events, so each rank votes a partial DSI for its slice of the
    stream and an `all_reduce` over this axis rebuilds the grid;
  - axis "plane": depth planes split into z-blocks, one a rank.  Voting
    needs no communication there; the collapsed 2D (confidence, index) maps
    are `all_gather`ed for the global depth decision.

The backend follows the layout, and is chosen before the first collective:
gloo on the CPU, NCCL where each rank owns a card, and gloo on CUDA tensors
(staged through the host) where ranks share a card.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import require_cuda

log = logging.getLogger(__name__)

EVENT_AXIS = "event"
PLANE_AXIS = "plane"

# How long the ranks wait for each other at the rendezvous (the JAX
# package's `jax.distributed.initialize` default).
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


def _plane_sharding_helps(backend: Optional[str]) -> bool:
    """Whether the splat backend gains from plane shards: the hist backends
    bin the whole event stream before resampling it onto each plane, so a
    plane shard repeats the binning; the scatter family splats per plane,
    so its plane shards cost no extra work."""
    return backend is not None and backend.partition(":")[0] not in (
        "hist", "hist_exact")


def pick_mesh_shape(
    n_devices: int, dim_z: int, max_plane_shards: int = 8,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """(n_event, n_plane) factorization of `n_devices`, backend-aware: every
    device on "event" for the hist backends; otherwise plane shards up to
    `max_plane_shards` that divide `dim_z` (and `n_devices`), the rest on
    "event"."""
    if backend is not None and not _plane_sharding_helps(backend):
        return n_devices, 1
    n_plane = 1
    for cand in range(min(max_plane_shards, n_devices), 0, -1):
        if n_devices % cand == 0 and dim_z % cand == 0:
            n_plane = cand
            break
    return n_devices // n_plane, n_plane


def global_mesh_shape(
    n_devices: int, process_count: int, dim_z: int, max_plane_shards: int = 8,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """(n_event, n_plane) of a multi-process run over `n_devices` devices in
    `process_count` processes: like `pick_mesh_shape`, with the "event" axis
    divisible by the process count and no "plane" group crossing a process,
    so each process owns whole event-shard rows and feeds them from its own
    memory.  With one rank a process (the port's layout) that is
    (n_devices, 1)."""
    local = n_devices // process_count
    n_plane = 1
    if backend is None or _plane_sharding_helps(backend):
        for cand in range(min(max_plane_shards, local), 0, -1):
            if (n_devices % cand == 0 and dim_z % cand == 0
                    and local % cand == 0
                    and (n_devices // cand) % process_count == 0):
                n_plane = cand
                break
    return n_devices // n_plane, n_plane


def _device_type(device) -> str:
    """'cpu' when `device` names the CPU; else 'cuda', raising without a card."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    require_cuda()
    return "cuda"


def make_mesh(n_event: int, n_plane: int, device=None) -> DeviceMesh:
    """The ("event", "plane") mesh over ranks 0 .. n_event*n_plane - 1 of the
    initialized process group, row-major (rank = e * n_plane + p).  On the
    card unless `device` is the CPU; every rank of the group calls it."""
    dev_type = _device_type(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    need = n_event * n_plane
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} ranks, have {have}")
    ranks = torch.arange(need, dtype=torch.int).reshape(n_event, n_plane)
    return DeviceMesh(dev_type, ranks, mesh_dim_names=(EVENT_AXIS, PLANE_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on for `mesh`."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _env(name: str):
    value = os.environ.get(name)
    return None if value is None or value == "" else value


def _pick_backend(store: dist.Store, rank: int, world: int, device: torch.device) -> str:
    """gloo on the CPU; on the card NCCL when every rank owns its card, else
    gloo.  Each rank posts its host and card index to the store and reads
    every other rank's, so the choice is the same on all ranks."""
    if device.type == "cpu":
        return "gloo"
    store.set(f"card/{rank}", f"{socket.gethostname()}/{device.index}")
    cards = {store.get(f"card/{r}") for r in range(world)}
    return "nccl" if len(cards) == world else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> Tuple[int, int]:
    """Join this process to the run's process group as rank `process_id` of
    `num_processes`, rendezvousing at `coordinator_address` ("host:port",
    where rank 0 listens).  Values left None come from the environment a
    launcher such as torchrun sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK); one missing there too raises.  The rank computes on `device`:
    by default the card at index `process_id` modulo the cards present
    (raising without one), "cpu" for the CPU.  Safe to call twice.  Returns
    (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and _env("MASTER_ADDR"):
        coordinator_address = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT') or ''}"
    if num_processes is None and _env("WORLD_SIZE"):
        num_processes = int(_env("WORLD_SIZE"))
    if process_id is None and _env("RANK"):
        process_id = int(_env("RANK"))
    missing = [name for name, v in (("coordinator address (MASTER_ADDR)", coordinator_address),
                                    ("process count (WORLD_SIZE)", num_processes),
                                    ("process id (RANK)", process_id)) if v is None]
    if missing:
        raise ValueError(f"init_distributed: no {', no '.join(missing)}")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got {coordinator_address!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    if device is None:
        require_cuda()
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=RENDEZVOUS_TIMEOUT)
    backend = _pick_backend(store, process_id, num_processes, device)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes)
    log.info("rank %d of %d on %s, backend %s", process_id, num_processes, device, backend)
    return process_id, num_processes


def free_port() -> int:
    """A TCP port free on this host now (for a local rendezvous)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(fn: Callable, world: int, args: Sequence = (),
                timeout: Optional[float] = None) -> None:
    """fn(rank, world, coordinator, *args) in `world` spawned processes on
    this host, rendezvousing at a free local port.  A rank that raises ends
    the others and raises here with its traceback; past `timeout` seconds
    (None: none) every rank is killed and TimeoutError raised."""
    import torch.multiprocessing as tmp

    coordinator = f"127.0.0.1:{free_port()}"
    ctx = tmp.start_processes(fn, args=(world, coordinator, *args), nprocs=world,
                              join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=30)


def shutdown_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(dim_z: int, max_plane_shards: int = 8, backend: Optional[str] = None,
                device=None) -> DeviceMesh:
    """The mesh over every rank of a multi-process run (`global_mesh_shape`
    with one rank a process); on the card unless `device` is the CPU."""
    world = dist.get_world_size()
    return make_mesh(*global_mesh_shape(world, world, dim_z, max_plane_shards, backend),
                     device)
