"""Multi-device and multi-process runs: process groups, the mesh, the sharded step."""

from .mesh import global_mesh, init_distributed, make_mesh, pick_mesh_shape  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedRigSpec,
    ShardedStepConfig,
    make_sharded_step,
    pad_events_for_sharding,
)
