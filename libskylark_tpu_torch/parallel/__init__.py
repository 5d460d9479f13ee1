"""Parallelism layer: process meshes, placements and the explicit
collectives (the port of libskylark_tpu/parallel/)."""

from libskylark_tpu_torch.parallel import multihost, shard_apply
from libskylark_tpu_torch.parallel.mesh import (
    COLS,
    ROWS,
    col_sharded,
    distribute,
    grid2d,
    make_mesh,
    replicated,
    row_sharded,
    square_mesh,
    to_host,
    use_mesh,
    vec_sharded,
)

__all__ = [
    "multihost",
    "shard_apply",
    "COLS",
    "ROWS",
    "col_sharded",
    "distribute",
    "grid2d",
    "make_mesh",
    "replicated",
    "row_sharded",
    "square_mesh",
    "to_host",
    "use_mesh",
    "vec_sharded",
]
