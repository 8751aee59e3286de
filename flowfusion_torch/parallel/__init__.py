"""Parallelism: device meshes, batch sharding, process groups and the
batch-global and per-shard entry points (counterpart of the JAX package's
``parallel/``)."""

from .distributed import (
    global_batch_from_local,
    initialize_distributed,
    local_rows,
)
from .sharding import (
    data_parallel,
    data_parallel_per_shard,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)

__all__ = [
    "data_parallel",
    "data_parallel_per_shard",
    "global_batch_from_local",
    "initialize_distributed",
    "local_rows",
    "make_mesh",
    "pad_to_multiple",
    "replicate",
    "shard_batch",
]
