"""Multi-process deployment: process initialization and global batches
(counterpart of the JAX package's ``parallel/distributed.py``).

One process a card, as ``torchrun`` launches them; the process group of
``torch.distributed`` is the axis across processes and hosts:

  * ``initialize_distributed`` — one call per process before any
    collective; wraps ``torch.distributed.init_process_group`` with torch's
    launcher variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) and is a no-op for a single-process run with nothing
    configured, so the same entry script works on one card or many;
  * ``local_rows`` — the (start, stop) row range of this process's part of
    an evenly split global batch;
  * ``global_batch_from_local`` — this process's rows placed on its device,
    the shard that ``sharding.data_parallel`` takes.

Typical use, one process a card::

    rank = initialize_distributed()                # no-op if single process
    mesh = make_mesh([torch.device("cuda", local_rank)])
    start, stop = local_rows(n_global)
    xb = global_batch_from_local(x_global[start:stop], mesh)
    lp = data_parallel(lambda b: model.log_prob(b, probes=...)[0], mesh)(xb)

Nothing in the model or solver code changes: while ``data_parallel`` runs,
the solver's error norm and the losses' batch division are summed over the
group (``_collective``).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from .sharding import Mesh, _map

__all__ = ["initialize_distributed", "global_batch_from_local", "local_rows"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    **kwargs: Any,
) -> int:
    """Initialize the default process group; returns this process's rank.

    ``coordinator_address`` is ``host:port`` (or an ``init_method`` URL);
    unset arguments are read from ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  The backend is ``nccl`` where CUDA is
    available and ``gloo`` otherwise, unless ``backend`` says.  A
    single-process run with nothing configured is a no-op that returns 0
    and touches nothing; a second call returns the rank.  ``kwargs`` go to
    ``init_process_group`` (e.g. ``timeout`` in seconds or a timedelta).
    """
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and not (num_processes and num_processes > 1):
        return 0
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed needs the coordinator address, the number of processes and "
            "this process's id (arguments, or MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK); got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if "timeout" in kwargs and not isinstance(kwargs["timeout"], datetime.timedelta):
        kwargs["timeout"] = datetime.timedelta(seconds=float(kwargs["timeout"]))
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes), rank=int(process_id),
                            **kwargs)
    return dist.get_rank()


def _world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_rows(n_global: int) -> Tuple[int, int]:
    """This process's (start, stop) row range of an evenly split global
    batch.  Divisibility is checked against the global device count: the
    world size, one device a process as ``data_parallel`` takes it."""
    n_dev, rank = _world()
    if n_global % n_dev:
        raise ValueError(
            f"global batch of {n_global} rows does not shard evenly over "
            f"{n_dev} devices; pad first (parallel.pad_to_multiple)"
        )
    per = n_global // n_dev
    return rank * per, (rank + 1) * per


def global_batch_from_local(x_local: Any, mesh: Mesh) -> Any:
    """This process's rows on its device (a mesh of one device): the shard
    ``data_parallel`` takes.  Rank-0 leaves pass through.  No process ever
    holds the whole batch.  Single-process it equals ``shard_batch``'s one
    shard."""
    if len(mesh.devices) != 1:
        raise ValueError(
            f"global_batch_from_local places a process's rows on its one device; this mesh holds "
            f"{len(mesh.devices)} (shard_batch splits rows over several)"
        )
    dev = mesh.devices[0]
    return _map(lambda a: a.to(dev) if a.ndim else a, x_local)
