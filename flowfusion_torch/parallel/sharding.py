"""Device meshes and batch sharding (counterpart of the JAX package's
``parallel/sharding.py``), in PyTorch's own idiom:

  * a mesh's devices are this process's devices (by default every visible
    CUDA device), one 'data' entry each; an explicit list may repeat a
    device or name ``"cpu"`` (eight CPU entries give the tests the JAX
    suite's eight virtual CPU devices);
  * the axis across hosts is the ``torch.distributed`` process group, one
    process a card (``torchrun``), and a batch-global reduction is an
    explicit all-reduce where XLA's partitioner would put a ``psum``
    (``_collective``);
  * ``shard_batch`` splits a batch tree into one tree a 'data' entry, each
    on its device; ``replicate`` copies a tree to every device;
  * ``data_parallel`` runs a function on this process's rows with every
    batch-global reduction summed over the process group — the reference's
    batch-global stepping across processes;
  * ``data_parallel_per_shard`` runs a function on each device's rows with
    no collective and joins the outputs in row order — per-shard stepping,
    the deployment path of the fused kernels on a host with several cards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .._device import strict_fp32_matmul
from ..utils.tree import map_with_path
from . import _collective

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_parallel",
    "data_parallel_per_shard",
    "pad_to_multiple",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered device list and its axes, ('data',) or ('data', 'model');
    the devices run row-major over the axes."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    model_axis: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        n = len(self.devices) // self.model_axis
        return {"data": n, "model": self.model_axis} if len(self.axis_names) == 2 else {"data": n}

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The device of each 'data' entry (the first of its 'model' row)."""
        return self.devices[:: self.model_axis]


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return d


def make_mesh(devices: Optional[Sequence[Any]] = None, model_axis: int = 1) -> Mesh:
    """Mesh over the given devices (default: every visible CUDA device):
    ('data',) or ('data', 'model')."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass the devices, e.g. "
                "make_mesh(['cpu'] * 8) for eight CPU shards"
            )
    devices = tuple(_as_device(d) for d in devices)
    n = len(devices)
    if model_axis < 1:
        raise ValueError(f"model_axis must be >= 1, got {model_axis}")
    if model_axis == 1:
        return Mesh(devices, ("data",))
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
    return Mesh(devices, ("data", "model"), model_axis)


def _map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor of a tree of dicts, lists, tuples and
    dataclasses; everything else is kept as it is."""
    return map_with_path(lambda _, leaf: fn(leaf) if isinstance(leaf, torch.Tensor) else leaf, tree)


def _uneven(n: int, n_data: int) -> ValueError:
    return ValueError(
        f"batch size {n} is not divisible by the mesh's {n_data}-device 'data' axis — "
        "pad with parallel.pad_to_multiple and slice the outputs"
    )


def shard_batch(x: Any, mesh: Mesh) -> List[Any]:
    """Split the batch-major tensors of a tree over the mesh's 'data'
    entries: one tree an entry, its tensors on the entry's device.

    Scalar (rank-0) leaves and non-tensors pass through.  Batch sizes must
    be divisible by the 'data' axis size — the error names
    :func:`pad_to_multiple`."""
    n_data = mesh.shape["data"]

    def rows(a):
        if a.ndim and a.shape[0] % n_data:
            raise _uneven(a.shape[0], n_data)

    _map(rows, x)
    out = []
    for i, dev in enumerate(mesh.data_devices):
        def take(a, i=i, dev=dev):
            if not a.ndim:
                return a
            per = a.shape[0] // n_data
            return a[i * per:(i + 1) * per].to(dev)

        out.append(_map(take, x))
    return out


def replicate(x: Any, mesh: Mesh) -> List[Any]:
    """One copy of a tree (e.g. a model) on each device of the mesh, in the
    mesh's order; non-tensor leaves pass through.  A tensor already on a
    device is that device's copy."""
    return [_map(lambda a, dev=dev: a.to(dev), x) for dev in mesh.devices]


_routing = threading.local()


@contextlib.contextmanager
def unrouted() -> Iterator[None]:
    """Calls on this thread inside the block are not routed over local
    devices (``autoshard.should_route``)."""
    saved = routing_off()
    _routing.off = True
    try:
        yield
    finally:
        _routing.off = saved


def routing_off() -> bool:
    return getattr(_routing, "off", False)


def data_parallel(fn: Callable, mesh: Mesh) -> Callable:
    """``fn(batch)`` on this process's rows, with batch-global semantics
    across the process group.

    ``batch`` is this process's rows (``distributed.global_batch_from_local``
    places them); its tensors are moved to the mesh's device.  While ``fn``
    runs, every reduction that the reference takes over the whole batch is
    summed over the default process group, where one is initialized: the
    adaptive solvers' error norm, the EM NaN freezes, the
    losses' division by the batch (``_collective``).  So every process
    takes the single-process solve's steps on the global batch, and returns
    its own rows of the result.  With no process group, or a world of one,
    it is ``fn`` on the batch.  Calls inside ``fn`` are not routed over
    local devices, as calls under a JAX ``jit`` are not.

    The departure from the JAX package: there one process holds several
    devices and its partitioner spreads one program over all of them.
    Here one process drives one device, and a program over several cards
    is one process a card (``torchrun --nproc-per-node``), its group the
    'data' axis across them — so a mesh with more than one device is
    refused; use ``data_parallel_per_shard`` for per-shard stepping over
    local cards.
    """
    if len(mesh.devices) > 1:
        raise ValueError(
            f"data_parallel takes one device a process; this mesh holds {len(mesh.devices)}. "
            "Run one process a card (torchrun --nproc-per-node=<cards>) with "
            "make_mesh([its device]), or use data_parallel_per_shard for per-shard stepping "
            "over local devices"
        )
    dev = mesh.devices[0]

    def wrapped(batch):
        group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
        with _collective.activate(group), unrouted():
            return fn(_map(lambda a: a.to(dev), batch))

    return wrapped


def _join(outs: List[Any], leaf: Callable[[List[Any]], Any]) -> Any:
    """Per-shard output trees (tensors and numbers in tuples, named
    tuples, lists and dicts) joined leaf by leaf with ``leaf``."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _join([o[k] for o in outs], leaf) for k in first}
    if isinstance(first, (list, tuple)):
        parts = [_join([o[i] for o in outs], leaf) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)
    return leaf(outs)


def _stack(outs: List[Any]) -> Any:
    """Per-shard values stacked on a leading axis (host numbers become a
    CPU tensor; tensors join on the first shard's device)."""
    return _join(outs, lambda ls: torch.stack([o.reshape(()).to(ls[0].device) for o in ls])
                 if isinstance(ls[0], torch.Tensor) else torch.tensor(ls))


def _concat(outs: List[Any], device: torch.device) -> Any:
    """Row-major outputs joined in row order on ``device``."""
    return _join(outs, lambda ls: torch.cat([o.to(device) for o in ls]))


def run_shards(jobs: Sequence[Callable[[], Any]], devices: Sequence[torch.device]) -> List[Any]:
    """``jobs[i]()`` for each shard, its results in shard order: one worker
    thread a distinct CUDA device, so the devices run at once and join at
    the end, the shards of one device in order on its thread; CPU shards
    and a single device run on the calling thread.  The solves inside run
    unrouted with TF32 off (set once around all workers: a worker's own
    ``strict_fp32_matmul`` would restore another's setting)."""
    distinct = list(dict.fromkeys(devices))

    def run(indices):
        with unrouted():
            if devices[indices[0]].type == "cuda":
                with torch.cuda.device(devices[indices[0]]):
                    return [(i, jobs[i]()) for i in indices]
            return [(i, jobs[i]()) for i in indices]

    groups = [[i for i, d in enumerate(devices) if d == dev] for dev in distinct]
    with strict_fp32_matmul():
        if len(distinct) == 1 or any(d.type != "cuda" for d in distinct):
            done = [r for g in groups for r in run(g)]
        else:
            with ThreadPoolExecutor(max_workers=len(groups)) as pool:
                done = [r for f in [pool.submit(run, g) for g in groups] for r in f.result()]
    results = [None] * len(jobs)
    for i, r in done:
        results[i] = r
    return results


def data_parallel_per_shard(fn: Callable, mesh: Mesh, out_specs: Any = "data") -> Callable:
    """``fn(batch)`` on each 'data' entry's rows, with NO cross-shard
    collective.

    Differences from ``data_parallel``, and when to prefer this:
      * adaptive solves step *per shard* rather than batch-globally (each
        device's error norm covers only its rows — finer-grained
        accept/reject than the reference's batch-global semantics, so
        accuracy is kept while easy shards finish sooner);
      * each device runs the fused kernels on its own rows: the deployment
        path of the kernels on a host with several cards (``models``'
        auto-routing takes it for eager calls);
      * ``fn`` returns batch-major tensors, joined in row order on the
        first device; pass ``out_specs`` = "shard" (or a tree of "data" /
        "shard" matching ``fn``'s output) for per-shard values such as
        ``SolverStats``, stacked on a leading n_shards axis.

    Rejects meshes with a 'model' axis > 1: rows are split over 'data'
    only, so every model-axis device would re-run the identical shard.
    """
    if mesh.shape.get("model", 1) > 1:
        raise ValueError(
            "data_parallel_per_shard shards rows over 'data' only; a "
            f"{mesh.shape['model']}-way 'model' axis would redundantly "
            "recompute every shard — pass a 1-D ('data',) mesh"
        )
    devices = mesh.data_devices

    def join(spec, outs):
        if spec == "data":
            return _concat(outs, devices[0])
        if spec == "shard":
            return _stack(outs)
        if isinstance(spec, dict):
            return {k: join(spec[k], [o[k] for o in outs]) for k in spec}
        parts = [join(s, [o[i] for o in outs]) for i, s in enumerate(spec)]
        first = outs[0]
        return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)

    def wrapped(batch):
        shards = shard_batch(batch, mesh)
        outs = run_shards([lambda b=b: fn(b) for b in shards], devices)
        return join(out_specs, outs)

    return wrapped


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0) -> Tuple[torch.Tensor, int]:
    """Pad the batch axis up to a multiple (for even sharding) by repeating
    its last entry; returns (padded, original_length)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    last = x.narrow(axis, n - 1, 1)
    reps = [1] * x.ndim
    reps[axis] = target - n
    return torch.cat([x, last.repeat(*reps)], dim=axis), n
