"""Transparent multi-device routing for the eager model APIs (counterpart
of the JAX package's ``parallel/autoshard.py``).

When an eager model call (CUDA tensors, nothing tracing it) sees more than
one CUDA device in a single process, the batch is padded and split over a
'data' mesh of every visible card, and each card runs the single-device
solve — the fused kernels included — on its own rows.  Per-shard adaptive
solves step independently (finer-grained accept/reject than batch-global
stepping; see ``sharding.data_parallel_per_shard``).  The shards launch at
once, one thread a card, and join at the end; batch outputs come back in
row order on the caller's device, and per-shard outputs (``SolverStats``)
carry a leading n_devices axis.

Per-shard randomness: each shard draws from its own ``torch.Generator``,
seeded from the caller's generator (``train._epoch_generators``' way of
seeding per-epoch generators) — a routed solve draws other probes than an
unrouted one, as the JAX package's ``split(key, n_dev)`` does.  Explicit
probes are batch-shaped and shard with the rows.

Not routed: calls with CPU tensors, on one visible card, inside a process
group of world > 1 (each process holds only its own rows there; pod-scale
work goes through ``distributed`` and ``data_parallel`` explicitly), calls
under ``torch.compile``, ``torch.export``, fake tensors or a ``torch.func``
transform (the serving exports trace these solves: routing would be baked
into the program), calls inside a routed shard or ``data_parallel``, and
calls whose solver options cannot be made hashable.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake

from .sharding import (
    Mesh, _concat, _join, _stack, make_mesh, pad_to_multiple, replicate, routing_off, run_shards, unrouted,
)

__all__ = [
    "should_route",
    "maybe_route",
    "maybe_route_sample",
    "routed_call",
    "routed_sample",
    "hashable_options",
    "UNROUTABLE",
    "n_data_devices",
]

def n_data_devices() -> int:
    """Number of devices an eager routed call shards the batch over."""
    return torch.cuda.device_count()


def _tensors(values) -> list:
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            for item in v.values():
                walk(item)
        elif isinstance(v, (list, tuple)):
            for item in v:
                walk(item)

    for v in values:
        walk(v)
    return out


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _traced(t: torch.Tensor) -> bool:
    return is_fake(t) or torch._C._functorch.is_functorch_wrapped_tensor(t)


def should_route(*values) -> bool:
    """Route an eagerly called batch API over the visible CUDA cards.

    True only when the call's tensors (arguments may be tensors or trees:
    callers pass the model's params too) are all on CUDA, more than one
    CUDA device is visible, no process group of world > 1 is active, and
    nothing is tracing: ``torch.compile``, ``torch.export``, fake tensors,
    ``torch.func`` transforms — and no routed shard or ``data_parallel``
    call encloses this one."""
    # first: under torch.compile this folds to False before anything else
    # is traced
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return False
    if routing_off():
        return False
    tensors = _tensors(values)
    if not tensors or any(_traced(t) for t in tensors) or not all(_on_card(t) for t in tensors):
        return False
    if torch.cuda.device_count() <= 1:
        return False
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return False
    return True


def _shard_generators(generator: Optional[torch.Generator], n: int):
    """One generator a shard, seeded from ``generator`` on its device."""
    if generator is None:
        return [None] * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s) for s in seeds]


def _split(a: Optional[torch.Tensor], n_dev: int, axis: int = 0):
    """``a`` edge-padded to a multiple of ``n_dev`` along ``axis`` and cut
    into ``n_dev`` equal parts (None: ``n_dev`` Nones)."""
    if a is None:
        return [None] * n_dev
    a, _ = pad_to_multiple(a, n_dev, axis)
    return list(torch.chunk(a, n_dev, dim=axis))


def routed_call(
    per_shard: Callable,
    model: Any,
    x: torch.Tensor,
    conditional: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    probes: Optional[Sequence[torch.Tensor]] = None,
    mesh: Optional[Mesh] = None,
):
    """Pad, split and run ``per_shard`` on every 'data' device of ``mesh``
    (default ``make_mesh()``); un-pad the batch outputs.

    ``per_shard(model, x_block, cond_block_or_None, generator_or_None,
    probes_block_or_None) -> (batch_out_tree, per_shard_out_tree)``.
    Probes shard on their batch axis (the second to last: (B, D)
    Hutchinson, (k, B, D) sketch).  Returns ``(batch_out tree sliced to the
    true batch, on x's device; per_shard_out tree with a leading n_devices
    axis)``.
    """
    mesh = mesh if mesh is not None else make_mesh()
    devices = mesh.data_devices
    n_dev, n = len(devices), x.shape[0]
    xs, cs = _split(x, n_dev), _split(conditional, n_dev)
    ps = [None] * n_dev
    if probes is not None:
        parts = [_split(p, n_dev, p.ndim - 2) for p in probes]
        ps = [tuple(part[i] for part in parts) for i in range(n_dev)]
    gens = _shard_generators(generator, n_dev)
    models = replicate(model, Mesh(devices, ("data",)))

    def job(i):
        dev = devices[i]
        to = (lambda a: None if a is None else a.to(dev))
        pb = None if ps[i] is None else tuple(to(p) for p in ps[i])
        return per_shard(models[i], to(xs[i]), to(cs[i]), gens[i], pb)

    outs = run_shards([lambda i=i: job(i) for i in range(n_dev)], devices)
    batch_out = _slice(_concat([o[0] for o in outs], x.device), n)
    return batch_out, _stack([o[1] for o in outs])


def _slice(tree, n):
    """The first ``n`` rows of every tensor of an output tree."""
    return _join([tree], lambda ls: ls[0][:n])


def routed_sample(
    per_shard: Callable,
    model: Any,
    generator: Optional[torch.Generator],
    batch: int,
    conditional: Optional[torch.Tensor],
    mesh: Optional[Mesh] = None,
):
    """Run a sampler per shard: split the requested batch over the mesh's
    'data' devices (rounded up; the surplus rows are sliced off), one
    generator a shard seeded from ``generator``, and slice the outputs
    back to ``batch`` rows on the model's device (the conditional's, or
    the first shard's).

    ``per_shard(model, local_rows, cond_block_or_None, generator) ->
    (batch_out_tree, per_shard_out_tree)``.
    """
    mesh = mesh if mesh is not None else make_mesh()
    devices = mesh.data_devices
    n_dev = len(devices)
    local = -(-batch // n_dev)
    cs = [None] * n_dev
    if conditional is not None:
        cond_p, _ = pad_to_multiple(conditional, n_dev * local)
        cs = list(torch.chunk(cond_p[: n_dev * local], n_dev))
    gens = _shard_generators(generator, n_dev)
    models = replicate(model, Mesh(devices, ("data",)))

    def job(i):
        cb = None if cs[i] is None else cs[i].to(devices[i])
        return per_shard(models[i], local, cb, gens[i])

    outs = run_shards([lambda i=i: job(i) for i in range(n_dev)], devices)
    home = conditional.device if conditional is not None else getattr(model, "device", None) or devices[0]
    batch_out = _slice(_concat([o[0] for o in outs], home), batch)
    return batch_out, _stack([o[1] for o in outs])


def _with(out: tuple, values: dict) -> tuple:
    """``out`` (a tuple or a named tuple) with the positions in ``values``
    replaced by their values."""
    vals = [values.get(i, o) for i, o in enumerate(out)]
    return type(out)(*vals) if hasattr(out, "_fields") else type(out)(vals)


def _split_out(out, stacked: Sequence[int]):
    """A method's output as ``routed_call``'s pair: the output with None at
    the positions in ``stacked`` (the batch tree), and the values there
    (the per-shard tree)."""
    if not stacked:
        return out, ()
    return _with(out, dict.fromkeys(stacked)), tuple(out[i] for i in stacked)


def _join_out(joined, stacked: Sequence[int]):
    """The inverse of :func:`_split_out` on the joined pair."""
    batch, shard = joined
    return _with(batch, dict(zip(stacked, shard))) if stacked else batch


def maybe_route(
    model: Any,
    name: str,
    x: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    probes: Optional[Sequence[torch.Tensor]] = None,
    *,
    stacked: Sequence[int] = (),
    probes_as: Optional[Callable[[tuple], dict]] = None,
    **kwargs,
):
    """``model.<name>(x, conditional, **kwargs)`` run per shard over
    ``make_mesh()``'s 'data' devices (``routed_call``), or None where the
    call is not routed: ``should_route`` is false, or the ``options``
    keyword cannot be made hashable (``UNROUTABLE``; 0-d tensor options
    reach the shards as numbers).

    Each shard's call gets its own generator (``generator=``, where the
    caller gave one) and its block of ``probes`` (``probes=``, or the
    keywords ``probes_as(block)`` returns).  The output's positions in
    ``stacked`` are per-shard values, stacked on a leading n_devices axis
    (``SolverStats``); the others are batch outputs, joined in row order.
    """
    if not should_route(x, conditional, probes, model.params):
        return None
    if "options" in kwargs:
        opts = hashable_options(kwargs["options"])
        if opts is UNROUTABLE:
            return None
        kwargs["options"] = None if opts is None else dict(opts)

    def per_shard(m, xb, cb, gb, pb):
        kw = dict(kwargs)
        if gb is not None:
            kw["generator"] = gb
        if pb is not None:
            kw.update(probes_as(pb) if probes_as is not None else {"probes": pb})
        return _split_out(getattr(m, name)(xb, cb, **kw), stacked)

    return _join_out(routed_call(per_shard, model, x, conditional, generator, probes), stacked)


def maybe_route_sample(
    model: Any,
    name: str,
    shape: Sequence[int],
    conditional: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    *,
    stacked: Sequence[int] = (),
    **kwargs,
):
    """The sampler ``model.<name>(shape, conditional, generator=, **kwargs)``
    run per shard (``routed_sample``: each shard its rows of ``shape[0]``
    and its own generator), or None where ``should_route`` is false.
    ``stacked`` as in :func:`maybe_route`."""
    if not should_route(conditional, model.params):
        return None

    def per_shard(m, local, cb, gb):
        return _split_out(getattr(m, name)((local, *shape[1:]), cb, generator=gb, **kwargs), stacked)

    return _join_out(routed_sample(per_shard, model, generator, shape[0], conditional), stacked)


UNROUTABLE = object()
"""Sentinel: options cannot be made hashable — the caller takes the
unrouted path instead."""


def hashable_options(options: Optional[dict]):
    """Solver options as a hashable statics tuple (sorted items).

    0-d tensor and numpy values become Python scalars; anything else that
    is not hashable (a tensor or array of more than one element, a list)
    gives ``UNROUTABLE``, so routing is skipped rather than raising an
    ``unhashable type`` error only on hosts with several cards."""
    if options is None:
        return None
    items = []
    for k in sorted(options):
        v = options[k]
        try:
            if hasattr(v, "dtype") and hasattr(v, "ndim"):
                if v.ndim != 0:
                    return UNROUTABLE
                v = v.item()
            hash(v)
        except (TypeError, RuntimeError):
            return UNROUTABLE
        items.append((k, v))
    return tuple(items)
