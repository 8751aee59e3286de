"""The process group that ``parallel.data_parallel`` activates, and the
batch-global reductions of the solve and loss paths over it.

The JAX package keeps the reference's batch-global semantics under
``data_parallel`` because XLA's partitioner lowers every reduction over the
batch to a ``psum``.  Here each of those reductions asks :func:`active_group`
and, where a group of world > 1 is active on this thread, sums its parts
over the group with an explicit all-reduce:

  * the adaptive solvers' mixed-RMS error norm (``ops.integrate.adaptive``):
    the squares and the element counts of each state component;
  * the Euler--Maruyama and predictor--corrector NaN freezes and the fused
    EM sampler's divergence flag: any non-finite row anywhere;
  * ``sample_pc``'s batch-mean norms: the sum of the row norms and the rows;
  * the training losses' division by the batch (``ops.losses``): the loss
    summed over the group and divided by the global batch
    (:func:`mean_over_group`), and the models' parameters enter the loss
    through :func:`replicated`, so every rank's gradients are those of the
    global batch.

Each reduction is one all-reduce of one tensor on the device of the
values it reduces, the counts beside the sums: an NCCL group reduces CUDA
tensors only.

With no group active every caller computes its single-process expression,
bit for bit.

Gloo collectives are run on host copies of CUDA tensors: gloo's CUDA path
is not taken at all (a two-rank gloo group on one card is how the
batch-global path is checked on a machine with one card; each of these
reductions is a few scalars, and the solve reads its error ratio back to
the host an attempt anyway).  NCCL reduces CUDA tensors in place.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "active_group", "activate", "all_reduce", "any_over_group", "mean_over_group", "replicated", "mean_squares",
]

_state = threading.local()


def active_group() -> Optional[Any]:
    """The process group of world > 1 that ``data_parallel`` activated on
    this thread, or None."""
    return getattr(_state, "group", None)


@contextlib.contextmanager
def activate(group: Any) -> Iterator[None]:
    """Make ``group`` the batch-global reductions' group on this thread
    inside the block (None, or a group of world 1, leaves them local)."""
    if group is not None and dist.get_world_size(group) <= 1:
        group = None
    saved = active_group()
    _state.group = group
    try:
        yield
    finally:
        _state.group = saved


def all_reduce(t: torch.Tensor, group: Any, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group``, a new tensor on ``t``'s device."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        # gloo: through a host copy (see the module's docstring)
        host = t.detach().cpu().clone()
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def any_over_group(flag: torch.Tensor, group: Any) -> torch.Tensor:
    """A 0-d bool tensor: ``flag`` is true on some rank of ``group``."""
    return all_reduce(flag.to(torch.int32).reshape(1), group, dist.ReduceOp.MAX)[0].to(torch.bool)


def mean_squares(leaves: Sequence[torch.Tensor], group: Any) -> List[Optional[torch.Tensor]]:
    """The mean of the squares of each leaf over all its elements on every
    rank of ``group`` (one all-reduce for all leaves, float64 sums), float32
    0-d tensors; None for a leaf with no element on any rank."""
    dev = leaves[0].device
    sums = torch.stack([torch.sum(torch.square(l.to(torch.float64))) for l in leaves])
    counts = torch.tensor([float(l.numel()) for l in leaves], dtype=torch.float64, device=dev)
    both = all_reduce(torch.cat([sums, counts]), group)
    n = len(leaves)
    counts = both[n:].tolist()
    return [(both[i] / counts[i]).to(torch.float32) if counts[i] > 0 else None for i in range(n)]


class _MeanOverGroup(torch.autograd.Function):
    """Forward: the sum of ``total`` over the group divided by the sum of
    the counts ``n``, one all-reduce of both (float64, on ``total``'s
    device).  Backward: the output's gradient over the global count, as
    each rank's term enters the sum once (torch's own
    ``torch.distributed.nn.functional.all_reduce`` sums the gradient over
    the group as well, which counts the loss once a rank)."""

    @staticmethod
    def forward(ctx, total, n, group):
        both = torch.stack([total.detach().to(torch.float64).reshape(()),
                            torch.full((), float(n), dtype=torch.float64, device=total.device)])
        both = all_reduce(both, group)
        ctx.count = both[1]
        return (both[0] / both[1]).to(total.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.count.to(grad.dtype), None, None


class _Replicated(torch.autograd.Function):
    """Forward: the tensor itself.  Backward: the gradient summed over the
    group, as a replicated parameter's gradient is under the JAX package's
    partitioner (the transpose of the sum in :class:`_MeanOverGroup`)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def mean_over_group(total: torch.Tensor, n: int, group: Any) -> torch.Tensor:
    """The 0-d ``total`` summed over ``group`` over the sum of the counts
    ``n``; differentiable (the gradient of the global mean in this rank's
    term is the output's gradient over the global count)."""
    return _MeanOverGroup.apply(total, n, group)


def replicated(tree: Any, group: Any) -> Any:
    """A params tree (dicts and lists of tensors) whose tensors that
    require grad enter the graph through :class:`_Replicated`: their
    gradients are summed over ``group`` in the backward pass."""
    if isinstance(tree, torch.Tensor):
        return _Replicated.apply(tree, group) if tree.requires_grad else tree
    if isinstance(tree, dict):
        return {k: replicated(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicated(v, group) for v in tree)
    return tree
