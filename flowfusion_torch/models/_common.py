"""Shared plumbing for the model families: the fused-kernel dispatch
policy, the standardization statistics and the adjoint solves' inputs
(counterpart of the JAX package's ``models/_common.py``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch

__all__ = [
    "auto_fused", "fused_dispatch", "std_stats", "cond_stats", "norm_cond", "std_normal_logpdf",
    "check_trace_mode", "check_probes", "adjoint_refusal", "adjoint_inputs",
    "check_per_sample_mode", "per_shard_variant", "logprob_per_sample_per_shard", "group_params",
]


TRACE_MODES = ("exact", "hutchinson", "hutchpp", "xtrace")
_N_PROBES = {"exact": 0, "hutchinson": 1, "hutchpp": 2, "xtrace": 1}


def check_trace_mode(trace_mode: str) -> None:
    if trace_mode not in TRACE_MODES:
        raise ValueError(f"unknown trace mode {trace_mode!r}; use one of {TRACE_MODES}")


def check_probes(trace_mode: str, probes) -> tuple:
    """``probes`` as a tuple, raising unless it holds the tensors the trace
    mode takes: () exact, (e,) hutchinson, (S, G) hutchpp, (O,) xtrace."""
    probes = tuple(probes)
    n = _N_PROBES[trace_mode]
    if len(probes) != n:
        raise ValueError(
            f"trace_mode {trace_mode!r} takes {n} probe tensor(s); got {len(probes)}"
        )
    return probes


def adjoint_refusal() -> NotImplementedError:
    """The refusal of ``adjoint=True`` with XTrace, as in the JAX package."""
    return NotImplementedError(
        "trace_mode='xtrace' has no gradient (its sketch is fully detached, "
        "see ops.trace.xtrace_divergence) — use 'exact', 'hutchinson', or "
        "'hutchpp' for adjoint/training solves"
    )


def check_per_sample_mode(trace_mode: str) -> None:
    """Per-sample stepping takes the row-wise estimators only, as in the
    JAX package."""
    if trace_mode not in ("exact", "hutchinson"):
        raise NotImplementedError(
            "per-sample stepping supports trace_mode 'exact' and "
            "'hutchinson' (sketch-based estimators are batch-coupled)"
        )


def _param_leaves(params) -> Tuple[List[torch.Tensor], Callable]:
    """The tensors of a params tree (dict keys sorted, list items in
    order) and the function that rebuilds the tree from new tensors."""
    leaves: List[torch.Tensor] = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            for v in node:
                walk(v)

    def rebuild(new):
        it = iter(new)

        def build(node):
            if isinstance(node, torch.Tensor):
                return next(it)
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            return type(node)(build(v) for v in node)

        return build(params)

    walk(params)
    return leaves, rebuild


def adjoint_inputs(model, conditional: Optional[torch.Tensor]):
    """``(tensors, rebuild)`` for ``odeint_adjoint``: the model's parameter
    leaves, then its other tensor fields and the conditional where they
    require grad (the JAX package hoists what it differentiates with
    ``closure_convert``; an autograd Function must be passed it).
    ``rebuild(p)`` gives ``(model, conditional)`` with those tensors in
    place."""
    leaves, rebuild_params = _param_leaves(model.params)
    fields = [
        f.name for f in dataclasses.fields(model)
        if f.name != "params" and isinstance(getattr(model, f.name), torch.Tensor)
        and getattr(model, f.name).requires_grad
    ]
    cond_in = conditional is not None and conditional.requires_grad
    tensors = leaves + [getattr(model, n) for n in fields] + ([conditional] if cond_in else [])
    n = len(leaves)

    def rebuild(p):
        m = dataclasses.replace(
            model, params=rebuild_params(p[:n]), **dict(zip(fields, p[n:n + len(fields)]))
        )
        return m, (p[-1] if cond_in else conditional)

    return tensors, rebuild


_ENVELOPE = (
    "the fused kernel's envelope (activation silu/tanh/relu/gelu, any depth, "
    "and a shared-memory plan that fits D, C, the hidden width and the trace "
    "mode: kernels.fused_mlp.fusable_config/supports_features; "
    "for 'hutchpp'/'xtrace' also D <= 64 and the probe counts: "
    "kernels.fused_sketch.supports_sketch)"
)


def fused_dispatch(use_fused_kernel: Optional[bool], supported: bool, on_cuda: bool) -> bool:
    """Whether a solve runs its RHS through the fused kernel wrapper.

    Auto (None) takes the kernel when the solve's tensors are on CUDA and
    the plain torch path on the CPU; on CUDA a config outside the kernel's
    envelope raises instead of giving way to the plain path.  True with CPU
    tensors runs the wrapper's plain version (as the JAX package's
    interpret mode does), and an explicit True outside the envelope raises.
    False gives the plain torch path on any device.
    """
    if use_fused_kernel is None:
        if on_cuda and not supported:
            raise ValueError(
                f"the solve's tensors are on CUDA but the config is outside {_ENVELOPE}; "
                "pass use_fused_kernel=False to run the plain PyTorch path on the card, "
                "or switch trace_mode to 'hutchinson'"
            )
        return on_cuda
    if use_fused_kernel and not supported:
        raise ValueError(
            f"use_fused_kernel=True but this solve is outside {_ENVELOPE}; fix the "
            "config, switch trace_mode to 'hutchinson', or drop the flag"
        )
    return bool(use_fused_kernel)


def auto_fused(use_fused_kernel: Optional[bool], supported: bool, on_cuda: bool = False) -> bool:
    """The JAX package's name for :func:`fused_dispatch`, the same rule:
    an explicit True or False wins (True raises outside the envelope), and
    auto (None) takes the kernel where the solve's tensors are on CUDA
    (``on_cuda``), as the JAX rule takes it on a single-device TPU."""
    return fused_dispatch(use_fused_kernel, supported, on_cuda)


def per_shard_variant(model, supported: bool):
    """The model a device runs under per-shard routing
    (``parallel.autoshard``) — one rule for the three families.

    The JAX package forces its fused kernel per shard on the TPU, where its
    auto policy counts the devices of the realm, not of the shard.  Here
    the rule is: on CUDA, with ``use_fused_kernel=None`` and a supported
    config, set it to True — which is what ``fused_dispatch`` already takes
    for CUDA tensors, so the routed calls (``autoshard.maybe_route``) run
    each shard's model as it is, and a shard runs the kernel exactly as a
    direct call on its rows does.  Off CUDA, or outside the envelope, the
    auto policy stands.  ``supported`` is the family's own envelope answer
    for the solve at hand."""
    dev = model.device
    if model.use_fused_kernel is None and dev is not None and dev.type == "cuda" and supported:
        return dataclasses.replace(model, use_fused_kernel=True)
    return model


def logprob_per_sample_per_shard(atol, rtol, method, opts):
    """The per-shard ``log_prob_per_sample`` body of ``autoshard.routed_call``
    (ScoreModel and ODEFlow, whose per-sample solves share the
    ``(x, conditional, generator=, probes=)`` signature): both outputs are
    row-shaped, so they ride in the batch tree.  ``opts`` is the options
    dict or ``hashable_options``' tuple.  The models route through
    ``autoshard.maybe_route``, which builds the same body."""

    def per_shard(model, xb, cb, gb, pb):
        lp, stats = model.log_prob_per_sample(
            xb, cb, generator=gb, probes=pb, atol=atol, rtol=rtol, method=method,
            options=dict(opts) if opts is not None else None,
        )
        return (lp, stats), ()

    return per_shard


def group_params(model):
    """``model`` with its parameters entering the graph through
    ``_collective.replicated`` inside ``parallel.data_parallel`` (their
    gradients summed over the process group, so every process holds the
    global batch's gradient); ``model`` itself outside it."""
    from ..parallel import _collective

    group = _collective.active_group()
    if group is None:
        return model
    return dataclasses.replace(model, params=_collective.replicated(model.params, group))


_LOG_2PI = math.log(2.0 * math.pi)


def std_normal_logpdf(x: torch.Tensor) -> torch.Tensor:
    """Elementwise log N(x | 0, 1)."""
    return -0.5 * x**2 - 0.5 * _LOG_2PI


def _as_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def std_stats(dim: int, shift, scale, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standardization buffers with reference defaults (shift 0, scale 1)."""
    return (
        _as_f32(shift, device) if shift is not None else torch.zeros(dim, device=device),
        _as_f32(scale, device) if scale is not None else torch.ones(dim, device=device),
    )


def cond_stats(n_conditionals: int, shift, scale, device):
    """Conditional standardization buffers; (None, None) when unconditional."""
    if not n_conditionals:
        if shift is not None or scale is not None:
            raise ValueError(
                "conditional shift/scale supplied but n_conditionals=0 — did "
                "you forget to set the conditional dimension?"
            )
        return None, None
    return std_stats(n_conditionals, shift, scale, device)


def norm_cond(conditional, shift, scale):
    """Standardize a conditional batch; passes None through."""
    if conditional is None:
        return None
    if shift is None or scale is None:
        raise ValueError(
            "a conditional was passed but this model has no conditional "
            "statistics (built with n_conditionals=0?)"
        )
    return (conditional - shift) / scale
