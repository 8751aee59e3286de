"""Shared plumbing for the model families: the fused-kernel dispatch
policy and the standardization statistics (counterpart of
the JAX package's ``models/_common.py``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = [
    "fused_dispatch", "not_ported", "std_stats", "cond_stats", "norm_cond",
    "std_normal_logpdf", "check_trace_mode", "check_probes", "adjoint_refusal",
]


def not_ported(what: str, item: str) -> NotImplementedError:
    """The refusal of a feature outside the ported slice, naming the
    ROADMAP.md item that will port it."""
    return NotImplementedError(
        f"{what} is not ported to flowfusion_torch yet (ROADMAP.md queue 1, {item})"
    )


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


def adjoint_refusal(trace_mode: str) -> NotImplementedError:
    """The refusal of ``adjoint=True``: the adjoint solver is ROADMAP.md
    item 13; XTrace will refuse it even then, as in the JAX package."""
    what = "adjoint=True"
    if trace_mode == "xtrace":
        what += (
            " with trace_mode='xtrace' (which has no gradient even then: its sketch "
            "is fully detached — use 'exact', 'hutchinson' or 'hutchpp' for "
            "adjoint/training solves)"
        )
    return not_ported(what, "item 13: the adjoint solver")


_ENVELOPE = (
    "the fused kernel's envelope (activation silu/tanh/relu/gelu, at most 17 "
    "hidden layers, and a shared-memory plan that fits D, C, the hidden width "
    "and the trace mode: kernels.fused_mlp.fusable_config/supports_features; "
    "for 'hutchpp'/'xtrace' also D <= 8 and the probe counts: "
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
