"""Jacobian-trace (divergence) estimators for CNF log-likelihoods.

PyTorch counterpart of the JAX package's ``ops/trace.py`` for the ``exact``
and ``hutchinson`` estimators, on ``torch.func.jvp``:

  * ``exact``      — D forward-mode JVP columns with the basis tangents
    e_d: div = sum_d [J e_d]_d (the RHS acts row-wise, so the batched
    Jacobian is block-diagonal);
  * ``hutchinson`` — e^T J e with a fixed probe, one JVP.

Probes are drawn once per solve and held fixed across every RHS
evaluation; they are explicit arguments, so tests hand the same numpy
probes to both packages.  Hutch++ and XTrace are not ported yet
(ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.func import jvp

__all__ = [
    "rademacher",
    "exact_divergence",
    "hutchinson_divergence",
    "divergence_fn",
    "make_probes",
]

_SKETCH_MODES = ("hutchpp", "xtrace")


def _sketch_not_ported(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"trace_mode={mode!r} is not ported to flowfusion_torch yet "
        "(ROADMAP.md queue 1, item 12: sketch estimators); use 'exact' or "
        "'hutchinson'"
    )


def rademacher(
    generator: Optional[torch.Generator], shape, dtype=torch.float32, device=None
) -> torch.Tensor:
    """sign(N(0,1)) probes, drawn on the generator's device then moved."""
    gen_dev = generator.device if generator is not None else None
    z = torch.randn(shape, generator=generator, dtype=dtype, device=gen_dev)
    return torch.sign(z).to(device if device is not None else z.device)


def exact_divergence(
    f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact divergence via D forward-mode JVP columns."""
    D = x.shape[-1]
    x_dot = None
    div = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for d in range(D):
        tangent = torch.zeros_like(x)
        tangent[..., d] = 1.0
        out, jv = jvp(f, (x,), (tangent,))
        if x_dot is None:
            x_dot = out
        div = div + jv[..., d]
    return x_dot, div


def hutchinson_divergence(
    f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, e: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Skilling--Hutchinson estimate e^T J e with one JVP."""
    x_dot, je = jvp(f, (x,), (e,))
    div = torch.sum(je * e, dim=tuple(range(1, x.ndim)))
    return x_dot, div


def make_probes(
    mode: str, generator: Optional[torch.Generator], x: torch.Tensor
) -> tuple:
    """The probe set an estimator needs, drawn once per solve:
    'exact' -> (); 'hutchinson' -> (e,) Rademacher on ``x``'s device."""
    if mode in _SKETCH_MODES:
        raise _sketch_not_ported(mode)
    if mode not in ("exact", "hutchinson"):
        raise ValueError(f"unknown trace mode {mode!r}")
    if mode == "exact":
        return ()
    if generator is None:
        raise ValueError(
            f"trace mode {mode!r} needs a torch.Generator (or explicit "
            "probes) for its probes"
        )
    return (rademacher(generator, x.shape, x.dtype, x.device),)


def divergence_fn(mode: str):
    """Look up an estimator by name ('exact' | 'hutchinson')."""
    if mode in _SKETCH_MODES:
        raise _sketch_not_ported(mode)
    table = {"exact": exact_divergence, "hutchinson": hutchinson_divergence}
    if mode not in table:
        raise ValueError(f"unknown trace mode {mode!r}; use one of {sorted(table)}")
    return table[mode]
