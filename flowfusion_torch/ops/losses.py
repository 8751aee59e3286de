"""Training losses: denoising score matching, likelihood weighting and flow
matching (counterpart of the JAX package's ``ops/losses.py``).

Draws come from an explicit ``torch.Generator`` on its own device and are
moved to the data's device.  One draw function per family is the single
source of the sampling convention: the losses here and the fused training
engine's table builders (``kernels.fused_train.train_tables*``) both call
it, so with the same generator the two engines train on the same draws.

Reductions as in the JAX package: the two score-matching losses sum the
squared residuals over batch *and* dimensions and divide by the batch size;
the flow-matching loss is a plain mean over batch and dimensions.  Inside
``parallel.data_parallel`` the batch is the global one: the sum runs over
every process of the group and the division is by the global batch
(``_collective.mean_over_group``), so each process holds the global loss.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel import _collective
from .sde import SDE

__all__ = ["denoising_score_matching", "log_prob_score_matching", "flow_matching_loss"]

ScoreFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def _gen_device(generator: Optional[torch.Generator], like: torch.Tensor):
    return generator.device if generator is not None else like.device


def _normal_like(generator: Optional[torch.Generator], x: torch.Tensor) -> torch.Tensor:
    """N(0, 1) draws of ``x``'s shape and dtype, on ``x``'s device."""
    return torch.randn(
        x.shape, generator=generator, dtype=x.dtype, device=_gen_device(generator, x)
    ).to(x.device)


def _uniform_rows(generator: Optional[torch.Generator], x: torch.Tensor) -> torch.Tensor:
    """One float32 U[0, 1) draw per row of ``x``, on ``x``'s device."""
    return torch.rand(
        (x.shape[0],), generator=generator, dtype=torch.float32, device=_gen_device(generator, x)
    ).to(x.device)


def _draw_t_and_z(generator: Optional[torch.Generator], sde: SDE, x: torch.Tensor):
    """Score-matching draw: z ~ N(0, 1) like x, then t ~ U[epsilon, T] per
    row, always float32."""
    z = _normal_like(generator, x)
    t = _uniform_rows(generator, x) * (sde.T - sde.epsilon) + sde.epsilon
    return t, z


def _draw_xT_and_t(generator: Optional[torch.Generator], x0: torch.Tensor):
    """Flow-matching draw: the base sample x_T ~ N(0, 1), then t ~ U[0, 1)
    per row."""
    xT = _normal_like(generator, x0)
    return xT, _uniform_rows(generator, x0)


def _batch_mean(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n``, or inside ``data_parallel`` the sum over the group
    divided by the sum of the counts."""
    group = _collective.active_group()
    if group is None:
        return total / n
    return _collective.mean_over_group(total, n, group)


def denoising_score_matching(
    score_fn: ScoreFn,
    sde: SDE,
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DSM loss (Song+2021): sum ||z + eta_t s(t, mu_t + eta_t z, c)||^2 / B."""
    t, z = _draw_t_and_z(generator, sde, x)
    mean, sigma = sde.marginal_prob(t, x)
    s = score_fn(t, mean + sigma * z, conditional)
    return _batch_mean(torch.sum((z + sigma * s) ** 2), x.shape[0])


def log_prob_score_matching(
    score_fn: ScoreFn,
    sde: SDE,
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Likelihood-weighted score matching (Song+2021b, arXiv:2101.09258):
    sum ||(g/eta) z + g s||^2 / B."""
    t, z = _draw_t_and_z(generator, sde, x)
    g = sde.diffusion(t, x)
    mean, sigma = sde.marginal_prob(t, x)
    s = score_fn(t, mean + sigma * z, conditional)
    return _batch_mean(torch.sum(((g / sigma) * z + g * s) ** 2), x.shape[0])


def flow_matching_loss(
    velocity_fn: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
    generator: Optional[torch.Generator],
    x0: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Conditional flow matching with the linear interpolant
    x_t = (1 - t) x0 + t x_T and target velocity x_T - x0 (Lipman+2023);
    ``x0`` already standardized.  Mean over batch and dims."""
    xT, t = _draw_xT_and_t(generator, x0)
    t_b = t.reshape((x0.shape[0],) + (1,) * (x0.ndim - 1))
    xt = (1.0 - t_b) * x0 + t_b * xT
    v_pred = velocity_fn(t, xt, conditional)
    sq = (v_pred - (xT - x0)) ** 2
    if _collective.active_group() is None:
        return torch.mean(sq)
    return _batch_mean(torch.sum(sq), sq.numel())
