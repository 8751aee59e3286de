r"""DPM-Solver: exponential-integrator sampling for diffusion models.

Counterpart of the JAX package's ``ops/integrate/dpm.py``.  The SDEs here
are semi-linear, so the probability-flow ODE has the exact
variation-of-constants form (Lu et al. 2022, arXiv:2206.00927)

    x_t = (nu_t / nu_s) x_s - nu_t \int_{lam_s}^{lam_t} e^{-lam} eps(x, lam) dlam

with lam the half-log-SNR and eps the noise prediction
(eps = -eta(t) * score).  Discretizing on a uniform-lambda grid gives
samplers whose only error is in the eps integrand.  Orders 1 (DDIM) and 2
(midpoint) are provided; the loop is a Python loop over device tensors,
so a solve never synchronises with the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["dpm_solver_sample", "log_snr_grid"]


def _linspace_f32(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``num`` points from ``start`` to ``stop`` in float32 as
    ``jnp.linspace`` rounds them: start (1 - s) + stop s with
    s = i / (num - 1), and the endpoint appended exactly."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) / float(div)
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def log_snr_grid(sde, t_start: float, t_end: float, steps: int):
    """(lams, ts): the uniform half-log-SNR grid of ``steps`` intervals and
    its times, the endpoints pinned to ``t_start``/``t_end`` (the inverse
    log-SNR round trip carries float32 error, and the first and last
    evaluations must stay inside the trained [epsilon, T] range)."""
    lam0 = sde.log_snr(torch.tensor(t_start, dtype=torch.float32))
    lam1 = sde.log_snr(torch.tensor(t_end, dtype=torch.float32))
    lams = _linspace_f32(lam0, lam1, steps + 1)
    ts = sde.t_of_log_snr(lams)
    ts[0], ts[-1] = t_start, t_end
    return lams, ts


def dpm_solver_sample(
    eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sde,
    x_T: torch.Tensor,
    steps: int = 12,
    order: int = 2,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
) -> torch.Tensor:
    """Integrate the probability-flow ODE from t_start (noise) to t_end.

    ``eps_fn(t_batch, x)`` is the noise prediction at time t (a (B,)
    vector of one time).  ``x_T`` are prior samples *including* the prior
    scale (x(T) ~ N(0, prior_scale^2) for VESDE).  Returns x(t_end).  An
    order-``order`` solve calls ``eps_fn`` ``steps * order`` times.
    """
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    t0 = float(t_start if t_start is not None else sde.T)
    t1 = float(t_end if t_end is not None else sde.epsilon)
    lams, ts = (v.to(x_T.device) for v in log_snr_grid(sde, t0, t1, steps))
    alpha, sigma = sde.marginal_prob_scalars(ts)
    B = x_T.shape[0]

    x = x_T
    for i in range(steps):
        h = lams[i + 1] - lams[i]
        eps_s = eps_fn(ts[i].expand(B), x)
        if order == 2:
            lam_m = 0.5 * (lams[i] + lams[i + 1])
            t_m = sde.t_of_log_snr(lam_m)
            a_m, s_m = sde.marginal_prob_scalars(t_m)
            u = (a_m / alpha[i]) * x - s_m * torch.expm1(0.5 * h) * eps_s
            eps_s = eps_fn(t_m.expand(B), u)
        x = (alpha[i + 1] / alpha[i]) * x - sigma[i + 1] * torch.expm1(h) * eps_s
    return x
