"""Stochastic differential equations for score-based generative models.

PyTorch counterpart of the JAX package's ``ops/sde.py``: VESDE, VPSDE and
SUBVPSDE as frozen dataclasses of floats whose methods are functions of
``(t, x)`` on tensors.  Scalars of ``t`` stay float32 and stay on the
device of ``t``, so a solver can keep its time on the card.

Conventions (identical to the JAX package):
  * t = 0 is data, t = T is noise/base.
  * ``marginal_prob_scalars(t) -> (nu, eta)`` with
    p[x(t)|x(0)] = N(nu(t) x(0), eta(t)^2).
  * ``prior_log_prob`` returns the per-dimension log density of the base
    distribution (callers sum over trailing dims).
  * ``log_snr(t) = log(nu / eta)`` is the DPM-Solver half-log-SNR and
    ``t_of_log_snr`` its inverse, in closed form for each family.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = ["SDE", "VESDE", "VPSDE", "SUBVPSDE"]

_LOG_2PI = math.log(2.0 * math.pi)


def _f32(t) -> torch.Tensor:
    """``t`` as a float32 tensor, on its own device when it has one."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32)
    return torch.as_tensor(t, dtype=torch.float32)


def _bcast_right(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-batch scalar ``a`` of shape (B,) against x (B, ...)."""
    if a.ndim == 0:
        return a
    return a.reshape(a.shape + (1,) * (x.ndim - a.ndim))


@dataclasses.dataclass(frozen=True)
class SDE:
    """Base class: the shared API surface."""

    T: float = 1.0
    epsilon: float = 1e-3

    def marginal_prob_scalars(self, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """(nu(t), eta(t)): mean coefficient and std of p[x(t)|x(0)]."""
        raise NotImplementedError

    def sigma(self, t) -> torch.Tensor:
        """Marginal standard deviation eta(t)."""
        return self.marginal_prob_scalars(t)[1]

    def marginal_prob(self, t, x: torch.Tensor):
        """Mean and std of p[x(t)|x(0)], broadcast against ``x``."""
        nu, eta = self.marginal_prob_scalars(t)
        return _bcast_right(nu, x) * x, _bcast_right(eta, x) * torch.ones_like(x)

    def sample_marginal(self, generator: Optional[torch.Generator], t, x0: torch.Tensor) -> torch.Tensor:
        """Draw x(t) ~ p[x(t)|x(0)] = nu x0 + eta z, z ~ N(0, I) drawn from
        ``generator`` on its own device."""
        gen_dev = generator.device if generator is not None else x0.device
        z = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=gen_dev).to(x0.device)
        nu, eta = self.marginal_prob_scalars(t)
        return _bcast_right(nu, x0) * x0 + _bcast_right(eta, x0) * z

    def drift(self, t, x: torch.Tensor) -> torch.Tensor:
        """Forward-SDE drift f(x, t) = a(t) x."""
        return _bcast_right(self.drift_coefficient(t), x) * x

    def diffusion(self, t, x: torch.Tensor) -> torch.Tensor:
        """Forward-SDE diffusion g(t), broadcast to ``x``'s shape."""
        g = torch.sqrt(self.diffusion_squared_scalar(t))
        return _bcast_right(g, x) * torch.ones_like(x)

    def drift_coefficient(self, t) -> torch.Tensor:
        """Scalar a(t) with drift(t, x) = a(t) x (all three families are
        affine, which lets the fused kernel fold the SDE into two scalars)."""
        raise NotImplementedError

    def diffusion_squared_scalar(self, t) -> torch.Tensor:
        """Scalar g(t)^2 (the diffusion is state-independent)."""
        raise NotImplementedError

    @property
    def prior_scale(self) -> float:
        """Std of the N(0, s^2) base distribution."""
        return 1.0

    def log_snr(self, t) -> torch.Tensor:
        """lambda(t) = log(nu(t) / eta(t)), the DPM-Solver half-log-SNR."""
        nu, eta = self.marginal_prob_scalars(t)
        return torch.log(nu) - torch.log(eta)

    def t_of_log_snr(self, lam) -> torch.Tensor:
        """Inverse of ``log_snr`` (defined per family)."""
        raise NotImplementedError

    def prior_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise log N(x | 0, prior_scale^2)."""
        s = self.prior_scale
        return -0.5 * (x / s) ** 2 - math.log(s) - 0.5 * _LOG_2PI

    def prior_sample(
        self, generator: Optional[torch.Generator], shape, device=None
    ) -> torch.Tensor:
        """N(0, prior_scale^2) float32 draws from ``generator`` on its own
        device, moved to ``device`` (default: the generator's device)."""
        gen_dev = generator.device if generator is not None else None
        z = torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=gen_dev)
        return (z * self.prior_scale).to(device if device is not None else z.device)


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
    """Variance-exploding SDE: sigma(t) = sigma_min (sigma_max/sigma_min)^(t/T);
    f = 0; g(t) = sigma(t) sqrt(2 log(sigma_max/sigma_min) / T);
    prior N(0, sigma_max^2)."""

    sigma_min: float = 1e-2
    sigma_max: float = 10.0
    T: float = 1.0
    epsilon: float = 1e-5

    def _log_ratio_rate(self) -> float:
        return 2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)) / self.T

    def sigma(self, t) -> torch.Tensor:
        t = _f32(t)
        return self.sigma_min * torch.pow(self.sigma_max / self.sigma_min, t / self.T)

    def drift(self, t, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)

    def diffusion(self, t, x: torch.Tensor) -> torch.Tensor:
        g = self.sigma(t) * math.sqrt(self._log_ratio_rate())
        return _bcast_right(g, x) * torch.ones_like(x)

    def drift_coefficient(self, t) -> torch.Tensor:
        return torch.zeros_like(_f32(t))

    def diffusion_squared_scalar(self, t) -> torch.Tensor:
        return self.sigma(t) ** 2 * self._log_ratio_rate()

    def marginal_prob_scalars(self, t):
        t = _f32(t)
        return torch.ones_like(t), self.sigma(t)

    def t_of_log_snr(self, lam) -> torch.Tensor:
        # lambda = -log sigma(t)  =>  t = T log(e^-lam / sigma_min) / log(r)
        sigma = torch.exp(-_f32(lam))
        return self.T * torch.log(sigma / self.sigma_min) / math.log(self.sigma_max / self.sigma_min)

    @property
    def prior_scale(self) -> float:
        return self.sigma_max


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE):
    """Variance-preserving SDE: beta(t) = beta_min + (beta_max - beta_min) t/T;
    f = -beta(t) x / 2; g = sqrt(beta(t)); nu = exp(-B(t)/2),
    eta = sqrt(1 - exp(-B(t))) with B(t) = int_0^t beta; prior N(0, 1)."""

    beta_min: float = 0.1
    beta_max: float = 20.0
    T: float = 1.0
    epsilon: float = 1e-3

    def beta(self, t) -> torch.Tensor:
        """Linear noise schedule beta(t)."""
        t = _f32(t)
        return self.beta_min + (self.beta_max - self.beta_min) * (t / self.T)

    def _int_beta(self, t) -> torch.Tensor:
        t = _f32(t)
        return 0.5 * (self.beta_max - self.beta_min) * t**2 / self.T + self.beta_min * t

    def drift(self, t, x: torch.Tensor) -> torch.Tensor:
        return -0.5 * _bcast_right(self.beta(t), x) * x

    def diffusion(self, t, x: torch.Tensor) -> torch.Tensor:
        return _bcast_right(torch.sqrt(self.beta(t)), x) * torch.ones_like(x)

    def drift_coefficient(self, t) -> torch.Tensor:
        return -0.5 * self.beta(t)

    def diffusion_squared_scalar(self, t) -> torch.Tensor:
        return self.beta(t)

    def marginal_prob_scalars(self, t):
        log_coeff = self._int_beta(t)
        # -expm1 instead of 1 - exp: equal in exact math, far more
        # accurate in float32 for small t.
        std = torch.sqrt(-torch.expm1(-log_coeff))
        return torch.exp(-0.5 * log_coeff), std

    def _t_of_int_beta(self, B: torch.Tensor) -> torch.Tensor:
        """Invert B(t) = a t^2 + b t for t >= 0 with the cancellation-free
        root 2B / (b + sqrt(b^2 + 4 a B)) (exact for a -> 0, where the
        textbook -b + sqrt form is 0/0)."""
        a = 0.5 * (self.beta_max - self.beta_min) / self.T
        b = self.beta_min
        return 2.0 * B / (b + torch.sqrt(b**2 + 4.0 * a * B))

    def t_of_log_snr(self, lam) -> torch.Tensor:
        # lambda = -0.5 log(e^B - 1)  =>  B = log1p(e^{-2 lambda})
        return self._t_of_int_beta(torch.log1p(torch.exp(-2.0 * _f32(lam))))


@dataclasses.dataclass(frozen=True)
class SUBVPSDE(VPSDE):
    """Sub-variance-preserving SDE: same beta/f as VPSDE;
    g = sqrt(beta(t)(1 - exp(-2 B(t)))); eta = 1 - exp(-B(t)); prior N(0, 1)."""

    def _discount(self, t) -> torch.Tensor:
        t = _f32(t)
        return -torch.expm1(
            -2.0 * self.beta_min * t - (self.beta_max - self.beta_min) * t**2 / self.T
        )

    def diffusion(self, t, x: torch.Tensor) -> torch.Tensor:
        g = torch.sqrt(self.beta(t) * self._discount(t))
        return _bcast_right(g, x) * torch.ones_like(x)

    def diffusion_squared_scalar(self, t) -> torch.Tensor:
        return self.beta(t) * self._discount(t)

    def marginal_prob_scalars(self, t):
        log_coeff = self._int_beta(t)
        std = -torch.expm1(-log_coeff)
        return torch.exp(-0.5 * log_coeff), std

    def t_of_log_snr(self, lam) -> torch.Tensor:
        # eta = 1 - e^{-B}: with u = e^{-B/2}, e^lam = u / (1 - u^2)
        #  =>  u = 2 e^lam / (1 + sqrt(1 + 4 e^{2 lam})),  B = -2 log u.
        # (the textbook (sqrt(1+4r^2)-1)/(2r) form cancels for negative
        # lambda: at r ~ 1e-4 float32 rounds 1 + 4r^2 to 1, u = 0, B = inf)
        r = torch.exp(_f32(lam))
        u = 2.0 * r / (1.0 + torch.sqrt(1.0 + 4.0 * r**2))
        return self._t_of_int_beta(-2.0 * torch.log(u))
