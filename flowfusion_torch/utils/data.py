"""Toy data with analytic densities, and dataset helpers (counterpart of
the JAX package's ``utils/data.py``).

Sampling draws from a ``torch.Generator`` on the generator's own device
(the CPU by default) and moves the rows to ``device``; torch and JAX
streams differ, so the same seed gives other rows than the JAX package.
The mixtures' constants and the conditional family's functional form are
the JAX package's, copied here: the committed checkpoints were trained on
them and are scored against these analytic densities.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = [
    "GMM", "DEMO_GMM", "REFERENCE_GMM", "ConditionalPopulation",
    "CONDITIONAL_POP", "train_val_test_split", "standardization_stats",
]


def _gen_device(generator: Optional[torch.Generator]):
    return generator.device if generator is not None else None


@dataclasses.dataclass(frozen=True)
class GMM:
    """K-component Gaussian mixture with exact sampling and log density."""

    weights: Tuple[float, ...]
    means: Tuple[Tuple[float, ...], ...]
    covs: Tuple[Tuple[Tuple[float, ...], ...], ...]

    def __post_init__(self):
        w = np.asarray(self.weights, np.float64)
        mu = np.asarray(self.means, np.float64)
        cov = np.asarray(self.covs, np.float64)
        if np.any(w <= 0):
            raise ValueError(f"mixture weights must be positive; got {w}")
        if not (len(w) == mu.shape[0] == cov.shape[0]):
            raise ValueError(
                f"component count mismatch: {len(w)} weights, {mu.shape[0]} "
                f"means, {cov.shape[0]} covs"
            )
        if cov.shape[1:] != (mu.shape[1], mu.shape[1]):
            raise ValueError(f"cov shape {cov.shape[1:]} vs dim {mu.shape[1]}")
        if not np.allclose(cov, np.swapaxes(cov, 1, 2)):
            raise ValueError("covariances must be symmetric")
        if np.any(np.linalg.eigvalsh(cov) <= 0):
            raise ValueError("covariances must be positive definite")

    @property
    def dim(self) -> int:
        return len(self.means[0])

    def _np(self):
        w = np.asarray(self.weights, np.float64)
        return w / w.sum(), np.asarray(self.means), np.asarray(self.covs)

    def sample(
        self, generator: Optional[torch.Generator], n: int, device: DeviceLike = None
    ) -> torch.Tensor:
        """``n`` float32 mixture rows (component choice + Cholesky noise)."""
        dev = resolve_device(device)
        w, mu, cov = self._np()
        gdev = _gen_device(generator)
        comps = torch.multinomial(
            torch.as_tensor(w, device=gdev), n, replacement=True, generator=generator
        )
        z = torch.randn((n, self.dim), generator=generator, dtype=torch.float64, device=gdev)
        chols = torch.as_tensor(np.linalg.cholesky(cov), device=gdev)
        x = torch.as_tensor(mu, device=gdev)[comps] + torch.einsum("nij,nj->ni", chols[comps], z)
        return x.to(device=dev, dtype=torch.float32)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Closed-form mixture log-density of (n, D) rows (or one (D,) row),
        in ``x``'s dtype and on its device."""
        w, mu, cov = self._np()
        x = torch.atleast_2d(x)

        def t(a):
            return torch.as_tensor(a, dtype=x.dtype, device=x.device)

        inv = t(np.linalg.inv(cov))
        logdet = t(np.linalg.slogdet(cov)[1])
        diff = x[:, None, :] - t(mu)[None, :, :]  # (n, K, D)
        maha = torch.einsum("nki,kij,nkj->nk", diff, inv, diff)
        logps = torch.log(t(w))[None, :] - 0.5 * (
            maha + logdet[None, :] + self.dim * math.log(2 * math.pi)
        )
        return torch.logsumexp(logps, dim=1)


# The reference notebooks' mixture: well-separated modes at (-3, 3), (2, -2).
REFERENCE_GMM = GMM(
    weights=(0.4, 0.6),
    means=((-3.0, 3.0), (2.0, -2.0)),
    covs=(((1.0, 0.0), (0.0, 1.0)), ((2.0, 0.9), (0.9, 2.0))),
)

# The package's demo mixture (two close, overlapping components): the
# field of the committed flagship checkpoint.
DEMO_GMM = GMM(
    weights=(0.4, 0.6),
    means=((-1.0, -1.0), (1.0, 1.0)),
    covs=(((0.5, 0.2), (0.2, 0.5)), ((0.7, -0.3), (-0.3, 0.4))),
)


def train_val_test_split(
    generator: Optional[torch.Generator], x: torch.Tensor, fractions=(0.25, 0.25, 0.5)
):
    """Random split with torch random_split's remainder handling: floored
    lengths, leftover rows handed out round-robin."""
    if len(fractions) != 3 or abs(sum(fractions) - 1.0) > 1e-6:
        raise ValueError(f"fractions must be 3 values summing to 1; got {fractions}")
    n = x.shape[0]
    perm = torch.randperm(n, generator=generator, device=_gen_device(generator)).to(x.device)
    lengths = [int(f * n) for f in fractions]
    for i in range(n - sum(lengths)):
        lengths[i % 3] += 1
    n_train, n_val, _ = lengths
    return (
        x[perm[:n_train]],
        x[perm[n_train : n_train + n_val]],
        x[perm[n_train + n_val :]],
    )


def standardization_stats(x: torch.Tensor):
    """(shift, scale) = per-dimension mean and unbiased std; constant
    columns and a single-row dataset (NaN std) get scale 1."""
    std = torch.std(x, dim=0, correction=1) if x.shape[0] > 1 else torch.full_like(x[0], float("nan"))
    scale = torch.where(torch.isfinite(std) & (std > 1e-12), std, torch.ones_like(std))
    return torch.mean(x, dim=0), scale


@dataclasses.dataclass(frozen=True)
class ConditionalPopulation:
    """The frozen 6-D theta | 3-D c family with an analytic conditional
    density: c ~ U(-1, 1)^3 drives a nonlinear mean and a sigmoid-modulated
    scale of a Gaussian."""

    theta_dim: int = 6
    cond_dim: int = 3

    def __post_init__(self):
        if (self.theta_dim, self.cond_dim) != (6, 3):
            raise ValueError(
                "ConditionalPopulation is a frozen 6-D/3-cond family; got "
                f"({self.theta_dim}, {self.cond_dim})"
            )

    def mean_scale(self, c: torch.Tensor):
        """Analytic (mean, scale) of theta | c, each (n, 6)."""
        mean = torch.cat(
            [
                torch.sin(2 * c),
                torch.tanh(c[:, :1] * c[:, 1:2]),
                c[:, 2:] ** 2,
                (c[:, :1] + c[:, 2:]) / 2,
            ],
            dim=1,
        )
        scale = 0.3 + 0.2 * torch.sigmoid(torch.cat([c, -c], dim=1))
        return mean, scale

    def sample(
        self, generator: Optional[torch.Generator], n: int, device: DeviceLike = None
    ):
        """(theta, c) float32 draws."""
        dev = resolve_device(device)
        gdev = _gen_device(generator)
        c = 2.0 * torch.rand((n, self.cond_dim), generator=generator, device=gdev) - 1.0
        z = torch.randn((n, self.theta_dim), generator=generator, device=gdev)
        mean, scale = self.mean_scale(c)
        return (mean + scale * z).to(dev), c.to(dev)

    def log_prob(self, theta: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """Exact conditional log density log p(theta | c)."""
        mean, scale = self.mean_scale(c)
        return torch.sum(
            -0.5 * ((theta - mean) / scale) ** 2
            - torch.log(scale)
            - 0.5 * math.log(2 * math.pi),
            dim=1,
        )


CONDITIONAL_POP = ConditionalPopulation()
