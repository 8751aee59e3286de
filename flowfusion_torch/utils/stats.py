"""Two-sample statistics for generated samples (counterpart of the JAX
package's ``utils/stats.py``).

  * ``energy_distance`` — Szekely & Rizzo's E-statistic: zero iff the two
    distributions coincide, in any dimension;
  * ``energy_distance_test`` — its permutation p-value for H0: same law,
    permutations drawn from an explicit ``torch.Generator``.

Both are O(n^2) in time (pairwise distances on the tensors' device);
the distance matrix is summed in row blocks of at most 2^26 entries, so
memory stays bounded at 50,000-row sets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._device import strict_fp32_matmul

__all__ = ["energy_distance", "energy_distance_test"]


def _mean_pdist(a: torch.Tensor, b: torch.Tensor, block: int = 2**26) -> torch.Tensor:
    """Mean Euclidean distance over all (a_i, b_j) pairs, summed in
    float64 over row blocks of ``a``; TF32 off (|a|^2 + |b|^2 - 2 a.b
    cancels)."""
    rows = max(1, block // max(b.shape[0], 1))
    bb = (b**2).sum(dim=1)[None, :]
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    with strict_fp32_matmul():
        for i in range(0, a.shape[0], rows):
            ai = a[i : i + rows]
            d2 = (ai**2).sum(dim=1)[:, None] + bb - 2.0 * ai @ b.T
            total = total + torch.sqrt(torch.clamp_min(d2, 0.0)).sum(dtype=torch.float64)
    return (total / (a.shape[0] * b.shape[0])).to(a.dtype)


def energy_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """E(x, y) = 2 E|X-Y| - E|X-X'| - E|Y-Y'|  (>= 0; 0 iff same law)."""
    return 2.0 * _mean_pdist(x, y) - _mean_pdist(x, x) - _mean_pdist(y, y)


def energy_distance_test(
    x: torch.Tensor,
    y: torch.Tensor,
    n_permutations: int = 200,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permutation test of H0: x and y come from the same distribution.

    Returns (statistic, p_value).  Sample sizes must match (subsample
    beforehand); permutations are drawn on the generator's device."""
    n = x.shape[0]
    if y.shape[0] != n:
        raise ValueError("x and y must have equal sample sizes")
    stat = energy_distance(x, y)
    pooled = torch.cat([x, y], dim=0)
    gen_dev = generator.device if generator is not None else None
    null = []
    for _ in range(n_permutations):
        perm = torch.randperm(2 * n, generator=generator, device=gen_dev).to(pooled.device)
        shuffled = pooled[perm]
        null.append(energy_distance(shuffled[:n], shuffled[n:]))
    p = (1.0 + (torch.stack(null) >= stat).sum()) / (n_permutations + 1.0)
    return stat, p
