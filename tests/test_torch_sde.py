"""flowfusion_torch SDE scalar surface against the JAX package.

Tolerance: <= 1e-6 relative (float32 scalar math on both sides; the
-expm1 forms keep small-t values accurate on both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.ops import sde as jsde
from flowfusion_torch.ops import sde

torch.set_num_threads(1)

T_GRID = np.concatenate([[1e-7, 1e-5, 1e-3], np.linspace(0.01, 1.0, 30)]).astype(np.float32)

PAIRS = {
    "vesde": (jsde.VESDE(), sde.VESDE()),
    "vesde_custom": (jsde.VESDE(sigma_min=0.05, sigma_max=25.0), sde.VESDE(sigma_min=0.05, sigma_max=25.0)),
    "vpsde": (jsde.VPSDE(), sde.VPSDE()),
    "subvpsde": (jsde.SUBVPSDE(), sde.SUBVPSDE()),
}


def _close(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * np.max(np.abs(ref)) + 1e-30)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_scalar_surface_matches_jax(name):
    j, p = PAIRS[name]
    tj, tp = jnp.asarray(T_GRID), torch.as_tensor(T_GRID)
    _close(p.sigma(tp), j.sigma(tj))
    _close(p.drift_coefficient(tp), j.drift_coefficient(tj))
    _close(p.diffusion_squared_scalar(tp), j.diffusion_squared_scalar(tj))
    for a, b in zip(p.marginal_prob_scalars(tp), j.marginal_prob_scalars(tj)):
        _close(a, b)
    assert p.prior_scale == j.prior_scale
    assert (p.T, p.epsilon) == (j.T, j.epsilon)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_state_functions_match_jax(name):
    j, p = PAIRS[name]
    x = np.random.default_rng(0).standard_normal((len(T_GRID), 3)).astype(np.float32)
    tj, tp = jnp.asarray(T_GRID), torch.as_tensor(T_GRID)
    xj, xp = jnp.asarray(x), torch.as_tensor(x)
    _close(p.drift(tp, xp), j.drift(tj, xj))
    _close(p.diffusion(tp, xp), j.diffusion(tj, xj))
    for a, b in zip(p.marginal_prob(tp, xp), j.marginal_prob(tj, xj)):
        _close(a, b)
    _close(p.prior_log_prob(xp * 3.0), j.prior_log_prob(xj * 3.0))
    # scalar (batch-global) time, the solver's form
    _close(p.drift(torch.tensor(0.3), xp), j.drift(jnp.float32(0.3), xj))
    _close(p.diffusion(torch.tensor(0.3), xp), j.diffusion(jnp.float32(0.3), xj))
