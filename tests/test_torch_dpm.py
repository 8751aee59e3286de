"""flowfusion_torch's DPM-Solver against the JAX package's: the log-SNR
maps of the three SDEs, the float32 lambda grid as ``jnp.linspace`` rounds
it, and ``ScoreModel.sample_dpm`` (orders 1 and 2) on the flagship weights
within 1e-5 relative / 1e-4 absolute, through the plain path and through
the kernel wrapper's plain version."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import sde as jsde
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.kernels import fused_mlp
from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops import sde as tsde
from flowfusion_torch.ops.integrate import dpm_solver_sample
from flowfusion_torch.ops.integrate.dpm import _linspace_f32, log_snr_grid
from flowfusion_torch.utils import convert
from flowfusion_torch.utils.checkpoint import load_npz

torch.set_num_threads(1)

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                        "flagship_ckpt.npz")
SDES = {
    "ve": (jsde.VESDE(), tsde.VESDE()),
    "vp": (jsde.VPSDE(), tsde.VPSDE()),
    "subvp": (jsde.SUBVPSDE(), tsde.SUBVPSDE()),
    "vp_constant_beta": (jsde.VPSDE(beta_min=1.0, beta_max=1.0), tsde.VPSDE(beta_min=1.0, beta_max=1.0)),
}


@pytest.mark.parametrize("name", sorted(SDES))
def test_log_snr_round_trip_matches_jax(name):
    """log_snr and t_of_log_snr equal the JAX package's (float32, 1 ulp),
    and t_of_log_snr(log_snr(t)) returns t over [epsilon, T]."""
    jm, tm = SDES[name]
    t = np.linspace(tm.epsilon, tm.T, 257).astype(np.float32)
    lam = tm.log_snr(torch.as_tensor(t))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jm.log_snr(jnp.asarray(t))), rtol=2e-6, atol=2e-6)
    back = tm.t_of_log_snr(lam)
    np.testing.assert_allclose(back.numpy(), np.asarray(jm.t_of_log_snr(jnp.asarray(lam.numpy()))),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(back.numpy(), t, rtol=2e-4, atol=1e-6)
    # a constant-beta-style exact inverse where the textbook form cancels
    assert torch.isfinite(tm.t_of_log_snr(torch.tensor([-9.0, 0.0, 9.0]))).all()


@pytest.mark.parametrize("name", sorted(SDES))
@pytest.mark.parametrize("steps", [1, 12, 25])
def test_lambda_grid_matches_jnp_linspace(name, steps):
    """From the same endpoints the uniform lambda grid is ``jnp.linspace``'s
    formula, start (1 - i/n) + stop i/n with the endpoint exact: every
    point within two float32 ulps of the endpoints' magnitude of the JAX
    grid (XLA's CPU compiler turns the division into a reciprocal product
    and contracts into FMAs, which moves some points by an ulp).  The
    port's own grid sits within float32 rounding of the JAX package's (the
    endpoints' log may differ by an ulp between the two libraries), its
    times on the JAX grid too, and its end times are pinned."""
    jm, tm = SDES[name]
    lam0 = jm.log_snr(jnp.asarray(jm.T, jnp.float32))
    lam1 = jm.log_snr(jnp.asarray(jm.epsilon, jnp.float32))
    jl = np.asarray(jnp.linspace(lam0, lam1, steps + 1))
    grid = _linspace_f32(torch.as_tensor(np.asarray(lam0)), torch.as_tensor(np.asarray(lam1)), steps + 1)
    assert grid[0] == jl[0] and grid[-1] == jl[-1]
    ulp = np.spacing(np.float32(max(abs(float(lam0)), abs(float(lam1)))))
    assert np.all(np.abs(grid.numpy() - jl) <= 2 * ulp), np.abs(grid.numpy() - jl).max() / ulp
    lams, ts = log_snr_grid(tm, tm.T, tm.epsilon, steps)
    np.testing.assert_allclose(lams.numpy(), jl, rtol=1e-6, atol=1e-6)
    jt = np.asarray(jm.t_of_log_snr(jnp.asarray(jl)))
    np.testing.assert_allclose(tm.t_of_log_snr(torch.as_tensor(jl)).numpy(), jt, rtol=2e-6, atol=1e-7)
    assert ts[0] == tm.T and ts[-1] == np.float32(tm.epsilon)


@pytest.fixture(scope="module")
def flagship():
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    jm = jckpt.load_npz(FLAGSHIP, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg,
                                              sde=jsde.VESDE(), use_fused_kernel=False))
    tm = ScoreModel(convert.params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu"),
                    ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), tsde.VESDE())
    return jm, tm


@pytest.mark.parametrize("order", [1, 2])
def test_sample_dpm_matches_jax(flagship, order):
    """Flagship sample_dpm at 256 rows, 12 steps: within 1e-5 relative and
    1e-4 absolute of the JAX package's; the kernel wrapper's plain version
    (use_fused_kernel=True on the CPU) within the same bar, and it is
    called steps x order times."""
    jm, tm = flagship
    z = np.random.default_rng(11).standard_normal((256, 2)).astype(np.float32)
    js = np.asarray(jax.jit(lambda m, zz: m.sample_dpm(zz, steps=12, order=order))(jm, jnp.asarray(z)))
    s = tm.sample_dpm(torch.as_tensor(z), steps=12, order=order)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-5, atol=1e-4)
    fused_mlp.reset_launch_counts()
    calls = []
    orig = fused_mlp.fused_drift_reference

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    fused_mlp.fused_drift_reference = counting
    try:
        s_f = dataclasses.replace(tm, use_fused_kernel=True).sample_dpm(torch.as_tensor(z), steps=12, order=order)
    finally:
        fused_mlp.fused_drift_reference = orig
    assert len(calls) == 12 * order
    np.testing.assert_allclose(s_f.numpy(), s.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("sde_name", ["vp", "subvp"])
def test_sample_dpm_no_sigma_and_conditional_matches_jax(sde_name):
    """A conditional no_sigma net (the served conditional checkpoint's
    form) on the VP-family SDEs, random weights: plain and wrapper paths
    against the JAX package at the same bar."""
    jsd, tsd = SDES[sde_name]
    cfg = ScoreMLPConfig(n_dimensions=3, n_conditionals=2, units=(32, 32))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(4), "cpu")
    jcfg = jnets.ScoreMLPConfig(n_dimensions=3, n_conditionals=2, units=(32, 32))
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), params)
    jm = JScoreModel(params=jparams, net=jcfg, sde=jsd, no_sigma=True, use_fused_kernel=False)
    tm = ScoreModel(params, cfg, tsd, no_sigma=True)
    rng = np.random.default_rng(12)
    z = rng.standard_normal((128, 3)).astype(np.float32)
    c = rng.standard_normal((128, 2)).astype(np.float32)
    js = np.asarray(jm.sample_dpm(jnp.asarray(z), conditional=jnp.asarray(c), steps=8, order=2))
    for fused in (False, True):
        s = dataclasses.replace(tm, use_fused_kernel=fused).sample_dpm(
            torch.as_tensor(z), conditional=torch.as_tensor(c), steps=8, order=2)
        np.testing.assert_allclose(s.numpy(), js, rtol=1e-5, atol=1e-4)


def test_dpm_solver_refuses_other_orders():
    with pytest.raises(ValueError, match="order"):
        dpm_solver_sample(lambda t, x: x, tsde.VPSDE(), torch.zeros(2, 2), order=3)
