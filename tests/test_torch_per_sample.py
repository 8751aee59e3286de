"""flowfusion_torch's per-sample stepping (``odeint_per_sample`` and the
models' ``log_prob_per_sample``) against the JAX package's vmapped solve:
per-row NFE equal and values within 1e-4 on the JAX package's own
three-row problem and on 16 flagship rows (Hutchinson, the JAX probe),
and the wrappers' conventions (probe and conditional riding in the state,
the default ``min_step``, the refused sketch estimators).

Step sizes are pinned below (``min_step``): an error ratio at float32
rounding level lets rounding pick a step size, and the two packages'
compilers round differently (ROADMAP.md queue 3, step-size noise)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.integrate.adaptive import odeint_per_sample as jodeint_per_sample
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.models.nets import ScoreMLPConfig
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.models.symplectic import SymplecticFlowModel
from flowfusion_torch.ops.integrate import odeint_adaptive, odeint_per_sample
from flowfusion_torch.ops.sde import VESDE, VPSDE
from flowfusion_torch.utils import convert
from flowfusion_torch.utils.checkpoint import load_npz

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")


def _jrhs(t, state):
    x, _ = state
    return (-x, jnp.sum(x, axis=-1))


def _trhs(t, state):
    x, _ = state
    return (-x, x.sum(-1))


X3 = np.asarray([[0.1, 0.2], [5.0, -3.0], [0.5, 0.5]], np.float32)


@pytest.mark.parametrize("opts", [{"min_step": 0.05}, {"min_step": 0.02}])
def test_three_row_problem_matches_jax(opts):
    """The JAX package's own problem (tests/test_integrate.py): per-row
    n_func_evals, n_accepted and n_rejected equal, values within 1e-6,
    the closed form within 1e-5, per-row stats of shape (3,)."""
    (jx, jl), jst = jodeint_per_sample(_jrhs, (jnp.asarray(X3), jnp.zeros(3)), [0.0, 1.0], rtol=1e-6,
                                       atol=1e-8, options=opts)
    (xs, ls), st = odeint_per_sample(_trhs, (torch.as_tensor(X3), torch.zeros(3)), [0.0, 1.0], rtol=1e-6,
                                     atol=1e-8, options=opts)
    assert xs.shape == (3, 2, 2) and ls.shape == (3, 2) and st.n_accepted.shape == (3,)
    for a, b in zip(st[:3], jst[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(st.succeeded.all())
    np.testing.assert_allclose(xs.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ls.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xs[:, -1].numpy(), X3 * np.exp(-1.0), rtol=1e-5)


def test_rows_step_alone():
    """Each row's solve is the batch-global solve of that row alone (same
    counts, values within 1e-6), on a multi-output decreasing grid with a
    clipped tableau and with dopri5; a row's NFE counts only while the row
    is active, and an exhausted row reports failure without holding the
    others back."""
    x0 = torch.as_tensor(X3)
    for method in ("dopri5", "tsit5"):
        (xs, _), st = odeint_per_sample(_trhs, (x0, torch.zeros(3)), [1.0, 0.4, 0.0], rtol=1e-5, atol=1e-7,
                                        method=method, options={"min_step": 0.02})
        for r in range(3):
            (xr, _), sr = odeint_adaptive(_trhs, (x0[r:r + 1], torch.zeros(1)), [1.0, 0.4, 0.0], rtol=1e-5,
                                          atol=1e-7, method=method, options={"min_step": 0.02})
            assert (int(st.n_func_evals[r]), int(st.n_accepted[r]), int(st.n_rejected[r])) == tuple(sr[:3])
            np.testing.assert_allclose(xs[r].numpy(), xr[:, 0].numpy(), atol=1e-6)
    # a single-tensor state, and a row that exhausts max_num_steps
    y = torch.tensor([[1.0], [1e4]])
    ys, st = odeint_per_sample(lambda t, v: -v * torch.abs(v), y, [0.0, 1.0], rtol=1e-9, atol=1e-12,
                               options={"max_num_steps": 40})
    assert ys.shape == (2, 2, 1) and st.succeeded.tolist() == [True, False]
    assert int(st.n_accepted[1] + st.n_rejected[1]) == 40


@pytest.fixture(scope="module")
def flagship():
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    jm = jckpt.load_npz(os.path.join(BENCH, "flagship_ckpt.npz"),
                        JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg,
                                    sde=JVESDE(), trace_mode="hutchinson", use_fused_kernel=False))
    tm = ScoreModel(convert.params_from_numpy(load_npz(os.path.join(BENCH, "flagship_ckpt.npz"))["params"], "cpu"),
                    ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), VESDE(), trace_mode="hutchinson")
    return jm, tm


@pytest.mark.parametrize("tol, bar", [(1e-2, 1e-4), (1e-4, 5e-3)])
def test_flagship_log_prob_per_sample_matches_jax(flagship, tol, bar):
    """16 flagship rows, Hutchinson with the JAX probe, the steps held in
    [0.02, 0.1]: per-row NFE equal to the JAX package's (the rows at their
    own pace) and log-densities within 1e-4 at rtol 1e-2.  At rtol 1e-4
    the counts still agree while single rows' step sizes differ in their
    last digits (their error ratios reach float32 rounding), which moves
    a density by up to 5e-3.  The batch-global solve at the same settings
    within 5e-2 on average (the JAX package's bar)."""
    jm, tm = flagship
    x = np.random.default_rng(13).standard_normal((16, 2)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    kw = dict(atol=tol, rtol=tol, options={"min_step": 0.02, "max_step": 0.1})
    # jit pins the JAX call to one unsharded solve (its eager route shards
    # the batch over the test mesh and draws other probes a shard)
    jlp, jst = jax.jit(lambda m, xx: m.log_prob_per_sample(xx, key=key, **kw))(jm, jnp.asarray(x))
    probes = tuple(torch.as_tensor(np.asarray(p)) for p in jtrace.make_probes("hutchinson", key, jnp.asarray(x)))
    lp, st = tm.log_prob_per_sample(torch.as_tensor(x), probes=probes, **kw)
    np.testing.assert_array_equal(st.n_func_evals.numpy(), np.asarray(jst.n_func_evals))
    assert float(np.max(np.abs(lp.numpy() - np.asarray(jlp)))) <= bar
    assert int(st.n_func_evals.min()) < int(st.n_func_evals.max())  # rows step at their own pace
    lp_g, _ = tm.log_prob(torch.as_tensor(x), probes=probes, **kw)
    assert float((lp - lp_g).abs().mean()) <= 5e-2
    # the default options carry the min_step guard; the sketch modes refuse
    lp_d, st_d = tm.log_prob_per_sample(torch.as_tensor(x), probes=probes)
    lp_gd, _ = tm.log_prob(torch.as_tensor(x), probes=probes)
    assert bool(st_d.succeeded.all()) and float((lp_d - lp_gd).abs().mean()) <= 5e-2
    for mode in ("hutchpp", "xtrace"):
        with pytest.raises(NotImplementedError, match="batch-coupled"):
            dataclasses.replace(tm, trace_mode=mode).log_prob_per_sample(torch.as_tensor(x))


def test_wrappers_per_sample():
    """The population wrapper (standardization, conditional, volume term,
    no min_step guard), ODEFlow (exact, conditional) and the symplectic
    model (given momentum): per-sample log-densities within 5e-2 of their
    batch-global solves, per-row stats."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 2, generator=torch.Generator().manual_seed(1))
    c = torch.randn(8, 1, generator=torch.Generator().manual_seed(2))
    pop = PopulationModelDiffusion.create(
        VPSDE(), n_dimensions=2, n_conditionals=1, units=(32, 32), shift=[0.5, -1.0], scale=[2.0, 0.5],
        conditional_shift=[0.3], conditional_scale=[2.0], trace_mode="hutchinson", generator=g, device="cpu")
    e = torch.sign(torch.randn(8, 2, generator=torch.Generator().manual_seed(3)))
    lp_g, _ = pop.log_prob(x, conditional=c, probes=(e,), volume_corrected=True)
    lp, st = pop.log_prob_per_sample(x, conditional=c, probes=(e,), volume_corrected=True)
    assert st.n_func_evals.shape == (8,) and float((lp - lp_g).abs().max()) <= 5e-2
    flow = ODEFlow.create(target_dimension=2, conditional_dimension=1, hidden_units=(32, 32),
                          target_shift=[0.1, 0.2], target_scale=[1.5, 0.7], conditional_shift=[0.2],
                          conditional_scale=[3.0], generator=g, device="cpu")
    lp_g, _ = flow.log_prob(x, conditional=c)
    lp, st = flow.log_prob_per_sample(x, conditional=c)
    assert st.n_func_evals.shape == (8,) and float((lp - lp_g).abs().max()) <= 5e-2
    sym = SymplecticFlowModel.create(n_data_dims=2, n_conditionals=1, units=(32,), shift=[0.1, 0.2],
                                     scale=[1.5, 0.7], conditional_shift=[0.2], conditional_scale=[3.0],
                                     generator=g, device="cpu")
    p0 = torch.randn(8, 2, generator=torch.Generator().manual_seed(4))
    lp_g, _ = sym.log_prob(x, conditional=c, momentum=p0)
    lp, st = sym.log_prob_per_sample(x, conditional=c, momentum=p0)
    assert st.n_func_evals.shape == (8,) and float((lp - lp_g).abs().max()) <= 5e-2
