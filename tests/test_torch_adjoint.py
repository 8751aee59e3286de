"""flowfusion_torch's continuous adjoint (``odeint_adjoint``, a
``torch.autograd.Function``) against closed forms and the JAX package's
``custom_vjp``: linear and time-dependent fields, several output times,
a decreasing grid, the NaN poison of a failed solve, gradients into
values passed beside the parameters (a conditioning batch, the
population's standardization statistics) and the flagship model's
gradient of mean log_prob against the JAX adjoint's on the same
parameters and probe."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.population import PopulationModelDiffusion as JPopulation
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.ops.sde import VPSDE as JVPSDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.integrate import odeint_adjoint
from flowfusion_torch.ops.sde import VESDE, VPSDE
from flowfusion_torch.utils import convert
from flowfusion_torch.utils.checkpoint import load_npz

torch.set_num_threads(1)

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                        "flagship_ckpt.npz")


def _leaf(v):
    return torch.tensor(v, dtype=torch.float32, requires_grad=True)


def test_adjoint_gradient_linear_closed_form():
    """dy/dt = -a y: y(1) = y0 e^-a; d/da = -y0 e^-a; d/dy0 = e^-a."""
    y0, a = _leaf([2.0, 3.0]), _leaf(0.7)
    ys = odeint_adjoint(lambda t, y, p: -p[0] * y, y0, [0.0, 1.0], (a,), rtol=1e-7, atol=1e-9)
    ys[-1].sum().backward()
    np.testing.assert_allclose(y0.grad.numpy(), np.exp(-0.7), rtol=1e-4)
    np.testing.assert_allclose(a.grad.numpy(), -5.0 * np.exp(-0.7), rtol=1e-4)
    np.testing.assert_allclose(ys[-1].detach().numpy(), np.array([2.0, 3.0]) * np.exp(-0.7), rtol=1e-5)


def test_adjoint_gradient_time_dependent_and_unused_parameter():
    """dy/dt = a cos(t): d y(2) / da = sin(2); a parameter the field does
    not use gets a zero gradient."""
    a, unused = _leaf(1.3), _leaf([1.0, 2.0])
    ys = odeint_adjoint(lambda t, y, p: p[0] * torch.cos(t) * torch.ones_like(y), torch.zeros(1), [0.0, 2.0],
                        (a, unused), rtol=1e-7, atol=1e-9)
    ys[-1][0].backward()
    np.testing.assert_allclose(a.grad.numpy(), np.sin(2.0), rtol=1e-4)
    assert unused.grad is not None and float(unused.grad.abs().sum()) == 0.0


def test_adjoint_multiple_output_times_and_tuple_state():
    """L = sum_i y(t_i) accumulates every output's cotangent; a tuple state
    carries each leaf's; the JAX adjoint gives the same gradient."""
    ts = [0.0, 0.5, 1.0]
    a = _leaf(0.5)
    ys = odeint_adjoint(lambda t, y, p: -p[0] * y, torch.ones(1), ts, (a,), rtol=1e-8, atol=1e-10)
    ys.sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), sum(-t * np.exp(-0.5 * t) for t in ts), rtol=1e-4)

    def jloss(p):
        from flowfusion_tpu.ops.integrate.adjoint import odeint_adjoint as jadj

        y, z = jadj(lambda t, s, q: (-q * s[0], jnp.sin(t) * s[0] - s[1]), (jnp.ones(2), jnp.zeros(2)), ts, p,
                    rtol=1e-7, atol=1e-9)
        return jnp.sum(y) + 2.0 * jnp.sum(z)

    b = _leaf(0.8)
    y, z = odeint_adjoint(lambda t, s, q: (-q[0] * s[0], torch.sin(t) * s[0] - s[1]), (torch.ones(2), torch.zeros(2)),
                          ts, (b,), rtol=1e-7, atol=1e-9)
    (y.sum() + 2.0 * z.sum()).backward()
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jax.grad(jloss)(jnp.float32(0.8))), rtol=1e-5)


def test_adjoint_decreasing_grid_gradient():
    """t: 1 -> 0 (the sampling direction): y(0) = y0 e^a for dy/dt = -a y,
    d/da mean(y(0)) = mean(y0) e^a."""
    a = _leaf(0.7)
    y0 = torch.tensor([1.0, 2.0, -0.5])
    ys = odeint_adjoint(lambda t, y, p: -p[0] * y, y0, [1.0, 0.0], (a,), rtol=1e-8, atol=1e-10)
    loss = ys[-1].mean()
    loss.backward()
    expected = float(y0.mean()) * np.exp(0.7)
    np.testing.assert_allclose(a.grad.numpy(), expected, rtol=1e-4)
    np.testing.assert_allclose(float(loss), expected, rtol=1e-4)


def test_adjoint_gradient_into_passed_values():
    """A conditioning batch passed beside the parameters takes its
    gradient: d y(1) / d c = (1 - e^-a) / a elementwise."""
    cond = _leaf([[0.3, 0.1]])
    ys = odeint_adjoint(lambda t, y, p: -0.5 * y + p[0], torch.tensor([[1.0, -1.0]]), [0.0, 1.0], (cond,),
                        rtol=1e-7, atol=1e-9)
    ys[-1].sum().backward()
    np.testing.assert_allclose(cond.grad.numpy(), (1.0 - np.exp(-0.5)) / 0.5, rtol=1e-4)


def test_adjoint_failure_poisons_and_refuses_fixed_step():
    """An exhausted solve returns NaN (forward), and an exhausted backward
    interval NaN gradients; fixed-step methods refuse."""
    p = _leaf(1.0)
    ys = odeint_adjoint(lambda t, y, q: q[0] * torch.full_like(y, float("nan")), torch.ones(3), [0.0, 1.0], (p,),
                        options={"max_num_steps": 8})
    assert bool(torch.isnan(ys[-1]).all())
    # a field the forward solve crosses easily but whose adjoint system
    # is stiff: the backward interval exhausts its steps
    q = _leaf(1.0)

    def stiff_backward(t, y, params):
        return params[0] * torch.sin(y)

    ys = odeint_adjoint(stiff_backward, torch.ones(2), [0.0, 1.0], (q,), rtol=1e-6, atol=1e-8,
                        adjoint_rtol=1e-13, adjoint_atol=1e-16, options={"max_num_steps": 30})
    assert bool(torch.isfinite(ys).all())
    ys[-1].sum().backward()
    assert bool(torch.isnan(q.grad).all())
    with pytest.raises(ValueError, match="adaptive-only"):
        odeint_adjoint(lambda t, y, q: -y, torch.ones(2), [0.0, 1.0], (), method="rk4")


def _requires_grad(params):
    return {"W": params["W"].detach().clone().requires_grad_(True),
            "layers": [{k: v.detach().clone().requires_grad_(True) for k, v in l.items()} for l in params["layers"]]}


def _flat_grads(params):
    return torch.cat([params["W"].grad.reshape(-1)] + [l[k].grad.reshape(-1) for l in params["layers"]
                                                        for k in ("b", "w")])


def _jflat(g):
    return np.concatenate([np.asarray(g["W"]).reshape(-1)] + [np.asarray(l[k]).reshape(-1) for l in g["layers"]
                                                               for k in ("b", "w")])


def test_population_gradients_into_conditional_and_statistics():
    """The population wrapper's adjoint log_prob (Hutchinson, the JAX
    probe): the value and the gradients into the parameters, the data and
    conditional statistics and the conditional batch against the JAX
    package's adjoint gradients (1e-3 relative to each gradient's norm)."""
    cfg = ScoreMLPConfig(n_dimensions=2, n_conditionals=1, units=(16, 16))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(20)
    x = rng.standard_normal((8, 2)).astype(np.float32)
    c = rng.standard_normal((8, 1)).astype(np.float32)
    stats = dict(shift=np.array([0.5, -1.0], np.float32), scale=np.array([2.0, 0.5], np.float32),
                 conditional_shift=np.array([0.3], np.float32), conditional_scale=np.array([2.0], np.float32))
    key = jax.random.PRNGKey(21)
    kw = dict(atol=1e-6, rtol=1e-6, adjoint=True)
    jcfg = jnets.ScoreMLPConfig(n_dimensions=2, n_conditionals=1, units=(16, 16))
    jsm = JScoreModel(params=jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), params), net=jcfg,
                      sde=JVPSDE(), trace_mode="hutchinson", use_fused_kernel=False)
    jpop = JPopulation(jsm, **{k: jnp.asarray(v) for k, v in stats.items()})

    def jloss(pop, cc):
        return jnp.mean(pop.log_prob(jnp.asarray(x), conditional=cc, key=key, **kw)[0])

    jv, (jg_pop, jg_c) = jax.value_and_grad(jloss, argnums=(0, 1))(jpop, jnp.asarray(c))
    x_std = (jnp.asarray(x) - jpop.shift) / jpop.scale
    e = torch.as_tensor(np.asarray(jtrace.make_probes("hutchinson", key, x_std)[0]))

    tparams = _requires_grad(params)
    tstats = {k: torch.tensor(v, requires_grad=True) for k, v in stats.items()}
    pop = PopulationModelDiffusion(ScoreModel(tparams, cfg, VPSDE(), trace_mode="hutchinson"), **tstats)
    tc = torch.tensor(c, requires_grad=True)
    lp, st = pop.log_prob(torch.as_tensor(x), conditional=tc, probes=(e,), **kw)
    assert st is None
    loss = lp.mean()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)

    def close(g, jg):
        jg = np.asarray(jg, np.float64)
        assert np.linalg.norm(np.asarray(g, np.float64) - jg) <= 1e-3 * np.linalg.norm(jg), (g, jg)

    close(_flat_grads(tparams).numpy(), _jflat(jg_pop.score_model.params))
    for k in stats:
        assert float(tstats[k].grad.abs().sum()) > 0
        close(tstats[k].grad.numpy(), getattr(jg_pop, k))
    close(tc.grad.numpy(), jg_c)


@pytest.mark.parametrize("mode", ["hutchinson", "exact"])
def test_flagship_adjoint_gradient_matches_jax(mode):
    """The flagship gradient of -mean log_prob(adjoint=True) at 32 rows with
    the JAX probe against the JAX adjoint's on the same parameters: value
    within 1e-5 relative, gradient relative norm within 1e-3.  The Δlogp
    term's parameter gradient goes through the estimator's own derivative
    (a second derivative of the net)."""
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    jm = jckpt.load_npz(FLAGSHIP, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg,
                                              sde=JVESDE(), trace_mode=mode, use_fused_kernel=False))
    x = np.random.default_rng(22).standard_normal((32, 2)).astype(np.float32)
    key = jax.random.PRNGKey(23)
    kw = dict(atol=1e-5, rtol=1e-5)

    def jloss(p):
        return -jnp.mean(dataclasses.replace(jm, params=p).log_prob(jnp.asarray(x), key=key, adjoint=True, **kw)[0])

    jv, jg = jax.value_and_grad(jloss)(jm.params)
    probes = tuple(torch.as_tensor(np.asarray(p)) for p in jtrace.make_probes(mode, key, jnp.asarray(x)))
    params = _requires_grad(convert.params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu"))
    tm = ScoreModel(params, ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), VESDE(), trace_mode=mode)
    loss = -tm.log_prob(torch.as_tensor(x), probes=probes, adjoint=True, **kw)[0].mean()
    loss.backward()
    assert abs(float(loss) - float(jv)) <= 1e-5 * abs(float(jv))
    g, jgf = _flat_grads(params).numpy().astype(np.float64), _jflat(jg).astype(np.float64)
    assert np.linalg.norm(g - jgf) <= 1e-3 * np.linalg.norm(jgf), np.linalg.norm(g - jgf) / np.linalg.norm(jgf)
    # the divergence term carries its own gradient: without it the
    # gradient would be the prior term's alone
    prior_only = ScoreModel(_requires_grad(params), tm.net, tm.sde, trace_mode=mode)
    xT, _, _ = prior_only.solve_odes_forward(torch.as_tensor(x), probes=probes, adjoint=True, **kw)
    (-prior_only.sde.prior_log_prob(xT).sum(1).mean()).backward()
    assert np.linalg.norm(_flat_grads(prior_only.params).numpy() - g) > 1e-2 * np.linalg.norm(g)


def test_model_adjoint_rejects_xtrace():
    cfg = ScoreMLPConfig(n_dimensions=2, units=(16,))
    m = ScoreModel(init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, VPSDE(), trace_mode="xtrace")
    with pytest.raises(NotImplementedError, match="no gradient"):
        m.solve_odes_forward(torch.zeros(8, 2), generator=torch.Generator().manual_seed(1), adjoint=True)
