"""The port's training losses (``ops/losses.py`` and the four models'
``loss_fn``) against the JAX package's, on the CPU.

The two packages' random streams differ, so each test draws with the JAX
package's draw function and hands the same (t, z) / (x_T, t) / p0 to the
port by replacing the port's draw functions: the losses then agree within
rtol 1e-6 (float32 sums of the same terms).  The draw functions' own
conventions (t float32 in [epsilon, T], shapes, the generator's device,
reproducibility) are checked on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.flow import ODEFlow as JODEFlow
from flowfusion_tpu.models.population import PopulationModelDiffusion as JPop
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.models.symplectic import SymplecticFlowModel as JSym
from flowfusion_tpu.ops import losses as jlosses
from flowfusion_tpu.ops import sde as jsde
from flowfusion_torch.models import nets
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.models.symplectic import SymplecticFlowModel
from flowfusion_torch.ops import losses
from flowfusion_torch.ops import sde as tsde
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

SDES = {"ve": (jsde.VESDE(), tsde.VESDE()), "vp": (jsde.VPSDE(), tsde.VPSDE()),
        "subvp": (jsde.SUBVPSDE(), tsde.SUBVPSDE())}


def T(a):
    return torch.as_tensor(np.array(a))


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _inject_t_z(monkeypatch, jax_sde, key, x):
    """Replace the port's score-matching draw by the JAX draw at ``key``."""
    t, z = jlosses._draw_t_and_z(key, jax_sde, jnp.asarray(x))
    monkeypatch.setattr(losses, "_draw_t_and_z", lambda g, sde, xx: (T(t), T(z)))


def _inject_xT_t(monkeypatch, key, x0):
    xT, t = jlosses._draw_xT_and_t(key, jnp.asarray(x0))
    monkeypatch.setattr(losses, "_draw_xT_and_t", lambda g, xx: (T(xT), T(t)))


def _score_pair(C=0, units=(32, 32)):
    jcfg = jnets.ScoreMLPConfig(n_dimensions=3, n_conditionals=C, units=units)
    jp = jnets.init_score_mlp(jax.random.PRNGKey(0), jcfg)
    return jp, jcfg, to_torch(jp), nets.ScoreMLPConfig(n_dimensions=3, n_conditionals=C, units=units)


@pytest.mark.parametrize("sde_name", ["ve", "vp", "subvp"])
@pytest.mark.parametrize("loss", ["dsm", "lw"])
def test_score_matching_losses_match_jax_on_injected_draws(monkeypatch, sde_name, loss):
    jsd, tsd = SDES[sde_name]
    jp, jcfg, tp, tcfg = _score_pair(C=2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    c = rng.standard_normal((40, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jfn = jlosses.denoising_score_matching if loss == "dsm" else jlosses.log_prob_score_matching
    tfn = losses.denoising_score_matching if loss == "dsm" else losses.log_prob_score_matching

    def jscore(t, xx, cc):
        return jnets.apply_score_mlp(jcfg, jp, t, xx, cc) / jsd.sigma(t)[:, None]

    def tscore(t, xx, cc):
        return nets.apply_score_mlp(tcfg, tp, t, xx, cc) / tsd.sigma(t)[:, None]

    want = float(jfn(jscore, jsd, key, jnp.asarray(x), jnp.asarray(c)))
    _inject_t_z(monkeypatch, jsd, key, x)
    got = float(tfn(tscore, tsd, None, T(x), T(c)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_flow_matching_loss_matches_jax_on_injected_draws(monkeypatch):
    jcfg = jnets.VelocityMLPConfig(target_dimension=2, conditional_dimension=1, hidden_units=(32,))
    jp = jnets.init_velocity_mlp(jax.random.PRNGKey(2), jcfg)
    tcfg = nets.VelocityMLPConfig(target_dimension=2, conditional_dimension=1, hidden_units=(32,))
    tp = to_torch(jp)
    rng = np.random.default_rng(3)
    x0, c = (rng.standard_normal((33, n)).astype(np.float32) for n in (2, 1))
    key = jax.random.PRNGKey(8)
    want = float(jlosses.flow_matching_loss(
        lambda t, xx, cc: jnets.apply_velocity_mlp(jcfg, jp, t, xx, cc), key, jnp.asarray(x0), jnp.asarray(c)))
    _inject_xT_t(monkeypatch, key, x0)
    got = float(losses.flow_matching_loss(
        lambda t, xx, cc: nets.apply_velocity_mlp(tcfg, tp, t, xx, cc), None, T(x0), T(c)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("no_sigma", [False, True])
def test_score_model_loss_fn_matches_jax(monkeypatch, no_sigma):
    jp, jcfg, tp, tcfg = _score_pair()
    jm = JScoreModel(params=jp, net=jcfg, sde=jsde.VPSDE(), no_sigma=no_sigma)
    tm = ScoreModel(tp, tcfg, tsde.VPSDE(), no_sigma=no_sigma)
    x = np.random.default_rng(4).standard_normal((24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = float(jm.loss_fn(key, jnp.asarray(x)))
    _inject_t_z(monkeypatch, jm.sde, key, x)
    np.testing.assert_allclose(float(tm.loss_fn(None, T(x))), want, rtol=1e-6)


def test_population_loss_fn_standardizes_like_jax(monkeypatch):
    """The wrapper standardizes x and the conditional inside the loss."""
    rng = np.random.default_rng(5)
    x = (3.0 * rng.standard_normal((30, 2)) + 1.0).astype(np.float32)
    c = (2.0 * rng.standard_normal((30, 3)) - 1.0).astype(np.float32)
    stats = dict(shift=x.mean(0), scale=x.std(0), conditional_shift=c.mean(0), conditional_scale=c.std(0))
    jm = JPop.create(jax.random.PRNGKey(1), jsde.VESDE(), n_dimensions=2, n_conditionals=3, units=(32,),
                     **{k: jnp.asarray(v) for k, v in stats.items()})
    sm = jm.score_model
    tm = PopulationModelDiffusion(
        ScoreModel(to_torch(sm.params), nets.ScoreMLPConfig(n_dimensions=2, n_conditionals=3, units=(32,)),
                   tsde.VESDE()),
        *(T(stats[k]) for k in ("shift", "scale", "conditional_shift", "conditional_scale")),
    )
    key = jax.random.PRNGKey(10)
    want = float(jm.loss_fn(key, jnp.asarray(x), jnp.asarray(c)))
    _inject_t_z(monkeypatch, sm.sde, key, (x - stats["shift"]) / stats["scale"])
    np.testing.assert_allclose(float(tm.loss_fn(None, T(x), T(c))), want, rtol=1e-6)


def test_flow_model_loss_fn_matches_jax(monkeypatch):
    rng = np.random.default_rng(6)
    x = (0.5 * rng.standard_normal((28, 2)) + 1.0).astype(np.float32)
    c = rng.standard_normal((28, 1)).astype(np.float32)
    st = dict(target_shift=x.mean(0), target_scale=x.std(0), conditional_shift=c.mean(0),
              conditional_scale=c.std(0))
    jm = JODEFlow.create(jax.random.PRNGKey(3), target_dimension=2, conditional_dimension=1, hidden_units=(32,),
                         **{k: jnp.asarray(v) for k, v in st.items()})
    tm = ODEFlow(to_torch(jm.params), *(T(st[k]) for k in st), net=nets.VelocityMLPConfig(
        target_dimension=2, conditional_dimension=1, hidden_units=(32,)))
    key = jax.random.PRNGKey(11)
    want = float(jm.loss_fn(key, jnp.asarray(x), jnp.asarray(c)))
    assert float(jm.flow_matching_loss(key, jnp.asarray(x), jnp.asarray(c))) == want
    _inject_xT_t(monkeypatch, key, (x - st["target_shift"]) / st["target_scale"])
    np.testing.assert_allclose(float(tm.loss_fn(None, T(x), T(c))), want, rtol=1e-6)
    np.testing.assert_allclose(float(tm.flow_matching_loss(None, T(x), T(c))), want, rtol=1e-6)


def test_symplectic_loss_fn_draws_momentum_then_flow_matching(monkeypatch):
    rng = np.random.default_rng(7)
    x = (0.5 * rng.standard_normal((26, 2)) - 1.0).astype(np.float32)
    shift, scale = x.mean(0), x.std(0)
    jm = JSym.create(jax.random.PRNGKey(4), n_data_dims=2, units=(32,), shift=jnp.asarray(shift),
                     scale=jnp.asarray(scale))
    tm = SymplecticFlowModel(to_torch(jm.params), T(shift), T(scale), None, None,
                             nets.SymplecticMLPConfig(n_data_dims=2, units=(32,)))
    key = jax.random.PRNGKey(12)
    want = float(jm.loss_fn(key, jnp.asarray(x)))
    kq, k_fm = jax.random.split(key)
    q0 = (x - shift) / scale
    p0 = np.asarray(jax.random.normal(kq, q0.shape, jnp.float32))
    monkeypatch.setattr(losses, "_normal_like", lambda g, xx: T(p0))
    _inject_xT_t(monkeypatch, k_fm, np.concatenate([q0, p0], axis=-1))
    np.testing.assert_allclose(float(tm.loss_fn(None, T(x))), want, rtol=1e-6)


@pytest.mark.parametrize("sde_name", ["ve", "vp"])
def test_draw_conventions(sde_name):
    """t is float32 in [epsilon, T] with one value a row, z has x's shape
    and dtype; the same seed gives the same draws; the draws land on x's
    device from the generator's own."""
    sde = SDES[sde_name][1]
    x = torch.zeros(500, 3)
    t, z = losses._draw_t_and_z(torch.Generator().manual_seed(0), sde, x)
    t2, z2 = losses._draw_t_and_z(torch.Generator().manual_seed(0), sde, x)
    assert t.dtype == torch.float32 and t.shape == (500,) and z.shape == x.shape
    assert float(t.min()) >= sde.epsilon and float(t.max()) <= sde.T
    assert torch.equal(t, t2) and torch.equal(z, z2)
    xT, u = losses._draw_xT_and_t(torch.Generator().manual_seed(1), x)
    assert xT.shape == x.shape and u.shape == (500,) and 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(z.mean())) < 0.1 and abs(float(z.std()) - 1.0) < 0.1


def test_losses_are_differentiable_and_train_only_the_layers():
    """Autograd through a model's loss reaches the layers; the frozen W
    takes no part in training (it carries no grad request)."""
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(16,))
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    for lyr in params["layers"]:
        for a in lyr.values():
            a.requires_grad_(True)
    m = ScoreModel(params, cfg, tsde.VESDE())
    loss = m.loss_fn(torch.Generator().manual_seed(1), torch.randn(16, 2, generator=torch.Generator().manual_seed(2)))
    loss.backward()
    assert torch.isfinite(loss) and loss.ndim == 0
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for lyr in params["layers"] for a in lyr.values())
    assert params["W"].grad is None
