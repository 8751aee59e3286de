"""The examples' twins against the JAX package: each twin's evaluation stage
against the same steps written with the JAX package, on the same numpy
rows and on weights carried across with ``utils.convert.params_from_numpy``
(a seeded JAX init, or the committed flagship checkpoint).

Deterministic quantities agree to 1e-4 relative with equal NFE, the steps
pinned (``min_step = max_step``, or a [0.01, 0.1] window where the VE
field rejects the pinned step; ROADMAP queue 3 "Properties"): the exact
log_prob sum, the ODE samples from one base noise, the flow's samples and
exact sum, the symplectic sums with the momentum passed in, the
conditional twin's offset and scatter with the probes passed in, and the
serving twin's sampler artifact.  Stochastic ones (the Hutchinson, Hutch++
and XTrace sums with each package's own probes, the SDE moments) sit
within six standard errors of the two draws' difference, each standard
error from the draw's own per-row spread.  The MLE step on one batch is
deterministic: its loss agrees to 1e-4 and its adjoint gradient to 2e-2
(the JAX package's adjoint bar).
"""

import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flowfusion_tpu.models.flow import ODEFlow as JODEFlow
from flowfusion_tpu.models.population import PopulationModelDiffusion as JPop
from flowfusion_tpu.models.symplectic import SymplecticFlowModel as JSympl
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.ops.sde import VPSDE as JVPSDE
from flowfusion_tpu.utils.data import CONDITIONAL_POP as JPOP
from flowfusion_tpu.utils.data import REFERENCE_GMM as JGMM
from flowfusion_torch import VESDE, VPSDE, ODEFlow, PopulationModelDiffusion, SymplecticFlowModel
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = {"min_step": 0.05, "max_step": 0.05}
# the VE field at these tolerances rejects a 0.05 step: a window instead
WINDOW = {"min_step": 0.01, "max_step": 0.1}


def twin(name):
    path = os.path.join(ROOT, "examples", f"demo_{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"demo_{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def as_torch(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def rel(a, b):
    return abs(a - b) / abs(b)


def nfe(stats):
    return int(np.sum(np.asarray(stats.n_func_evals)))


def rows(seed, n, d, scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal((n, d))).astype(np.float32)


def bar(a, b):
    """Six standard errors of the difference of two sums of independent
    per-row draws, each from its own per-row spread."""
    return 6.0 * math.sqrt(len(a) * np.var(a) + len(b) * np.var(b))


@pytest.fixture(scope="module")
def diffusion_pair():
    shift, scale = np.array([0.2, -0.1], np.float32), np.array([2.0, 1.7], np.float32)
    jm = JPop.create(jax.random.PRNGKey(3), JVESDE(), n_dimensions=2, units=(128, 128, 128), shift=shift,
                     scale=scale, use_fused_kernel=False)
    tm = PopulationModelDiffusion.create(VESDE(), n_dimensions=2, units=(128, 128, 128), shift=shift,
                                         scale=scale, device="cpu")
    tm = dataclasses.replace(tm, score_model=dataclasses.replace(tm.score_model,
                                                                  params=as_torch(jm.score_model.params)))
    return jm, tm


def test_diffusion_likelihood_stage_against_jax(diffusion_pair):
    """The four trace modes at 1e-4, steps pinned: the exact sum and NFE
    equal to JAX's; the estimators' sums, each package drawing
    its own probes, within the bar of their per-row spreads about the
    exact density."""
    jm, tm = diffusion_pair
    x = rows(0, 128, 2, 3.0)
    report = twin("diffusion").likelihood_stage(tm, torch.as_tensor(x), 5, options=WINDOW)
    key = jax.random.PRNGKey(5)
    jlp = {}
    for mode in ("exact", "hutchinson", "hutchpp", "xtrace"):
        m = dataclasses.replace(jm, score_model=dataclasses.replace(
            jm.score_model, trace_mode=mode, hpp_rank=1, hpp_vecs=1, xt_vecs=2))
        lp, st = jax.jit(lambda mm, xx: mm.log_prob(xx, key=key, atol=1e-4, rtol=1e-4, volume_corrected=True,
                                                    options=WINDOW))(m, jnp.asarray(x))
        jlp[mode] = np.asarray(lp)
        if mode == "exact":  # the estimators' step counts follow their probes
            assert report["nfe"][mode] == nfe(st)
    assert rel(report["sum"]["exact"], float(jlp["exact"].sum())) <= 1e-4
    exact = report["lp"]["exact"].numpy()
    for mode in ("hutchinson", "hutchpp", "xtrace"):
        d_port, d_jax = report["lp"][mode].numpy() - exact, jlp[mode] - jlp["exact"]
        diff = abs(report["sum"][mode] - float(jlp[mode].sum()))
        assert diff <= bar(d_port, d_jax) + 1e-4 * abs(report["sum"]["exact"]), (mode, diff, bar(d_port, d_jax))
    assert report["truth"] == pytest.approx(float(np.sum(np.asarray(JGMM.log_prob(jnp.asarray(x))))), rel=1e-5)


def test_diffusion_sampling_stage_against_jax(diffusion_pair):
    """The ODE map of one base noise (steps pinned) to 1e-4 with JAX's NFE;
    the reverse-SDE moments, each package its own noise, within the bar."""
    jm, tm = diffusion_pair
    n = 512
    base = rows(1, n, 2, 1.0)
    out = twin("diffusion").sampling_stage(tm, n, torch.Generator().manual_seed(4), torch.as_tensor(base),
                                           options=WINDOW)
    js, jst = jax.jit(lambda m, b: m.forward(b, options=WINDOW))(jm, jnp.asarray(base))
    js = np.asarray(js)
    assert out["ode"]["nfe"] == nfe(jst)
    assert np.max(np.abs(out["samples_ode"].numpy() - js)) / np.max(np.abs(js)) <= 1e-4
    jsde = np.asarray(jax.jit(lambda m: m.sample_sde(jax.random.PRNGKey(4), (n, 2)))(jm))
    jmean, jstd = jsde.mean(0), jsde.std(0)
    for k in range(2):
        se = jstd[k] / math.sqrt(n)
        assert abs(out["sde"]["mean"][k] - jmean[k]) <= 6 * math.sqrt(2) * se, (k, out["sde"], jmean)
        assert abs(out["sde"]["std"][k] - jstd[k]) <= 6 * math.sqrt(2) * jstd[k] / math.sqrt(2 * n), (k, out["sde"])


def test_flow_evaluation_stage_against_jax():
    """The flow's samples from one base noise and its exact sum at 1e-4,
    steps pinned: 1e-4 relative, NFE equal."""
    shift, scale = np.array([0.3, 0.1], np.float32), np.array([2.2, 1.9], np.float32)
    jf = JODEFlow.create(jax.random.PRNGKey(2), target_dimension=2, hidden_units=(128, 128), target_shift=shift,
                         target_scale=scale, use_fused_kernel=False)
    tf = ODEFlow.create(target_dimension=2, hidden_units=(128, 128), target_shift=shift, target_scale=scale,
                        device="cpu")
    tf = dataclasses.replace(tf, params=as_torch(jf.params))
    xT, x = rows(2, 512, 2, 1.0), rows(3, 512, 2, 3.0)
    out = twin("flow").evaluation_stage(tf, torch.as_tensor(xT), torch.as_tensor(x), options=PINNED)
    js, jst = jax.jit(lambda f, z: f.sample(z, options=PINNED))(jf, jnp.asarray(xT))
    js = np.asarray(js)
    assert out["sample"]["nfe"] == nfe(jst)
    assert np.max(np.abs(out["samples"].numpy() - js)) / np.max(np.abs(js)) <= 1e-4
    jlp, jst = jax.jit(lambda f, xx: f.log_prob(xx, atol=1e-4, rtol=1e-4, options=PINNED))(jf, jnp.asarray(x))
    assert out["nfe"] == nfe(jst)
    assert rel(out["sum"], float(np.sum(np.asarray(jlp)))) <= 1e-4


def test_symplectic_likelihood_stage_against_jax():
    """The trace-free sums with one and 16 momentum draws, the momenta JAX
    draws from its key passed in: 1e-4 relative, NFE equal (steps
    pinned)."""
    shift, scale = np.array([0.2, 0.2], np.float32), np.array([1.1, 0.9], np.float32)
    jm = JSympl.create(jax.random.PRNGKey(4), n_data_dims=2, units=(128, 128), shift=shift, scale=scale,
                       use_fused_kernel=False)
    tm = SymplecticFlowModel.create(n_data_dims=2, units=(128, 128), shift=shift, scale=scale, device="cpu")
    tm = dataclasses.replace(tm, params=as_torch(jm.params))
    B = 128
    x = rows(5, B, 2, 1.0)
    key = jax.random.PRNGKey(5)
    momenta = tuple(torch.as_tensor(np.asarray(jax.random.normal(key, (K * B, 2), jnp.float32))) for K in (1, 16))
    out = twin("symplectic").likelihood_stage(tm, torch.as_tensor(x), 5, momenta=momenta, options=PINNED)
    for K in (1, 16):
        jlp, jst = jax.jit(lambda m, xx: m.log_prob(key, xx, n_momentum_samples=K, options=PINNED))(
            jm, jnp.asarray(x))
        assert out[f"k{K}"]["nfe"] == nfe(jst), K
        assert rel(out[f"k{K}"]["sum"], float(np.sum(np.asarray(jlp)))) <= 1e-4, K


def test_conditional_evaluation_stage_against_jax():
    """The sharded conditional density of the twin (padding, ``shard_batch``,
    ``data_parallel``) with JAX's Hutchinson probes passed in, steps pinned:
    the offset and scatter against the analytic truth to 1e-4, NFE equal."""
    theta_tr, c_tr = (np.asarray(a) for a in JPOP.sample(jax.random.PRNGKey(0), 2000))
    stats = [np.asarray(v, np.float32) for v in (theta_tr.mean(0), theta_tr.std(0, ddof=1), c_tr.mean(0),
                                                 c_tr.std(0, ddof=1))]
    jm = JPop.create(jax.random.PRNGKey(1), JVPSDE(), n_dimensions=6, n_conditionals=3, units=(128, 128, 128),
                     shift=stats[0], scale=stats[1], conditional_shift=stats[2], conditional_scale=stats[3],
                     no_sigma=True, trace_mode="hutchinson", kernel_compute_dtype="highf32", use_fused_kernel=False)
    tm = PopulationModelDiffusion.create(
        VPSDE(), n_dimensions=6, n_conditionals=3, units=(128, 128, 128), shift=stats[0], scale=stats[1],
        conditional_shift=stats[2], conditional_scale=stats[3], no_sigma=True, trace_mode="hutchinson",
        kernel_compute_dtype="highf32", device="cpu")
    tm = dataclasses.replace(tm, score_model=dataclasses.replace(tm.score_model,
                                                                  params=as_torch(jm.score_model.params)))
    theta, c = (np.asarray(a) for a in JPOP.sample(jax.random.PRNGKey(9), 129))
    mean, scale = (np.asarray(a) for a in JPOP.mean_scale(jnp.asarray(c)))
    key = jax.random.PRNGKey(3)
    opts = {"min_step": 0.02, "max_step": 0.02}
    (e,) = jtrace.make_probes("hutchinson", key, jnp.asarray(theta))
    mod = twin("conditional_population")
    out = mod.evaluation_stage(tm, *(torch.as_tensor(a) for a in (theta, c, mean, scale)), 3,
                               probes=torch.as_tensor(np.asarray(e)), options=opts)
    jlp, jst = jax.jit(lambda m, th, cc: m.log_prob(th, conditional=cc, key=key, atol=1e-5, rtol=1e-5,
                                                    volume_corrected=True, options={"controller": "pi", **opts}))(
        jm, jnp.asarray(theta), jnp.asarray(c))
    jlp = np.asarray(jlp)
    truth = mod.analytic_log_prob(*(torch.as_tensor(a) for a in (theta, mean, scale))).numpy()
    bias = float(np.mean(jlp - truth))
    rmse = float(np.sqrt(np.mean((jlp - truth - bias) ** 2)))
    assert out["nfe"] == nfe(jst) and out["n_devices"] == 1
    assert np.abs(out["lp"].numpy() - jlp).max() <= 1e-3
    assert rel(out["mean_offset"], bias) <= 1e-4 and rel(out["scatter"], rmse) <= 1e-4, (out, bias, rmse)


def test_likelihood_mle_step_against_jax():
    """One MLE step of the twin (``mle_step``: the adjoint gradient of the
    negative mean log-likelihood at 1e-3 under Adam) on the batch and
    weights of the JAX demo's step: the loss to 1e-4, the gradient to 2e-2
    of its norm, the Adam update's direction."""
    shift, scale = np.array([0.1, -0.2], np.float32), np.array([1.0, 0.8], np.float32)
    jf = JODEFlow.create(jax.random.PRNGKey(6), target_dimension=2, hidden_units=(128, 128), target_shift=shift,
                         target_scale=scale, use_fused_kernel=False)
    xb = rows(7, 256, 2, 1.0)

    def loss_fn(p):
        lp, _ = dataclasses.replace(jf, params=p).log_prob(jnp.asarray(xb), atol=1e-3, rtol=1e-3, adjoint=True)
        return -jnp.mean(lp)

    jnll, jgrad = jax.jit(jax.value_and_grad(loss_fn))(jf.params)
    tx = optax.adam(3e-5)
    updates, _ = tx.update(jgrad, tx.init(jf.params), jf.params)

    mod = twin("likelihood_training")
    tf = ODEFlow.create(target_dimension=2, hidden_units=(128, 128), target_shift=shift, target_scale=scale,
                        device="cpu")
    tf, leaves = mod.trainable(dataclasses.replace(tf, params=as_torch(jf.params)))
    before = [{k: v.detach().clone() for k, v in layer.items()} for layer in tf.params["layers"]]
    nll = mod.mle_step(tf, torch.optim.Adam(leaves, lr=3e-5), torch.as_tensor(xb))
    assert rel(nll, float(jnll)) <= 1e-4
    agree = []
    for i, layer in enumerate(tf.params["layers"]):
        for k in ("w", "b"):
            g, jg = layer[k].grad.numpy(), np.asarray(jgrad["layers"][i][k])
            assert np.linalg.norm(g - jg) <= 2e-2 * np.linalg.norm(jg), (i, k)
            moved = (layer[k].detach() - before[i][k]).numpy()
            agree.append(np.sign(moved) == np.sign(np.asarray(updates["layers"][i][k])))
    assert np.mean(np.concatenate([a.ravel() for a in agree])) >= 0.95


def test_serving_twin_against_jax(tmp_path):
    """The serving twin's own run (the committed flagship checkpoint, the
    default) to its end: its sampler artifact's 256 samples from seed 3
    against the JAX model's ODE map of the same base rows at the same
    tolerances (1e-4), every number finite, the served densities at the
    live model's (on the CPU the artifact's op runs the plain version of
    the folded operands, the eager call torch.func's jvp: the two solves
    agree to the tolerance's scale, 1e-3; on the card both launch the
    kernel and the script holds them to 1e-4)."""
    from flowfusion_tpu.models import nets as jnets
    from flowfusion_tpu.models.score import ScoreModel as JScoreModel
    from flowfusion_tpu.utils import checkpoint as jckpt

    mod = twin("serving")
    report = mod.main(["--device", "cpu", "--out", str(tmp_path / "lp.pt2")])
    assert all(math.isfinite(v) for v in (report["served_vs_live_max_abs"], report["fixed_mean"],
                                          *report["served_mean"].values(), *report["bucketed_mean"].values(),
                                          *report["sampler_mean"], *report["sampler_std"]))
    assert report["served_vs_live_max_abs"] <= 1e-3
    assert report["served_mean"][512] == report["bucketed_mean"][512] == report["fixed_mean"]
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    jm = jckpt.load_npz(mod.CKPT_PATH, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg),
                                                   net=cfg, sde=JVESDE(), use_fused_kernel=False))
    base = torch.randn((256, 2), generator=torch.Generator("cpu").manual_seed(3)).numpy()
    js = np.asarray(jax.jit(lambda m, b: m.sample_ode_from_base(b, atol=1e-4, rtol=1e-4)[0])(jm, jnp.asarray(base)))
    np.testing.assert_allclose(report["sampler_mean"], js.mean(0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(report["sampler_std"], js.std(0), rtol=1e-4, atol=1e-5)
