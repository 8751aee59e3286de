"""The port's main path as a whole, on the CPU, against the JAX package.

* Flagship ``ScoreModel.log_prob`` (committed weights, 512 rows), exact
  and Hutchinson with the same numpy probes, against the JAX plain path:
  identical solver counts and mean |dlogp| <= 1e-4, the JAX package's own
  fused-versus-plain bar (bench.py:323).  Single rows may differ more
  (max <= 1e-3): the first, tiny steps have error ratios near float32
  rounding, so the two solvers' step sizes differ in the last digits and
  the row-wise densities by a fraction of the solve's own 1e-4 tolerance.
* ``sample_ode_from_base`` (256 rows): identical counts, samples within
  1e-4 of their scale.
* ``PopulationModelDiffusion.log_prob`` on the conditional checkpoint
  (256 rows, Hutchinson, pinned step size), with and without
  ``volume_corrected``: |dlogp| <= 1e-4.
* Fixed-step ``log_prob`` (euler, rk4) against the JAX package's, and the
  reverse-SDE samplers on the flagship weights.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.models.nets import ScoreMLPConfig
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.sde import VESDE, VPSDE
from flowfusion_torch.utils import convert
from flowfusion_torch.utils.checkpoint import load_npz

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
FLAGSHIP = os.path.join(BENCH, "flagship_ckpt.npz")
CONDITIONAL = os.path.join(BENCH, "conditional_ckpt.npz")


@pytest.fixture(scope="module")
def flagship():
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    jm = jckpt.load_npz(
        FLAGSHIP,
        JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg, sde=JVESDE()),
    )
    params = convert.params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu")
    tm = ScoreModel(params, ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), VESDE())
    return jm, tm


def _stats(st):
    return tuple(int(v) for v in st[:3])


@pytest.mark.parametrize("mode", ["exact", "hutchinson"])
def test_flagship_log_prob_matches_jax(flagship, mode):
    jm, tm = flagship
    jm = dataclasses.replace(jm, trace_mode=mode, use_fused_kernel=False)
    tm = dataclasses.replace(tm, trace_mode=mode)
    x = np.random.default_rng(0).standard_normal((512, 2)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    # jit pins the JAX call to one unsharded solve (its eager route shards
    # the batch over the test mesh's 8 devices)
    jlp, jst = jax.jit(lambda m, xx: m.log_prob(xx, key=key))(jm, jnp.asarray(x))
    probes = tuple(torch.as_tensor(np.asarray(p)) for p in jtrace.make_probes(mode, key, jnp.asarray(x)))
    lp, st = tm.log_prob(torch.as_tensor(x), probes=probes)
    assert _stats(st) == _stats(jst)
    err = np.abs(lp.numpy() - np.asarray(jlp))
    assert err.mean() <= 1e-4 and err.max() <= 1e-3, (err.mean(), err.max())

    # use_fused_kernel=True on CPU tensors runs the wrapper's plain version:
    # the same solve as the plain torch path
    lp_f, st_f = dataclasses.replace(tm, use_fused_kernel=True).log_prob(
        torch.as_tensor(x), probes=probes
    )
    assert _stats(st_f) == _stats(st)
    assert float((lp_f - lp).abs().mean()) <= 1e-4


def test_flagship_sample_ode_from_base_matches_jax(flagship):
    jm, tm = flagship
    jm = dataclasses.replace(jm, use_fused_kernel=False)
    z = np.random.default_rng(2).standard_normal((256, 2)).astype(np.float32)
    js, jst = jax.jit(lambda m, zz: m.sample_ode_from_base(zz))(jm, jnp.asarray(z))
    s, st = tm.sample_ode_from_base(torch.as_tensor(z))
    assert _stats(st) == _stats(jst)
    ref = np.asarray(js)
    assert np.max(np.abs(s.numpy() - ref)) / np.max(np.abs(ref)) <= 1e-4


@pytest.mark.parametrize("volume_corrected", [False, True])
def test_conditional_population_log_prob_matches_jax(volume_corrected):
    """The wrapper (standardization, conditional statistics, volume term,
    options) on the conditional checkpoint.  The step size is pinned
    (min_step = max_step, every step accepted): this VP-SDE field cancels
    ~100x in its drift near t = 1, where float32 rounding moves adaptive
    step sizes, and the solve's own truncation error on it is ~2.6e-3
    (tests/test_checkpoint_quality.py) — far above the 1e-4 bar."""
    from benchmarks.make_conditional_ckpt import load_conditional_model
    from flowfusion_tpu.utils.data import CONDITIONAL_POP as JPOP

    jmodel = load_conditional_model()[0]
    jmodel = dataclasses.replace(
        jmodel, score_model=dataclasses.replace(jmodel.score_model, use_fused_kernel=False)
    )
    model, extra = PopulationModelDiffusion.from_conditional_npz(CONDITIONAL, device="cpu")
    assert model.score_model.net.units == (128, 128, 128) and extra["family"] == "conditional_population"
    theta, c = (np.asarray(a) for a in JPOP.sample(jax.random.PRNGKey(9), 256))
    key = jax.random.PRNGKey(4)
    opts = {"min_step": 0.02, "max_step": 0.02}
    jlp, jst = jax.jit(
        lambda m, th, cc: m.log_prob(
            th, conditional=cc, key=key, atol=1e-2, rtol=1e-2,
            volume_corrected=volume_corrected, options=opts,
        )
    )(jmodel, jnp.asarray(theta), jnp.asarray(c))
    (e,) = jtrace.make_probes("hutchinson", key, jnp.asarray(theta))
    lp, st = model.log_prob(
        torch.as_tensor(theta), conditional=torch.as_tensor(c),
        probes=(torch.as_tensor(np.asarray(e)),), atol=1e-2, rtol=1e-2,
        volume_corrected=volume_corrected, options=opts,
    )
    assert _stats(st) == _stats(jst) and st.n_rejected == 0
    err = np.abs(lp.numpy() - np.asarray(jlp))
    assert err.mean() <= 1e-4 and err.max() <= 1e-4, (err.mean(), err.max())


@pytest.mark.parametrize("method,steps", [("euler", 24), ("rk4", 6)])
def test_flagship_fixed_step_log_prob_matches_jax(flagship, method, steps):
    """The fixed-step solvers under ``log_prob`` (no min_step option for
    them, as in the JAX package): the same float32 grid, so the densities
    agree to float32 rounding of the RHS."""
    jm, tm = flagship
    jm = dataclasses.replace(jm, use_fused_kernel=False)
    x = np.random.default_rng(3).standard_normal((256, 2)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    opts = {"steps": steps}
    jlp, jst = jax.jit(lambda m, xx: m.log_prob(xx, key=key, method=method, options=opts))(jm, jnp.asarray(x))
    lp, st = tm.log_prob(torch.as_tensor(x), method=method, options=opts)
    assert st is None and jst is None
    err = np.abs(lp.numpy() - np.asarray(jlp))
    assert err.mean() <= 1e-4 and err.max() <= 1e-3, (err.mean(), err.max())
    # the default options of a fixed-step log_prob carry no min_step
    lp1, _ = tm.log_prob(torch.as_tensor(x[:8]), method=method)
    assert torch.isfinite(lp1).all()


def test_flagship_reverse_sde_samplers(flagship):
    """sample_sde, sample_pc and sample_sde_fused on the flagship weights
    (CPU: the plain drift and the EM kernel's plain version) draw the same
    distribution: first two moments within the on-card bars
    (tests/test_tpu_numerics.py:137-138) at 3,000 rows."""
    _, tm = flagship
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = tm.sample_sde((3000, 2), steps=60, generator=g(0))
    b = tm.sample_sde_fused((3000, 2), steps=60, generator=g(1))
    c = tm.sample_pc((3000, 2), steps=60, corrector_steps=1, generator=g(2))
    for res in (a, b, c):
        assert res.x_mean.shape == (3000, 2) and not bool(res.nan_encountered)
        assert float((res.x_mean.mean(0) - a.x_mean.mean(0)).abs().max()) <= 0.08
        assert float((torch.cov(res.x_mean.T) - torch.cov(a.x_mean.T)).abs().max()) <= 0.12
    # the same generator seed draws the same samples
    torch.testing.assert_close(tm.sample_sde((64, 2), steps=5, generator=g(3)).x,
                               tm.sample_sde((64, 2), steps=5, generator=g(3)).x, rtol=0, atol=0)


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PopulationModelDiffusion.create(VESDE())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy(load_npz(FLAGSHIP)["params"])
    with pytest.raises(RuntimeError, match="CUDA"):
        PopulationModelDiffusion.from_conditional_npz(CONDITIONAL)
    # an explicit CPU request runs
    m = PopulationModelDiffusion.create(VESDE(), units=(16,), device="cpu")
    assert m.shift.device.type == "cpu"


def test_refusals_name_their_roadmap_item(flagship):
    """The remaining refusals name their ROADMAP.md item; the solvers of
    item 13 run (tests/test_torch_adjoint.py, test_torch_dpm.py and
    test_torch_per_sample.py hold them against the JAX package)."""
    _, tm = flagship
    x = torch.randn(4, 2, generator=torch.Generator().manual_seed(3))
    # XTrace has no gradient: its adjoint refuses with the JAX package's reason
    with pytest.raises(NotImplementedError, match="no gradient"):
        dataclasses.replace(tm, trace_mode="xtrace").log_prob(x, adjoint=True)
    # Hutch++ and the exact trace differentiate through the adjoint
    for mode, probes in (("hutchpp", (torch.ones(1, 4, 2), torch.ones(1, 4, 2))), ("exact", ())):
        params = {"W": tm.params["W"], "layers": [{k: v.clone().requires_grad_(True) for k, v in l.items()}
                                                  for l in tm.params["layers"]]}
        m = dataclasses.replace(tm, params=params, trace_mode=mode)
        lp, st = m.log_prob(x, probes=probes, adjoint=True)
        assert st is None and lp.shape == (4,)
        lp.sum().backward()
        assert all(torch.isfinite(l["w"].grad).all() and l["w"].grad.abs().sum() > 0 for l in params["layers"])
    s_adj, st = tm.sample_ode_from_base(x, adjoint=True)
    assert st is None and torch.isfinite(s_adj).all()
    assert tm.sample_dpm(x, steps=4).shape == (4, 2)
    lp_ps, st_ps = tm.log_prob_per_sample(x)
    assert lp_ps.shape == (4,) and st_ps.n_func_evals.shape == (4,) and bool(st_ps.succeeded.all())
    with pytest.raises(NotImplementedError, match="batch-coupled"):
        dataclasses.replace(tm, trace_mode="hutchpp").log_prob_per_sample(x)
    # highf32 and bfloat16 are ported; an unknown compute mode raises
    assert dataclasses.replace(tm, kernel_compute_dtype="highf32").kernel_compute_dtype == "highf32"
    assert dataclasses.replace(tm, kernel_compute_dtype="bfloat16").kernel_compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="unknown"):
        dataclasses.replace(tm, kernel_compute_dtype="float16")
    with pytest.raises(NotImplementedError, match="item 14"):
        tm.sample_sde((4, 2), steps=2, progress=True)
    # the EM kernel's bfloat16 mode runs (its plain version on the CPU)
    res = tm.sample_sde_fused((4, 2), steps=2, compute_dtype="bfloat16")
    assert res.x.shape == (4, 2) and not bool(res.nan_encountered)
    # training is ported: the loss draws from the generator and is finite
    loss = tm.loss_fn(torch.Generator().manual_seed(0), torch.randn(8, 2, generator=torch.Generator().manual_seed(1)))
    assert loss.ndim == 0 and torch.isfinite(loss)
    # an explicit kernel request outside the envelope raises, never falls
    # back: 16 exact-trace chains of width 1024 overflow shared memory
    wide = ScoreModel(
        tm.params, ScoreMLPConfig(n_dimensions=16, units=(1024, 1024, 1024)), VESDE(),
        use_fused_kernel=True,
    )
    with pytest.raises(ValueError, match="envelope"):
        wide.solve_odes_forward(torch.zeros(4, 16))
    # the model and its inputs must share a device
    with pytest.raises(ValueError, match="parameters are on"):
        tm.log_prob(torch.zeros(4, 2, device="meta"))


def test_auto_dispatch_on_cuda_launches_or_raises(flagship):
    """Auto dispatch (use_fused_kernel=None) takes the kernel for CUDA
    tensors whenever the kernel's shared-memory plan fits, and raises
    otherwise: it never gives way to the plain path on the card.  A stand-in
    with ``is_cuda`` set plays the CUDA tensor."""
    _, tm = flagship
    on_card = types.SimpleNamespace(is_cuda=True)
    for mode in ("forward", "hutchinson", "exact"):
        assert tm._fused_available(on_card, mode) is True
        assert tm._fused_available(torch.zeros(1, 2), mode) is False
    # 17 exact-trace features at H=128 fit (4 rows a block)
    d17 = dataclasses.replace(tm, net=ScoreMLPConfig(n_dimensions=17, units=(128, 128, 128)))
    assert d17._fused_available(on_card, "exact") is True
    big = dataclasses.replace(tm, net=ScoreMLPConfig(n_dimensions=16, units=(1024, 1024, 1024)))
    assert big._fused_available(on_card, "hutchinson") is True
    with pytest.raises(ValueError, match="use_fused_kernel=False"):
        big._fused_available(on_card, "exact")
    assert dataclasses.replace(big, use_fused_kernel=False)._fused_available(on_card, "exact") is False
    assert big._fused_available(torch.zeros(1, 16), "exact") is False


def test_population_create_and_forward_cpu():
    g = torch.Generator().manual_seed(0)
    m = PopulationModelDiffusion.create(
        VPSDE(), n_dimensions=2, n_conditionals=1, units=(32, 32), shift=[1.0, 2.0],
        scale=[2.0, 0.5], conditional_shift=[0.0], conditional_scale=[1.0],
        generator=g, device="cpu", trace_mode="hutchinson",
    )
    z = torch.randn(16, 2, generator=g)
    c = torch.zeros(16, 1)
    x, st = m.forward(z, conditional=c)
    assert x.shape == (16, 2) and torch.isfinite(x).all() and st.succeeded
    lp, _ = m.log_prob(x, conditional=c, generator=torch.Generator().manual_seed(1))
    lp_v, _ = m.log_prob(x, conditional=c, generator=torch.Generator().manual_seed(1),
                         volume_corrected=True)
    np.testing.assert_allclose((lp - lp_v).numpy(), np.log(2.0 * 0.5), rtol=1e-5, atol=1e-6)
