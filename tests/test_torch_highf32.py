"""Compute mode ``highf32`` of the port's RHS kernel, on the CPU.

The mode splits every fp32 operand of a layer product into TF32 halves and
sums hi hi + hi lo + lo hi (``tf32x3_matmul``), the port's counterpart of
the JAX package's 3-pass bf16 split (``bf16_3pass_dot_general``), and takes
SiLU through the tanh-form sigmoid.  On CPU tensors the wrappers run their
plain versions in the mode; the CUDA kernel is held against them by
``tests/test_torch_gpu.py`` on the card.

Bars.  Each package within its own bar of its own strict path, the JAX
package's ``highf32`` bars (tests/test_kernels.py:803-822, :884-921):
forward and hutchinson 1e-5 of the max magnitude, exact and tangents 5e-5
(drift) and 5e-4 (divergence, J v).  The two packages' ``highf32`` outputs
within the sum of the two bars (their splits differ: TF32 halves here,
bf16 halves there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.kernels import fused_mlp as jfm
from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.flow import ODEFlow as JODEFlow
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.sde import VPSDE as JVPSDE
from flowfusion_torch import train
from flowfusion_torch.kernels import em_sampler, fused_mlp, fused_sketch, fused_train
from flowfusion_torch.models import nets
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.models.symplectic import SymplecticFlowModel
from flowfusion_torch.ops.sde import VESDE, VPSDE
from flowfusion_torch.utils.convert import params_from_numpy
from flowfusion_torch.utils.data import DEMO_GMM
from flowfusion_torch.utils.tree import leaves_with_paths

torch.set_num_threads(1)

# (drift, divergence or J v) bars of a highf32 output against its strict path
BARS = {"forward": (1e-5, None), "hutchinson": (1e-5, 1e-5), "exact": (5e-5, 5e-4), "tangents": (5e-5, 5e-4)}


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _check_pair(kind, port_hf, port_32, jax_hf, jax_32):
    """Each package's highf32 output within its bar of its strict one, and
    the two highf32 outputs within the sum of the bars."""
    for i, bar in enumerate(BARS[kind]):
        if bar is None:
            continue
        p_hf, p_32, j_hf, j_32 = (_np(v[i]) for v in (port_hf, port_32, jax_hf, jax_32))
        assert _rel(p_hf, p_32) <= bar, (kind, i, _rel(p_hf, p_32))
        assert _rel(j_hf, j_32) <= bar, (kind, i, _rel(j_hf, j_32))
        assert _rel(p_hf, j_hf) <= 2 * bar, (kind, i, _rel(p_hf, j_hf))


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

ULP = 2.0**-10  # of a TF32 value in [1, 2)


@pytest.mark.parametrize("value,expected", [
    (1.0 + ULP / 2, 1.0 + ULP),  # a tie rounds away from zero
    (-(1.0 + ULP / 2), -(1.0 + ULP)),
    (1.0 + 3 * ULP / 2, 1.0 + 2 * ULP),  # a tie away from zero, not to even
    (1.0 + ULP / 2 - 2.0**-23, 1.0),  # below the tie rounds down
    (1.0 + ULP / 2 + 2.0**-23, 1.0 + ULP),
    (-3.0 - 0.75 * 2 * ULP, -3.0 - 2 * ULP),  # negative, above the tie in magnitude
    (1.5, 1.5),  # exactly representable values stay
    (-0.0, -0.0),
    (2.0**-130, 2.0**-130),  # a subnormal with its bits above the cut
    (float("inf"), float("inf")),
    (float("-inf"), float("-inf")),
])
def test_tf32_round_known_answers(value, expected):
    out = fused_mlp.tf32_round(torch.tensor([value], dtype=torch.float32))
    want = torch.tensor([expected], dtype=torch.float32)
    assert torch.equal(out, want) and torch.signbit(out) == torch.signbit(want), (value, out.item())


def test_tf32_round_keeps_nan_and_clears_low_bits():
    x = torch.randn(4096, generator=gen(0)) * torch.exp(torch.randn(4096, generator=gen(1)) * 8)
    bits = fused_mlp.tf32_round(x).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    # round to nearest: within half a TF32 ulp of the input
    err = (fused_mlp.tf32_round(x).double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0**-11).all())
    assert torch.isnan(fused_mlp.tf32_round(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("shape", [(64, 128, 32), (7, 40, 3)])
def test_tf32x3_matmul_error_bound(shape):
    m, k, n = shape
    rng = np.random.default_rng(m)
    A = torch.as_tensor(rng.standard_normal((m, k)).astype(np.float32))
    B = torch.as_tensor((rng.standard_normal((k, n)) * np.exp(rng.standard_normal((k, n)))).astype(np.float32))
    exact = A.double() @ B.double()
    scale = A.double().abs() @ B.double().abs()
    err3 = (fused_mlp.tf32x3_matmul(A, B).double() - exact).abs()
    assert bool((err3 <= 2.0**-19 * scale).all()), float((err3 / scale).max())
    # a single TF32 pass on the same operands is far coarser: the trap the
    # split exists to avoid
    err1 = (fused_mlp.tf32_round(A).double() @ fused_mlp.tf32_round(B).double() - exact).abs()
    assert float(err1.max()) >= 100 * float(err3.max())


def test_apply_float32_unchanged_and_ops_taken():
    """The nets' forwards give bitwise their float32 output without ops,
    and take the split and the activation when handed them."""
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(32, 32))
    params = nets.init_score_mlp(cfg, gen(0), "cpu")
    x = torch.randn(16, 2, generator=gen(1))
    h = torch.cat([nets.fourier_time_embedding(torch.full((16,), 0.3), params["W"]), x], -1)
    manual = h
    for i, layer in enumerate(params["layers"]):
        manual = manual @ layer["w"] + layer["b"]
        if i < len(params["layers"]) - 1:
            manual = torch.nn.functional.silu(manual)
    assert torch.equal(nets.apply_score_mlp(cfg, params, 0.3, x), manual)
    calls = []

    def mm(a, b):
        calls.append(a.shape)
        return a @ b

    nets.apply_score_mlp(cfg, params, 0.3, x, matmul=mm)
    assert len(calls) == 2  # every layer after the first


# ---------------------------------------------------------------------------
# the wrappers' plain versions against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------


def _score_pair(d=2, c=0, units=(128, 128), activation="silu"):
    jcfg = jnets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units, activation=activation)
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(0), jcfg)
    cfg = nets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units, activation=activation)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _inputs(B, d, c=0, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    cond = rng.standard_normal((B, c)).astype(np.float32) if c else None
    return x, cond, np.sign(rng.standard_normal((B, d))).astype(np.float32)


def _both_dtypes(fn):
    return [fn(dt) for dt in ("highf32", "float32")]


@pytest.mark.parametrize("activation", ["silu", "tanh"])
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_fused_drift_matches_jax_highf32(mode, activation):
    jcfg, jparams, cfg, params = _score_pair(d=3, c=2, activation=activation)
    x, cond, e = _inputs(32, 3, 2)
    kw_j = {"e": jnp.asarray(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    kw_t = {"e": torch.as_tensor(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}

    def port(dt):
        out = fused_mlp.fused_drift(params, cfg, torch.tensor(0.37), torch.as_tensor(x), torch.as_tensor(cond),
                                    c0=-0.3, c1=0.9, compute_dtype=dt, **kw_t)
        return out if isinstance(out, tuple) else (out,)

    def ref(dt):
        out = jfm.fused_drift(jparams, jcfg, jnp.float32(0.37), jnp.asarray(x), jnp.asarray(cond), c0=-0.3, c1=0.9,
                              interpret=True, tile=32, compute_dtype=dt, **kw_j)
        return out if isinstance(out, tuple) else (out,)

    _check_pair(mode, *_both_dtypes(port), *_both_dtypes(ref))


def test_wide_input_projection_takes_the_split():
    """More than 16 [x | cond] features: the input projection takes the
    split too (the JAX kernel's MXU side of its rank-1 crossover)."""
    jcfg, jparams, cfg, params = _score_pair(d=2, c=18, units=(64, 64))
    x, cond, e = _inputs(32, 2, 18)
    out = [fused_mlp.fused_drift(params, cfg, 0.37, torch.as_tensor(x), torch.as_tensor(cond), e=torch.as_tensor(e),
                                 c0=-0.3, c1=0.9, compute_dtype=dt) for dt in ("highf32", "float32")]
    ref = [jfm.fused_drift(jparams, jcfg, jnp.float32(0.37), jnp.asarray(x), jnp.asarray(cond), e=jnp.asarray(e),
                           c0=-0.3, c1=0.9, interpret=True, tile=32, compute_dtype=dt) for dt in ("highf32", "float32")]
    _check_pair("hutchinson", *out, *ref)
    assert "in_matmul" in fused_mlp._net_ops("highf32", "silu", 20)
    assert "in_matmul" not in fused_mlp._net_ops("highf32", "silu", 16)


@pytest.mark.parametrize("family", ["drift", "velocity"])
def test_tangents_match_jax_highf32(family):
    x, cond, _ = _inputs(32, 2)
    V = np.random.default_rng(3).standard_normal((3, 32, 2)).astype(np.float32)
    if family == "drift":
        jcfg, jparams, cfg, params = _score_pair()

        def port(dt):
            return fused_mlp.fused_drift_tangents(params, cfg, 0.37, torch.as_tensor(x), torch.as_tensor(V),
                                                  c0=-0.3, c1=0.9, compute_dtype=dt)

        def ref(dt):
            return jfm.fused_drift_tangents(jparams, jcfg, jnp.float32(0.37), jnp.asarray(x), jnp.asarray(V),
                                            c0=-0.3, c1=0.9, interpret=True, tile=32, compute_dtype=dt)
    else:
        jflow = JODEFlow.create(jax.random.PRNGKey(0), target_dimension=2, hidden_units=(128, 128))
        cfg = nets.VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128))
        params = params_from_numpy(jax.tree.map(np.asarray, jflow.params), "cpu")

        def port(dt):
            return fused_mlp.fused_velocity_tangents(params, cfg, 0.37, torch.as_tensor(x), torch.as_tensor(V),
                                                     compute_dtype=dt)

        def ref(dt):
            return jfm.fused_velocity_tangents(jflow.params, jflow.net, jnp.float32(0.37), jnp.asarray(x),
                                               jnp.asarray(V), interpret=True, tile=32, compute_dtype=dt)

    def flat(out):  # (drift cols, [J v cols]) -> (drift, stacked J v)
        drift, cols = out
        return drift, (torch.stack(list(cols)) if isinstance(drift, torch.Tensor) else jnp.stack(list(cols)))

    _check_pair("tangents", *(flat(o) for o in _both_dtypes(port)), *(flat(o) for o in _both_dtypes(ref)))


@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_fused_velocity_matches_jax_highf32(mode):
    jflow = JODEFlow.create(jax.random.PRNGKey(0), target_dimension=2, hidden_units=(128, 128))
    cfg = nets.VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128))
    params = params_from_numpy(jax.tree.map(np.asarray, jflow.params), "cpu")
    x, _, e = _inputs(32, 2)
    kw_j = {"e": jnp.asarray(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    kw_t = {"e": torch.as_tensor(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}

    def port(dt):
        out = fused_mlp.fused_velocity(params, cfg, 0.37, torch.as_tensor(x), compute_dtype=dt, **kw_t)
        return out if isinstance(out, tuple) else (out,)

    def ref(dt):
        out = jfm.fused_velocity(jflow.params, jflow.net, jnp.float32(0.37), jnp.asarray(x), interpret=True,
                                 tile=32, compute_dtype=dt, **kw_j)
        return out if isinstance(out, tuple) else (out,)

    _check_pair(mode, *_both_dtypes(port), *_both_dtypes(ref))


@pytest.mark.parametrize("C", [0, 3])
def test_fused_symplectic_velocity_matches_jax_highf32(C):
    jcfg = jnets.SymplecticMLPConfig(n_data_dims=2, n_conditionals=C, units=(96, 96))
    jparams = jnets.init_symplectic_mlp(jax.random.PRNGKey(C), jcfg)
    cfg = nets.SymplecticMLPConfig(n_data_dims=2, n_conditionals=C, units=(96, 96))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(4)
    state = rng.standard_normal((32, 4)).astype(np.float32)
    cond = rng.standard_normal((32, C)).astype(np.float32) if C else None

    def port(dt):
        return (fused_mlp.fused_symplectic_velocity(params, cfg, 0.37, torch.as_tensor(state),
                                                    None if cond is None else torch.as_tensor(cond), compute_dtype=dt),)

    def ref(dt):
        return (jfm.fused_symplectic_velocity(jparams, jcfg, jnp.float32(0.37), jnp.asarray(state),
                                              None if cond is None else jnp.asarray(cond), interpret=True, tile=32,
                                              compute_dtype=dt),)

    _check_pair("forward", *_both_dtypes(port), *_both_dtypes(ref))


def test_highf32_pads_hidden_widths_to_eight():
    cfg = nets.ScoreMLPConfig(n_dimensions=3, units=(100, 100))
    params = nets.init_score_mlp(cfg, gen(2), "cpu")
    assert fused_mlp.supports_config((100, 100)) and not fused_mlp.supports_config((100, 100), "silu", "highf32")
    assert fused_mlp.pad_to_lanes(params, cfg)[1].units == (100, 100)
    padded, pcfg = fused_mlp.pad_to_lanes(params, cfg, "highf32")
    assert pcfg.units == (104, 104) and padded["layers"][1]["w"].shape == (104, 104)
    x = torch.randn(16, 3, generator=gen(3))
    e = torch.sign(torch.randn(16, 3, generator=gen(4)))
    # the padding is exact: the padded net computes what the unpadded one does
    a = fused_mlp.fused_drift_reference(params, cfg, 0.2, x, e=e, compute_dtype="highf32")
    b = fused_mlp.fused_drift_reference(padded, pcfg, 0.2, x, e=e, compute_dtype="highf32")
    assert all(_rel(u, v) <= 1e-6 for u, v in zip(a, b))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def test_score_model_log_prob_highf32():
    """ScoreModel(kernel_compute_dtype='highf32', use_fused_kernel=True) on
    the CPU (the wrapper's highf32 plain version): near its float32 twin at
    the bar of the JAX package's test_highf32_solver_path_runs, and near the
    JAX highf32 solve with the same probes."""
    jcfg, jparams, cfg, params = _score_pair(units=(128,))
    x = np.random.default_rng(5).standard_normal((32, 2)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jm = JScoreModel(params=jparams, net=jcfg, sde=JVPSDE(), trace_mode="hutchinson", use_fused_kernel=True,
                     kernel_compute_dtype="highf32")
    jlp, _ = jax.jit(lambda m, xx: m.log_prob(xx, key=key, atol=1e-4, rtol=1e-4))(jm, jnp.asarray(x))
    probes = tuple(torch.as_tensor(np.asarray(p)) for p in jtrace.make_probes("hutchinson", key, jnp.asarray(x)))
    m32 = ScoreModel(params, cfg, VPSDE(), trace_mode="hutchinson", use_fused_kernel=True)
    mhf = dataclasses.replace(m32, kernel_compute_dtype="highf32")
    lp32, _ = m32.log_prob(torch.as_tensor(x), probes=probes, atol=1e-4, rtol=1e-4)
    lphf, st = mhf.log_prob(torch.as_tensor(x), probes=probes, atol=1e-4, rtol=1e-4)
    assert st.succeeded
    np.testing.assert_allclose(lphf.numpy(), lp32.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(lphf.numpy(), np.asarray(jlp), rtol=1e-4, atol=1e-3)


def test_conditional_checkpoint_served_in_highf32():
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                        "conditional_ckpt.npz")
    model, _ = PopulationModelDiffusion.from_conditional_npz(path, device="cpu")
    assert model.score_model.kernel_compute_dtype == "highf32"
    assert model.score_model.trace_mode == "hutchinson"


@pytest.mark.parametrize("family", ["score", "flow", "symplectic"])
def test_fit_trains_a_highf32_model_in_float32(family):
    """fit passes no compute dtype to the training kernel, in either
    package (the JAX package's train.py:798-820): a highf32 model, and a
    bfloat16 one, trains on the float32 kernel's arithmetic (bitwise its
    float32 twin's run) and keeps its serving mode."""
    x = DEMO_GMM.sample(gen(1), 128, device="cpu")
    if family == "score":
        cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(32, 32))
        m32 = ScoreModel(nets.init_score_mlp(cfg, gen(0), "cpu"), cfg, VESDE())
    elif family == "flow":
        m32 = ODEFlow.create(target_dimension=2, hidden_units=(32, 32), generator=gen(0), device="cpu")
    else:
        m32 = SymplecticFlowModel.create(units=(32, 32), generator=gen(0), device="cpu")
    kw = dict(stages=[(32, 1e-3)], epochs_per_stage=2, ema_decay=0.9, engine="fused")
    fit32, r32 = train.fit(m32, gen(5), x, **kw)
    for mode in ("highf32", "bfloat16"):
        mhf = dataclasses.replace(m32, kernel_compute_dtype=mode)
        fithf, rhf = train.fit(mhf, gen(5), x, **kw)
        assert fithf.kernel_compute_dtype == mode
        assert np.array_equal(r32[0].train_losses, rhf[0].train_losses)
        for (_, a), (_, b) in zip(leaves_with_paths(fit32), leaves_with_paths(fithf)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


def test_bfloat16_refused_everywhere_naming_3b():
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(16,))
    params = nets.init_score_mlp(cfg, gen(0), "cpu")
    vcfg = nets.VelocityMLPConfig(target_dimension=2, hidden_units=(16,))
    vparams = nets.init_velocity_mlp(vcfg, gen(0), "cpu")
    scfg = nets.SymplecticMLPConfig(units=(16,))
    sparams = nets.init_symplectic_mlp(scfg, gen(0), "cpu")
    x = torch.zeros(4, 2)
    V = torch.zeros(1, 4, 2)
    calls = [
        lambda dt: fused_mlp.fused_drift(params, cfg, 0.5, x, compute_dtype=dt),
        lambda dt: fused_mlp.fused_velocity(vparams, vcfg, 0.5, x, compute_dtype=dt),
        lambda dt: fused_mlp.fused_drift_tangents(params, cfg, 0.5, x, V, compute_dtype=dt),
        lambda dt: fused_mlp.fused_velocity_tangents(vparams, vcfg, 0.5, x, V, compute_dtype=dt),
        lambda dt: fused_mlp.fused_symplectic_velocity(sparams, scfg, 0.5, torch.zeros(4, 4), compute_dtype=dt),
        lambda dt: fused_sketch.fused_drift_sketch(params, cfg, 0.5, x, (V,), "xtrace", compute_dtype=dt),
        lambda dt: fused_sketch.fused_velocity_sketch(vparams, vcfg, 0.5, x, (V,), "xtrace", compute_dtype=dt),
        lambda dt: ScoreModel(params, cfg, VESDE(), kernel_compute_dtype=dt),
        lambda dt: ODEFlow.create(target_dimension=2, hidden_units=(16,), device="cpu", kernel_compute_dtype=dt),
        lambda dt: SymplecticFlowModel.create(units=(16,), device="cpu", kernel_compute_dtype=dt),
        lambda dt: em_sampler.fused_em_sample(params, cfg, VESDE(), x, 1, steps=1, compute_dtype=dt),
        lambda dt: fused_train.fused_train_epoch(params, cfg, lr=1e-3, compute_dtype=dt, **_train_table(cfg)),
    ]
    # every kernel's entries and the models take bfloat16 (queue 2 #3b,
    # rows 1-10); the training kernel runs it at its own API
    for call in calls:
        call("bfloat16")
    for call in calls[:10] + calls[11:]:  # the RHS, sketch and training kernels' entries take no unknown mode
        with pytest.raises(ValueError, match="unknown"):
            call("float16")


def _train_table(cfg):
    B = 8
    return dict(xt=torch.zeros(1, B, 2), zw=torch.zeros(1, B, 2), t=torch.full((1, B), 0.5),
                beta=torch.ones(1, B))


def test_sketch_wrappers_refuse_highf32_naming_6():
    """Both sketch wrappers and a model on the sketch kernel take highf32
    (ROADMAP queue 2 #6), on the CPU through the plain versions in that
    mode; bfloat16 runs too, through its plain version, off float32 within
    the mode's accuracy class (3e-2)."""
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(16,))
    params = nets.init_score_mlp(cfg, gen(0), "cpu")
    vcfg = nets.VelocityMLPConfig(target_dimension=2, hidden_units=(16,))
    vparams = nets.init_velocity_mlp(vcfg, gen(0), "cpu")
    x = torch.randn(4, 2, generator=gen(1))
    O = torch.ones(1, 4, 2)
    for fn, p, c in ((fused_sketch.fused_drift_sketch, params, cfg), (fused_sketch.fused_velocity_sketch, vparams, vcfg)):
        out = [fn(p, c, 0.5, x, (O,), "xtrace", compute_dtype=dt) for dt in ("highf32", "float32")]
        assert all(bool(torch.isfinite(v).all()) for v in out[0])
        assert _rel(out[0][0], out[1][0]) <= 5e-5 and _rel(out[0][1], out[1][1]) <= 5e-4
        bf = fn(p, c, 0.5, x, (O,), "xtrace", compute_dtype="bfloat16")
        assert all(bool(torch.isfinite(v).all()) for v in bf)
        assert 0 < _rel(bf[0], out[1][0]) <= 3e-2 and _rel(bf[1], out[1][1]) <= 3e-2
    # a highf32 model on the sketch wrapper, and under auto dispatch the plain path
    m = ScoreModel(params, cfg, VESDE(), trace_mode="xtrace", use_fused_kernel=True, kernel_compute_dtype="highf32")
    lp, st = m.log_prob(x, probes=(O,))
    assert st.succeeded and bool(torch.isfinite(lp).all())
    lp_auto, st_auto = dataclasses.replace(m, use_fused_kernel=None).log_prob(x, probes=(O,))
    assert st_auto.succeeded and float((lp - lp_auto).abs().max()) <= 1e-3


def test_highf32_bound_counts():
    """The flops the highf32 bound counts: the flagship's hidden products
    on the tensor cores, its input projections and 3x its output layer on
    the CUDA cores; a projection past 16 features counts 3x."""
    assert fused_mlp.highf32_flops_per_row(2, 2, 128, 4, "hutchinson") == (131_072, 4_096)
    assert fused_mlp.highf32_flops_per_row(2, 2, 128, 4, "forward") == (65_536, 2_048)
    tc, cc = fused_mlp.highf32_flops_per_row(20, 2, 64, 3, "exact")
    assert tc == 2 * 64 * 64 * 3 and cc == 2 * 64 * (3 * 20 + 3 * 2 * 3)
