"""Compute mode ``highf32`` of the port's sketch kernel (Hutch++ and XTrace in
one launch, ``kernels.fused_sketch``), on the CPU.

In ``highf32`` the sketch wrappers' plain versions run the ``ops.trace``
estimators on the net of ``kernels.fused_mlp``'s ``highf32`` plain version:
every layer product after the first through the TF32 split
(``tf32x3_matmul``, tangents included) and SiLU through the tanh-form
sigmoid.  The CUDA kernel is held against them by ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` on the card.

Bars, the JAX package's own for its ``highf32`` sketch kernel against strict
float32 (tests/test_kernels.py:826-856): drift within 5e-5 and divergence
within 5e-4 of their max magnitude.  The port's ``highf32`` against the JAX
package's ``highf32`` Pallas kernel in interpret mode holds to the same
bars: TF32 halves and bf16 halves round differently.  Solves: equal solver
counts and mean |dlogp| <= 1e-4 (the fused-versus-plain bar, bench.py:323).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.kernels import fused_mlp as jfm
from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.kernels import fused_mlp, fused_sketch
from flowfusion_torch.models import nets
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.utils import convert
from flowfusion_torch.utils.checkpoint import load_npz
from flowfusion_torch.utils.data import CONDITIONAL_POP

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
C0, C1 = 0.2, -1.7
BARS = (5e-5, 5e-4)  # (drift, div), relative to the reference's max magnitude


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


def _stats(st):
    return tuple(int(v) for v in st[:3])


def _probes(mode, B, D, seed):
    """Hutch++ (r = 2, m = 1) with some exactly parallel sketch rows and a
    zero-sketch row, or XTrace (m = 2) sphere probes.  No zero XTrace row:
    there the JAX Pallas kernel and the JAX plain estimator disagree with
    each other, in float32 too (their inv(R) of an all-zero R), and the
    port follows the plain estimator (tests/test_torch_sketch.py)."""
    rng = np.random.default_rng(seed)
    if mode == "hutchpp":
        S = np.sign(rng.standard_normal((2, B, D))).astype(np.float32)
        S[1, :8] = S[0, :8]
        S[:, 3] = 0.0
        return S, np.sign(rng.standard_normal((1, B, D))).astype(np.float32)
    g = rng.standard_normal((2, B, D))
    return ((g / np.linalg.norm(g, axis=-1, keepdims=True) * np.sqrt(D)).astype(np.float32),)


# -- the wrappers' plain versions against the JAX kernel -------------------


@pytest.mark.parametrize("family", ["drift", "velocity"])
@pytest.mark.parametrize("C", [0, 3])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
def test_sketch_highf32_plain_version_matches_jax(mode, C, family):
    """B = 70, D = 2, units (48, 48, 48): the port's highf32 plain version
    against the JAX highf32 Pallas kernel in interpret mode, and against
    the port's float32 plain version, at the JAX bars; and not equal to the
    float32 one (the split and the tanh form are applied)."""
    D, B = 2, 70
    rng = np.random.default_rng(20)
    x = rng.standard_normal((B, D)).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32) if C else None
    probes = _probes(mode, B, D, 21)
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else torch.as_tensor(cond)
    tp = tuple(map(torch.as_tensor, probes))
    jp = tuple(map(jnp.asarray, probes))
    if family == "drift":
        jcfg = jnets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(48, 48, 48))
        jparams = jnets.init_score_mlp(jax.random.PRNGKey(22), jcfg)
        cfg = nets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(48, 48, 48))
        params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        jout = jfm.fused_drift_sketch(jparams, jcfg, jnp.float32(0.37), jnp.asarray(x), jp, mode, jc, c0=C0, c1=C1,
                                      tile=64, interpret=True, compute_dtype="highf32")

        def port(dt):
            return fused_sketch.fused_drift_sketch(params, cfg, torch.tensor(0.37), torch.as_tensor(x), tp, mode, tc,
                                                   c0=C0, c1=C1, compute_dtype=dt)
        counter = fused_sketch.fused_drift_sketch
    else:
        jcfg = jnets.VelocityMLPConfig(target_dimension=D, conditional_dimension=C, hidden_units=(48, 48, 48))
        jparams = jnets.init_velocity_mlp(jax.random.PRNGKey(22), jcfg)
        cfg = nets.VelocityMLPConfig(target_dimension=D, conditional_dimension=C, hidden_units=(48, 48, 48))
        params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        jout = jfm.fused_velocity_sketch(jparams, jcfg, jnp.float32(0.37), jnp.asarray(x), jp, mode, jc,
                                         tile=64, interpret=True, compute_dtype="highf32")

        def port(dt):
            return fused_sketch.fused_velocity_sketch(params, cfg, torch.tensor(0.37), torch.as_tensor(x), tp, mode,
                                                      tc, compute_dtype=dt)
        counter = fused_sketch.fused_velocity_sketch
    before = dict(counter.launches_by_dtype)
    hf, f32 = port("highf32"), port("float32")
    assert counter.launches_by_dtype == before  # CPU tensors: the plain versions
    assert bool(torch.isfinite(hf[1]).all())
    for i, bar in enumerate(BARS):
        assert _rel(hf[i], np.asarray(jout[i])) <= bar, (i, _rel(hf[i], np.asarray(jout[i])))
        assert _rel(hf[i], f32[i]) <= bar, (i, _rel(hf[i], f32[i]))
    assert not torch.equal(hf[0], f32[0]) and not torch.equal(hf[1], f32[1])


def test_sketch_highf32_reference_takes_the_split_and_the_tanh_form():
    """The highf32 plain version computes through the one split of the port
    (``fused_mlp.tf32x3_matmul``) and the tanh-form SiLU: built by hand from
    those two, the drift agrees bitwise and the divergence to rounding."""
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(48, 48))
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(40, 2, generator=torch.Generator().manual_seed(1))
    (O,) = (torch.as_tensor(p) for p in _probes("xtrace", 40, 2, 2))
    drift, div = fused_sketch.fused_drift_sketch_reference(params, cfg, 0.3, x, (O,), "xtrace", c0=C0, c1=C1,
                                                           compute_dtype="highf32")
    calls = []

    def mm(a, b):
        calls.append(a.shape)
        return fused_mlp._TF32x3.apply(a, b)

    def f(xx):
        return C0 * xx + C1 * nets.apply_score_mlp(cfg, params, 0.3, xx, matmul=mm, act=fused_mlp._tanh_silu)

    from flowfusion_torch.ops import trace

    d_hand, div_hand = trace.xtrace_divergence(f, x, O)
    assert calls and torch.equal(drift, d_hand)
    torch.testing.assert_close(div, div_hand, rtol=1e-6, atol=1e-6)


# -- the solves ---------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    path = os.path.join(BENCH, "flagship_ckpt.npz")
    jm = jckpt.load_npz(
        path, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg, sde=JVESDE())
    )
    params = convert.params_from_numpy(load_npz(path)["params"], "cpu")
    tm = ScoreModel(params, nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), VESDE())
    return jm, tm


# XTrace at a pinned step size: at adaptive steps its leave-one-out
# estimate (through inv(R)) turns rounding on rows where A is near singular
# into error ratios that pick different steps, between the JAX package's own
# highf32 kernel solve and its plain solve too.
SOLVES = [("hutchpp", dict(hpp_rank=2, hpp_vecs=1), {}),
          ("xtrace", dict(xt_vecs=2), dict(atol=1e-2, rtol=1e-2, options={"min_step": 0.1, "max_step": 0.1}))]


@pytest.mark.parametrize("mode,kw,solve", SOLVES)
def test_flagship_sketch_log_prob_highf32_matches_jax(flagship, mode, kw, solve):
    """The flagship checkpoint's Hutch++ (r = 2, m = 1, the log_prob
    defaults) and XTrace (m = 2) log_prob in highf32, the JAX bench suite's
    sketch configs: the port's solve on the sketch wrapper's highf32 plain
    version against the JAX solve on its highf32 Pallas kernel in interpret
    mode, same probes."""
    jm, tm = flagship
    jm = dataclasses.replace(jm, trace_mode=mode, use_fused_kernel=True, kernel_compute_dtype="highf32", **kw)
    tm = dataclasses.replace(tm, trace_mode=mode, use_fused_kernel=True, kernel_compute_dtype="highf32", **kw)
    x = np.random.default_rng(23).standard_normal((256, 2)).astype(np.float32)
    key = jax.random.PRNGKey(24)
    jlp, jst = jax.jit(lambda m, xx: m.log_prob(xx, key=key, **solve))(jm, jnp.asarray(x))
    probes = tuple(torch.as_tensor(np.array(p)) for p in jtrace.make_probes(mode, key, jnp.asarray(x), **kw))
    before = fused_sketch.fused_drift_sketch.launches
    lp, st = tm.log_prob(torch.as_tensor(x), probes=probes, **solve)
    assert fused_sketch.fused_drift_sketch.launches == before
    assert _stats(st) == _stats(jst)
    err = np.abs(lp.numpy() - np.asarray(jlp))
    assert err.mean() <= 1e-4, (err.mean(), err.max())


def test_flow_xtrace_log_prob_highf32():
    """ODEFlow (flow checkpoint) with XTrace (m = 2) in highf32 through the
    model, on the velocity sketch wrapper's highf32 plain version, against
    the model's float32 plain path with the same probes, at a pinned step
    size (equal solver counts by construction)."""
    tm, _ = ODEFlow.from_npz(os.path.join(BENCH, "flow_ckpt.npz"), device="cpu")
    tm = dataclasses.replace(tm, trace_mode="xtrace", xt_vecs=2)
    x = torch.as_tensor((np.random.default_rng(25).standard_normal((256, 2)) * 2.0).astype(np.float32))
    probes = (torch.as_tensor(_probes("xtrace", 256, 2, 26)[0]),)
    kw = dict(atol=1e-2, rtol=1e-2, options={"min_step": 0.1, "max_step": 0.1})
    lp, st = dataclasses.replace(tm, use_fused_kernel=False).log_prob(x, probes=probes, **kw)
    hf = dataclasses.replace(tm, use_fused_kernel=True, kernel_compute_dtype="highf32")
    lp_hf, st_hf = hf.log_prob(x, probes=probes, **kw)
    assert _stats(st_hf) == _stats(st) and bool(torch.isfinite(lp_hf).all())
    assert float((lp_hf - lp).abs().mean()) <= 1e-4
    assert not torch.equal(lp_hf, lp)


def test_conditional_checkpoint_served_with_xtrace_on_the_cpu():
    """The conditional checkpoint as ``from_conditional_npz`` serves it
    (highf32), switched to XTrace (m = 3): the sketch wrapper's highf32
    plain version through the population model, against its float32 twin
    with the same probes, at a pinned step size."""
    model, _ = PopulationModelDiffusion.from_conditional_npz(os.path.join(BENCH, "conditional_ckpt.npz"),
                                                             device="cpu")
    assert model.score_model.kernel_compute_dtype == "highf32"
    theta, cond = CONDITIONAL_POP.sample(torch.Generator().manual_seed(27), 64, device="cpu")
    hf = dataclasses.replace(model, score_model=dataclasses.replace(
        model.score_model, trace_mode="xtrace", xt_vecs=3, use_fused_kernel=True))
    f32 = dataclasses.replace(hf, score_model=dataclasses.replace(hf.score_model, kernel_compute_dtype="float32"))
    kw = dict(atol=1e-2, rtol=1e-2, options={"min_step": 0.1, "max_step": 0.1})
    (lp_hf, st_hf), (lp_32, st_32) = (
        m.log_prob(theta, cond, generator=torch.Generator().manual_seed(28), **kw) for m in (hf, f32))
    assert _stats(st_hf) == _stats(st_32) and bool(torch.isfinite(lp_hf).all())
    assert float((lp_hf - lp_32).abs().mean()) <= 1e-4
    assert not torch.equal(lp_hf, lp_32)


# -- the bound and the plan ----------------------------------------------------


def test_highf32_sketch_bound_counts():
    """The flops the highf32 sketch bound counts, flagship net (D = 2,
    H = 128, two hidden products): 2r + m (Hutch++) or 2m (XTrace) tangent
    chains beside the forward chain, each seeded through w_in[:D] once; at
    50,000 rows the TF32 bound, 3 passes on the tensor cores at 495
    TFLOP/s plus the CUDA-core rest at 67, is ~0.128 and ~0.107 ms."""
    hpp = fused_mlp.highf32_flops_per_row(2, 2, 128, 4, "hutchpp", 2, 1)
    xt = fused_mlp.highf32_flops_per_row(2, 2, 128, 4, "xtrace", 2)
    assert hpp == (393_216, 12_288)
    assert xt == (327_680, 10_240)
    assert fused_mlp.highf32_flops_per_row(2, 2, 128, 4, "hutchpp", 1, 1) == (262_144, 8_192)

    def bound_ms(tc, cc):
        return 50_000 * (3 * tc / 495e12 + cc / 67e12) * 1e3

    assert abs(bound_ms(*hpp) - 0.128) < 5e-4 and abs(bound_ms(*xt) - 0.107) < 5e-4
    # the float32 bound of the same calls, fp32 at 67 TFLOP/s
    assert round(50_000 * fused_mlp.flops_per_row(2, 2, 128, 4, "hutchpp", 2, 1) / 67e12 * 1e3, 3) == 0.298
    assert round(50_000 * fused_mlp.flops_per_row(2, 2, 128, 4, "xtrace", 2) / 67e12 * 1e3, 3) == 0.248


def test_highf32_sketch_plan_pads_to_eight_and_four_row_plans():
    """highf32 pads hidden widths to 8 (100 -> 104) and plans the same
    shared memory; the conditional H = 256 net at r = m = 3 fits only at 4
    rows a block (M = 6 x 4 = 24 rows in a product: a partial m-tile)."""
    assert fused_sketch.supports_sketch("xtrace", 100, 2, 2, 2, 2, 0, "highf32")
    assert fused_sketch.sketch_plan("hutchpp", 256, 3, 9, 6, 3, 3)[0] == 4
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(100, 100))
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(3), "cpu")
    padded, pcfg = fused_mlp.pad_to_lanes(params, cfg, "highf32")
    assert pcfg.units == (104, 104)
    x = torch.randn(16, 2, generator=torch.Generator().manual_seed(4))
    probes = tuple(torch.as_tensor(p)[:, :16] for p in _probes("hutchpp", 16, 2, 5))
    a = fused_sketch.fused_drift_sketch(params, cfg, 0.2, x, probes, "hutchpp", c0=C0, c1=C1,
                                        compute_dtype="highf32")
    b = fused_sketch.fused_drift_sketch_reference(padded, pcfg, 0.2, x, probes, "hutchpp", c0=C0, c1=C1,
                                                  compute_dtype="highf32")
    assert all(_rel(u, v) <= 1e-6 for u, v in zip(a, b))


def test_sketch_compute_dtype_checks():
    """bfloat16 is a compute mode of the sketch kernel too (ROADMAP #3b,
    ported); an unknown mode is a ValueError; the launch counts keep a
    split by the three compute modes."""
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(16,))
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    x, O = torch.zeros(4, 2), torch.ones(1, 4, 2)
    out = fused_sketch.fused_drift_sketch(params, cfg, 0.5, x, (O,), "xtrace", compute_dtype="bfloat16")
    assert all(bool(torch.isfinite(v).all()) for v in out)
    with pytest.raises(ValueError, match="unknown"):
        fused_sketch.fused_drift_sketch(params, cfg, 0.5, x, (O,), "xtrace", compute_dtype="float16")
    fused_sketch.reset_launch_counts()
    for fn in (fused_sketch.fused_drift_sketch, fused_sketch.fused_velocity_sketch):
        assert fn.launches_by_dtype == {"float32": 0, "highf32": 0, "bfloat16": 0}
