"""The sketch kernel's wide path (8 < D <= 64) on the CPU: the one-launch
Hutch++/XTrace wrappers (``kernels.fused_sketch``) at the JAX sketch
kernel's envelope, D + C <= 64 features.

On CPU tensors the wrappers run their plain versions; here they are held
against the JAX package's ``fused_drift_sketch`` / ``fused_velocity_sketch``
Pallas kernel in interpret mode at the D of the pop-cosmos workload
(D = 16, C = 8; ``benchmarks/bench_suite.py:486-505``), past the 16-row
probe projection (D = 20, C = 4) and at the top of the envelope (D = 64),
in float32 and ``highf32``, at the JAX wide test's tolerances
(``tests/test_kernels.py:1115-1158``: drift atol 5e-5, div rtol 1e-4 and
atol 5e-4).  ``bfloat16`` is held against the numpy spec of
``tests/test_torch_bf16.py`` (JAX's CPU runtime cannot run bf16 x bf16
dots), whose input projection rounds a probe past 16 rows.  The envelope:
``sketch_md``, ``sketch_plan`` and ``supports_sketch`` for D up to 64 in
every compute mode, the raise at D = 65, and auto dispatch on a stand-in
CUDA tensor.  ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 18
hold the CUDA kernel against these plain versions on the card.
"""

import dataclasses

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
from flowfusion_torch.kernels import fused_mlp, fused_sketch
from flowfusion_torch.models import nets
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops import trace
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.utils.convert import params_from_numpy
from test_torch_bf16 import _fold_score, _np_params, _spec_sketch, _tail
from test_torch_sketch_bf16 import _check

torch.set_num_threads(1)

C0, C1 = 0.3, -0.9
WIDE = [(16, 8), (20, 4), (64, 0)]  # (D, C): pop-cosmos, past 16 probe rows, the envelope's top
B = 40


def _probes(mode, B, D, seed):
    """Hutch++ Rademacher (r = 2, m = 1), as the JAX wide test draws them,
    with exactly parallel Gaussian sketch columns on five rows (basis
    completion), or XTrace sphere probes (m = 2).  Parallel Rademacher
    columns would tie every canonical residual (norm^2 = 1 - 1/D), and
    which of them completes the basis would then be decided by the last
    ulp of each implementation's sums, not by the algebra."""
    rng = np.random.default_rng(seed)
    if mode == "hutchpp":
        S = np.sign(rng.standard_normal((2, B, D))).astype(np.float32)
        S[:, :5] = rng.standard_normal((5, D)).astype(np.float32)
        return S, np.sign(rng.standard_normal((1, B, D))).astype(np.float32)
    g = rng.standard_normal((2, B, D))
    return ((g / np.linalg.norm(g, axis=-1, keepdims=True) * np.sqrt(D)).astype(np.float32),)


def _pair(family, D, C, seed):
    """(jcfg, jparams, cfg, params) of a one-hidden-layer net of width 128,
    the JAX init converted to the port."""
    if family == "drift":
        jcfg = jnets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(128,))
        jparams = jnets.init_score_mlp(jax.random.PRNGKey(seed), jcfg)
        cfg = nets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(128,))
    else:
        jcfg = jnets.VelocityMLPConfig(target_dimension=D, conditional_dimension=C, hidden_units=(128,))
        jparams = jnets.init_velocity_mlp(jax.random.PRNGKey(seed), jcfg)
        cfg = nets.VelocityMLPConfig(target_dimension=D, conditional_dimension=C, hidden_units=(128,))
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


# -- the wrappers' plain versions against the JAX kernel -------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "highf32"])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("family", ["drift", "velocity"])
@pytest.mark.parametrize("D,C", WIDE)
def test_wide_sketch_plain_version_matches_jax(D, C, family, mode, compute_dtype):
    """B = 40 rows, one hidden layer of 128: the port's plain version
    against the JAX Pallas kernel in interpret mode, same compute mode;
    the kernel takes the wide path (MD = 64) at this D."""
    jcfg, jparams, cfg, params = _pair(family, D, C, D + C)
    rng = np.random.default_rng(D)
    x = rng.standard_normal((B, D)).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32) if C else None
    probes = _probes(mode, B, D, D + 1)
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else torch.as_tensor(cond)
    jp, tp = tuple(map(jnp.asarray, probes)), tuple(map(torch.as_tensor, probes))
    if family == "drift":
        jout = jfm.fused_drift_sketch(jparams, jcfg, jnp.float32(0.6), jnp.asarray(x), jp, mode, jc, c0=C0, c1=C1,
                                      interpret=True, compute_dtype=compute_dtype)
        out = fused_sketch.fused_drift_sketch(params, cfg, torch.tensor(0.6), torch.as_tensor(x), tp, mode, tc,
                                              c0=C0, c1=C1, compute_dtype=compute_dtype)
    else:
        jout = jfm.fused_velocity_sketch(jparams, jcfg, jnp.float32(0.6), jnp.asarray(x), jp, mode, jc,
                                         interpret=True, compute_dtype=compute_dtype)
        out = fused_sketch.fused_velocity_sketch(params, cfg, torch.tensor(0.6), torch.as_tensor(x), tp, mode, tc,
                                                 compute_dtype=compute_dtype)
    assert fused_sketch.sketch_plan(mode, 128, 1, D + C, D, *trace.probe_counts(mode, tp),
                                    compute_dtype=compute_dtype)[2] == fused_sketch.MAX_SKETCH_DIM
    assert bool(torch.isfinite(out[1]).all())
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]), atol=5e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jout[1]), rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("D,C", WIDE)
def test_wide_bf16_sketch_plain_version_matches_spec(D, C, mode):
    """``bfloat16``: the drift wrapper's plain version against the numpy
    spec (the JAX package's estimator algebra over the JAX kernel's rounding
    points; a probe of more than 16 rows projects through the bf16
    product), at the mode's bars: the mean within 1e-5 of the max, and 10x
    closer to the spec than the spec is to strict float32."""
    cfg = nets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(128, 128))
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(D), "cpu")
    p = _np_params(jax.tree.map(lambda v: v.numpy(), params))
    rng = np.random.default_rng(D + 2)
    x = rng.standard_normal((64, D)).astype(np.float32)
    cond = rng.standard_normal((64, C)).astype(np.float32) if C else None
    probes = _probes(mode, 64, D, D + 3)
    tc = None if cond is None else torch.as_tensor(cond)
    tp = tuple(torch.as_tensor(v) for v in probes)
    args = (params, cfg, 0.37, torch.as_tensor(x), tp, mode, tc)
    out = fused_sketch.fused_drift_sketch(*args, c0=C0, c1=C1, compute_dtype="bfloat16")
    strict = fused_sketch.fused_drift_sketch(*args, c0=C0, c1=C1)
    w_in, b_eff = _fold_score(p, cfg.embedding_dimensions, D, C > 0, 0.37)
    spec = _spec_sketch(w_in, b_eff, _tail(p), x, cond, cfg.activation, np.float32(C0), np.float32(C1), probes, mode)
    _check(out, spec, strict)


def test_bf16_probe_projection_rounds_past_16_rows():
    """The bf16 chain's probe projection: the rank-1 sum over the rounded
    weights on the probe as it is up to 16 rows, the rounded probe's product
    past that (the JAX kernel's ``in_proj_rows``), as ``fused_sketch.cu``
    projects it; it differs from the unrounded product past 16 rows."""
    g = torch.Generator().manual_seed(3)
    for D, rounds in ((16, False), (17, True), (64, True)):
        w_in, b_eff = torch.randn(D + 2, 32, generator=g), torch.randn(32, generator=g)
        x_in, v = torch.randn(8, D + 2, generator=g), torch.randn(8, D, generator=g)
        layers = [None, {"w": torch.randn(32, D, generator=g), "b": torch.zeros(D)}]
        _, (t,) = fused_mlp._bf16_chains(layers, w_in, b_eff, x_in, [v], "silu", D)
        _, dh = fused_mlp._act_pair("silu")(fused_mlp.bf16_matmul(x_in, w_in, D + 2 > 16) + b_eff)

        def chain(probe):
            return fused_mlp.bf16_matmul(dh * (probe @ fused_mlp.bf16_round(w_in[:D])), layers[1]["w"])

        assert torch.equal(t, chain(fused_mlp.bf16_round(v) if rounds else v))
        assert torch.equal(t, chain(v)) is not rounds


# -- the likelihood solve at D16C8 -----------------------------------------


@pytest.fixture(scope="module")
def d16c8():
    jcfg = jnets.ScoreMLPConfig(n_dimensions=16, n_conditionals=8, units=(64, 64))
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(30), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(31)
    W = rng.standard_normal((8, 16)) / np.sqrt(8)
    c = rng.standard_normal((64, 8)).astype(np.float32)
    x = (np.tanh(c @ W) + 0.3 * rng.standard_normal((64, 16))).astype(np.float32)
    jm = JScoreModel(params=jparams, net=jcfg, sde=JVESDE(), use_fused_kernel=False)
    tm = ScoreModel(params, nets.ScoreMLPConfig(n_dimensions=16, n_conditionals=8, units=(64, 64)), VESDE())
    return jm, tm, x, c


@pytest.mark.parametrize("mode,kw", [("hutchpp", dict(hpp_rank=2, hpp_vecs=1)), ("xtrace", dict(xt_vecs=2))])
def test_d16c8_sketch_log_prob_matches_jax(d16c8, mode, kw):
    """A D16C8 ``ScoreModel`` with each sketch trace against the JAX solve
    on the same probes (the JAX draw, passed in): NFE equal, mean |dlogp|
    <= 1e-4; the wrapper's plain version under the solver (what the kernel
    computes on the card) gives the same NFE and densities within 1e-5."""
    jm, tm, x, c = d16c8
    jm = dataclasses.replace(jm, trace_mode=mode, **kw)
    tm = dataclasses.replace(tm, trace_mode=mode, **kw)
    key = jax.random.PRNGKey(32)
    jlp, jst = jax.jit(lambda m, xx, cc: m.log_prob(xx, conditional=cc, key=key))(jm, jnp.asarray(x), jnp.asarray(c))
    probes = tuple(torch.as_tensor(np.asarray(p)) for p in jtrace.make_probes(mode, key, jnp.asarray(x), **kw))
    lp, st = tm.log_prob(torch.as_tensor(x), conditional=torch.as_tensor(c), probes=probes)
    stats = tuple(int(v) for v in st[:3])
    assert stats == tuple(int(v) for v in jst[:3])
    assert np.abs(lp.numpy() - np.asarray(jlp)).mean() <= 1e-4
    lp_f, st_f = dataclasses.replace(tm, use_fused_kernel=True).log_prob(
        torch.as_tensor(x), conditional=torch.as_tensor(c), probes=probes)
    assert tuple(int(v) for v in st_f[:3]) == stats and float((lp_f - lp).abs().mean()) <= 1e-5


# -- the envelope ----------------------------------------------------------


def test_sketch_md_and_plan_up_to_64():
    """Buckets 2, 4, 8 in registers, 64 the wide path; the plan's bytes are
    the narrow layout's at every D; D = 65 raises, naming the plain path."""
    for D in range(1, 65):
        md = fused_sketch.sketch_md(D)
        assert md == (2 if D <= 2 else 4 if D <= 4 else 8 if D <= 8 else 64)
        for mode, (n_s, n_g) in (("hutchpp", (min(2, D), 1)), ("xtrace", (min(2, D), 0))):
            rows, smem, md_, group = fused_sketch.sketch_plan(mode, 128, 3, D + 8, D, n_s, n_g)
            assert md_ == md and group == 0
            kmax, ncols = fused_sketch._layout(mode, n_s, n_g)
            n_alg = fused_sketch._algebra_floats(mode, n_s, D, D + 8, 3, 128)
            assert smem == 4 * rows * (3 * 128 + D + 8 + ncols * D + n_alg) + 8 * kmax * rows * 128
    # the pop-cosmos plans: three blocks an SM in every compute mode
    for dt, hpp_rows, xt_rows in (("float32", 8, 16), ("highf32", 8, 16), ("bfloat16", 16, 16)):
        hpp = fused_sketch.sketch_plan("hutchpp", 128, 3, 24, 16, 2, 1, compute_dtype=dt)
        xt = fused_sketch.sketch_plan("xtrace", 128, 3, 24, 16, 2, 0, compute_dtype=dt)
        assert (hpp[0], xt[0], hpp[2], xt[2]) == (hpp_rows, xt_rows, 64, 64)
        assert fused_sketch.sketch_blocks(hpp) == fused_sketch.sketch_blocks(xt) == 3
    with pytest.raises(ValueError, match="not one of"):
        fused_sketch.sketch_plan("xtrace", 128, 3, 24, 16, 2, 0, md=8)
    for fn in (lambda: fused_sketch.sketch_md(65), lambda: fused_sketch.sketch_plan("xtrace", 128, 3, 65, 65, 2, 0)):
        with pytest.raises(ValueError, match="D <= 64.*use_fused_kernel=False"):
            fn()
    assert not fused_sketch.supports_sketch("xtrace", 128, 3, 65, 65, 2, 0)


@pytest.mark.parametrize("compute_dtype", ["float32", "highf32", "bfloat16"])
def test_every_jax_envelope_config_fits(compute_dtype):
    """Every (D, C) with D + C <= 64 (the JAX sketch kernel's envelope),
    r, m <= 4 and three hidden layers of H = 128 or 256 has a plan."""
    for H in (128, 256):
        for D in range(1, 65):
            for C in range(0, 65 - D):
                for k in range(1, min(4, D) + 1):
                    assert fused_sketch.supports_sketch("xtrace", H, 3, D + C, D, k, 0, compute_dtype), (H, D, C, k)
                    for m in range(1, 5):
                        assert fused_sketch.supports_sketch("hutchpp", H, 3, D + C, D, k, m, compute_dtype), \
                            (H, D, C, k, m)


def test_auto_dispatch_takes_the_wide_kernel_on_cuda():
    """On a stand-in CUDA tensor, auto dispatch takes the sketch kernel at
    D = 16 (where it raised before the wide path) and raises at D = 65,
    naming use_fused_kernel=False; no plain path on the card unless asked."""
    on_card = type("OnCard", (), {"is_cuda": True})()
    for mode, kw, probes in (("hutchpp", dict(hpp_rank=2, hpp_vecs=1), (torch.ones(2, 8, 16), torch.ones(1, 8, 16))),
                             ("xtrace", dict(xt_vecs=2), (torch.ones(2, 8, 16),))):
        cfg = nets.ScoreMLPConfig(n_dimensions=16, n_conditionals=8, units=(128, 128, 128))
        sm = ScoreModel(nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, VESDE(),
                        trace_mode=mode, **kw)
        assert sm._fused_available(on_card, mode, probes) is True
        assert dataclasses.replace(sm, use_fused_kernel=False)._fused_available(on_card, mode, probes) is False
        wide = dataclasses.replace(sm, net=nets.ScoreMLPConfig(n_dimensions=65, units=(128,)))
        wide_probes = tuple(torch.ones(p.shape[0], 8, 65) for p in probes)
        with pytest.raises(ValueError, match="D <= 64.*use_fused_kernel=False"):
            wide._fused_available(on_card, mode, wide_probes)
