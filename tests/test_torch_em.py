"""Reverse-SDE sampling of the port on the CPU: the EM kernel's plain
version against the JAX Pallas kernel, the Philox stream, the samplers on
an analytic score field, and the energy distance.

* ``fused_em_sample_reference`` with streamed noise against the JAX
  ``_fused_em_impl`` in interpret mode on the same numpy inputs: x and
  x_mean within rtol 2e-4 / atol 1e-4, the JAX package's own kernel bar
  (tests/test_kernels.py:203-204).  The JAX kernel uses the tanh-form
  sigmoid and the port the exp form; the difference is far inside it.
* ``philox_normals``: Random123's published Philox4x32-10 known answers,
  then moments and the stream's independence from B.
* The samplers with the true score of N(0, I) data (as
  tests/test_score_model.py does for the JAX package): first two moments.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.kernels import em_sampler as jes
from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.ops.sde import VPSDE as JVPSDE
from flowfusion_tpu.utils import stats as jstats
from flowfusion_torch.kernels import _build
from flowfusion_torch.kernels import em_sampler as es
from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.sde import VESDE, VPSDE
from flowfusion_torch.utils import stats
from flowfusion_torch.utils.checkpoint import load_npz
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")


# ---------------------------------------------------------------------------
# the Philox stream
# ---------------------------------------------------------------------------

KNOWN_ANSWERS = [  # Random123 kat_vectors, philox4x32 with 10 rounds
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,expected", KNOWN_ANSWERS)
def test_philox_known_answers(counter, key, expected):
    out = es.philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in out) == expected


def test_philox_normals_moments_and_stream():
    z = es.philox_normals(2**40 + 7, 4, 25_000, 1)  # 10^5 draws
    assert z.shape == (4, 25_000, 1) and z.dtype == torch.float32
    assert abs(float(z.mean())) < 0.01 and abs(float(z.var()) - 1.0) < 0.015
    # four normals a call: D = 5 takes two feature blocks, independent columns
    w = es.philox_normals(3, 2, 20_000, 5).reshape(-1, 5)
    corr = np.corrcoef(w.numpy().T)
    assert np.max(np.abs(corr - np.eye(5))) < 0.03
    # a row's noise depends on (seed, row, step, feature) only: not on B
    np.testing.assert_array_equal(es.philox_normals(9, 3, 50, 5).numpy(), es.philox_normals(9, 3, 100, 5)[:, :50].numpy())
    # no two seeds share a stream (the TPU kernel's seed + tile collision)
    assert not torch.equal(es.philox_normals(0, 1, 8, 2)[:, 1:], es.philox_normals(1, 1, 8, 2)[:, :-1])
    with pytest.raises(ValueError, match="seed"):
        es.philox_normals(-1, 1, 1, 1)


# ---------------------------------------------------------------------------
# the EM kernel's plain version against the JAX kernel
# ---------------------------------------------------------------------------


def _pair(c=0, units=(32, 32), seed=0, activation="silu"):
    jcfg = jnets.ScoreMLPConfig(n_dimensions=2, n_conditionals=c, units=units, activation=activation)
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(seed), jcfg)
    cfg = ScoreMLPConfig(n_dimensions=2, n_conditionals=c, units=units, activation=activation)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


SDES = {"vp": (JVPSDE, VPSDE), "ve": (JVESDE, VESDE)}


def _jax_em(jcfg, jparams, jsde, x0, noise, cond, steps, no_sigma):
    coeffs, b_eff = jes.em_prep(jparams, jcfg, jsde, steps, no_sigma=no_sigma)
    E, D = jcfg.embedding_dimensions, jcfg.n_dimensions
    layers = jparams["layers"]
    w1 = layers[0]["w"]
    cond_proj = None if cond is None else jnp.asarray(cond) @ w1[E + D :]
    hidden = []
    for lyr in layers[1:-1]:
        hidden += [lyr["w"], lyr["b"][None, :]]
    return jes._fused_em_impl(
        jnp.asarray(x0), jnp.asarray([0], jnp.int32), jnp.asarray(noise), cond_proj, coeffs, b_eff,
        w1[E : E + D], tuple(hidden), layers[-1]["w"], layers[-1]["b"][None, :],
        steps=steps, n_hidden=len(layers) - 1, d_out=D, tile=x0.shape[0], interpret=True,
        compute_dtype="float32", activation=jcfg.activation,
    )


# (conditionals, no_sigma, SDE, hidden units): the flagship sampler is
# VESDE (c1 = -g^2 / sigma) with two H x H layers
EM_CASES = [
    pytest.param(0, False, "vp", (32, 32), id="0-False"),
    pytest.param(3, True, "vp", (32, 32), id="3-True"),
    pytest.param(0, False, "ve", (32, 32, 32), id="ve-3layer"),
    pytest.param(3, False, "ve", (32, 32, 32), id="ve-3layer-cond"),
]


@pytest.mark.parametrize("c,no_sigma,sde,units", EM_CASES)
def test_em_reference_matches_jax_kernel(c, no_sigma, sde, units):
    jcfg, jparams, cfg, params = _pair(c=c, units=units)
    jsde, tsde = SDES[sde]
    steps, B = 8, 64
    rng = np.random.default_rng(1)
    x0 = (rng.standard_normal((B, 2)) * float(tsde().prior_scale)).astype(np.float32)
    noise = rng.standard_normal((steps, B, 2)).astype(np.float32)
    cond = rng.standard_normal((B, c)).astype(np.float32) if c else None
    jxm, jx, jdiv = _jax_em(jcfg, jparams, jsde(), x0, noise, cond, steps, no_sigma)
    xm, x, div = es.fused_em_sample_reference(
        params, cfg, tsde(), torch.as_tensor(x0), torch.as_tensor(noise),
        None if cond is None else torch.as_tensor(cond), steps=steps, no_sigma=no_sigma,
    )
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(xm.numpy(), np.asarray(jxm), rtol=2e-4, atol=1e-4)
    assert bool(div) == bool(jdiv) is False


@pytest.mark.parametrize("sde,units", [("vp", (32, 32)), ("ve", (32, 32, 32))])
def test_em_prep_matches_jax(sde, units):
    jcfg, jparams, cfg, params = _pair(units=units)
    jsde, tsde = SDES[sde]
    for no_sigma in (False, True):
        jc, jb = jes.em_prep(jparams, jcfg, jsde(), 50, no_sigma=no_sigma)
        tc, tb = es.em_prep(params, cfg, tsde(), 50, no_sigma)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_em_tile_freeze_and_ragged_batch():
    """The port's freeze granularity is the kernel's block of R rows (64
    for this net).  96 real rows make two tiles, the second ragged (32
    real rows, 32 masked): a NaN in a real row of tile 1 freezes tile 1 at
    its last finite state and trips ``diverged``; tile 0 is bitwise the
    clean run (tests/test_kernels.py:207-266 for the JAX kernel's tiles).
    Rows past B never reach the outputs."""
    _, _, cfg, params = _pair()
    assert es.em_plan(32, 2, False)[0] == 64
    steps, B = 6, 96
    rng = np.random.default_rng(2)
    x0 = torch.as_tensor(rng.standard_normal((B, 2)).astype(np.float32))
    clean = torch.as_tensor(rng.standard_normal((steps, B, 2)).astype(np.float32))
    run = lambda z: es.fused_em_sample_reference(params, cfg, VPSDE(), x0, z, steps=steps)  # noqa: E731
    xm_c, x_c, div_c = run(clean)
    assert not bool(div_c) and x_c.shape == (B, 2)
    bad = clean.clone()
    bad[3, 70, 0] = float("nan")
    xm_b, x_b, div_b = run(bad)
    assert bool(div_b)
    assert torch.isfinite(x_b).all() and torch.isfinite(xm_b).all()
    assert torch.equal(x_b[:64], x_c[:64]) and torch.equal(xm_b[:64], xm_c[:64])
    # tile 1 stopped at step 3: the noise of later steps no longer reaches
    # it, and it differs from the clean run
    later = bad.clone()
    later[4:] = torch.randn(2, B, 2)
    xm_l, x_l, _ = run(later)
    assert torch.equal(x_l[64:], x_b[64:]) and torch.equal(xm_l[64:], xm_b[64:])
    assert not torch.equal(x_b[64:], x_c[64:])
    # the rows of a ragged batch are the first rows of a longer one
    x0_long = torch.cat([x0, torch.randn(32, 2)])
    z_long = torch.cat([clean, torch.randn(steps, 32, 2)], dim=1)
    _, x_long, _ = es.fused_em_sample_reference(params, cfg, VPSDE(), x0_long, z_long, steps=steps)
    assert torch.equal(x_long[:B], x_c)


@pytest.mark.parametrize("c, units", [(0, (32, 32)), (3, (32, 32, 32))])
def test_em_reference_is_bitwise_across_tiles(c, units):
    """Rows are independent until a NaN: on finite data the plain version
    at its own tile (64 rows), at 8 and at 32 rows gives the same bits,
    ragged batch included."""
    _, _, cfg, params = _pair(c=c, units=units)
    steps, B = 6, 100
    rng = np.random.default_rng(11)
    x0 = torch.as_tensor(rng.standard_normal((B, 2)).astype(np.float32))
    noise = torch.as_tensor(rng.standard_normal((steps, B, 2)).astype(np.float32))
    cond = torch.as_tensor(rng.standard_normal((B, c)).astype(np.float32)) if c else None
    assert es.em_plan(32, 2, c > 0)[0] == 64
    outs = [es.fused_em_sample_reference(params, cfg, VPSDE(), x0, noise, cond, steps=steps, rows=rows)
            for rows in (None, 8, 32)]
    assert not bool(outs[0][2])
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


def test_fused_em_sample_on_cpu_runs_the_plain_version():
    """CPU tensors run the plain version on the kernel's own Philox noise,
    at the kernel's tile; nothing is launched."""
    _, _, cfg, params = _pair(c=3)
    x0 = torch.randn(40, 2, generator=torch.Generator().manual_seed(3))
    cond = torch.randn(40, 3, generator=torch.Generator().manual_seed(4))
    before = es.fused_em_sample.launches
    out = es.fused_em_sample(params, cfg, VPSDE(), x0, 77, cond, steps=5, no_sigma=True)
    ref = es.fused_em_sample_reference(
        params, cfg, VPSDE(), x0, es.philox_normals(77, 5, 40, 2), cond, steps=5, no_sigma=True
    )
    assert es.fused_em_sample.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # highf32 maps to float32; bfloat16 waits for its queue-2 item
    out_h = es.fused_em_sample(params, cfg, VPSDE(), x0, 77, cond, steps=5, no_sigma=True, compute_dtype="highf32")
    assert torch.equal(out_h[1], out[1])
    with pytest.raises(NotImplementedError, match="queue 2"):
        es.fused_em_sample(params, cfg, VPSDE(), x0, 77, cond, steps=5, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="seed"):
        es.fused_em_sample(params, cfg, VPSDE(), x0, None, cond, steps=5)
    with pytest.raises(ValueError, match="conditional"):
        es.fused_em_sample(params, cfg, VPSDE(), x0, 77, steps=5)
    with pytest.raises(ValueError, match="shared-memory"):
        es.em_plan(32768, 2, True)
    assert es.em_flops(50_000, 100, 2, 128, 4) == 332_800_000_000


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """Every source includes csrc/mlp_tile.cuh: editing it must change
    every library's build key, or a stale library would load."""
    assert _build.SOURCES == ("fused_mlp", "em_sampler", "fused_sketch", "fused_train")
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._library_path(n) for n in _build.SOURCES}
    assert before == {n: _build._library_path(n) for n in _build.SOURCES}
    header = tmp_path / "mlp_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    (tmp_path / "em_sampler.cu").write_text((tmp_path / "em_sampler.cu").read_text() + "\n")
    assert _build._library_path("em_sampler") != after["em_sampler"]
    assert _build._library_path("fused_mlp") == after["fused_mlp"]


# ---------------------------------------------------------------------------
# the samplers on the true score of N(0, I) data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnalyticGaussianScore:
    """True score of data ~ N(0, s0^2 I) diffused by ``sde``: -x / var(t)."""

    sde: object
    s0: float = 1.0

    def apply(self, params, t, x, conditional=None):
        nu, eta = self.sde.marginal_prob_scalars(t)
        return -x / ((nu * self.s0) ** 2 + eta**2)


def _analytic(sde):
    return ScoreModel(params={}, net=AnalyticGaussianScore(sde), sde=sde, no_sigma=True)


def test_sample_sde_statistics_analytic():
    m = _analytic(VESDE())
    res = m.sample_sde((20_000, 2), steps=200, generator=torch.Generator().manual_seed(0))
    assert not bool(res.nan_encountered)
    np.testing.assert_allclose(float(res.x_mean.std()), 1.0, atol=0.05)
    np.testing.assert_allclose(float(res.x_mean.mean()), 0.0, atol=0.05)


@pytest.mark.parametrize("corrector_steps,steps", [(2, 100), (0, 50)])
def test_sample_pc_statistics_analytic(corrector_steps, steps):
    """The corrector does not bias the marginals; with no corrector step
    the rule is the EM predictor's."""
    m = _analytic(VESDE())
    res = m.sample_pc((20_000, 2), steps=steps, corrector_steps=corrector_steps,
                      generator=torch.Generator().manual_seed(1))
    assert not bool(res.nan_encountered)
    np.testing.assert_allclose(float(res.x_mean.std()), 1.0, atol=0.05)
    np.testing.assert_allclose(float(res.x_mean.mean()), 0.0, atol=0.05)
    if corrector_steps == 0:
        em = m.sample_sde((20_000, 2), steps=steps, generator=torch.Generator().manual_seed(2))
        np.testing.assert_allclose(float(res.x_mean.std()), float(em.x_mean.std()), atol=0.03)


def test_flagship_samplers_agree_on_cpu():
    """The scan sampler and the fused sampler's plain version on the
    flagship weights: the same distribution (first two moments), and the
    fused path reaches ``fused_em_sample``."""
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    params = params_from_numpy(load_npz(os.path.join(BENCH, "flagship_ckpt.npz"))["params"], "cpu")
    m = ScoreModel(params, cfg, VESDE())
    a = m.sample_sde((4000, 2), steps=100, generator=torch.Generator().manual_seed(5)).x_mean
    res = m.sample_sde_fused((4000, 2), steps=100, generator=torch.Generator().manual_seed(6))
    assert not bool(res.nan_encountered) and torch.isfinite(res.x).all()
    b = res.x_mean
    assert float((a.mean(0) - b.mean(0)).abs().max()) <= 0.08
    assert float((torch.cov(a.T) - torch.cov(b.T)).abs().max()) <= 0.12
    with pytest.raises(ValueError, match="ScoreMLPConfig"):
        _analytic(VESDE()).sample_sde_fused((4, 2))
    # DPM-Solver runs (tests/test_torch_dpm.py holds it against the JAX package)
    assert torch.isfinite(m.sample_dpm(torch.zeros(4, 2), steps=4, order=1)).all()


def test_population_sample_sde():
    """Data units out, ``steps`` honoured, a diverged solve warns and
    returns its last finite state (here: the prior, frozen at step 0)."""
    model, _ = PopulationModelDiffusion.from_conditional_npz(
        os.path.join(BENCH, "conditional_ckpt.npz"), device="cpu"
    )
    c = torch.randn(256, 3, generator=torch.Generator().manual_seed(7))
    x = model.sample_sde((256, 6), conditional=c, steps=20, generator=torch.Generator().manual_seed(8))
    assert x.shape == (256, 6) and torch.isfinite(x).all()
    cfg = ScoreMLPConfig(n_dimensions=2, units=(16,))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    params["layers"][0]["b"][0] = float("nan")
    broken = PopulationModelDiffusion(
        ScoreModel(params, cfg, VPSDE()), torch.full((2,), 1.0), torch.full((2,), 2.0), None, None
    )
    with pytest.warns(UserWarning, match="diverged"):
        x = broken.sample_sde((8, 2), steps=3, generator=torch.Generator().manual_seed(9))
    prior = VPSDE().prior_sample(torch.Generator().manual_seed(9), (8, 2))
    torch.testing.assert_close(x, prior * 2.0 + 1.0)


# ---------------------------------------------------------------------------
# the energy distance
# ---------------------------------------------------------------------------


def test_energy_distance_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((300, 2)).astype(np.float32)
    y = (rng.standard_normal((300, 2)) * 1.3 + 0.4).astype(np.float32)
    ref = float(jstats.energy_distance(jnp.asarray(x), jnp.asarray(y)))
    got = float(stats.energy_distance(torch.as_tensor(x), torch.as_tensor(y)))
    assert abs(got - ref) <= 1e-5 * abs(ref)
    g = torch.Generator().manual_seed(11)
    stat, p = stats.energy_distance_test(torch.as_tensor(x), torch.as_tensor(y), 50, generator=g)
    assert float(stat) == pytest.approx(got) and float(p) < 0.05
    same = torch.as_tensor(rng.standard_normal((300, 2)).astype(np.float32))
    stat_same, p_same = stats.energy_distance_test(torch.as_tensor(x), same, 50, generator=g)
    assert float(stat_same) < 0.2 * float(stat) and 1 / 51 <= float(p_same) <= 1.0
    with pytest.raises(ValueError, match="equal sample sizes"):
        stats.energy_distance_test(torch.as_tensor(x), same[:10])
