"""Compute mode ``bfloat16`` of the port's RHS and EM kernels, on the CPU.

The mode is the JAX package's fast serving mode
(``flowfusion_tpu/models/score.py:73-77``): bf16 operands at one MXU pass,
fp32 sums, the tanh-form SiLU.  On CPU tensors the wrappers run their plain
versions in the mode (``fused_mlp._bf16_reference``,
``em_sampler.fused_em_sample_reference``); ``tests/test_torch_gpu.py`` holds
the CUDA kernels against them on the card.

No JAX ``bfloat16`` result exists on the CPU.  The JAX kernel cannot run
the mode in interpret mode there: ``jfm.fused_drift(..., interpret=True,
compute_dtype="bfloat16")`` on a random 2 -> 128x3 -> 2 net raises
``JaxRuntimeError: INTERNAL: ... Unsupported element type for
DotThunk::Execute: BF16 x BF16 = F32`` (jax 0.9.0, and the same with
``--xla_cpu_use_thunk_runtime=false``), and the JAX package's own tests
never run the mode.  So the port's plain versions are held two ways:

* against a numpy spec of the JAX kernel's rounding points, written here
  from its source: ``_compute_mode`` (kernels/fused_mlp.py:175-201, bf16
  operands at DEFAULT precision), the wrapper's casts of ``w_in``, the
  hidden weights and ``w_out`` (:1311-1314, :1323, :1326; biases and the
  time fold f32), ``_kernel``'s ``mm`` casting the activation or tangent
  operand before every product (:554-560, :682, :685, :693, :801, :807,
  :810), the tangents rounded like the drift (``relax_tangents`` is
  float32's, :577-582), ``in_proj_rows``' rank-1 sum of bf16 weights times
  f32 inputs up to 16 features (:313-331) and the tanh-form activation
  pair (:257-300, :598); for the EM kernel ``_em_weight_dtype`` (:64-70),
  the casts (:417-441), the dots (:160-170) and the tanh-form sigmoid
  (:177).  Bar: max |d| <= 1e-3 and mean |d| <= 1e-5 of the max magnitude.
  A bf16 x bf16 product is exact in fp32, so the two differ in the order
  of the fp32 sums alone, and where that moves a value across a bf16
  rounding boundary (a flip, one bf16 ulp of one activation);
* against the JAX ``float32`` kernel in interpret mode at the mode's
  accuracy class, 3e-2 of the max magnitude (score.py:76: ~1e-3 density
  accuracy), and farther from it than from the spec, so the mode is on.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.kernels import em_sampler as jes
from flowfusion_tpu.kernels import fused_mlp as jfm
from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.flow import ODEFlow as JODEFlow
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.kernels import em_sampler, fused_mlp, fused_sketch
from flowfusion_torch.models import nets
from flowfusion_torch.models import score as score_mod
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.utils import serving
from flowfusion_torch.utils.checkpoint import load_npz
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
FLAGSHIP = os.path.join(BENCH, "flagship_ckpt.npz")
SPEC_MAX, SPEC_MEAN = 1e-3, 1e-5  # against the spec, of the max magnitude
ACCURACY_CLASS = 3e-2  # against float32 (score.py:76)
BF = dict(compute_dtype="bfloat16")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _mean_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean(np.abs(a - b)) / np.max(np.abs(b)))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# the spec: the JAX kernel's rounding points in numpy float32
# ---------------------------------------------------------------------------


def _bf16(a):
    """float32 -> bf16 (round to nearest, ties to even) -> float32, on the
    bits (finite values)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _mm(a, w):
    """``_kernel``'s mm at DEFAULT precision on the MXU: both operands bf16,
    fp32 sums."""
    return _bf16(a) @ _bf16(w)


def _in_proj(x, w):
    """``in_proj_rows``: up to 16 features a rank-1 sum of bf16 weight rows
    times the f32 inputs, in f32; past 16 through ``mm``."""
    n = x.shape[1]
    if n > 16:
        return _mm(x, w[:n])
    acc = x[:, 0:1] * _bf16(w[0:1])
    for j in range(1, n):
        acc = acc + x[:, j:j + 1] * _bf16(w[j:j + 1])
    return acc


def _pair(a, activation):
    """``_act_pair_fn`` with the throughput modes' tanh-form sigmoid."""
    if activation == "silu":
        s = 0.5 + 0.5 * np.tanh(0.5 * a)
        return a * s, s * (1.0 + a * (1.0 - s))
    if activation == "tanh":
        h = np.tanh(a)
        return h, 1.0 - h * h
    m = (a > 0).astype(np.float32)  # relu
    return a * m, m


def _spec_chains(w_in, b_eff, layers, x_in, probes, activation, d):
    """``compute_chunk`` (kernels/fused_mlp.py:780-830) in bfloat16: the
    net and J_net v of each probe, ``layers`` the (w, b) after the first."""
    a = _in_proj(x_in, w_in) + b_eff
    ts = [_in_proj(v, w_in[:d]) for v in probes]
    for w, b in layers:
        h, dh = _pair(a, activation)
        ts = [_mm(dh * t, w) for t in ts]
        a = _mm(h, w) + b
    return a, ts


def _spec_rhs(w_in, b_eff, layers, x, cond, activation, c0, c1, mode, probes=None):
    """One launch in ``mode``: (drift, div) or (drift, [J v])."""
    d = x.shape[1]
    x_in = x if cond is None else np.concatenate([x, cond], axis=1)
    if mode == "exact":
        probes = [np.broadcast_to(np.eye(d, dtype=np.float32)[k], x.shape) for k in range(d)]
    net, jv = _spec_chains(w_in, b_eff, layers, x_in, probes or [], activation, d)
    drift = c0 * x + c1 * net
    if mode == "hutchinson":
        e = probes[0]
        return drift, c0 * np.sum(e * e, axis=1) + c1 * np.sum(jv[0] * e, axis=1)
    if mode == "exact":
        acc = np.zeros(x.shape[0], np.float32)
        for k in range(d):
            acc = acc + jv[k][:, k]
        return drift, c0 * np.float32(d) + c1 * acc
    if mode == "tangents":
        return drift, [c0 * v + c1 * j for v, j in zip(probes, jv)]
    return (drift,)


def _spec_sketch(w_in, b_eff, layers, x, cond, activation, c0, c1, probes, mode):
    """(drift, div) of one bf16 sketch launch: drift c0 x + c1 net, div the
    JAX package's own estimator algebra (``ops/trace.py::hutchpp_core`` or
    ``xtrace_core``, which the JAX kernel's ``_sketch_chunk`` runs over its
    ``apply_A``, kernels/fused_mlp.py:673-754) over A v = c0 v + c1 J_net v,
    the net and J_net v from ``_spec_chains``.  ``probes``: (S, G) or
    (O,), each (k, B, D)."""
    d = x.shape[1]
    x_in = x if cond is None else np.concatenate([x, cond], axis=1)
    net, _ = _spec_chains(w_in, b_eff, layers, x_in, [], activation, d)

    def apply_cols(cols):
        vs = [np.asarray(c, np.float32).T for c in cols]
        _, jv = _spec_chains(w_in, b_eff, layers, x_in, vs, activation, d)
        return [jnp.asarray((c0 * v + c1 * j).T) for v, j in zip(vs, jv)]

    cols = [[jnp.asarray(p[i].T) for i in range(p.shape[0])] for p in probes]
    core = jtrace.hutchpp_core if mode == "hutchpp" else jtrace.xtrace_core
    return c0 * x + c1 * net, np.array(core(apply_cols, *cols), np.float32)


def _spec_sketch_drift(model):
    """A score model's sketch RHS as the spec computes it: a stand-in for
    ``fused_drift_sketch`` with its signature (``models/score.py``'s name
    for it), on the model's weights folded as the JAX wrapper folds them."""
    p = _np_params(jax.tree.map(lambda v: v.numpy(), model.params))
    E, D = model.net.embedding_dimensions, model.net.n_dimensions

    def rhs(params, cfg, t, x, probes, mode, conditional=None, c0=0.0, c1=1.0, compute_dtype="float32"):
        assert compute_dtype == "bfloat16"
        w_in, b_eff = _fold_score(p, E, D, conditional is not None, float(t))
        drift, div = _spec_sketch(w_in, b_eff, _tail(p), _np(x), None if conditional is None else _np(conditional),
                                  cfg.activation, np.float32(float(c0)), np.float32(float(c1)),
                                  tuple(_np(v) for v in probes), mode)
        return torch.from_numpy(drift), torch.from_numpy(div)
    return rhs


def _temb(t, W):
    proj = np.float32(t) * W * np.float32(2.0 * math.pi)
    return np.concatenate([np.sin(proj), np.cos(proj)]).astype(np.float32)


def _fold_score(p, E, D, with_cond, t):
    """The score net's first layer as the JAX wrapper folds it: the time
    embedding's rows into the bias (f32), the [x | cond] rows."""
    w1 = p["layers"][0]["w"]
    b_eff = p["layers"][0]["b"] + _temb(t, p["W"]) @ w1[:E]
    return (w1[E:] if with_cond else w1[E:E + D]), b_eff


def _np_params(params):
    return jax.tree.map(lambda v: np.asarray(v, np.float32), params)


def _tail(p, key="layers"):
    return [(l["w"], l["b"]) for l in p[key][1:]]


# ---------------------------------------------------------------------------
# the rounding
# ---------------------------------------------------------------------------

ULP = 2.0**-7  # of a bf16 value in [1, 2)


@pytest.mark.parametrize("value,expected", [
    (1.0 + ULP / 2, 1.0),  # a tie rounds to even
    (1.0 + 3 * ULP / 2, 1.0 + 2 * ULP),  # a tie to even, away from the odd value below
    (-(1.0 + 3 * ULP / 2), -(1.0 + 2 * ULP)),
    (1.0 + ULP / 2 + 2.0**-23, 1.0 + ULP),  # above the tie rounds up
    (1.0 + ULP / 2 - 2.0**-23, 1.0),
    (3.4e38, float("inf")),  # past the midpoint above bf16's largest finite value
    (-0.0, -0.0),
    (float("inf"), float("inf")),
])
def test_bf16_round_known_answers(value, expected):
    out = fused_mlp.bf16_round(torch.tensor([value], dtype=torch.float32))
    want = torch.tensor([expected], dtype=torch.float32)
    assert torch.equal(out, want) and torch.signbit(out) == torch.signbit(want), (value, out.item())
    if math.isfinite(expected):
        assert _bf16(np.float32([value]))[0] == np.float32(expected)


def test_bf16_matmul_rounds_the_operands_and_sums_in_fp32():
    rng = np.random.default_rng(0)
    a, b = (torch.as_tensor(rng.standard_normal(s).astype(np.float32)) for s in ((64, 96), (96, 24)))
    exact = fused_mlp.bf16_round(a).double() @ fused_mlp.bf16_round(b).double()
    out = fused_mlp.bf16_matmul(a, b)
    assert float((out.double() - exact).abs().max()) <= 96 * 2.0**-24 * float(exact.abs().max())
    np.testing.assert_allclose(out.numpy(), _mm(a.numpy(), b.numpy()), rtol=0, atol=1e-5)
    # round_a=False rounds the weights alone (the rank-1 input projection)
    keep = fused_mlp.bf16_matmul(a, b, round_a=False).double()
    assert float((keep - a.double() @ fused_mlp.bf16_round(b).double()).abs().max()) <= 1e-4
    assert float((keep - exact).abs().max()) >= 1e-3


# ---------------------------------------------------------------------------
# the RHS plain versions against the spec
# ---------------------------------------------------------------------------


def _score_net(kind):
    """(torch params, cfg, numpy params): the flagship checkpoint, a
    conditional tanh net, and one whose 20 input features pass the rank-1
    crossover."""
    if kind == "flagship":
        tree = load_npz(FLAGSHIP)["params"]
        cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
        return params_from_numpy(tree, "cpu"), cfg, _np_params(tree)
    d, c, units, act = {"conditional": (3, 2, (64, 64), "tanh"), "wide": (2, 18, (32, 32), "silu")}[kind]
    cfg = nets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units, activation=act)
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(5), "cpu")
    return params, cfg, _np_params(jax.tree.map(lambda v: v.numpy(), params))


def _rows(B, d, c=0, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    cond = rng.standard_normal((B, c)).astype(np.float32) if c else None
    e = np.sign(rng.standard_normal((B, d))).astype(np.float32)
    V = rng.standard_normal((3, B, d)).astype(np.float32)
    return x, cond, e, V


def _check_spec(port, spec):
    for p, s in zip(port, spec):
        p, s = _np(p), np.asarray(s)
        assert _rel(p, s) <= SPEC_MAX and _mean_rel(p, s) <= SPEC_MEAN, (_rel(p, s), _mean_rel(p, s))


@pytest.mark.parametrize("kind", ["flagship", "conditional", "wide"])
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact", "tangents"])
def test_fused_drift_bf16_matches_spec(mode, kind):
    params, cfg, p = _score_net(kind)
    D, C = cfg.n_dimensions, cfg.n_conditionals
    x, cond, e, V = _rows(256, D, C)
    tc = None if cond is None else torch.as_tensor(cond)
    w_in, b_eff = _fold_score(p, cfg.embedding_dimensions, D, C > 0, 0.37)
    kw = dict(c0=-0.3, c1=0.9, **BF)
    if mode == "tangents":
        drift, cols = fused_mlp.fused_drift_tangents(params, cfg, 0.37, torch.as_tensor(x), torch.as_tensor(V), tc,
                                                     **kw)
        sd, scols = _spec_rhs(w_in, b_eff, _tail(p), x, cond, cfg.activation, -0.3, 0.9, mode, list(V))
        _check_spec([drift.T] + [c.T for c in cols], [sd] + scols)
        return
    tkw = {"e": torch.as_tensor(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    out = fused_mlp.fused_drift(params, cfg, torch.tensor(0.37), torch.as_tensor(x), tc, **kw, **tkw)
    out = out if isinstance(out, tuple) else (out,)
    _check_spec(out, _spec_rhs(w_in, b_eff, _tail(p), x, cond, cfg.activation, -0.3, 0.9, mode, [e]))


def _velocity_net():
    jflow = JODEFlow.create(jax.random.PRNGKey(0), target_dimension=2, hidden_units=(128, 128))
    cfg = nets.VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128))
    return jflow, cfg, params_from_numpy(jax.tree.map(np.asarray, jflow.params), "cpu"), _np_params(jflow.params)


@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact", "tangents"])
def test_fused_velocity_bf16_matches_spec(mode):
    """The velocity net: the raw time's row folded into the bias."""
    _, cfg, params, p = _velocity_net()
    x, _, e, V = _rows(256, 2, seed=2)
    w1 = p["layers"][0]["w"]
    w_in, b_eff = w1[:2], p["layers"][0]["b"] + np.float32(0.37) * w1[2]
    if mode == "tangents":
        drift, cols = fused_mlp.fused_velocity_tangents(params, cfg, 0.37, torch.as_tensor(x), torch.as_tensor(V), **BF)
        sd, scols = _spec_rhs(w_in, b_eff, _tail(p), x, None, "silu", 0.0, 1.0, mode, list(V))
        _check_spec([drift.T] + [c.T for c in cols], [sd] + scols)
        return
    tkw = {"e": torch.as_tensor(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    out = fused_mlp.fused_velocity(params, cfg, 0.37, torch.as_tensor(x), **tkw, **BF)
    out = out if isinstance(out, tuple) else (out,)
    _check_spec(out, _spec_rhs(w_in, b_eff, _tail(p), x, None, "silu", 0.0, 1.0, mode, [e]))


def test_fused_symplectic_velocity_bf16_matches_spec():
    """Two forward stacks, each folded from its first layer's trailing
    embedding rows, (c0, c1) = (0, +1) on p and (0, -1) on q."""
    cfg = nets.SymplecticMLPConfig(n_data_dims=2, n_conditionals=1, units=(64, 64))
    params = nets.init_symplectic_mlp(cfg, torch.Generator().manual_seed(3), "cpu")
    p = _np_params(jax.tree.map(lambda v: v.numpy(), params))
    rng = np.random.default_rng(4)
    state = rng.standard_normal((256, 4)).astype(np.float32)
    cond = rng.standard_normal((256, 1)).astype(np.float32)
    out = fused_mlp.fused_symplectic_velocity(params, cfg, 0.37, torch.as_tensor(state), torch.as_tensor(cond), **BF)
    temb = _temb(0.37, p["W"])
    halves = []
    for stack, other, sign in (("q_layers", state[:, 2:], 1.0), ("p_layers", state[:, :2], -1.0)):
        w1 = p[stack][0]["w"]
        b_eff = p[stack][0]["b"] + temb @ w1[3:]
        halves.append(_spec_rhs(w1[:3], b_eff, _tail(p, stack), other, cond, "silu", 0.0, sign, "forward")[0])
    _check_spec([out], [np.concatenate(halves, axis=1)])


# ---------------------------------------------------------------------------
# the accuracy class against the JAX float32 kernel
# ---------------------------------------------------------------------------


def _jax_score_pair(d, c, units):
    jcfg = jnets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units)
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(0), jcfg)
    cfg = nets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _flagship_pair():
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    jm = jckpt.load_npz(FLAGSHIP, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg,
                                              sde=JVESDE()))
    return jm.net, jm.params, nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), \
        params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu")


@pytest.mark.parametrize("net", ["flagship", "conditional"])
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_fused_drift_bf16_within_accuracy_class_of_jax_float32(mode, net):
    jcfg, jparams, cfg, params = _flagship_pair() if net == "flagship" else _jax_score_pair(3, 2, (128, 128))
    D, C = cfg.n_dimensions, cfg.n_conditionals
    x, cond, e, _ = _rows(64, D, C, seed=7)
    kw_j = {"e": jnp.asarray(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    kw_t = {"e": torch.as_tensor(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    out = fused_mlp.fused_drift(params, cfg, 0.37, torch.as_tensor(x), None if cond is None else torch.as_tensor(cond),
                                c0=-0.3, c1=0.9, **kw_t, **BF)
    ref = jfm.fused_drift(jparams, jcfg, jnp.float32(0.37), jnp.asarray(x), None if cond is None else jnp.asarray(cond),
                          c0=-0.3, c1=0.9, interpret=True, tile=64, compute_dtype="float32", **kw_j)
    out, ref = (o if isinstance(o, tuple) else (o,) for o in (out, ref))
    for o, r in zip(out, ref):
        # within the class, and off float32: the mode is on
        assert 1e-5 <= _rel(_np(o), r) <= ACCURACY_CLASS, _rel(_np(o), r)


def test_flagship_rk4_log_prob_bf16_against_jax_float32():
    """The flagship's exact-trace ``log_prob`` at a pinned step (rk4 x 6) on
    the bf16 plain RHS against the JAX package's float32 solve on the same
    grid: mean |d log p| 1.10e-2 measured here (max 0.159; the float32 RHS
    gives 8.1e-7), held at the card's bar for the mode, 5e-2
    (BENCHMARKS.md:514-518)."""
    jcfg, jparams, cfg, params = _flagship_pair()
    jm = JScoreModel(params=jparams, net=jcfg, sde=JVESDE(), use_fused_kernel=False)
    tm = ScoreModel(params, cfg, VESDE(), use_fused_kernel=True, **{"kernel_compute_dtype": "bfloat16"})
    x = np.random.default_rng(3).standard_normal((256, 2)).astype(np.float32)
    opts = {"steps": 6}
    jlp, _ = jax.jit(lambda m, xx: m.log_prob(xx, method="rk4", options=opts))(jm, jnp.asarray(x))
    lp, _ = tm.log_prob(torch.as_tensor(x), method="rk4", options=opts)
    err = np.abs(lp.numpy() - np.asarray(jlp))
    assert np.isfinite(lp.numpy()).all() and err.mean() <= 5e-2, (err.mean(), err.max())
    assert err.mean() >= 1e-5  # the bf16 RHS, not the float32 one


# ---------------------------------------------------------------------------
# the EM kernel's plain version
# ---------------------------------------------------------------------------


def _em_case():
    jcfg, jparams, cfg, params = _jax_score_pair(2, 2, (64, 64, 64))
    rng = np.random.default_rng(9)
    B, steps = 128, 10
    x0 = (rng.standard_normal((B, 2)) * 5.0).astype(np.float32)
    noise = rng.standard_normal((steps, B, 2)).astype(np.float32)
    cond = rng.standard_normal((B, 2)).astype(np.float32)
    return jcfg, jparams, cfg, params, x0, noise, cond, steps


def test_em_bf16_matches_spec():
    """The EM loop with streamed noise (10 steps) against a numpy spec of
    the JAX kernel's body (em_sampler.py:202-236) in bfloat16: the per-step
    tables from the JAX ``em_prep``, the conditional projection in f32."""
    jcfg, jparams, cfg, params, x0, noise, cond, steps = _em_case()
    xm, x, div = em_sampler.fused_em_sample_reference(params, cfg, VESDE(), torch.as_tensor(x0),
                                                      torch.as_tensor(noise), torch.as_tensor(cond), steps, **BF)
    coeffs, b_eff = (np.asarray(v, np.float32) for v in jes.em_prep(jparams, jcfg, JVESDE(), steps, no_sigma=False))
    p = _np_params(jparams)
    w1 = p["layers"][0]["w"]
    E = jcfg.embedding_dimensions
    cond_proj = cond @ w1[E + 2:]
    sx = x0
    for s in range(steps):
        a = _in_proj(sx, w1[E:E + 2]) + b_eff[s] + cond_proj
        for w, b in _tail(p):
            a = _mm(_pair(a, "silu")[0], w) + b
        mean = coeffs[s, 0] * sx + coeffs[s, 1] * a
        sx = mean + coeffs[s, 2] * noise[s]
    assert not bool(div)
    for port, spec in ((x, sx), (xm, mean)):
        assert _rel(_np(port), spec) <= SPEC_MAX and _mean_rel(_np(port), spec) <= SPEC_MEAN, \
            (_rel(_np(port), spec), _mean_rel(_np(port), spec))


def test_em_bf16_within_accuracy_class_of_jax_float32():
    jcfg, jparams, cfg, params, x0, noise, cond, steps = _em_case()
    coeffs, b_eff = jes.em_prep(jparams, jcfg, JVESDE(), steps, no_sigma=False)
    layers = jparams["layers"]
    E = jcfg.embedding_dimensions
    hidden = []
    for lyr in layers[1:-1]:
        hidden += [lyr["w"], lyr["b"][None, :]]
    jxm, jx, _ = jes._fused_em_impl(
        jnp.asarray(x0), jnp.asarray([0], jnp.int32), jnp.asarray(noise), jnp.asarray(cond) @ layers[0]["w"][E + 2:],
        coeffs, b_eff, layers[0]["w"][E:E + 2], tuple(hidden), layers[-1]["w"], layers[-1]["b"][None, :],
        steps=steps, n_hidden=len(layers) - 1, d_out=2, tile=x0.shape[0], interpret=True,
        compute_dtype="float32", activation="silu",
    )
    xm, x, _ = em_sampler.fused_em_sample_reference(params, cfg, VESDE(), torch.as_tensor(x0), torch.as_tensor(noise),
                                                    torch.as_tensor(cond), steps, **BF)
    for port, ref in ((x, jx), (xm, jxm)):
        assert 1e-6 <= _rel(_np(port), ref) <= ACCURACY_CLASS, _rel(_np(port), ref)


# ---------------------------------------------------------------------------
# models and serving in bfloat16
# ---------------------------------------------------------------------------


def _small_model(**kw):
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(32, 32))
    return ScoreModel(nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, VESDE(),
                      kernel_compute_dtype="bfloat16", **kw)


def test_bf16_artifact_holds_the_mode_and_matches_eager(monkeypatch):
    """A bfloat16 model's likelihood artifact calls the op in compute mode
    'bfloat16' and serves bitwise the eager solve through the op."""
    tol = dict(atol=1e-4, rtol=1e-4)
    m = _small_model(trace_mode="hutchinson")
    f = serving.deserialize_log_prob(serving.export_log_prob(m, **tol))
    gm = f.program.graph_module
    ops = [n for g in [gm, *gm.children()] for n in g.graph.nodes
           if n.op == "call_function" and "fused_mlp" in str(n.target)]
    assert ops and all("bfloat16" in n.args for n in ops)
    monkeypatch.setattr(fused_mlp, "_on_card", lambda x: True)
    eager = serving._set_kernel(_small_model(trace_mode="hutchinson"), True)
    for n in (16, 5):
        x = torch.from_numpy(np.random.default_rng(n).standard_normal((n, 2)).astype(np.float32))
        ref, _ = eager.log_prob(x, generator=torch.Generator().manual_seed(2), **tol)
        assert torch.equal(f(x, seed=2), ref)


@pytest.mark.parametrize("trace_mode", ["hutchpp", "xtrace"])
def test_bf16_sketch_solve_raises_naming_3b(trace_mode, monkeypatch):
    """Named for the refusal it held until the sketch kernel had a bfloat16
    mode (queue 2 #3b): a bfloat16 model's Hutch++ or XTrace solve on the
    CPU runs the sketch kernel's bf16 plain version at every RHS call, and
    its log-densities match the same solve on the spec's RHS at a pinned
    step (rk4 x 4) within the bf16 bars: mean |d| <= 1e-5 of the max, 10x
    closer than the spec's solve is to the float32 one."""
    m = _small_model(trace_mode=trace_mode, use_fused_kernel=True)
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.standard_normal((64, 2)).astype(np.float32))
    if trace_mode == "hutchpp":
        probes = tuple(torch.as_tensor(np.sign(rng.standard_normal((1, 64, 2))).astype(np.float32)) for _ in range(2))
    else:
        g = rng.standard_normal((2, 64, 2))
        probes = (torch.as_tensor((g / np.linalg.norm(g, axis=-1, keepdims=True) * np.sqrt(2)).astype(np.float32)),)
    kw = dict(probes=probes, method="rk4", options={"steps": 4})
    calls = []
    plain = fused_sketch._bf16_sketch_reference
    monkeypatch.setattr(fused_sketch, "_bf16_sketch_reference", lambda *a: calls.append(1) or plain(*a))
    lp, _ = m.log_prob(x, **kw)
    assert len(calls) == 16  # rk4 x 4: four evaluations a step
    lp32, _ = dataclasses.replace(m, kernel_compute_dtype="float32").log_prob(x, **kw)
    monkeypatch.setattr(score_mod, "fused_drift_sketch", _spec_sketch_drift(m))
    lp_spec, _ = m.log_prob(x, **kw)
    lp, lp_spec, lp32 = (v.numpy() for v in (lp, lp_spec, lp32))
    assert np.isfinite(lp).all()
    assert _mean_rel(lp, lp_spec) <= SPEC_MEAN and _mean_rel(lp, lp_spec) <= 0.1 * _mean_rel(lp_spec, lp32), \
        (_mean_rel(lp, lp_spec), _mean_rel(lp_spec, lp32))
    assert dataclasses.replace(m, use_fused_kernel=False).log_prob(x, probes=probes)[0].shape == (64,)
