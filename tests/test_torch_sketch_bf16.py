"""Compute mode ``bfloat16`` of the one-launch Hutch++/XTrace kernel
(``kernels.fused_sketch``), and the bf16 solve's step count, on the CPU.

On CPU tensors the sketch wrappers run their bf16 plain versions
(``fused_sketch._bf16_sketch_reference``): the ``ops.trace`` estimator's
algebra over A v = c0 v + c1 J_net v, each application the explicit bf16
chain of ``fused_mlp._bf16_chains``.  ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold the CUDA kernel against them on the card.

JAX cannot run the mode on the CPU (``tests/test_torch_bf16.py``'s
docstring: its CPU runtime refuses bf16 x bf16 dots), so the cross-package
spec is the JAX package's own estimator algebra,
``flowfusion_tpu/ops/trace.py::hutchpp_core`` and ``xtrace_core``, over an
operator given by the numpy spec of the JAX kernel's rounding points
(``test_torch_bf16._spec_chains``): the JAX kernel's ``_sketch_chunk``
(kernels/fused_mlp.py:673-754) runs exactly that algebra over its
``apply_A``, whose tangents round like the drift in ``bfloat16``.

Bars, PR 15's for the mode: the mean |d| within 1e-5 of the max magnitude,
and 10x closer to the spec in the mean than the spec is to strict float32
(a skipped rounding point fails it).  There is no max bar: a sum order
moves the odd activation across a bf16 rounding boundary, and the per-row
QR turns that into larger steps on near-singular rows.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from flowfusion_torch.kernels import fused_mlp, fused_sketch
from flowfusion_torch.models import nets
from flowfusion_torch.models import score as score_mod
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.utils.checkpoint import load_npz
from flowfusion_torch.utils.convert import params_from_numpy
from test_torch_bf16 import _fold_score, _np_params, _spec_rhs, _spec_sketch, _spec_sketch_drift, _tail

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
FLAGSHIP = os.path.join(BENCH, "flagship_ckpt.npz")
SPEC_MEAN = 1e-5  # mean |d| against the spec, of the max magnitude
BF = dict(compute_dtype="bfloat16")


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _mean_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean(np.abs(a - b)) / np.max(np.abs(b)))


def _check(port, spec, strict):
    """PR 15's bf16 bars, output by output: the mean within ``SPEC_MEAN``,
    and 10x below the spec's own mean distance from strict float32."""
    for p, s, f in zip(port, spec, strict):
        p, s, f = _np(p), np.asarray(s), _np(f)
        assert np.isfinite(p).all()
        assert _mean_rel(p, s) <= SPEC_MEAN, _mean_rel(p, s)
        assert _mean_rel(p, s) <= 0.1 * _mean_rel(s, f), (_mean_rel(p, s), _mean_rel(s, f))


def _probes(mode, B, D, r, m, seed):
    """Hutch++ Rademacher (r sketch, m residual) or XTrace sphere (m)
    probes, as the sketch tests draw them: no zero row."""
    rng = np.random.default_rng(seed)
    if mode == "hutchpp":
        return tuple(np.sign(rng.standard_normal((k, B, D))).astype(np.float32) for k in (r, m))
    g = rng.standard_normal((m, B, D))
    return ((g / np.linalg.norm(g, axis=-1, keepdims=True) * np.sqrt(D)).astype(np.float32),)


def _family(family, C):
    """(params, cfg, numpy params, first-layer fold(t, with_cond), c0, c1):
    the flagship checkpoint, a small conditional score net, and velocity
    nets with and without a conditional."""
    if family == "drift" and C == 0:
        params = params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu")
        cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    elif family == "drift":
        cfg = nets.ScoreMLPConfig(n_dimensions=3, n_conditionals=C, units=(64, 64), activation="tanh")
        params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(5), "cpu")
    else:
        cfg = nets.VelocityMLPConfig(target_dimension=2 if C == 0 else 3, conditional_dimension=C,
                                     hidden_units=(96, 96))
        params = nets.init_velocity_mlp(cfg, torch.Generator().manual_seed(6), "cpu")
    p = _np_params(jax.tree.map(lambda v: v.numpy(), params))
    if family == "drift":
        def fold(t, with_cond):
            return _fold_score(p, cfg.embedding_dimensions, cfg.n_dimensions, with_cond, t)
        return params, cfg, p, fold, -0.3, 0.9

    def fold(t, with_cond):
        w1, D = p["layers"][0]["w"], cfg.target_dimension
        w_in = np.concatenate([w1[:D], w1[D + 1:]]) if with_cond else w1[:D]
        return w_in, p["layers"][0]["b"] + np.float32(t) * w1[D]
    return params, cfg, p, fold, 0.0, 1.0


def _case(family, C, mode, B=256, seed=1):
    params, cfg, p, fold, c0, c1 = _family(family, C)
    D = cfg.n_dimensions if family == "drift" else cfg.target_dimension
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D)).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32) if C else None
    r, m = (2, 1) if mode == "hutchpp" else (0, 2)
    if D > 2:
        r, m = (2, 2) if mode == "hutchpp" else (0, 3)
    return params, cfg, p, fold, c0, c1, x, cond, _probes(mode, B, D, r, m, seed + 1)


# ---------------------------------------------------------------------------
# the wrappers' plain versions against the spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("C", [0, 3])
@pytest.mark.parametrize("family", ["drift", "velocity"])
def test_bf16_sketch_plain_version_matches_spec(family, C, mode):
    """Both sketch wrappers on CPU tensors in bfloat16 (the flagship
    checkpoint's drift at c0 != 0, a conditional tanh score net, velocity
    nets with and without a conditional) against the spec, at PR 15's
    bars, drift and divergence."""
    params, cfg, p, fold, c0, c1, x, cond, probes = _case(family, C, mode)
    fn = fused_sketch.fused_drift_sketch if family == "drift" else fused_sketch.fused_velocity_sketch
    kw = dict(c0=c0, c1=c1) if family == "drift" else {}
    tc = None if cond is None else torch.as_tensor(cond)
    tp = tuple(torch.as_tensor(v) for v in probes)
    out = fn(params, cfg, 0.37, torch.as_tensor(x), tp, mode, tc, **kw, **BF)
    strict = fn(params, cfg, 0.37, torch.as_tensor(x), tp, mode, tc, **kw)
    w_in, b_eff = fold(0.37, C > 0)
    spec = _spec_sketch(w_in, b_eff, _tail(p), x, cond, cfg.activation, c0, c1, probes, mode)
    _check(out, spec, strict)


def test_bf16_sketch_op_cpu_kernel_is_the_plain_version():
    """The registered op's CPU kernel (what an exported program runs on CPU
    tensors) in bfloat16 is the wrapper's plain version, bitwise."""
    params, cfg, p, fold, c0, c1, x, cond, probes = _case("drift", 3, "xtrace")
    tx, tc = torch.as_tensor(x), torch.as_tensor(cond)
    tp = tuple(torch.as_tensor(v) for v in probes)
    ref = fused_sketch.fused_drift_sketch_reference(params, cfg, 0.37, tx, tp, "xtrace", tc, c0=c0, c1=c1, **BF)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, torch.tensor(0.37), tc)
    hidden = params["layers"][1:-1]
    out = fused_sketch._fused_sketch_op_cpu(
        torch.cat([tx, tc], dim=-1), tp[0], w_in, b_eff, [l["w"] for l in hidden], [l["b"] for l in hidden],
        params["layers"][-1]["w"], params["layers"][-1]["b"], torch.tensor([c0, c1]), "xtrace", 3, 3, 0,
        cfg.activation, "bfloat16", "fused_drift_sketch", 0, 0)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


# ---------------------------------------------------------------------------
# a bf16 model's sketch log_prob against the spec's solve
# ---------------------------------------------------------------------------


def _flagship_model(trace_mode, **kw):
    params = params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu")
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    return ScoreModel(params, cfg, VESDE(), trace_mode=trace_mode, use_fused_kernel=True, **kw)


@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
def test_bf16_sketch_log_prob_matches_spec_solve(mode, monkeypatch):
    """A bf16 ``ScoreModel`` (the flagship checkpoint) with each sketch
    trace: its ``log_prob`` on the CPU, the bf16 plain version under the
    solver, against the same solve with the spec's RHS, at a pinned step
    (rk4 x 6) so that the step count cannot differ; the 10x guard against
    the model's float32 solve."""
    kw = dict(hpp_rank=2, hpp_vecs=1) if mode == "hutchpp" else dict(xt_vecs=2)
    model = _flagship_model(mode, kernel_compute_dtype="bfloat16", **kw)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((256, 2)).astype(np.float32))
    probes = tuple(torch.as_tensor(v) for v in _probes(mode, 256, 2, 2 if mode == "hutchpp" else 0,
                                                       1 if mode == "hutchpp" else 2, 4))
    opts = dict(method="rk4", options={"steps": 6}, probes=probes)
    lp, _ = model.log_prob(x, **opts)
    lp32, _ = dataclasses.replace(model, kernel_compute_dtype="float32").log_prob(x, **opts)
    monkeypatch.setattr(score_mod, "fused_drift_sketch", _spec_sketch_drift(model))
    lp_spec, _ = model.log_prob(x, **opts)
    _check([lp], [_np(lp_spec)], [lp32])


# ---------------------------------------------------------------------------
# the plan: the envelope widths in the three modes
# ---------------------------------------------------------------------------

# (mode, features, D, r or m, residual probes, widest H in float32, in
# highf32, in bfloat16): the flagship Hutch++ r = 2, m = 1 and XTrace m = 2,
# the conditional checkpoints' D = 6, C = 3, r = m = 3, three hidden
# layers.  float32 and highf32 share a layout (highf32 pads to 8, so its
# widest is float32's rounded down to 8); bfloat16 keeps one fp32 chain
# buffer and one 2-byte plane (rows H + 8 apart) where the others keep two
# fp32 buffers, 6 bytes a chain value against 8, so its widest is wider.
_SKETCH_ENVELOPE = [
    ("hutchpp", 2, 2, 2, 1, 1612, 1608, 1920),
    ("xtrace", 2, 2, 2, 0, 2072, 2072, 2400),
    ("hutchpp", 9, 6, 3, 3, 964, 960, 1200),
    ("xtrace", 9, 6, 3, 0, 1608, 1608, 1920),
]


@pytest.mark.parametrize("mode, n_features, D, n_s, n_g, widest_float32, widest_highf32, widest_bfloat16",
                         _SKETCH_ENVELOPE)
def test_sketch_envelope_widths(mode, n_features, D, n_s, n_g, widest_float32, widest_highf32, widest_bfloat16):
    for dtype, widest in (("float32", widest_float32), ("highf32", widest_highf32), ("bfloat16", widest_bfloat16)):
        assert fused_sketch.supports_sketch(mode, widest, 3, n_features, D, n_s, n_g, dtype)
        assert not fused_sketch.supports_sketch(mode, widest + fused_mlp.lane(dtype), 3, n_features, D, n_s, n_g,
                                                dtype)
    assert widest_bfloat16 >= widest_float32


def test_bf16_sketch_plan_counts_the_plane():
    """The bfloat16 plan's bytes: the act' store, one fp32 chain buffer and
    one bf16 plane of kmax chains (rows H + 8 apart), the input and probe
    tiles and XTrace's R of the QR (m x m past a 2-feature input tile); the
    flagship plans keep float32's rows at three blocks an SM."""
    for mode, n_s, n_g, ncols, kmax, n_alg in (("hutchpp", 2, 1, 3, 3, 0), ("xtrace", 2, 0, 4, 2, 4)):
        rows, smem, md = fused_sketch.sketch_plan(mode, 128, 3, 2, 2, n_s, n_g, compute_dtype="bfloat16")
        assert smem == 4 * rows * (3 * 128 + 2 + ncols * 2 + n_alg) + 6 * kmax * rows * 136
        assert md == 2 and fused_sketch.sketch_blocks((rows, smem, md)) == 3
        assert rows == fused_sketch.sketch_plan(mode, 128, 3, 2, 2, n_s, n_g)[0]
    assert fused_sketch.sketch_plan("hutchpp", 128, 3, 2, 2, 2, 1, rows=4, compute_dtype="bfloat16")[1] == \
        4 * 4 * (3 * 128 + 2 + 6) + 6 * 3 * 4 * 136


# ---------------------------------------------------------------------------
# the bf16 solve's step count (ROADMAP queue 3 #1)
# ---------------------------------------------------------------------------


def _spec_hutchinson_rhs(model):
    """The Hutchinson RHS of the numpy spec as a stand-in for
    ``fused_drift``: the JAX kernel's bf16 rounding points, the fold as the
    JAX wrapper folds it."""
    p = _np_params(jax.tree.map(lambda v: v.numpy(), model.params))
    E, D = model.net.embedding_dimensions, model.net.n_dimensions

    def rhs(params, cfg, t, x, conditional=None, e=None, exact_divergence=False, c0=0.0, c1=1.0,
            compute_dtype="float32"):
        assert compute_dtype == "bfloat16" and e is not None
        w_in, b_eff = _fold_score(p, E, D, False, float(t))
        drift, div = _spec_rhs(w_in, b_eff, _tail(p), _np(x), None, cfg.activation, np.float32(float(c0)),
                               np.float32(float(c1)), "hutchinson", [_np(e)])
        return torch.as_tensor(drift), torch.as_tensor(div)
    return rhs


def bf16_step_counts(rows, seed=0):
    """The NFE of the flagship Hutchinson ``log_prob`` (``rows`` data rows,
    one fixed Rademacher probe, dopri5 at atol = rtol = 1e-5) under the I
    and the PI controller: in float32, through the port's bf16 plain RHS
    (``fused_drift_reference(..., compute_dtype="bfloat16")``, reached
    through the model on CPU tensors) and through the numpy spec's RHS.
    Returns {controller: {"float32": n, "port": n, "spec": n}}."""
    model = _flagship_model("hutchinson")
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((rows, 2)).astype(np.float32))
    e = torch.as_tensor(np.sign(rng.standard_normal((rows, 2))).astype(np.float32))
    out = {}
    for controller in ("i", "pi"):
        kw = dict(probes=(e,), atol=1e-5, rtol=1e-5, options={"controller": controller})
        counts = {"float32": model.log_prob(x, **kw)[1].n_func_evals}
        bf = dataclasses.replace(model, kernel_compute_dtype="bfloat16")
        counts["port"] = bf.log_prob(x, **kw)[1].n_func_evals
        saved = score_mod.fused_drift
        score_mod.fused_drift = _spec_hutchinson_rhs(model)
        try:
            counts["spec"] = bf.log_prob(x, **kw)[1].n_func_evals
        finally:
            score_mod.fused_drift = saved
        out[controller] = counts
    return out


def test_bf16_step_count_of_port_and_spec_agree():
    """Queue 3 #1 at 2,048 rows: the port's bf16 plain RHS and the numpy
    spec's take the same dopri5 step count within one attempt (6 NFE)
    under both controllers, and the mode costs steps against float32."""
    for controller, n in bf16_step_counts(2048).items():
        assert abs(n["port"] - n["spec"]) <= 6, (controller, n)
        assert n["port"] >= n["float32"], (controller, n)


def test_bf16_sketch_bound_counts():
    """The flops the bf16 sketch bound counts: every chain's hidden products
    on the bf16 tensor cores (the flagship: 2 r + m = 5 applications and the
    forward chain for Hutch++ r = 2, m = 1; 2 m = 4 for XTrace m = 2), the
    projections and the output layer once on the CUDA cores; highf32 counts
    the output layer three times."""
    assert fused_mlp.bf16_flops_per_row(2, 2, 128, 4, "hutchpp", 2, 1) == (393_216, 6_144)
    assert fused_mlp.bf16_flops_per_row(2, 2, 128, 4, "xtrace", 2) == (327_680, 5_120)
    tc, cc = fused_mlp.highf32_flops_per_row(2, 2, 128, 4, "hutchpp", 2, 1)
    assert tc == 393_216 and cc - 6_144 == 2 * 128 * 2 * 2 * 6
