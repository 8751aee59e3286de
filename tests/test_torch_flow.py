"""The flow-matching family of the port (``ODEFlow``, the velocity net and
``fused_velocity``) against the JAX package, on the CPU.

* The velocity net on ``benchmarks/flow_ckpt.npz`` within 1e-6.
* ``fused_velocity`` (its plain version, on CPU tensors) against the JAX
  ``fused_velocity`` in interpret mode, modes forward/hutchinson/exact:
  velocity within 1e-5 and divergence within 1e-4 relative, the JAX
  package's fused-versus-plain bars (bench.py:320-321).
* ``ODEFlow.log_prob`` on 512 rows, exact and Hutchinson with the same
  numpy probes: equal solver counts and mean |dlogp| <= 1e-4; ``sample``:
  equal counts, samples within 1e-4 of their scale.
* The conditional form on random weights carried across by
  ``params_from_numpy``.
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
from flowfusion_tpu.models.flow import ODEFlow as JODEFlow
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_torch.kernels import fused_mlp
from flowfusion_torch.models import nets
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

FLOW = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "flow_ckpt.npz")


@pytest.fixture(scope="module")
def flow_pair():
    from benchmarks.make_flow_symplectic_ckpts import load_flow_model

    jm = dataclasses.replace(load_flow_model()[0], use_fused_kernel=False)
    tm, extra = ODEFlow.from_npz(FLOW, device="cpu")
    assert extra["family"] == "flow"
    return jm, tm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _stats(st):
    return tuple(int(v) for v in st[:3])


def test_from_npz_and_velocity_net_match_jax(flow_pair):
    jm, tm = flow_pair
    assert tm.net == nets.VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128))
    np.testing.assert_array_equal(tm.target_scale.numpy(), np.asarray(jm.target_scale))
    np.testing.assert_array_equal(tm.target_shift.numpy(), np.asarray(jm.target_shift))
    x = np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32)
    for t in (0.0, 0.37, 1.0):
        ref = jm.dynamics(jnp.float32(t), jnp.asarray(x))
        got = tm.dynamics(torch.tensor(t), torch.as_tensor(x))
        assert _rel(got.numpy(), ref) <= 1e-6


def _run_velocity(mode, jcfg, jparams, cfg, params, x, cond, e, t=0.41):
    kw_j = {"e": jnp.asarray(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    kw_t = {"e": torch.as_tensor(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    ref = jfm.fused_velocity(
        jparams, jcfg, jnp.float32(t), jnp.asarray(x), None if cond is None else jnp.asarray(cond),
        interpret=True, tile=x.shape[0], **kw_j,
    )
    c = None if cond is None else torch.as_tensor(cond)
    before = fused_mlp.fused_velocity.launches
    out = fused_mlp.fused_velocity(params, cfg, torch.tensor(t), torch.as_tensor(x), c, **kw_t)
    assert fused_mlp.fused_velocity.launches == before  # CPU tensors: the plain version
    plain = fused_mlp.fused_velocity_reference(params, cfg, t, torch.as_tensor(x), c, **kw_t)
    if mode == "forward":
        out, ref, plain = (out,), (ref,), (plain,)
    assert _rel(out[0].numpy(), ref[0]) <= 1e-5
    torch.testing.assert_close(out[0], plain[0], rtol=0, atol=0)
    if mode != "forward":
        assert _rel(out[1].numpy(), ref[1]) <= 1e-4


@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_fused_velocity_matches_jax_kernel_on_flow_ckpt(flow_pair, mode):
    jm, tm = flow_pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((48, 2)).astype(np.float32)
    e = np.sign(rng.standard_normal((48, 2))).astype(np.float32)
    _run_velocity(mode, jm.net, jm.params, tm.net, tm.params, x, None, e)


@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_fused_velocity_conditional_and_padded(mode):
    """A conditional velocity net of odd widths, padded by pad_to_lanes
    on the port's side (to 100) and the JAX side (to 128): both exact."""
    jcfg = jnets.VelocityMLPConfig(target_dimension=3, conditional_dimension=2, hidden_units=(100, 60))
    jparams = jnets.init_velocity_mlp(jax.random.PRNGKey(3), jcfg)
    cfg = nets.VelocityMLPConfig(target_dimension=3, conditional_dimension=2, hidden_units=(100, 60))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    padded, pcfg = fused_mlp.pad_to_lanes(params, cfg)
    assert pcfg.hidden_units == (100, 100) and padded["layers"][1]["w"].shape == (100, 100)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    cond = rng.standard_normal((40, 2)).astype(np.float32)
    e = np.sign(rng.standard_normal((40, 3))).astype(np.float32)
    _run_velocity(mode, jcfg, jparams, cfg, params, x, cond, e)


@pytest.mark.parametrize("mode", ["exact", "hutchinson"])
def test_flow_log_prob_matches_jax(flow_pair, mode):
    jm, tm = flow_pair
    jm = dataclasses.replace(jm, trace_mode=mode)
    tm = dataclasses.replace(tm, trace_mode=mode)
    x = (np.random.default_rng(4).standard_normal((512, 2)) * 2.0).astype(np.float32)
    key = jax.random.PRNGKey(5)
    # jit pins the JAX call to one unsharded solve
    jlp, jst = jax.jit(lambda m, xx: m.log_prob(xx, key=key))(jm, jnp.asarray(x))
    x_std = (jnp.asarray(x) - jm.target_shift) / jm.target_scale
    probes = tuple(torch.as_tensor(np.asarray(p)) for p in jtrace.make_probes(mode, key, x_std))
    lp, st = tm.log_prob(torch.as_tensor(x), probes=probes)
    assert _stats(st) == _stats(jst)
    err = np.abs(lp.numpy() - np.asarray(jlp))
    assert err.mean() <= 1e-4, (err.mean(), err.max())
    # use_fused_kernel=True on CPU tensors runs the wrapper's plain version
    lp_f, st_f = dataclasses.replace(tm, use_fused_kernel=True).log_prob(torch.as_tensor(x), probes=probes)
    assert _stats(st_f) == _stats(st) and float((lp_f - lp).abs().max()) <= 1e-5


def test_flow_sample_matches_jax(flow_pair):
    jm, tm = flow_pair
    z = np.random.default_rng(6).standard_normal((256, 2)).astype(np.float32)
    js, jst = jax.jit(lambda m, zz: m.sample(zz, rtol=1e-5, atol=1e-5))(jm, jnp.asarray(z))
    s, st = tm.sample(torch.as_tensor(z), rtol=1e-5, atol=1e-5)
    assert _stats(st) == _stats(jst)
    assert _rel(s.numpy(), js) <= 1e-4


def test_conditional_flow_matches_jax():
    jm = JODEFlow.create(
        jax.random.PRNGKey(7), target_dimension=2, conditional_dimension=2, hidden_units=(32, 32),
        target_shift=jnp.asarray([0.5, -1.0]), target_scale=jnp.asarray([2.0, 0.5]),
        conditional_shift=jnp.asarray([1.0, 0.0]), conditional_scale=jnp.asarray([3.0, 1.5]),
        use_fused_kernel=False,
    )
    tree = jax.tree.map(np.asarray, {
        "params": jm.params, "target_shift": jm.target_shift, "target_scale": jm.target_scale,
        "conditional_shift": jm.conditional_shift, "conditional_scale": jm.conditional_scale,
    })
    t = params_from_numpy(tree, "cpu")
    cfg = nets.VelocityMLPConfig(target_dimension=2, conditional_dimension=2, hidden_units=(32, 32))
    tm = ODEFlow(t.pop("params"), net=cfg, **t)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((128, 2)).astype(np.float32)
    c = rng.standard_normal((128, 2)).astype(np.float32)
    opts = {"min_step": 0.02}
    jlp, jst = jax.jit(lambda m, xx, cc: m.log_prob(xx, cc, options=opts))(jm, jnp.asarray(x), jnp.asarray(c))
    lp, st = tm.log_prob(torch.as_tensor(x), torch.as_tensor(c), options=opts)
    assert _stats(st) == _stats(jst)
    assert np.abs(lp.numpy() - np.asarray(jlp)).mean() <= 1e-4
    js, _ = jax.jit(lambda m, xx, cc: m.sample(xx, cc, rtol=1e-5, atol=1e-5, options=opts))(
        jm, jnp.asarray(x), jnp.asarray(c))
    s, _ = tm.sample(torch.as_tensor(x), torch.as_tensor(c), rtol=1e-5, atol=1e-5, options=opts)
    assert _rel(s.numpy(), js) <= 1e-4
    # the conditional must reach the net
    lp2, _ = tm.log_prob(torch.as_tensor(x), torch.as_tensor(c) + 1.0, options=opts)
    assert float((lp2 - lp).abs().max()) > 1e-3


@dataclasses.dataclass(frozen=True)
class AnalyticLinearVelocity:
    """v(x, t) = a x: x(1) = x(0) e^a, log|det J| = a D."""

    a: float = -0.5

    def apply(self, params, t, x, conditional=None):
        return self.a * x


def test_linear_flow_closed_form_and_scale_correction():
    a, s = -0.7, 2.5
    flow = ODEFlow({}, torch.zeros(2), torch.full((2,), s), None, None, net=AnalyticLinearVelocity(a))
    x = torch.tensor([[0.5, -0.3], [1.0, 0.2]]) * s
    lp, st = flow.log_prob(x, atol=1e-7, rtol=1e-7)
    xT = (x / s).numpy() * np.exp(a)
    expected = np.sum(-0.5 * xT**2 - 0.5 * np.log(2 * np.pi), axis=1) + 2 * a - 2 * np.log(s)
    np.testing.assert_allclose(lp.numpy(), expected, atol=1e-4)
    assert st.succeeded
    xt, target = flow.compute_linear_velocity_field(x, torch.ones(2, 2), 0.25)
    np.testing.assert_allclose(target.numpy(), 1.0 - (x / s).numpy(), rtol=1e-6)
    np.testing.assert_allclose(xt.numpy(), 0.75 * (x / s).numpy() + 0.25, rtol=1e-6)


def test_flow_create_and_refusals(flow_pair):
    _, tm = flow_pair
    m = ODEFlow.create(target_dimension=2, conditional_dimension=1, hidden_units=(16,),
                       generator=torch.Generator().manual_seed(0), device="cpu")
    assert m.params["layers"][0]["w"].shape == (4, 16) and m.conditional_scale.shape == (1,)
    x = torch.zeros(4, 2)
    # training is ported: both loss entries draw the same from equal seeds
    losses = [fn(torch.Generator().manual_seed(0), x) for fn in (tm.flow_matching_loss, tm.loss_fn)]
    assert torch.isfinite(losses[0]) and torch.equal(losses[0], losses[1])
    for call, item in (
        (lambda: dataclasses.replace(tm, trace_mode="xtrace").log_prob(x, adjoint=True), "no gradient"),
        (lambda: dataclasses.replace(tm, trace_mode="xtrace").log_prob_per_sample(x), "batch-coupled"),
    ):
        with pytest.raises(NotImplementedError, match=item):
            call()
    # the sketch kernel takes bfloat16 too (queue 2 #3b): on the CPU its plain version
    lp_bf, _ = dataclasses.replace(tm, kernel_compute_dtype="bfloat16", trace_mode="xtrace",
                                   use_fused_kernel=True).log_prob(x, probes=(torch.ones(1, 4, 2),))
    assert lp_bf.shape == (4,) and bool(torch.isfinite(lp_bf).all())
    # the solvers of item 13 run: adjoint gradients, per-sample stepping
    xr = torch.randn(4, 2, generator=torch.Generator().manual_seed(2))
    s_g, st = tm.sample(xr, gradients=True, rtol=1e-5, atol=1e-5)
    assert st is None and torch.isfinite(s_g).all()
    lp_a, st = tm.log_prob(xr, adjoint=True)
    lp, _ = tm.log_prob(xr)
    assert st is None and float((lp_a - lp).abs().max()) <= 1e-5
    lp_ps, st_ps = tm.log_prob_per_sample(xr)
    assert st_ps.n_func_evals.shape == (4,) and float((lp_ps - lp).abs().max()) <= 1e-2
    with pytest.raises(ValueError, match="probe"):
        dataclasses.replace(tm, trace_mode="hutchinson").log_prob(x)
    with pytest.raises(ValueError, match="parameters are on"):
        tm.sample(torch.zeros(4, 2, device="meta"))
    # highf32 and bfloat16 are ported; an unknown compute mode raises
    assert fused_mlp.fused_velocity(tm.params, tm.net, 0.5, x, compute_dtype="highf32").shape == x.shape
    assert fused_mlp.fused_velocity(tm.params, tm.net, 0.5, x, compute_dtype="bfloat16").shape == x.shape
    with pytest.raises(ValueError, match="unknown"):
        fused_mlp.fused_velocity(tm.params, tm.net, 0.5, x, compute_dtype="float16")
    # auto dispatch on a CUDA tensor takes the kernel (a stand-in plays it)
    on_card = type("OnCard", (), {"is_cuda": True})()
    assert all(tm._fused_available(on_card, mode) for mode in ("forward", "hutchinson", "exact"))
    assert not tm._fused_available(x, "exact")
