"""The training kernel's host side and plain version against the JAX
package, on the CPU.

``fused_train_epoch`` on CPU tensors runs its plain version (autograd of the
table loss, then the kernel's Adam formula); here it is held against the
JAX package's Pallas kernel in interpret mode on the same tables, at that
package's own bars (tests/test_fused_train.py): losses rtol 1e-5 and layers
atol 3e-5, chained state 5e-5, the symplectic form 3e-4 after 6 chained
steps, flow losses rtol 1e-5 / atol 1e-6.  The Adam moments are compared
after transposing the JAX kernel's batch-in-lanes layout.  The table
builders are checked against the losses' own draws, the kernel layout's
packing against itself, the guards against the JAX package's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flowfusion_tpu.kernels import fused_train as jft
from flowfusion_tpu.models import nets as jnets
from flowfusion_torch.kernels import fused_train as ft
from flowfusion_torch.models import nets
from flowfusion_torch.ops import losses
from flowfusion_torch.ops import sde as tsde
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _tables(steps, bs, D, C=0, seed=1, symplectic=False):
    rng = np.random.default_rng(seed)
    normal = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if symplectic:
        out = dict(xt_q=normal(steps, bs, D), zw_q=normal(steps, bs, D), xt_p=normal(steps, bs, D),
                   zw_p=normal(steps, bs, D), t=rng.uniform(0, 1, (steps, bs)).astype(np.float32))
    else:
        out = dict(xt=normal(steps, bs, D), zw=normal(steps, bs, D),
                   t=rng.uniform(1e-3, 1.0, (steps, bs)).astype(np.float32),
                   beta=rng.uniform(0.5, 2.0, (steps, bs)).astype(np.float32))
    out["conditional"] = normal(steps, bs, C) if C else None
    return out


def _torch_tables(tab):
    return {k: (None if v is None else T(v)) for k, v in tab.items()}


def _assert_layers(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["w"].numpy(), np.asarray(w["w"]), atol=atol)
        np.testing.assert_allclose(g["b"].numpy(), np.asarray(w["b"]), atol=atol)


def _assert_moments(got, want, atol):
    """The port keeps (K, O) / (O,) moments, the JAX kernel (O, K) / (O, 1)."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w.T if g.ndim == 2 else w[:, 0], atol=atol)


def _score(C=0, units=(128,), D=2, key=0):
    jcfg = jnets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=units)
    jp = jnets.init_score_mlp(jax.random.PRNGKey(key), jcfg)
    return jp, jcfg, to_torch(jp), nets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=units)


@pytest.mark.parametrize(
    "C,units,D,steps,bs,lr",
    [(0, (128,), 2, 4, 32, 1e-3), (3, (128, 128), 2, 3, 48, 3e-4), (0, (128,), 2, 2, 20, 1e-3),
     (4, (128,), 20, 3, 32, 1e-3)],
    ids=["plain", "conditional_deep", "ragged_bs20", "wide_features"],
)
def test_epoch_matches_jax_kernel(C, units, D, steps, bs, lr):
    """The JAX package's cases and learning rates (tests/test_fused_train.py)."""
    jp, jcfg, tp, tcfg = _score(C, units, D)
    tab = _tables(steps, bs, D, C)
    jp2, jst, _, jl = jft.fused_train_epoch(jp, jcfg, None, lr=lr, interpret=True, **tab)
    tp2, tst, _, tl = ft.fused_train_epoch(tp, tcfg, None, lr=lr, **_torch_tables(tab))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    _assert_layers(tp2["layers"], jp2["layers"], 3e-5)
    _assert_moments(tst[0], jst[0], 1e-6)
    _assert_moments(tst[1], jst[1], 1e-6)
    assert tst[2] == jst[2] == steps
    assert tp2["W"] is tp["W"] and ft.fused_train_epoch.launches == 0  # W frozen, no launch on the CPU


def test_epoch_ema_and_chained_state_match_jax_kernel():
    """Two chained calls with the EMA on equal the JAX kernel's two chained
    calls (the step0 bias-correction carry, EMA from the previous call)."""
    jp, jcfg, tp, tcfg = _score()
    tab = _tables(6, 16, 2)
    half = [{k: None if v is None else v[sl] for k, v in tab.items()} for sl in (slice(0, 3), slice(3, 6))]
    j1 = jft.fused_train_epoch(jp, jcfg, None, lr=1e-3, ema=jp, ema_decay=0.9, interpret=True, **half[0])
    j2 = jft.fused_train_epoch(j1[0], jcfg, j1[1], lr=1e-3, ema=j1[2], ema_decay=0.9, interpret=True, **half[1])
    t1 = ft.fused_train_epoch(tp, tcfg, None, lr=1e-3, ema_decay=0.9, **_torch_tables(half[0]))
    t2 = ft.fused_train_epoch(t1[0], tcfg, t1[1], lr=1e-3, ema=t1[2], ema_decay=0.9, **_torch_tables(half[1]))
    np.testing.assert_allclose(torch.cat([t1[3], t2[3]]).numpy(), np.concatenate([j1[3], j2[3]]), rtol=1e-5)
    _assert_layers(t2[0]["layers"], j2[0]["layers"], 5e-5)
    _assert_layers(t2[2]["layers"], j2[2]["layers"], 5e-5)
    _assert_moments(t2[1][0], j2[1][0], 5e-5)
    assert t2[1][2] == j2[1][2] == 6


@pytest.mark.parametrize("C", [0, 3])
def test_flow_epoch_matches_jax_kernel(C):
    jcfg = jnets.VelocityMLPConfig(target_dimension=2, conditional_dimension=C, hidden_units=(128,))
    jp = jnets.init_velocity_mlp(jax.random.PRNGKey(0), jcfg)
    tcfg = nets.VelocityMLPConfig(target_dimension=2, conditional_dimension=C, hidden_units=(128,))
    tab = _tables(4, 32, 2, C, seed=2)
    jp2, _, _, jl = jft.fused_train_epoch(jp, jcfg, None, lr=1e-3, mean_over_dims=True, interpret=True, **tab)
    tp2, _, _, tl = ft.fused_train_epoch(to_torch(jp), tcfg, None, lr=1e-3, mean_over_dims=True,
                                         **_torch_tables(tab))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    for g, w in zip(tp2["layers"], jp2["layers"]):
        np.testing.assert_allclose(g["w"].numpy(), np.asarray(w["w"]), rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(g["b"].numpy(), np.asarray(w["b"]), rtol=2e-5, atol=2e-6)


def _sympl(C=0, units=(128,)):
    jcfg = jnets.SymplecticMLPConfig(n_data_dims=2, n_conditionals=C, units=units)
    jp = jnets.init_symplectic_mlp(jax.random.PRNGKey(0), jcfg)
    return jp, jcfg, to_torch(jp), nets.SymplecticMLPConfig(n_data_dims=2, n_conditionals=C, units=units)


@pytest.mark.parametrize("C", [0, 3])
def test_symplectic_epoch_matches_jax_kernel(C):
    jp, jcfg, tp, tcfg = _sympl(C)
    tab = _tables(4, 32, 2, C, seed=3, symplectic=True)
    jp2, jst, _, jl = jft.fused_train_epoch_symplectic(jp, jcfg, None, lr=1e-3, interpret=True, **tab)
    tp2, tst, _, tl = ft.fused_train_epoch_symplectic(tp, tcfg, None, lr=1e-3, **_torch_tables(tab))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for stack in ("q_layers", "p_layers"):
        _assert_layers(tp2[stack], jp2[stack], 3e-5)
    assert tp2["W"] is tp["W"] and tst[0][2] == tst[1][2] == jst[0][2] == 4


def test_symplectic_epoch_chained_with_ema_matches_jax_kernel():
    jp, jcfg, tp, tcfg = _sympl()
    tab = _tables(6, 16, 2, seed=4, symplectic=True)
    half = [{k: None if v is None else v[sl] for k, v in tab.items()} for sl in (slice(0, 3), slice(3, 6))]
    j1 = jft.fused_train_epoch_symplectic(jp, jcfg, None, lr=1e-3, ema=jp, ema_decay=0.9, interpret=True,
                                          **half[0])
    j2 = jft.fused_train_epoch_symplectic(j1[0], jcfg, j1[1], lr=1e-3, ema=j1[2], ema_decay=0.9,
                                          interpret=True, **half[1])
    t1 = ft.fused_train_epoch_symplectic(tp, tcfg, None, lr=1e-3, ema_decay=0.9, **_torch_tables(half[0]))
    t2 = ft.fused_train_epoch_symplectic(t1[0], tcfg, t1[1], lr=1e-3, ema=t1[2], ema_decay=0.9,
                                         **_torch_tables(half[1]))
    np.testing.assert_allclose(torch.cat([t1[3], t2[3]]).numpy(), np.concatenate([j1[3], j2[3]]), rtol=1e-5)
    for stack in ("q_layers", "p_layers"):
        _assert_layers(t2[0][stack], j2[0][stack], 3e-4)
        _assert_layers(t2[2][stack], j2[2][stack], 3e-4)


@pytest.mark.parametrize("no_sigma", [False, True])
@pytest.mark.parametrize("weighting", ["dsm", "lw"])
def test_train_tables_weighting_algebra(no_sigma, weighting):
    """z reconstructed from xt; zw and beta fold the loss weighting (the
    JAX package's tests/test_fused_train.py:220-242)."""
    sde = tsde.VPSDE()
    xb = torch.randn(3, 16, 2, generator=torch.Generator().manual_seed(3))
    xt, zw, t, beta = ft.train_tables(sde, torch.Generator().manual_seed(4), xb, no_sigma, weighting)
    assert xt.shape == xb.shape and t.shape == (3, 16)
    nu, sigma = sde.marginal_prob_scalars(t)
    z = (xt - nu[..., None] * xb) / sigma[..., None]
    if weighting == "dsm":
        torch.testing.assert_close(zw, z, rtol=1e-5, atol=1e-5)
        want_beta = sigma if no_sigma else torch.ones_like(sigma)
    else:
        g = torch.sqrt(sde.diffusion_squared_scalar(t))
        torch.testing.assert_close(zw, (g / sigma)[..., None] * z, rtol=1e-5, atol=1e-5)
        want_beta = g if no_sigma else g / sigma
    torch.testing.assert_close(beta, want_beta, rtol=1e-6, atol=0)
    assert float(t.min()) >= sde.epsilon and float(t.max()) <= sde.T


@pytest.mark.parametrize("weighting", ["dsm", "lw"])
def test_train_tables_consume_the_losses_draws(weighting):
    """With the same seed, one step's table loss equals the loss function on
    the same minibatch: both call the one draw function in the same order."""
    sde = tsde.VESDE()
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(32,))
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(64, 2, generator=torch.Generator().manual_seed(1))
    xt, zw, t, beta = ft.train_tables(sde, torch.Generator().manual_seed(5), x[None], False, weighting)
    r = zw[0] + beta[0][:, None] * nets.apply_score_mlp(cfg, params, t[0], xt[0])
    fn = losses.denoising_score_matching if weighting == "dsm" else losses.log_prob_score_matching
    want = fn(lambda tt, xx, c: nets.apply_score_mlp(cfg, params, tt, xx, c) / sde.sigma(tt)[:, None], sde,
              torch.Generator().manual_seed(5), x)
    np.testing.assert_allclose(float(torch.sum(r * r) / 64), float(want), rtol=1e-5)


def test_flow_and_symplectic_tables_consume_the_models_draws():
    from flowfusion_torch.models.flow import ODEFlow
    from flowfusion_torch.models.symplectic import SymplecticFlowModel

    x = torch.randn(48, 2, generator=torch.Generator().manual_seed(2))
    flow = ODEFlow.create(target_dimension=2, hidden_units=(32,), generator=torch.Generator().manual_seed(0),
                          device="cpu")
    xt, zw, t, beta = ft.train_tables_flow(torch.Generator().manual_seed(6), x[None])
    r = zw[0] + beta[0][:, None] * flow.dynamics(t[0], xt[0])
    np.testing.assert_allclose(float(torch.mean(r * r)),
                               float(flow.loss_fn(torch.Generator().manual_seed(6), x)), rtol=1e-5)
    sym = SymplecticFlowModel.create(units=(32,), generator=torch.Generator().manual_seed(1), device="cpu")
    xt_q, zw_q, xt_p, zw_p, t = ft.train_tables_symplectic(torch.Generator().manual_seed(7), x[None])
    vq = nets.apply_symplectic_q_velocity(sym.net, sym.params, t[0], xt_q[0])
    vp = nets.apply_symplectic_p_velocity(sym.net, sym.params, t[0], xt_p[0])
    joint = (torch.sum((zw_q[0] + vq) ** 2) + torch.sum((zw_p[0] + vp) ** 2)) / (48 * 4)
    np.testing.assert_allclose(float(joint), float(sym.loss_fn(torch.Generator().manual_seed(7), x)), rtol=1e-5)


def test_pack_round_trip_pads_to_the_kernel_layout():
    """K = 10 and D = 2 pad to 12 and 4, hidden 30 and 100 to 100; the flat
    buffer holds each layer's weight then bias, and unpacking strips the
    padding back exactly."""
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(30, 100))
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    K, H, n_hidden, D = ft._dims(cfg)
    assert (K, H, n_hidden, D) == (10, 100, 2, 2)
    pairs = [(l["w"], l["b"]) for l in params["layers"]]
    flat = ft._pack(pairs, K, H, D)
    assert flat.numel() == (12 + 1) * 100 + (100 + 1) * 100 + (100 + 1) * 4
    w0 = flat[: 12 * 100].view(12, 100)
    assert torch.equal(w0[:10, :30], pairs[0][0]) and not w0[10:].any() and not w0[:, 30:].any()
    for (w, b), (w2, b2) in zip(pairs, ft._unpack(flat, pairs, K, H, D)):
        assert torch.equal(w, w2) and torch.equal(b, b2)


def test_plan_bound_and_flops_of_the_main_path():
    """The flagship net (K = 10, H = 128 x 3, D = 2) runs 4-row tiles at bs
    512 (128 row tiles) and 1-row tiles at bs 128, the conditional H = 256
    net 4-row tiles at bs 512; 203,264 flops a row a step (no delta product
    goes back through the input layer)."""
    flag = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    cond = nets.ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(256, 256, 256))
    assert ft.train_plan(flag, 512)[0] == 4 and ft.train_plan(flag, 128)[0] == 1
    assert ft.train_plan(cond, 512)[0] == 4 and -(-512 // ft.train_plan(flag, 512)[0]) >= 128
    assert ft.train_flops(flag, 1, 1) == 203_264 and ft.train_flops(flag, 48, 512) == 48 * 512 * 203_264
    assert ft.train_plan(nets.ScoreMLPConfig(n_dimensions=2, units=(4096,) * 3)) is None


_FLAG = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
_SYMPL_HALF = ft._sympl_half_cfg(nets.SymplecticMLPConfig(n_data_dims=2, units=(128, 128)))


# (net, bs, rows, smem bytes, staged floats): 4 x (max(rows x row floats,
# 8,192) + staged floats), the whole net staged where it fits beside the
# row tile (flagship 36,400 floats), else what is left for k-chunks
# (conditional H = 256); phase B's partials and row buffers (8,192 floats)
# set the floor.  The three nets at bs 512 are pinned in
# tests/test_torch_fused_mlp.py::test_training_plan_keeps_its_rows.
@pytest.mark.parametrize("cfg, bs, rows, smem, wbuf", [
    (_FLAG, 77, 1, 178_368, 36_400),
    (_FLAG, 128, 1, 178_368, 36_400),
    (_FLAG, 500, 4, 178_368, 36_400),
    (_FLAG, 2048, 16, 195_776, 36_400),
    (_FLAG, 6400, 64, 232_448, 7_936),
    (nets.ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(256,) * 3), 1000, 8, 232_448, 45_600),
    (nets.VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128)), 512, 4, 106_560, 18_448),
    (_SYMPL_HALF, 512, 4, 110_784, 19_504),
    (_SYMPL_HALF, 256, 2, 110_784, 19_504),
])
def test_train_plan(cfg, bs, rows, smem, wbuf):
    plan = ft.train_plan(cfg, bs)
    assert plan == (rows, smem) and ft.plan_wbuf(cfg, plan) == wbuf


def test_train_plan_forced_rows():
    """``rows=`` forces a plan; a block that does not fit raises; the plan
    does not depend on the card (``sms`` is the plan's own)."""
    assert ft.train_plan(_FLAG, 512, rows=4) == ft.train_plan(_FLAG, 512)
    assert ft.train_plan(_FLAG, 512, rows=32) == (32, 232_448)  # the net does not fit beside 32 rows: k-chunks
    assert ft.plan_wbuf(_FLAG, (32, 232_448)) == 58_112 - 32 * (12 + 768 + 4)
    assert ft.train_plan(_FLAG, 512, rows=3) == (3, 4 * (8_192 + 36_400))  # phase B's floor, then the net
    for rows in (0, 257):
        with pytest.raises(ValueError, match="rows whose block fits"):
            ft.train_plan(_FLAG, 512, rows=rows)
    wide = nets.ScoreMLPConfig(n_dimensions=2, units=(2048,) * 3)
    with pytest.raises(ValueError, match="rows whose block fits"):
        ft.train_plan(wide, 512, rows=8)
    assert ft.train_plan(_FLAG, 512, sms=64)[0] == 8


# (D, C, hidden layers, widest H admitted): the admission policy
# (_ADMIT_ROW_FLOATS), the envelope of the first version of the kernel,
# unchanged: a 4-row block of activations, act' and a 256-float scratch
# within 232,448 bytes
@pytest.mark.parametrize("D, C, n_hidden, widest", [
    (2, 0, 3, 2408), (6, 3, 3, 2404), (2, 0, 1, 7224), (2, 0, 8, 900),
])
def test_train_envelope_widths(D, C, n_hidden, widest):
    def cfg(H):
        return nets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(H,) * n_hidden)

    assert ft.train_plan(cfg(widest)) is not None and ft.train_plan(cfg(widest + 4)) is None
    for bs in (1, 128, 512, 100_000):
        rows, smem = ft.train_plan(cfg(widest), bs)
        assert smem <= 232_448 and ft.plan_wbuf(cfg(widest), (rows, smem)) >= 4 * (widest + 4)


@pytest.mark.parametrize("cfg", [_FLAG, _SYMPL_HALF,
                                 nets.ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(256,) * 3),
                                 nets.ScoreMLPConfig(n_dimensions=3, units=(30, 18), activation="tanh"),
                                 nets.VelocityMLPConfig(target_dimension=2, conditional_dimension=2,
                                                        hidden_units=(100, 100))])
def test_param_tiles_cover_every_parameter_once(cfg):
    """Phase B's tile map covers every parameter of the flat layout, biases
    included, exactly once: weight tiles of at most 16 rows by 32 columns
    (at most 32 items of 4 k by 4 n), bias tiles of one row by at most 32,
    largest first."""
    K, H, n_hidden, D = ft._dims(cfg)
    shapes = ft._layer_shapes(K, H, n_hidden, D)
    offsets = np.cumsum([0] + [(k + 1) * n for k, n in shapes])
    hits = np.zeros(offsets[-1], dtype=int)
    tiles = ft.param_tiles(K, H, n_hidden, D)
    for l, k0, kc, n0, nc in tiles:
        k_l, n_l = shapes[l]
        assert nc % 4 == 0 and nc <= 32 and n0 + nc <= n_l
        assert (kc == 1 and k0 == k_l) or (kc % 4 == 0 and kc <= 16 and k0 + kc <= k_l)
        for k in range(k0, k0 + kc):
            hits[offsets[l] + k * n_l + n0: offsets[l] + k * n_l + n0 + nc] += 1
    assert (hits == 1).all()
    assert [kc * nc for _, _, kc, _, nc in tiles] == sorted((kc * nc for _, _, kc, _, nc in tiles), reverse=True)
    assert hits.size == ft._pack([(torch.zeros(k, n), torch.zeros(n)) for k, n in shapes], K, H, D).numel()
    if cfg is _FLAG:
        assert len(tiles) == 89  # at most one tile a block on 132 SMs


def test_workspace_size():
    """Phase A's workspace: each row's layer inputs and deltas at the
    kernel's padded widths and its loss, about 1.6 MB for the flagship net
    at bs 512."""
    assert ft.workspace_floats(_FLAG, 512) == (512 * (12 + 384), 512 * (384 + 4), 512)
    assert 4 * sum(ft.workspace_floats(_FLAG, 512)) == 1_607_680
    cond = nets.ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(256,) * 3)
    assert ft.workspace_floats(cond, 77) == (77 * (20 + 768), 77 * (768 + 8), 77)


def test_epoch_guards():
    """The JAX package's choke-point guards, and the port's own: a custom
    config, non-float32 state, zero steps, widths, the conditional, the
    compute dtype, a plan that does not fit."""
    _, _, tp, tcfg = _score(units=(32,))
    tab = _torch_tables(_tables(2, 8, 2))

    @dataclasses.dataclass(frozen=True)
    class Custom:
        hidden_units: tuple = (32,)
        target_dimension: int = 2
        conditional_dimension: int = 0
        activation: str = "silu"

    with pytest.raises(ValueError, match="plain engine"):
        ft.fused_train_epoch(tp, Custom(), lr=1e-3, **tab)
    half = {"W": tp["W"].double(), "layers": tp["layers"]}
    with pytest.raises(ValueError, match="float32"):
        ft.fused_train_epoch(half, tcfg, lr=1e-3, **tab)
    with pytest.raises(ValueError, match="at least one step"):
        ft.fused_train_epoch(tp, tcfg, lr=1e-3, **{k: None if v is None else v[:0] for k, v in tab.items()})
    with pytest.raises(ValueError, match="do not match the config"):
        ft.fused_train_epoch(tp, dataclasses.replace(tcfg, units=(64,)), lr=1e-3, **tab)
    with pytest.raises(ValueError, match="feature dim"):
        ft.fused_train_epoch(tp, dataclasses.replace(tcfg, n_dimensions=3), lr=1e-3, **tab)
    with pytest.raises(ValueError, match="conditional given"):
        ft.fused_train_epoch(tp, tcfg, lr=1e-3, **dict(tab, conditional=torch.zeros(2, 8, 1)))
    with pytest.raises(ValueError, match="expects 1 conditional"):
        ft.fused_train_epoch(tp, dataclasses.replace(tcfg, n_conditionals=1), lr=1e-3, **tab)
    with pytest.raises(ValueError, match="unknown kernel compute dtype 'float16'"):
        ft.fused_train_epoch(tp, tcfg, lr=1e-3, compute_dtype="float16", **tab)
    wide = nets.ScoreMLPConfig(n_dimensions=2, units=(1024,) * 8)  # 16,400 floats a row: over the 14,464 admitted
    with pytest.raises(ValueError, match="plan does not fit"):
        ft.fused_train_epoch(nets.init_score_mlp(wide, torch.Generator().manual_seed(0), "cpu"), wide, lr=1e-3,
                             **tab)
    with pytest.raises(ValueError, match="SymplecticMLPConfig"):
        ft.fused_train_epoch_symplectic(tp, tcfg, lr=1e-3, xt_q=tab["xt"], zw_q=tab["zw"], xt_p=tab["xt"],
                                        zw_p=tab["zw"], t=tab["t"])


def test_padded_hidden_units_train_as_the_unpadded_net():
    """Odd hidden widths run padded in the kernel; the plain version trains
    the net as given, and its step equals the step of the same net with
    zero-padded units (padded weights get zero gradient and stay zero)."""
    from flowfusion_torch.kernels.fused_mlp import pad_to_lanes

    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(30, 30), activation="tanh")
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    padded, pcfg = pad_to_lanes(params, cfg)
    tab = _torch_tables(_tables(3, 16, 2, seed=5))
    out = ft.fused_train_epoch(params, cfg, lr=1e-3, **tab)
    out_p = ft.fused_train_epoch(padded, pcfg, lr=1e-3, **tab)
    torch.testing.assert_close(out[3], out_p[3], rtol=1e-6, atol=0)
    for lyr, lp in zip(out[0]["layers"], out_p[0]["layers"]):
        w = lp["w"]
        torch.testing.assert_close(lyr["w"], w[: lyr["w"].shape[0], : lyr["w"].shape[1]], rtol=1e-5, atol=1e-7)
    assert not out_p[0]["layers"][0]["w"][:, 30:].any() and not out_p[0]["layers"][1]["w"][30:].any()
