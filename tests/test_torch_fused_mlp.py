"""flowfusion_torch ``fused_drift`` against the JAX Pallas kernel.

On CPU tensors the port's wrapper runs its plain version; it is held
against the JAX ``fused_drift`` in interpret mode on the same numpy
inputs.  Bars, the JAX package's own fused-versus-plain bars
(bench.py:320-321): drift within 1e-5 and divergence within 1e-4 of the
reference's max magnitude.  The CUDA kernel itself is held against the
plain version by ``tests/test_torch_gpu.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.kernels import fused_mlp as jfm
from flowfusion_tpu.models import nets as jnets
from flowfusion_torch.kernels import em_sampler, fused_mlp, fused_sketch, fused_train
from flowfusion_torch.models import nets
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)


def _pair(d=2, c=0, units=(128, 128), activation="silu", seed=0):
    jcfg = jnets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units, activation=activation)
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(seed), jcfg)
    cfg = nets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units, activation=activation)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _inputs(B, d, c=0, gaussian_probe=False, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    cond = rng.standard_normal((B, c)).astype(np.float32) if c else None
    e = rng.standard_normal((B, d)).astype(np.float32)
    return x, cond, (e if gaussian_probe else np.sign(e))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _run_both(mode, jcfg, jparams, cfg, params, x, cond, e, t=0.37, c0=-0.3, c1=0.7, tile=None):
    kw_j = {"e": jnp.asarray(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    kw_t = {"e": torch.as_tensor(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    B = x.shape[0]
    ref = jfm.fused_drift(
        jparams, jcfg, jnp.float32(t), jnp.asarray(x),
        None if cond is None else jnp.asarray(cond), c0=c0, c1=c1,
        interpret=True, tile=tile or B, **kw_j,
    )
    out = fused_mlp.fused_drift(
        params, cfg, torch.tensor(t), torch.as_tensor(x),
        None if cond is None else torch.as_tensor(cond), c0=c0, c1=c1, **kw_t,
    )
    if mode == "forward":
        assert _rel(out.numpy(), ref) <= 1e-5
    else:
        assert _rel(out[0].numpy(), ref[0]) <= 1e-5
        assert _rel(out[1].numpy(), ref[1]) <= 1e-4
    return out, ref


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "gelu"])
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_plain_fused_drift_matches_jax_kernel(mode, activation):
    jcfg, jparams, cfg, params = _pair(d=3, activation=activation)
    x, _, e = _inputs(32, 3)
    _run_both(mode, jcfg, jparams, cfg, params, x, None, e)


@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_conditional_net(mode):
    jcfg, jparams, cfg, params = _pair(d=2, c=3)
    x, cond, e = _inputs(32, 2, c=3)
    _run_both(mode, jcfg, jparams, cfg, params, x, cond, e, c0=0.0, c1=0.9)


def test_ragged_batch():
    """37 rows against JAX tiles of 32 (the JAX wrapper pads; the port
    masks the ragged tile on the card)."""
    jcfg, jparams, cfg, params = _pair()
    x, _, e = _inputs(37, 2)
    _run_both("hutchinson", jcfg, jparams, cfg, params, x, None, e, tile=32)


@pytest.mark.parametrize("mode", ["forward", "exact"])
def test_non_uniform_width_through_pad_to_lanes(mode):
    jcfg, jparams, cfg, params = _pair(units=(100, 60, 100))
    padded, pcfg = fused_mlp.pad_to_lanes(params, cfg)
    assert pcfg.units == (100, 100, 100)  # the widest, a multiple of LANE = 4
    assert [tuple(l["w"].shape) for l in padded["layers"]] == [(10, 100), (100, 100), (100, 100), (100, 2)]
    x, _, e = _inputs(24, 2)
    _run_both(mode, jcfg, jparams, cfg, params, x, None, e)
    # padding is exact: the padded net computes the unpadded one
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(
        nets.apply_score_mlp(pcfg, padded, 0.3, xt).numpy(),
        nets.apply_score_mlp(cfg, params, 0.3, xt).numpy(), rtol=0, atol=1e-6,
    )


def test_hutchinson_c0_term_uses_probe_norm():
    """div = c0 |e|^2 + c1 e.J e, not c0 D: only Rademacher probes have
    |e|^2 = D (flowfusion_tpu/kernels/fused_mlp.py:818-821)."""
    jcfg, jparams, cfg, params = _pair()
    x, _, e = _inputs(32, 2, gaussian_probe=True)
    (_, div), _ = _run_both("hutchinson", jcfg, jparams, cfg, params, x, None, e, c0=-0.8, c1=0.0)
    np.testing.assert_allclose(div.numpy(), -0.8 * np.sum(e * e, axis=1), rtol=1e-6)


def test_strict_fp32_is_scoped():
    """The float32 mode turns TF32 off inside its block only: the caller's
    setting comes back after it, also after an error."""
    from flowfusion_torch._device import strict_fp32_matmul

    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with strict_fp32_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(KeyError), strict_fp32_matmul():
            raise KeyError
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_envelope_and_refusals():
    assert fused_mlp.supports_config((128, 128)) and fused_mlp.supports_config((256,) * 3)
    assert fused_mlp.supports_config((100, 100))  # multiples of 4
    assert not fused_mlp.supports_config((30,)) and fused_mlp.fusable_config((30,))
    assert not fused_mlp.supports_config((128, 64)) and fused_mlp.fusable_config((128, 64))
    assert not fused_mlp.fusable_config((128,), "swish")
    assert not fused_mlp.fusable_config((128,) * 18)  # 17 hidden (H, H) layers
    # the feature envelope is the kernel's shared-memory plan: 17 exact
    # features fit at H=128 (4 rows a block), 16 do not at H=1024
    assert fused_mlp.supports_features(17, "exact", 128)
    assert not fused_mlp.supports_features(16, "exact", 1024)
    assert fused_mlp.supports_features(16, "hutchinson", 1024)
    assert fused_mlp.supports_features(64) and fused_mlp.supports_features(9, "exact", 256, 6)
    assert fused_mlp.flops_per_row(2, 2, 128, 4, "hutchinson") == 133_120
    jcfg, jparams, cfg, params = _pair(c=3)
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="conditional"):
        fused_mlp.fused_drift(params, cfg, 0.5, x)
    # highf32 and bfloat16 are ported; an unknown compute mode raises
    assert fused_mlp.fused_drift(params, cfg, 0.5, x, torch.zeros(4, 3), compute_dtype="highf32").shape == (4, 2)
    assert fused_mlp.fused_drift(params, cfg, 0.5, x, torch.zeros(4, 3), compute_dtype="bfloat16").shape == (4, 2)
    with pytest.raises(ValueError, match="unknown"):
        fused_mlp.fused_drift(params, cfg, 0.5, x, torch.zeros(4, 3), compute_dtype="float16")
    with pytest.raises(ValueError, match="OR"):
        fused_mlp.fused_drift(params, cfg, 0.5, x, torch.zeros(4, 3), e=x, exact_divergence=True)
    # shared-memory plan: exact trace of 16 features at H=1024 cannot fit,
    # and the wrapper refuses it on every device
    assert fused_mlp._rows_per_block(1024, 17, 16, 16) is None
    wide = nets.ScoreMLPConfig(n_dimensions=16, units=(1024,))
    wide_params = nets.init_score_mlp(wide, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="shared-memory"):
        fused_mlp.fused_drift(wide_params, wide, 0.5, torch.zeros(4, 16), exact_divergence=True)
    assert fused_mlp._rows_per_block(128, 2, 2, 2) == 32
    assert fused_mlp._rows_per_block(128, 1, 2, 2) == 64  # forward: one chain
    assert fused_mlp._plan(128, "exact", 16, 16) == (4, 4 * (2 * 17 * 4 * (128 + 4) + 4 * 32))
    assert not fused_mlp.supports_features(16, "exact", 1024, compute_dtype="highf32")


def test_rhs_blocks_an_sm_count_the_block_reserve():
    # an SM holds 233,472 bytes for its blocks, each block 1 KB more than
    # its own: two fit up to 115,712 bytes, not up to half the block limit
    assert fused_mlp.blocks_per_sm(115_712) == 2
    assert fused_mlp.blocks_per_sm(115_968) == 1
    assert fused_mlp.blocks_per_sm(76_800) == 3 and fused_mlp.blocks_per_sm(76_804) == 2
    assert fused_sketch.blocks_per_sm is fused_mlp.blocks_per_sm


# (H, mode, d_in, d_out, n_tan, compute dtype, rows, blocks an SM):
# the flagship (2 -> 128, also the flow and each symplectic stack), the
# conditional checkpoints (D = 6, C = 3, H = 128 and 256), tangents K = 3,
# highf32 with its planes, and the 4-row plans
_PLANS = [
    (128, "hutchinson", 2, 2, 0, "float32", 32, 3),
    (128, "exact", 2, 2, 0, "float32", 16, 3),
    (128, "forward", 2, 2, 0, "float32", 64, 3),
    (128, "hutchinson", 9, 6, 0, "float32", 32, 3),
    (128, "exact", 9, 6, 0, "float32", 8, 3),
    (256, "hutchinson", 9, 6, 0, "float32", 16, 3),
    (256, "exact", 9, 6, 0, "float32", 4, 3),
    (128, "tangents", 2, 2, 3, "float32", 16, 3),
    (256, "tangents", 9, 6, 3, "float32", 8, 3),
    (128, "hutchinson", 2, 2, 0, "highf32", 16, 3),
    (128, "forward", 2, 2, 0, "highf32", 32, 3),
    (128, "exact", 2, 2, 0, "highf32", 16, 3),
    (256, "hutchinson", 9, 6, 0, "highf32", 8, 3),
    (256, "exact", 9, 6, 0, "highf32", 4, 2),
    (128, "exact", 16, 16, 0, "highf32", 4, 2),
]


@pytest.mark.parametrize("H, mode, d_in, d_out, n_tan, dtype, rows, blocks", _PLANS)
def test_rhs_plan(H, mode, d_in, d_out, n_tan, dtype, rows, blocks):
    """Rows and bytes of the RHS kernel's plan, the padded stride (H + 4)
    and highf32's planes counted: the most blocks an SM holds (at most
    three), at the most rows that reach them."""
    chains = fused_mlp._chains(mode, d_out, n_tan)
    buffers = 3 if dtype == "highf32" else 2

    def smem(r):
        return 4 * r * (buffers * chains * (H + 4) + d_in + d_out * max(1, n_tan))

    plan = fused_mlp._plan(H, mode, d_in, d_out, n_tan, dtype)
    assert plan == (rows, smem(rows))
    assert fused_mlp.plan_blocks(plan) == blocks == min(3, fused_mlp.blocks_per_sm(smem(rows)))
    if rows < 64:  # twice the rows would cost a block
        assert smem(2 * rows) > fused_mlp._SMEM_LIMIT or fused_mlp.blocks_per_sm(smem(2 * rows)) < blocks
    # the plan at rows forced to 4 keeps the layout
    assert fused_mlp._plan(H, mode, d_in, d_out, n_tan, dtype, rows=4) == (4, smem(4))


def test_rhs_plan_forced_rows():
    assert fused_mlp._plan(128, "hutchinson", 2, 2, rows=8) == (8, 4 * 8 * (2 * 2 * 132 + 4))
    for rows in (6, 0, 260):
        with pytest.raises(ValueError, match="multiple of 4"):
            fused_mlp._plan(128, "hutchinson", 2, 2, rows=rows)
    with pytest.raises(ValueError, match="multiple of 4"):  # 64 rows of 17 chains at H=128 do not fit
        fused_mlp._plan(128, "exact", 16, 16, rows=64)


# (features, mode, D, widest H in float32, in highf32, in bfloat16): at 4
# rows a block the highf32 plan keeps the activations' TF32 hi and lo planes
# beside the pre-activations, three buffers where float32 has two, so its
# widest hidden layer is about two thirds of float32's; bfloat16 keeps one
# 2-byte plane beside the pre-activations (rows H + 8 apart), 6 bytes a
# value where float32 has 8, so its widest is about four thirds of
# float32's (in steps of its 16-wide lane)
_ENVELOPE = [
    (9, "exact", 6, 1032, 680, 1360),
    (9, "hutchinson", 6, 3624, 2408, 4816),
    (2, "exact", 2, 2416, 1608, 3216),
    (2, "hutchinson", 2, 3624, 2416, 4832),
]


@pytest.mark.parametrize("n_features, mode, D, widest_float32, widest_highf32, widest_bfloat16", _ENVELOPE)
def test_rhs_envelope_widths(n_features, mode, D, widest_float32, widest_highf32, widest_bfloat16):
    for dtype, widest in (("float32", widest_float32), ("highf32", widest_highf32), ("bfloat16", widest_bfloat16)):
        assert fused_mlp.supports_features(n_features, mode, widest, D, dtype)
        assert not fused_mlp.supports_features(n_features, mode, widest + fused_mlp.lane(dtype), D, dtype)


@pytest.mark.parametrize("H, D, with_cond, plan", [
    (128, 2, False, (64, 69_632)), (128, 6, True, (64, 106_496)), (256, 6, True, (32, 102_400)),
])
def test_em_plan_keeps_its_rows(H, D, with_cond, plan):
    """The EM kernel's plan (the flagship, the conditional H = 128 and
    H = 256 checkpoints): the most blocks an SM up to two (its launch
    bounds), at the most rows that reach them, in the padded layout (two
    (rows, H + 4) layer buffers, the (rows, H) conditional projection, two
    halves each of x and x_mean).  Each holds two blocks; twice the rows
    would hold fewer, and the plan forced to 4 rows keeps the layout."""
    def smem(r):
        return 4 * r * (2 * (H + 4) + (H if with_cond else 0) + 4 * D)

    rows = plan[0]
    assert em_sampler.em_plan(H, D, with_cond) == plan == (rows, smem(rows))
    assert em_sampler.em_plan_blocks(plan) == 2 == min(2, fused_mlp.blocks_per_sm(smem(rows)))
    if rows < 64:
        assert fused_mlp.blocks_per_sm(smem(2 * rows)) < 2
    assert em_sampler.em_plan(H, D, with_cond, rows=4) == (4, smem(4))


@pytest.mark.parametrize("D, C, H, plan, wbuf", [(2, 0, 128, (4, 178_368), 36_400),
                                                 (6, 3, 128, (4, 184_640), 37_968),
                                                 (6, 3, 256, (4, 232_448), 49_920)])
def test_training_plan_keeps_its_rows(D, C, H, plan, wbuf):
    """The training kernel plans with a plan of its own: at bs 512, 4 rows a
    block (128 row tiles on 132 SMs), the net staged beside them (whole for
    H = 128, in k-chunks for H = 256).  A launch's result does not depend on
    the plan, so FitCheckpoint resume does not either.  Other batches:
    tests/test_torch_fused_train.py::test_train_plan."""
    cfg = nets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(H,) * 3)
    assert fused_train.train_plan(cfg, 512) == plan and fused_train.plan_wbuf(cfg, plan) == wbuf


def test_em_plan_counts_the_block_reserve():
    """Two blocks share an SM up to 115,712 bytes a block (each reserves
    1 KB).  At H = 216 the 64-row block takes 114,688 bytes and two share
    an SM; at H = 220 it takes 116,736, half the SM's 233,472 bytes, so
    with the reserve one block would hold it and the plan takes 32 rows."""
    assert fused_mlp.blocks_per_sm(115_712) == 2 and fused_mlp.blocks_per_sm(115_968) == 1
    assert fused_mlp.blocks_per_sm(116_736) == 1
    assert em_sampler.em_plan(216, 2, False) == (64, 114_688)
    assert em_sampler.em_plan(220, 2, False) == (32, 58_368)
    assert em_sampler.em_plan_blocks((32, 58_368)) == 2  # three fit by bytes; the launch bounds hold two


def test_em_plan_forced_rows():
    """``rows`` forces a plan: a multiple of 4 up to 256 whose block fits,
    padded where the padded block fits, else at the unpadded stride."""
    assert em_sampler.em_plan(128, 2, False, rows=8) == (8, 4 * 8 * (2 * 132 + 8))
    assert em_sampler.em_plan(128, 2, False, rows=128) == (128, 4 * 128 * (2 * 132 + 8))
    assert em_sampler.em_plan(7260, 2, False, rows=4) == (4, 4 * 4 * (2 * 7260 + 8))  # unpadded
    for rows in (6, 0, 260, -4):
        with pytest.raises(ValueError, match="multiple of 4"):
            em_sampler.em_plan(128, 2, False, rows=rows)
    with pytest.raises(ValueError, match="multiple of 4"):  # 8 rows of H = 4832 do not fit
        em_sampler.em_plan(4832, 6, True, rows=8)


# (D, conditional, widest H): the widest hidden layer em_plan admits, the
# same as before the padded layout (the widest nets take 4 rows unpadded)
_EM_ENVELOPE = [(2, False, 7260), (6, True, 4832)]


@pytest.mark.parametrize("D, with_cond, widest", _EM_ENVELOPE)
def test_em_envelope_widths(D, with_cond, widest):
    rows, smem = em_sampler.em_plan(widest, D, with_cond)
    assert rows == 4 and smem <= fused_mlp._SMEM_LIMIT
    # the first version's layout at 4 rows: (2 or 3) x 4 x H + 4 x 4 x D floats
    assert 4 * ((3 if with_cond else 2) * 4 * widest + 16 * D) <= fused_mlp._SMEM_LIMIT
    with pytest.raises(ValueError, match="shared-memory"):
        em_sampler.em_plan(widest + 4, D, with_cond)
