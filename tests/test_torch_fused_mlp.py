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
from flowfusion_torch.kernels import fused_mlp
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
    # highf32 is ported; bfloat16 waits for queue 2 #3b
    assert fused_mlp.fused_drift(params, cfg, 0.5, x, torch.zeros(4, 3), compute_dtype="highf32").shape == (4, 2)
    with pytest.raises(NotImplementedError, match="#3b"):
        fused_mlp.fused_drift(params, cfg, 0.5, x, torch.zeros(4, 3), compute_dtype="bfloat16")
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
    assert fused_mlp._plan(128, "exact", 16, 16) == (4, 4 * (2 * 17 * 4 * 128 + 4 * 32))
