"""The CUDA kernel against its plain PyTorch version, on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (the conftest imports JAX, so run it there with
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``).  Without
a CUDA card every test skips: the kernel has no CPU mode.

Bars, the JAX package's fused-versus-plain bars (bench.py:320-321): drift
within 1e-5 and divergence within 1e-4 of the plain version's max
magnitude, TF32 off.
"""

import dataclasses

import pytest
import torch

from flowfusion_torch.kernels import fused_mlp
from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.sde import VESDE


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel has no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "gelu"])
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_cuda_kernel_matches_plain_version(cuda_device, mode, activation):
    cfg = ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(100, 100, 100), activation=activation)
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), cuda_device)
    g = torch.Generator().manual_seed(1)
    x, cond, e = (torch.randn(1001, n, generator=g).to(cuda_device) for n in (6, 3, 6))
    kw = {"e": torch.sign(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    before = fused_mlp.fused_drift.launches
    out = fused_mlp.fused_drift(params, cfg, 0.4, x, cond, c0=-0.2, c1=0.8, **kw)
    ref = fused_mlp.fused_drift_reference(params, cfg, 0.4, x, cond, c0=-0.2, c1=0.8, **kw)
    torch.cuda.synchronize()
    assert fused_mlp.fused_drift.launches == before + 1
    if mode == "forward":
        out, ref = (out,), (ref,)
    assert _rel(out[0], ref[0]) <= 1e-5
    if mode != "forward":
        assert _rel(out[1], ref[1]) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_cuda_kernel_four_row_plan(cuda_device, mode):
    """16 features at H=128: the exact plan fits only at 4 rows a block,
    which runs the kernel's 4-row tile; the other modes take wider tiles."""
    cfg = ScoreMLPConfig(n_dimensions=16, units=(128, 128))
    assert (fused_mlp._plan(128, mode, 16, 16)[0] == 4) == (mode == "exact")
    params = init_score_mlp(cfg, torch.Generator().manual_seed(2), cuda_device)
    g = torch.Generator().manual_seed(3)
    x, e = (torch.randn(1003, 16, generator=g).to(cuda_device) for _ in range(2))
    kw = {"e": torch.sign(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    out = fused_mlp.fused_drift(params, cfg, 0.6, x, c0=0.3, c1=-0.5, **kw)
    ref = fused_mlp.fused_drift_reference(params, cfg, 0.6, x, c0=0.3, c1=-0.5, **kw)
    torch.cuda.synchronize()
    if mode == "forward":
        out, ref = (out,), (ref,)
    assert _rel(out[0], ref[0]) <= 1e-5
    if mode != "forward":
        assert _rel(out[1], ref[1]) <= 1e-4


@pytest.mark.gpu
def test_auto_dispatch_on_card_raises_outside_envelope(cuda_device):
    """Auto dispatch launches the kernel or raises: 16 exact chains of
    width 1024 overflow shared memory, and the plain path runs on the card
    only when asked for."""
    cfg = ScoreMLPConfig(n_dimensions=16, units=(1024,))
    model = ScoreModel(init_score_mlp(cfg, torch.Generator().manual_seed(0), cuda_device), cfg, VESDE())
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    with pytest.raises(ValueError, match="use_fused_kernel=False"):
        model.log_prob(x)
    before = fused_mlp.fused_drift.launches
    lp, _ = dataclasses.replace(model, use_fused_kernel=False).log_prob(x)
    assert fused_mlp.fused_drift.launches == before and bool(torch.isfinite(lp).all())


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(cuda_device):
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), cuda_device)
    with pytest.raises(ValueError, match="float32"):
        fused_mlp.fused_drift(params, cfg, 0.4, torch.zeros(8, 2, device=cuda_device, dtype=torch.float64))
