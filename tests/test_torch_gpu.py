"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (the conftest imports JAX, so run it there with
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``).  Without
a CUDA card every test skips: the kernel has no CPU mode.

Bars, the JAX package's fused-versus-plain bars (bench.py:320-321): drift
within 1e-5 and divergence within 1e-4 of the plain version's max
magnitude, TF32 off.  In compute mode highf32 the kernel and its highf32
plain version differ in summation order only: drift 1e-5, divergence and
J v 5e-5.  The EM kernel: x and x_mean within rtol 2e-4 / atol
1e-4 of the plain version on the same noise (tests/test_kernels.py:203-204)
and the same ``diverged``.  Tangent columns within 1e-5 of their scale; the
sketch kernel's divergence within 2e-4 absolute (the JAX package's sketch
bar, tests/test_kernels.py:628), in highf32 too, and its highf32 output
within the JAX package's highf32 sketch bars of the float32 kernel's (drift
5e-5, div 5e-4 relative, tests/test_kernels.py:826-856); the symplectic
field within 1e-5.  The
training kernel: losses rtol 1e-5, layers atol 3e-5 (5e-5 chained, 3e-4
for the symplectic form; tests/test_fused_train.py:89-152, :784), two
launches bitwise equal, and a resumed ``fit`` bitwise equal to the
uninterrupted one.  In compute mode bfloat16 the RHS kernel and its
bfloat16 plain version round at the same points and differ in the order of
the fp32 sums, which moves the odd value across a bf16 rounding boundary:
max |d| within 4e-3 (measured up to 2.04e-3 on the H100; two plain versions
that differ only in fp32 or fp64 sums differ by up to 1.88e-3), mean |d|
within 1e-5 of the max magnitude (measured up to 1.3e-6), and at least 10x
closer in the mean to the bf16 plain version than that is to strict
float32, which a kernel that skipped a rounding point fails; against strict
float32 the mode's accuracy class, 3e-2.  The bf16 EM kernel within 1e-2
of its plain version over 10 steps of streamed noise.  The bf16 sketch
kernel: the 10x guard as above, the mean within the larger of 1e-5 and
twice the plain version's own mean spread with float64 sums (the per-row
QR and the next application carry a flip on: up to 7.2e-6 on these random
velocity nets, CPU), its max at the accuracy class, 3e-2 (measured up to
2.3e-3 on 50,000 random rows on the H100), the drift within 3e-2 of
strict float32.
"""

import dataclasses

import pytest
import torch

from flowfusion_torch.kernels import em_sampler, fused_mlp, fused_sketch
from flowfusion_torch.models.nets import (
    ScoreMLPConfig,
    SymplecticMLPConfig,
    VelocityMLPConfig,
    init_score_mlp,
    init_symplectic_mlp,
    init_velocity_mlp,
)
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.sde import VESDE, VPSDE


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
    """Auto dispatch launches the kernel or raises: exact chains of width
    4096 overflow shared memory even one basis chain a pass, and the plain
    path runs on the card only when asked for."""
    cfg = ScoreMLPConfig(n_dimensions=16, units=(4096,))
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


@pytest.mark.gpu
@pytest.mark.parametrize("noise_mode", ["streamed", "philox"])
@pytest.mark.parametrize("activation,c", [("tanh", 0), ("relu", 0), ("gelu", 0), ("silu", 3)])
def test_em_kernel_matches_plain_version(cuda_device, noise_mode, activation, c):
    """Random nets of width 100 (D=3) and a conditional net (D=6, C=3)
    under the VP-SDE with no_sigma, 1,001 rows (ragged), 40 steps."""
    d = 6 if c else 3
    cfg = ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=(100, 100, 100), activation=activation)
    params = init_score_mlp(cfg, torch.Generator().manual_seed(4), cuda_device)
    g = torch.Generator().manual_seed(5)
    x0 = torch.randn(1001, d, generator=g).to(cuda_device)
    cond = torch.randn(1001, c, generator=g).to(cuda_device) if c else None
    steps, seed = 40, 2**33 + 5
    noise = (torch.randn(steps, 1001, d, generator=g).to(cuda_device) if noise_mode == "streamed"
             else em_sampler.philox_normals(seed, steps, 1001, d, cuda_device))
    kw = dict(conditional=cond, steps=steps, no_sigma=True)
    before = em_sampler.fused_em_sample.launches
    if noise_mode == "streamed":
        out = em_sampler.fused_em_sample(params, cfg, VPSDE(), x0, noise=noise, **kw)
    else:
        out = em_sampler.fused_em_sample(params, cfg, VPSDE(), x0, seed, **kw)
    ref = em_sampler.fused_em_sample_reference(params, cfg, VPSDE(), x0, noise, **kw)
    torch.cuda.synchronize()
    assert em_sampler.fused_em_sample.launches == before + 1
    torch.testing.assert_close(out[0], ref[0], rtol=2e-4, atol=1e-4)
    torch.testing.assert_close(out[1], ref[1], rtol=2e-4, atol=1e-4)
    assert bool(out[2]) == bool(ref[2]) is False


@pytest.mark.gpu
def test_em_kernel_nan_freezes_only_its_block(cuda_device):
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(6), cuda_device)
    rows = em_sampler.em_plan(128, 2, False)[0]
    g = torch.Generator().manual_seed(7)
    x0 = torch.randn(4 * rows + 5, 2, generator=g).to(cuda_device)
    clean = torch.randn(20, x0.shape[0], 2, generator=g).to(cuda_device)
    bad = clean.clone()
    bad[7, 2 * rows + 3, 1] = float("nan")
    run = lambda z: em_sampler.fused_em_sample(params, cfg, VESDE(), x0, noise=z, steps=20)  # noqa: E731
    xm_c, x_c, div_c = run(clean)
    xm_b, x_b, div_b = run(bad)
    ref = em_sampler.fused_em_sample_reference(params, cfg, VESDE(), x0, bad, steps=20)
    torch.cuda.synchronize()
    assert not bool(div_c) and bool(div_b) and bool(ref[2])
    block = slice(2 * rows, 3 * rows)
    others = torch.ones(x0.shape[0], dtype=torch.bool, device=cuda_device)
    others[block] = False
    assert torch.equal(x_b[others], x_c[others]) and torch.equal(xm_b[others], xm_c[others])
    assert torch.isfinite(x_b).all() and not torch.equal(x_b[block], x_c[block])
    torch.testing.assert_close(x_b, ref[1], rtol=2e-4, atol=1e-4)


# (D, C, hidden units, activation, rows): the flagship's shape at 1,001
# ragged rows and at four of its blocks and 5 rows, a conditional net, a
# tanh net of width 100
_EM_PLAN_CASES = [(2, 0, (128,) * 3, "silu", 1001), (2, 0, (128,) * 3, "silu", None),
                  (6, 3, (128,) * 3, "silu", 1001), (3, 0, (100,) * 3, "tanh", 1001)]


def _em_plans(H, D, with_cond):
    """The plan of a launch, one forced to 4 rows and one at half its rows."""
    own = em_sampler.em_plan(H, D, with_cond)
    return [own, em_sampler.em_plan(H, D, with_cond, rows=4), em_sampler.em_plan(H, D, with_cond, rows=own[0] // 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("D, C, units, activation, B", _EM_PLAN_CASES)
def test_em_kernel_is_bitwise_across_plans(cuda_device, D, C, units, activation, B):
    """Rows are independent until a NaN: a finite launch at its own plan,
    forced to 4 rows and at half its rows gives x_mean, x and diverged
    bitwise equal, with streamed and with Philox noise."""
    cfg = ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=units, activation=activation)
    params = init_score_mlp(cfg, torch.Generator().manual_seed(8), cuda_device)
    plans = _em_plans(units[0], D, C > 0)
    B = B or 4 * plans[0][0] + 5
    g = torch.Generator().manual_seed(9)
    x0 = torch.randn(B, D, generator=g).to(cuda_device)
    cond = torch.randn(B, C, generator=g).to(cuda_device) if C else None
    steps = 30
    noise = torch.randn(steps, B, D, generator=g).to(cuda_device)
    w_in, cond_proj, coeffs, b_eff = em_sampler._prepare(params, cfg, VPSDE(), cond, steps, True)
    for seed, z in ((0, noise), (2**35 + 3, None)):
        outs = [em_sampler._launch(x0, z, seed, cond_proj, coeffs, b_eff, w_in, params["layers"], activation, steps,
                                   *plan) for plan in plans]
        torch.cuda.synchronize()
        assert not bool(outs[0][2])
        for out in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(out, outs[0])), (plans, z is None)


@pytest.mark.gpu
def test_em_kernel_keeps_no_local_memory(cuda_device):
    """Every plan of the cases above holds the blocks it plans for with no
    local memory a thread, and the kernel's written-out sincos is sincosf
    on every Box--Muller angle."""
    for D, C, units, _, _ in _EM_PLAN_CASES:
        for plan in _em_plans(units[0], D, C > 0):
            occ = em_sampler.em_occupancy(plan)
            assert occ["local_bytes"] == 0, (D, C, units, occ)
            assert occ["blocks_per_sm"] == em_sampler.em_plan_blocks(plan), (D, C, units, occ)
    assert em_sampler.trig_mismatches(cuda_device) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_fused_velocity_matches_plain_version(cuda_device, mode):
    cfg = VelocityMLPConfig(target_dimension=6, conditional_dimension=3, hidden_units=(128, 128))
    params = init_velocity_mlp(cfg, torch.Generator().manual_seed(8), cuda_device)
    g = torch.Generator().manual_seed(9)
    x, cond, e = (torch.randn(2003, n, generator=g).to(cuda_device) for n in (6, 3, 6))
    kw = {"e": torch.sign(e)} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    before = fused_mlp.fused_velocity.launches_by_mode[mode]
    out = fused_mlp.fused_velocity(params, cfg, 0.3, x, cond, **kw)
    ref = fused_mlp.fused_velocity_reference(params, cfg, 0.3, x, cond, **kw)
    torch.cuda.synchronize()
    assert fused_mlp.fused_velocity.launches_by_mode[mode] == before + 1
    if mode == "forward":
        out, ref = (out,), (ref,)
    assert _rel(out[0], ref[0]) <= 1e-5
    if mode != "forward":
        assert _rel(out[1], ref[1]) <= 1e-4


def _net(family, d, c, device, seed):
    if family == "drift":
        cfg = ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=(128, 128, 128))
        return cfg, init_score_mlp(cfg, torch.Generator().manual_seed(seed), device)
    cfg = VelocityMLPConfig(target_dimension=d, conditional_dimension=c, hidden_units=(128, 128))
    return cfg, init_velocity_mlp(cfg, torch.Generator().manual_seed(seed), device)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["drift", "velocity"])
def test_tangents_kernel_matches_plain_version(cuda_device, family):
    """Mode tangents, K = 3, a conditional net (D = 6, C = 3), 1,003 rows."""
    cfg, params = _net(family, 6, 3, cuda_device, 10)
    g = torch.Generator().manual_seed(11)
    x, cond = (torch.randn(1003, n, generator=g).to(cuda_device) for n in (6, 3))
    V = torch.randn(3, 1003, 6, generator=g).to(cuda_device)
    if family == "drift":
        fn, before = fused_mlp.fused_drift_tangents, fused_mlp.fused_drift_tangents.launches
        out = fn(params, cfg, 0.4, x, V, cond, c0=-0.2, c1=0.8)
        ref = fused_mlp.fused_drift_tangents_reference(params, cfg, 0.4, x, V, cond, c0=-0.2, c1=0.8)
    else:
        fn, before = fused_mlp.fused_velocity_tangents, fused_mlp.fused_velocity_tangents.launches
        out = fn(params, cfg, 0.4, x, V, cond)
        ref = fused_mlp.fused_velocity_tangents_reference(params, cfg, 0.4, x, V, cond)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out[0].shape == (6, 1003) and len(out[1]) == 3
    for o, r in zip([out[0]] + out[1], [ref[0]] + ref[1]):
        assert _rel(o, r) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["drift", "velocity"])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("d,c", [(2, 0), (6, 3)])
def test_sketch_kernel_matches_plain_version(cuda_device, family, mode, d, c):
    """1,001 rows (ragged); Hutch++ with some exactly parallel sketch rows;
    a row of zero probes stays finite."""
    cfg, params = _net(family, d, c, cuda_device, 12)
    g = torch.Generator().manual_seed(13)
    B, k = 1001, min(d, 3)
    x = torch.randn(B, d, generator=g).to(cuda_device)
    cond = torch.randn(B, c, generator=g).to(cuda_device) if c else None
    if mode == "hutchpp":
        S, G = (torch.sign(torch.randn(n, B, d, generator=g)) for n in (k, 2))
        S[1, :100] = S[0, :100]
        S[:, 7] = 0.0
        probes = (S.to(cuda_device), G.to(cuda_device))
    else:
        O = torch.randn(k, B, d, generator=g)
        O = O / O.norm(dim=-1, keepdim=True) * d**0.5
        O[:, 7] = 0.0
        probes = (O.to(cuda_device),)
    if family == "drift":
        fn = fused_sketch.fused_drift_sketch
        before = fn.launches_by_mode[mode]
        out = fn(params, cfg, 0.4, x, probes, mode, cond, c0=-0.2, c1=0.8)
        ref = fused_sketch.fused_drift_sketch_reference(params, cfg, 0.4, x, probes, mode, cond, c0=-0.2, c1=0.8)
    else:
        fn = fused_sketch.fused_velocity_sketch
        before = fn.launches_by_mode[mode]
        out = fn(params, cfg, 0.4, x, probes, mode, cond)
        ref = fused_sketch.fused_velocity_sketch_reference(params, cfg, 0.4, x, probes, mode, cond)
    torch.cuda.synchronize()
    assert fn.launches_by_mode[mode] == before + 1
    assert bool(torch.isfinite(out[1]).all())
    assert _rel(out[0], ref[0]) <= 1e-5
    assert float((out[1] - ref[1]).abs().max()) <= 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("c", [0, 3])
def test_symplectic_kernel_matches_plain_version(cuda_device, c):
    cfg = SymplecticMLPConfig(n_data_dims=2, n_conditionals=c, units=(128, 128))
    params = init_symplectic_mlp(cfg, torch.Generator().manual_seed(14), cuda_device)
    g = torch.Generator().manual_seed(15)
    state = torch.randn(2005, 4, generator=g).to(cuda_device)
    cond = torch.randn(2005, c, generator=g).to(cuda_device) if c else None
    before = fused_mlp.fused_symplectic_velocity.launches
    out = fused_mlp.fused_symplectic_velocity(params, cfg, 0.43, state, cond)
    ref = fused_mlp.fused_symplectic_velocity_reference(params, cfg, 0.43, state, cond)
    torch.cuda.synchronize()
    assert fused_mlp.fused_symplectic_velocity.launches == before + 2  # one launch a stack
    assert _rel(out, ref) <= 1e-5


def _drift_outputs(fn, mode, *args, **kw):
    kw.update({"e": args[-1]} if mode == "hutchinson" else {"exact_divergence": mode == "exact"})
    out = fn(*args[:-1], **kw)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.gpu
@pytest.mark.parametrize("activation,units", [("silu", (128, 128, 128)), ("tanh", (100, 100)), ("gelu", (256, 256))])
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_highf32_kernel_matches_its_plain_version(cuda_device, mode, activation, units):
    """The highf32 kernel (3xTF32 mma.sync) against its plain version in
    highf32: they differ in summation order only (drift 1e-5, div 5e-5);
    against strict float32 within the JAX package's highf32 bars.  Width
    100 pads to 104 (a ragged n-strip), 1,001 rows a ragged row tile."""
    cfg = ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=units, activation=activation)
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), cuda_device)
    g = torch.Generator().manual_seed(1)
    x, cond, e = (torch.randn(1001, n, generator=g).to(cuda_device) for n in (6, 3, 6))
    args = (params, cfg, 0.4, x, cond, torch.sign(e))
    counts = dict(fused_mlp.fused_drift.launches_by_dtype)
    out = _drift_outputs(fused_mlp.fused_drift, mode, *args, c0=-0.2, c1=0.8, compute_dtype="highf32")
    ref = _drift_outputs(fused_mlp.fused_drift_reference, mode, *args, c0=-0.2, c1=0.8, compute_dtype="highf32")
    strict = _drift_outputs(fused_mlp.fused_drift_reference, mode, *args, c0=-0.2, c1=0.8)
    torch.cuda.synchronize()
    assert fused_mlp.fused_drift.launches_by_dtype == {**counts, "highf32": counts["highf32"] + 1}
    assert _rel(out[0], ref[0]) <= 1e-5
    assert _rel(out[0], strict[0]) <= (5e-5 if mode == "exact" else 1e-5)
    if mode != "forward":
        assert _rel(out[1], ref[1]) <= 5e-5
        assert _rel(out[1], strict[1]) <= (5e-4 if mode == "exact" else 1e-5)


@pytest.mark.gpu
def test_highf32_four_row_plan_and_wide_input(cuda_device):
    """The exact plan of 16 features at 4 rows a block (its M tail: 68 rows
    in 5 m-tiles) and a 20-feature input projection through the split."""
    for d, c, mode in ((16, 0, "exact"), (4, 16, "hutchinson")):
        cfg = ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=(128, 128))
        params = init_score_mlp(cfg, torch.Generator().manual_seed(2), cuda_device)
        g = torch.Generator().manual_seed(3)
        x, cond, e = (torch.randn(1003, n, generator=g).to(cuda_device) if n else None for n in (d, c, d))
        args = (params, cfg, 0.6, x, cond, torch.sign(e))
        out = _drift_outputs(fused_mlp.fused_drift, mode, *args, c0=0.3, c1=-0.5, compute_dtype="highf32")
        ref = _drift_outputs(fused_mlp.fused_drift_reference, mode, *args, c0=0.3, c1=-0.5, compute_dtype="highf32")
        torch.cuda.synchronize()
        assert _rel(out[0], ref[0]) <= 1e-5 and _rel(out[1], ref[1]) <= 5e-5


@pytest.mark.gpu
def test_highf32_tangents_velocity_and_symplectic(cuda_device):
    """The other highf32 entries against their plain versions: both
    tangents entries (K = 3), fused_velocity and the symplectic field."""
    g = torch.Generator().manual_seed(11)
    x, cond = (torch.randn(1003, n, generator=g).to(cuda_device) for n in (6, 3))
    V = torch.randn(3, 1003, 6, generator=g).to(cuda_device)
    for family in ("drift", "velocity"):
        cfg, params = _net(family, 6, 3, cuda_device, 10)
        if family == "drift":
            out = fused_mlp.fused_drift_tangents(params, cfg, 0.4, x, V, cond, c0=-0.2, c1=0.8, compute_dtype="highf32")
            ref = fused_mlp.fused_drift_tangents_reference(params, cfg, 0.4, x, V, cond, c0=-0.2, c1=0.8,
                                                           compute_dtype="highf32")
        else:
            out = fused_mlp.fused_velocity_tangents(params, cfg, 0.4, x, V, cond, compute_dtype="highf32")
            ref = fused_mlp.fused_velocity_tangents_reference(params, cfg, 0.4, x, V, cond, compute_dtype="highf32")
            vel = fused_mlp.fused_velocity(params, cfg, 0.4, x, cond, e=torch.sign(V[0]), compute_dtype="highf32")
            vref = fused_mlp.fused_velocity_reference(params, cfg, 0.4, x, cond, e=torch.sign(V[0]),
                                                      compute_dtype="highf32")
            assert _rel(vel[0], vref[0]) <= 1e-5 and _rel(vel[1], vref[1]) <= 5e-5
        assert _rel(out[0], ref[0]) <= 1e-5
        for o, r in zip(out[1], ref[1]):
            assert _rel(o, r) <= 5e-5
    cfg = SymplecticMLPConfig(n_data_dims=2, n_conditionals=3, units=(128, 128))
    params = init_symplectic_mlp(cfg, torch.Generator().manual_seed(14), cuda_device)
    state = torch.randn(2005, 4, generator=g).to(cuda_device)
    out = fused_mlp.fused_symplectic_velocity(params, cfg, 0.43, state, cond[:1].expand(2005, 3).contiguous(),
                                              compute_dtype="highf32")
    ref = fused_mlp.fused_symplectic_velocity_reference(params, cfg, 0.43, state, cond[:1].expand(2005, 3),
                                                        compute_dtype="highf32")
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-5


@pytest.mark.gpu
def test_highf32_solve_never_runs_the_strict_kernel(cuda_device):
    """A highf32 model's solve launches the highf32 kernel every RHS call
    and the float32 one never, the RHS kernel and the sketch kernel alike."""
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), cuda_device)
    model = ScoreModel(params, cfg, VESDE(), trace_mode="hutchinson", kernel_compute_dtype="highf32")
    x = torch.randn(257, 2, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    e = torch.sign(torch.randn(257, 2, generator=torch.Generator().manual_seed(2))).to(cuda_device)
    fused_mlp.reset_launch_counts()
    lp, st = model.log_prob(x, probes=(e,))
    assert bool(torch.isfinite(lp).all())
    assert fused_mlp.fused_drift.launches_by_dtype == {"float32": 0, "highf32": st.n_func_evals, "bfloat16": 0}
    fused_sketch.reset_launch_counts()
    lp, st = dataclasses.replace(model, trace_mode="xtrace").log_prob(x, probes=(e[None],))
    assert bool(torch.isfinite(lp).all())
    assert fused_sketch.fused_drift_sketch.launches_by_dtype == {"float32": 0, "highf32": st.n_func_evals,
                                                                 "bfloat16": 0}


def _sketch_case(d, c, mode, B, k, device, seed, degenerate=True):
    """(x, cond, probes) as test_sketch_kernel_matches_plain_version draws
    them: some exactly parallel Hutch++ sketch rows and a zero-probe row
    (``degenerate``), else plain Rademacher or sphere draws."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, d, generator=g).to(device)
    cond = torch.randn(B, c, generator=g).to(device) if c else None
    if mode == "hutchpp":
        S, G = (torch.sign(torch.randn(n, B, d, generator=g)) for n in (k, k))
        if degenerate:
            S[1, :100] = S[0, :100]
            S[:, 7] = 0.0
        return x, cond, (S.to(device), G.to(device))
    O = torch.randn(k, B, d, generator=g)
    O = O / O.norm(dim=-1, keepdim=True) * d**0.5
    if degenerate:
        O[:, 7] = 0.0
    return x, cond, (O.to(device),)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["drift", "velocity"])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("d,c", [(2, 0), (6, 3)])
def test_highf32_sketch_kernel_matches_its_plain_version(cuda_device, family, mode, d, c):
    """The sketch kernel in highf32 (3xTF32 mma.sync products) against its
    highf32 plain version, the float32 sketch bars (summation order only:
    drift 1e-5, div 2e-4 absolute), and against the float32 kernel within
    the JAX package's highf32 sketch bars (drift 5e-5, div 5e-4 relative);
    1,001 rows (ragged), every launch counted as highf32."""
    cfg, params = _net(family, d, c, cuda_device, 12)
    x, cond, probes = _sketch_case(d, c, mode, 1001, min(d, 3), cuda_device, 13)
    if family == "drift":
        fn, ref_fn, kw = fused_sketch.fused_drift_sketch, fused_sketch.fused_drift_sketch_reference, dict(c0=-0.2, c1=0.8)
    else:
        fn, ref_fn, kw = fused_sketch.fused_velocity_sketch, fused_sketch.fused_velocity_sketch_reference, {}
    counts = dict(fn.launches_by_dtype)
    out = fn(params, cfg, 0.4, x, probes, mode, cond, compute_dtype="highf32", **kw)
    assert fn.launches_by_dtype == {**counts, "highf32": counts["highf32"] + 1}
    ref = ref_fn(params, cfg, 0.4, x, probes, mode, cond, compute_dtype="highf32", **kw)
    strict = fn(params, cfg, 0.4, x, probes, mode, cond, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out[1]).all())
    assert _rel(out[0], ref[0]) <= 1e-5 and float((out[1] - ref[1]).abs().max()) <= 2e-4
    assert _rel(out[0], strict[0]) <= 5e-5 and _rel(out[1], strict[1]) <= 5e-4


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "highf32", "bfloat16"])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("d,c", [(2, 0), (6, 3)])
def test_sketch_kernel_is_bitwise_across_plans(cuda_device, d, c, mode, compute_dtype):
    """A row's arithmetic does not depend on the schedule: the launch at its
    own plan and at a forced one (4 rows, 8 where the plan has 4; the
    algebra at MD = 8) give bitwise equal drift and div; 1,001 rows
    (ragged), some exactly parallel Hutch++ sketch rows and a zero-probe
    row."""
    cfg, params = _net("drift", d, c, cuda_device, 12)
    k = min(d, 3)
    x, cond, probes = _sketch_case(d, c, mode, 1001, k, cuda_device, 13)
    t = torch.tensor(0.4, device=cuda_device)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, t, cond)
    x_in = x if cond is None else torch.cat([x, cond], dim=-1)
    V = torch.cat(probes)
    n_s, n_g = (k, k) if mode == "hutchpp" else (k, 0)
    c0c1 = torch.tensor([-0.2, 0.8], device=cuda_device)
    own = fused_sketch.sketch_plan(mode, 128, 3, d + c, d, n_s, n_g, compute_dtype=compute_dtype)
    forced = fused_sketch.sketch_plan(mode, 128, 3, d + c, d, n_s, n_g, md=8, rows=4 if own[0] != 4 else 8,
                                      compute_dtype=compute_dtype)
    assert forced != own
    outs = []
    for plan in (own, forced):
        outs.append(fused_sketch._launch(x_in, V, w_in, b_eff, params["layers"], c0c1, mode, d, n_s, n_g, "silu",
                                         plan, fused_sketch.fused_drift_sketch, compute_dtype))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "highf32"])
def test_xtrace_kernel_algebra_past_the_act_store(cuda_device, compute_dtype):
    """A net too narrow for XTrace's matrices to lie over its act' store or
    R of the QR over the input tile (H = 8, one hidden width, D = 8, m = 4):
    they go past the probe tile.  Against the plain version, and bitwise
    across plans; 1,001 rows (ragged)."""
    cfg = ScoreMLPConfig(n_dimensions=8, units=(8,))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(18), cuda_device)
    x, _, probes = _sketch_case(8, 0, "xtrace", 1001, 4, cuda_device, 19)
    assert fused_sketch._algebra_floats("xtrace", 4, 8, 8, 1, 8) == 16 + 4 * 16 + 4 * 8
    kw = dict(c0=-0.2, c1=0.8, compute_dtype=compute_dtype)
    out = fused_sketch.fused_drift_sketch(params, cfg, 0.4, x, probes, "xtrace", **kw)
    ref = fused_sketch.fused_drift_sketch_reference(params, cfg, 0.4, x, probes, "xtrace", **kw)
    t = torch.tensor(0.4, device=cuda_device)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, t, None)
    plan = fused_sketch.sketch_plan("xtrace", 8, 1, 8, 8, 4, 0, rows=4)
    c0c1 = torch.tensor([-0.2, 0.8], device=cuda_device)
    four = fused_sketch._launch(x, probes[0], w_in, b_eff, params["layers"], c0c1, "xtrace", 8, 4, 0, "silu", plan,
                                fused_sketch.fused_drift_sketch, compute_dtype)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out[1]).all())
    assert _rel(out[0], ref[0]) <= 1e-5
    assert float((out[1] - ref[1]).abs().max()) <= 2e-4
    assert torch.equal(out[0], four[0]) and torch.equal(out[1], four[1])


@pytest.mark.gpu
def test_highf32_sketch_four_row_plan_and_one_hidden_layer(cuda_device):
    """A Hutch++ plan that fits only at 4 rows a block (H = 256, D = 6,
    r = m = 3: 24-row products, a partial m-tile) and a one-hidden-layer
    net (no (H, H) product), highf32 kernel against its plain version."""
    assert fused_sketch.sketch_plan("hutchpp", 256, 3, 9, 6, 3, 3)[0] == 4
    for d, c, units in ((6, 3, (256, 256, 256)), (2, 0, (128,))):
        cfg = ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units)
        params = init_score_mlp(cfg, torch.Generator().manual_seed(16), cuda_device)
        x, cond, probes = _sketch_case(d, c, "hutchpp", 1003, min(d, 3), cuda_device, 17)
        out = fused_sketch.fused_drift_sketch(params, cfg, 0.6, x, probes, "hutchpp", cond, c0=0.3, c1=-0.5,
                                              compute_dtype="highf32")
        ref = fused_sketch.fused_drift_sketch_reference(params, cfg, 0.6, x, probes, "hutchpp", cond, c0=0.3,
                                                        c1=-0.5, compute_dtype="highf32")
        torch.cuda.synchronize()
        assert _rel(out[0], ref[0]) <= 1e-5 and float((out[1] - ref[1]).abs().max()) <= 2e-4


@pytest.mark.gpu
def test_auto_dispatch_on_card_raises_outside_sketch_plan(cuda_device):
    """The sketch kernel takes D <= 64 (the JAX sketch kernel's envelope):
    auto dispatch on the card runs it at D = 16 (the wide path) and raises
    for D = 65 instead of running the plain path, which runs only when
    asked for."""
    gen = torch.Generator().manual_seed(2)
    cfg16 = ScoreMLPConfig(n_dimensions=16, n_conditionals=8, units=(64,))
    m16 = ScoreModel(init_score_mlp(cfg16, torch.Generator().manual_seed(0), cuda_device), cfg16, VESDE(),
                     trace_mode="xtrace", xt_vecs=2)
    before = fused_sketch.fused_drift_sketch.launches
    lp, st = m16.log_prob(torch.randn(8, 16, generator=gen).to(cuda_device),
                          conditional=torch.randn(8, 8, generator=gen).to(cuda_device), generator=gen)
    assert fused_sketch.fused_drift_sketch.launches - before == st.n_func_evals and bool(torch.isfinite(lp).all())
    cfg = ScoreMLPConfig(n_dimensions=65, units=(64,))
    model = ScoreModel(init_score_mlp(cfg, torch.Generator().manual_seed(0), cuda_device), cfg, VESDE(),
                       trace_mode="xtrace", xt_vecs=2)
    x = torch.randn(8, 65, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    with pytest.raises(ValueError, match="use_fused_kernel=False"):
        model.log_prob(x, generator=gen)
    before = fused_sketch.fused_drift_sketch.launches
    lp, _ = dataclasses.replace(model, use_fused_kernel=False).log_prob(x, generator=gen)
    assert fused_sketch.fused_drift_sketch.launches == before and bool(torch.isfinite(lp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "highf32", "bfloat16"])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("d,c", [(16, 8), (20, 4), (64, 0)])
def test_wide_sketch_kernel_matches_plain_version(cuda_device, d, c, mode, compute_dtype):
    """The wide path (8 < D <= 64) at 4,099 rows against its plain version:
    float32 drift 1e-5 of the max and |d div| <= 5e-4 + 1e-4 |div| row by
    row (the JAX bar for its wide sketch kernel), highf32 5e-5 and 5e-4 of
    the max, bfloat16 the mean within 1e-5 of the max; and the same launch
    at a forced 4-row plan, bitwise."""
    cfg = ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=(128, 128, 128))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(d), cuda_device)
    k = 2 if mode == "hutchpp" else 3
    x, cond, probes = _sketch_case(d, c, mode, 4_099, k, cuda_device, 40 + d, degenerate=False)
    args = (params, cfg, 0.4, x, probes, mode, cond)
    out = fused_sketch.fused_drift_sketch(*args, c0=0.3, c1=-0.7, compute_dtype=compute_dtype)
    ref = fused_sketch.fused_drift_sketch_reference(*args, c0=0.3, c1=-0.7, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out[1]).all())
    if compute_dtype == "float32":
        assert _rel(out[0], ref[0]) <= 1e-5
        assert float(((out[1] - ref[1]).abs() - 1e-4 * ref[1].abs()).max()) <= 5e-4
    elif compute_dtype == "highf32":
        assert _rel(out[0], ref[0]) <= 5e-5 and _rel(out[1], ref[1]) <= 5e-4
    else:
        for o, r in zip(out, ref):
            assert float((o - r).abs().mean() / r.abs().max()) <= 1e-5
    n_s, n_g = (k, k) if mode == "hutchpp" else (k, 0)
    own = fused_sketch.sketch_plan(mode, 128, 3, d + c, d, n_s, n_g, compute_dtype=compute_dtype)
    assert own[2] == fused_sketch.MAX_SKETCH_DIM
    four = fused_sketch.sketch_plan(mode, 128, 3, d + c, d, n_s, n_g, rows=4 if own[0] != 4 else 8,
                                    compute_dtype=compute_dtype)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, torch.tensor(0.4, device=cuda_device), cond)
    x_in = x if cond is None else torch.cat([x, cond], dim=-1)
    c0c1 = torch.tensor([0.3, -0.7], device=cuda_device)
    V = torch.cat(probes)
    a, b = (fused_sketch._launch(x_in, V, w_in, b_eff, params["layers"], c0c1, mode, d, n_s, n_g, "silu", plan,
                                 fused_sketch.fused_drift_sketch, compute_dtype) for plan in (own, four))
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _train_tables(steps, bs, D, C, device, seed, symplectic=False):
    g = torch.Generator().manual_seed(seed)
    names = ("xt_q", "zw_q", "xt_p", "zw_p") if symplectic else ("xt", "zw")
    out = {k: torch.randn(steps, bs, D, generator=g).to(device) for k in names}
    out["t"] = (torch.rand(steps, bs, generator=g) * 0.999 + 1e-3).to(device)
    if not symplectic:
        out["beta"] = (torch.rand(steps, bs, generator=g) + 0.5).to(device)
    out["conditional"] = torch.randn(steps, bs, C, generator=g).to(device) if C else None
    return out


def _train_net(family, device, C=0):
    g = torch.Generator().manual_seed(16)
    if family == "score":
        cfg = ScoreMLPConfig(n_dimensions=2, n_conditionals=C, units=(128, 128, 128))
        return cfg, init_score_mlp(cfg, g, device)
    if family == "score_deep":  # 20 hidden widths: past the 17 fusable_config held before any depth
        cfg = ScoreMLPConfig(n_dimensions=2, units=(32,) * 20)
        return cfg, init_score_mlp(cfg, g, device)
    if family == "score_odd":  # K = 11, hidden 30 and 18, D = 3: every width padded to 4
        cfg = ScoreMLPConfig(n_dimensions=3, units=(30, 18), activation="tanh")
        return cfg, init_score_mlp(cfg, g, device)
    if family == "velocity":
        cfg = VelocityMLPConfig(target_dimension=2, conditional_dimension=C, hidden_units=(128, 128))
        return cfg, init_velocity_mlp(cfg, g, device)
    cfg = SymplecticMLPConfig(n_data_dims=2, n_conditionals=C, units=(128, 128))
    return cfg, init_symplectic_mlp(cfg, g, device)


def _max_layer_err(a, b):
    return max(float((x - y).abs().max()) for k in ("layers", "q_layers", "p_layers") if k in a
               for la, lb in zip(a[k], b[k]) for x, y in zip(la.values(), lb.values()))


@pytest.mark.gpu
@pytest.mark.parametrize("family,C,bs", [("score", 0, 512), ("score", 0, 500), ("score", 3, 256),
                                         ("score_odd", 0, 77), ("score_deep", 0, 256), ("velocity", 2, 300),
                                         ("symplectic", 0, 512)])
def test_train_kernel_matches_plain_version(cuda_device, family, C, bs):
    """Two chained calls of 4 steps with the EMA on, against the plain
    version at the JAX package's bars: losses rtol 1e-5, layers 3e-5 after
    one call and 5e-5 chained (3e-4 for the symplectic form); one launch a
    call (two for the symplectic form)."""
    from flowfusion_torch.kernels import fused_train as ft

    cfg, params = _train_net(family, cuda_device, C)
    sympl = family == "symplectic"
    tab = _train_tables(8, bs, 3 if family == "score_odd" else 2, C, cuda_device, 17, symplectic=sympl)
    fn = ft.fused_train_epoch_symplectic if sympl else ft.fused_train_epoch
    ref_fn = ft.fused_train_epoch_symplectic_reference if sympl else ft.fused_train_epoch_reference
    kw = {"mean_over_dims": True} if family == "velocity" else {}
    halves = [{k: None if v is None else v[s] for k, v in tab.items()} for s in (slice(0, 4), slice(4, 8))]
    runs = []
    for f in (fn, ref_fn):
        before = fn.launches
        o1 = f(params, cfg, None, lr=1e-3, ema_decay=0.99, **halves[0], **kw)
        o2 = f(o1[0], cfg, o1[1], lr=1e-3, ema=o1[2], ema_decay=0.99, **halves[1], **kw)
        runs.append((o1, o2, fn.launches - before))
    torch.cuda.synchronize()
    (k1, k2, n_k), (r1, r2, n_r) = runs
    assert n_k == (4 if sympl else 2) and n_r == 0
    for o, r in ((k1, r1), (k2, r2)):
        torch.testing.assert_close(o[3], r[3], rtol=1e-5, atol=0)
    assert _max_layer_err(k1[0], r1[0]) <= (3e-4 if sympl else 3e-5)
    assert max(_max_layer_err(k2[0], r2[0]), _max_layer_err(k2[2], r2[2])) <= (3e-4 if sympl else 5e-5)
    key = "p_layers" if sympl else "layers"
    assert k2[0][key][0]["w"].shape == params[key][0]["w"].shape  # padding stripped


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["highf32", "bfloat16"])
@pytest.mark.parametrize("family,C,bs", [("score", 0, 512), ("score_odd", 0, 77), ("velocity", 2, 300),
                                         ("symplectic", 0, 512)])
def test_train_kernel_modes_match_plain_version(cuda_device, family, C, bs, mode):
    """highf32 and bfloat16: two chained calls of 4 steps with the EMA on,
    at eps = 1 (at 1e-8 a gradient near zero flips a step's sign), against
    the mode's plain version: losses rtol 1e-5 (3e-5 in bfloat16), layers
    and EMA at float32's chained bar (5e-5, symplectic 3e-4); the launches
    counted by mode; a repeated launch bitwise equal."""
    from flowfusion_torch.kernels import fused_train as ft

    cfg, params = _train_net(family, cuda_device, C)
    sympl = family == "symplectic"
    tab = _train_tables(8, bs, 3 if family == "score_odd" else 2, C, cuda_device, 21, symplectic=sympl)
    fn = ft.fused_train_epoch_symplectic if sympl else ft.fused_train_epoch
    ref_fn = ft.fused_train_epoch_symplectic_reference if sympl else ft.fused_train_epoch_reference
    kw = dict({"mean_over_dims": True} if family == "velocity" else {}, lr=1e-3, eps=1.0, ema_decay=0.99,
              compute_dtype=mode)
    halves = [{k: None if v is None else v[s] for k, v in tab.items()} for s in (slice(0, 4), slice(4, 8))]
    runs = []
    for f in (fn, ref_fn, fn):
        before = fn.launches_by_dtype[mode]
        o1 = f(params, cfg, None, **halves[0], **kw)
        o2 = f(o1[0], cfg, o1[1], ema=o1[2], **halves[1], **kw)
        runs.append((o2, fn.launches_by_dtype[mode] - before))
    torch.cuda.synchronize()
    (k, n_k), (r, n_r), (k_again, _) = runs
    assert n_k == (4 if sympl else 2) and n_r == 0
    torch.testing.assert_close(k[3], r[3], rtol=1e-5 if mode == "highf32" else 3e-5, atol=0)
    assert max(_max_layer_err(k[0], r[0]), _max_layer_err(k[2], r[2])) <= (3e-4 if sympl else 5e-5)
    assert torch.equal(k[3], k_again[3]) and _max_layer_err(k[0], k_again[0]) == 0.0


@pytest.mark.gpu
def test_train_kernel_is_deterministic(cuda_device):
    """No float atomics: two launches on the same inputs are bitwise equal."""
    from flowfusion_torch.kernels import fused_train as ft

    cfg, params = _train_net("score", cuda_device)
    tab = _train_tables(12, 1000, 2, 0, cuda_device, 18)
    a, b = (ft.fused_train_epoch(params, cfg, lr=1e-3, ema_decay=0.9, **tab) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a[3], b[3]) and _max_layer_err(a[0], b[0]) == 0.0 and _max_layer_err(a[2], b[2]) == 0.0


@pytest.mark.gpu
def test_train_kernel_raises_instead_of_falling_back(cuda_device):
    """On CUDA tensors the wrapper launches or raises: float64 tables, and a
    net whose shared-memory plan does not fit (fit's auto choice raises too,
    naming engine='plain')."""
    from flowfusion_torch import train
    from flowfusion_torch.kernels import fused_train as ft
    from flowfusion_torch.models.population import PopulationModelDiffusion

    cfg, params = _train_net("score", cuda_device)
    tab = _train_tables(2, 64, 2, 0, cuda_device, 19)
    with pytest.raises(ValueError, match="float32"):
        ft.fused_train_epoch(params, cfg, lr=1e-3, **dict(tab, xt=tab["xt"].double()))
    wide = ScoreMLPConfig(n_dimensions=2, units=(4096,) * 3)
    before = ft.fused_train_epoch.launches
    with pytest.raises(ValueError, match="plan does not fit"):
        ft.fused_train_epoch(init_score_mlp(wide, torch.Generator().manual_seed(0), cuda_device), wide, lr=1e-3, **tab)
    pop = PopulationModelDiffusion.create(VESDE(), n_dimensions=2, units=(4096,) * 3, device=cuda_device)
    with pytest.raises(ValueError, match="engine='plain'"):
        train.fit(pop, torch.Generator(device=cuda_device).manual_seed(0), torch.randn(64, 2, device=cuda_device),
                  stages=[(32, 1e-3)], epochs_per_stage=1)
    assert ft.fused_train_epoch.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["auto", "plain"])
def test_fit_exact_resume_on_the_card(cuda_device, tmp_path, engine):
    """Stopped by the budget mid-stage and resumed, fit on the card ends
    bitwise where the uninterrupted run ends; auto takes the fused engine
    (one launch an epoch)."""
    from flowfusion_torch import train
    from flowfusion_torch.kernels import fused_train as ft
    from flowfusion_torch.models.population import PopulationModelDiffusion
    from flowfusion_torch.utils.tree import leaves_with_paths

    x = torch.randn(1000, 2, generator=torch.Generator().manual_seed(20)).to(cuda_device)
    pop = PopulationModelDiffusion.create(VESDE(), n_dimensions=2, units=(128, 128),
                                          generator=torch.Generator().manual_seed(21), device=cuda_device)
    kw = dict(stages=[(64, 1e-3), (256, 1e-4)], epochs_per_stage=2, ema_decay=0.99, engine=engine)

    def gen(seed):
        return torch.Generator(device=cuda_device).manual_seed(seed)

    before = ft.fused_train_epoch.launches
    m_full, r_full = train.fit(pop, gen(3), x, **kw)
    assert ft.fused_train_epoch.launches - before == (4 if engine == "auto" else 0)
    train.fit(pop, gen(3), x, checkpoint_dir=str(tmp_path), max_epochs_total=3, **kw)
    m_res, r_res = train.fit(pop, gen(99), x, checkpoint_dir=str(tmp_path), **kw)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves_with_paths(m_res), leaves_with_paths(m_full)))
    for a, b in zip(r_res, r_full):
        assert list(a.train_losses) == list(b.train_losses)


def _train_launch_case(family, bs, C, cuda_device):
    """(cfg, flat layers, W, tables, inv) of one training-kernel launch on a
    random net, the symplectic form as its q stack's half-net."""
    from flowfusion_torch.kernels import fused_train as ft

    cfg, params = _train_net(family, cuda_device, C)
    layers = params["layers"] if family != "symplectic" else ft._sympl_perm_layer0(params["q_layers"], 2, C, 8, False)
    if family == "symplectic":
        cfg = ft._sympl_half_cfg(cfg)
    D = 3 if family == "score_odd" else 2
    tab = _train_tables(6, bs, D, C, cuda_device, 23)
    return cfg, layers, params["W"] if "W" in params else None, tab, 1.0 / bs


_TRAIN_PLAN_CASES = [("score", 512, 0), ("score", 77, 0), ("score", 256, 3), ("velocity", 300, 2),
                     ("symplectic", 512, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("family, bs, C", _TRAIN_PLAN_CASES)
def test_train_kernel_is_bitwise_across_plans(cuda_device, family, bs, C):
    """No sum's order depends on the plan: a launch at its own plan equals,
    bitwise (params, moments, EMA, losses), the same launch forced to other
    rows a block (4, or 8 where the plan has 4, for another row tile a
    thread), to a smaller grid, and to 32 rows a block (where the net no
    longer fits beside the rows and is staged in k-chunks)."""
    from flowfusion_torch.kernels import fused_train as ft

    cfg, layers, W, tab, inv = _train_launch_case(family, bs, C, cuda_device)
    K, H, _, D = ft._dims(cfg)
    own = ft.train_plan(cfg, bs)
    outs = []
    for plan, grid in ((own, None), (ft.train_plan(cfg, bs, rows=4 if own[0] != 4 else 8), None), (own, 17),
                       (ft.train_plan(cfg, bs, rows=32), None)):
        flat = ft._pack([(l["w"], l["b"]) for l in layers], K, H, D)
        state = [flat, torch.zeros_like(flat), torch.zeros_like(flat), flat.clone()]
        loss = ft.launch_packed(cfg, plan, tab["xt"], tab["zw"], tab["t"], tab["beta"], tab["conditional"], W, *state,
                                0, 1e-3, 0.9, 0.999, 1e-8, 0.99, inv, grid=grid)
        outs.append(state + [loss])
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other)), (family, bs, own)


@pytest.mark.gpu
def test_train_kernel_occupancy(cuda_device):
    """Every training plan of the cases above, at its own rows, 4 and 32,
    keeps no local memory a thread and launches with one block an SM at
    least."""
    from flowfusion_torch.kernels import fused_train as ft

    for family, bs, C in _TRAIN_PLAN_CASES + [("score", 128, 0)]:
        cfg = _train_launch_case(family, bs, C, cuda_device)[0]
        for plan in (ft.train_plan(cfg, bs), ft.train_plan(cfg, bs, rows=4), ft.train_plan(cfg, bs, rows=32)):
            occ = ft.occupancy(plan)
            assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, (family, bs, occ)


_RHS_NETS = [(2, 0, 128), (2, 0, 256), (6, 3, 128), (6, 3, 256)]


def _rhs_launch_args(cuda_device, D, C, H, mode, B=1001):
    """Operands of one RHS kernel launch on a random net, as the wrapper
    prepares them: (x_in, e, w_in, b_eff, layers, c0c1, mode, D, n_tan)."""
    cfg = ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(H,) * 3)
    params = init_score_mlp(cfg, torch.Generator().manual_seed(D + C + H), cuda_device)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(B, D, generator=g).to(cuda_device)
    cond = torch.randn(B, C, generator=g).to(cuda_device) if C else None
    n_tan = 3 if mode == "tangents" else 0
    e = {"hutchinson": torch.sign(torch.randn(B, D, generator=g)),
         "tangents": torch.randn(B, n_tan * D, generator=g)}.get(mode)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, 0.4, cond)
    x_in = x if cond is None else torch.cat([x, cond], -1)
    c0c1 = torch.tensor([-0.2, 0.8], device=cuda_device)
    return (x_in, None if e is None else e.to(cuda_device), w_in, b_eff, params["layers"], c0c1, mode, D, n_tan)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "highf32"])
@pytest.mark.parametrize("D, C, H", _RHS_NETS)
def test_rhs_kernel_is_bitwise_across_plans(cuda_device, D, C, H, compute_dtype):
    """A row's outputs do not depend on the plan: each mode's launch at its
    own plan equals, bitwise, one forced to 4 rows a block (8 where the plan
    has 4), on 1,001 ragged rows."""
    for mode in ("forward", "hutchinson", "exact", "tangents"):
        x_in, e, w_in, b_eff, layers, c0c1, mode, D_, n_tan = _rhs_launch_args(cuda_device, D, C, H, mode)
        own = fused_mlp._plan(H, mode, D + C, D, n_tan, compute_dtype)
        outs = [fused_mlp._launch(x_in, e, w_in, b_eff, layers, c0c1, mode, D, "silu", n_tan=n_tan,
                                  compute_dtype=compute_dtype, rows=rows)
                for rows in (None, 4 if own[0] != 4 else 8)]
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            if a is not None:
                assert torch.equal(a, b), (mode, own)


@pytest.mark.gpu
def test_rhs_kernel_occupancy(cuda_device):
    """Every plan of the cases above holds the blocks it plans for, with no
    local memory a thread; the float32 flagship Hutchinson plan holds three
    blocks an SM."""
    for D, C, H in _RHS_NETS:
        for mode in ("forward", "hutchinson", "exact", "tangents"):
            for dt in ("float32", "highf32"):
                plan = fused_mlp._plan(H, mode, D + C, D, 3 if mode == "tangents" else 0, dt)
                occ = fused_mlp.occupancy(plan, dt)
                assert occ["local_bytes"] == 0, (D, C, H, mode, dt, occ)
                assert occ["blocks_per_sm"] == fused_mlp.plan_blocks(plan), (D, C, H, mode, dt, occ)
    assert fused_mlp.occupancy(fused_mlp._plan(128, "hutchinson", 2, 2))["blocks_per_sm"] == 3


def _flagship(device, **kw):
    import os

    from flowfusion_torch.utils.checkpoint import load_npz
    from flowfusion_torch.utils.convert import params_from_numpy

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                        "flagship_ckpt.npz")
    return ScoreModel(params_from_numpy(load_npz(path)["params"], device),
                      ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), VESDE(), **kw)


def _rows(device, n=4096):
    g = torch.Generator().manual_seed(n)
    return torch.randn(n, 2, generator=g).to(device), (torch.sign(torch.randn(n, 2, generator=g)).to(device),)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["tsit5", "bosh3", "fehlberg2", "adaptive_heun", "dop853"])
def test_new_tableaus_launch_the_kernel_once_an_evaluation(cuda_device, method):
    """chip_smoke.py 13a at 4,096 rows: the kernel solve against the plain
    solve on the card, rtol 1e-5 PI: NFE within one attempt, mean |dlogp|
    <= 1e-4, launches = NFE."""
    from flowfusion_torch.ops.integrate.tableaus import get_adaptive_tableau

    x, probes = _rows(cuda_device)
    kw = dict(probes=probes, atol=1e-5, rtol=1e-5, method=method, options={"controller": "pi"})
    fused_mlp.reset_launch_counts()
    lp_k, st_k = _flagship(cuda_device, trace_mode="hutchinson").log_prob(x, **kw)
    assert fused_mlp.fused_drift.launches == st_k.n_func_evals
    lp_p, st_p = _flagship(cuda_device, trace_mode="hutchinson", use_fused_kernel=False).log_prob(x, **kw)
    assert abs(st_k.n_func_evals - st_p.n_func_evals) <= get_adaptive_tableau(method).evals_per_step
    assert float((lp_k - lp_p).abs().mean()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams"])
def test_adams_launch_the_kernel_by_the_formula(cuda_device, method):
    """chip_smoke.py 13b at 4,096 rows: launches = the method's NFE formula,
    log_prob within mean |dlogp| 1e-4 and samples within rtol 1e-5 / atol
    1e-4 of the plain path."""
    from flowfusion_torch.ops.integrate.multistep import multistep_evals

    x, probes = _rows(cuda_device)
    fused_mlp.reset_launch_counts()
    lp_k, _ = _flagship(cuda_device, trace_mode="hutchinson").log_prob(x, probes=probes, method=method)
    assert fused_mlp.fused_drift.launches == multistep_evals(method, 16, 1)
    lp_p, _ = _flagship(cuda_device, trace_mode="hutchinson", use_fused_kernel=False).log_prob(
        x, probes=probes, method=method)
    assert float((lp_k - lp_p).abs().mean()) <= 1e-4
    s_k, _ = _flagship(cuda_device).sample_ode_from_base(x, method=method)
    s_p, _ = _flagship(cuda_device, use_fused_kernel=False).sample_ode_from_base(x, method=method)
    torch.testing.assert_close(s_k, s_p, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2])
def test_dpm_launches_steps_times_order(cuda_device, order):
    """chip_smoke.py 13c at 4,096 rows: steps x order launches, samples
    within rtol 1e-5 / atol 1e-4 of the plain path (the JAX bar,
    tests/test_kernels.py:1065); per-sample and adjoint solves launch
    nothing."""
    x, probes = _rows(cuda_device)
    fused_mlp.reset_launch_counts()
    s_k = _flagship(cuda_device).sample_dpm(x, steps=12, order=order)
    assert fused_mlp.fused_drift.launches == 12 * order
    s_p = _flagship(cuda_device, use_fused_kernel=False).sample_dpm(x, steps=12, order=order)
    torch.testing.assert_close(s_k, s_p, rtol=1e-5, atol=1e-4)
    fused_mlp.reset_launch_counts()
    m = _flagship(cuda_device, trace_mode="hutchinson")
    lp, st = m.log_prob_per_sample(x[:256], probes=(probes[0][:256],))
    assert bool(st.succeeded.all()) and fused_mlp.fused_drift.launches == 0
    m.params["layers"][0]["w"].requires_grad_(True)
    m.log_prob(x[:64], probes=(probes[0][:64],), adjoint=True)[0].mean().backward()
    assert fused_mlp.fused_drift.launches == 0 and torch.isfinite(m.params["layers"][0]["w"].grad).all()


def _fake_call(op, args):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                [mode.from_tensor(t) for t in a] if isinstance(a, list) else a for a in args]
        return op(*fake)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact", "tangents", "hutchpp", "xtrace"])
def test_op_fake_shapes_match_the_launch(cuda_device, mode):
    """Each registered op's fake kernel gives the shapes, dtypes and device
    of its launch on the card, in every mode."""
    cfg = ScoreMLPConfig(n_dimensions=3, units=(64, 64))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), cuda_device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(777, 3, generator=g).to(cuda_device)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, 0.4, None)
    hidden = params["layers"][1:-1]
    common = (w_in, b_eff, [l["w"] for l in hidden], [l["b"] for l in hidden], params["layers"][-1]["w"],
              params["layers"][-1]["b"], torch.tensor([-0.2, 0.8], device=cuda_device))
    if mode in ("hutchpp", "xtrace"):
        n_s, n_g = (2, 1) if mode == "hutchpp" else (2, 0)
        V = torch.sign(torch.randn(n_s + n_g, 777, 3, generator=g)).to(cuda_device)
        op, args = fused_sketch.fused_sketch_op, (x, V, *common, mode, 3, n_s, n_g, "silu", "float32",
                                                  "fused_drift_sketch", 0, 0)
    else:
        n_tan = 2 if mode == "tangents" else 0
        e = {"hutchinson": torch.sign(torch.randn(777, 3, generator=g)),
             "tangents": torch.randn(777, 6, generator=g)}.get(mode)
        op = fused_mlp.fused_mlp_op
        args = (x, None if e is None else e.to(cuda_device), *common, mode, 3, n_tan, "silu", "float32",
                "fused_drift", 0)
    real = op(*args)
    torch.cuda.synchronize()
    fake = _fake_call(op, args)
    for f, r in zip(fake, real):
        assert tuple(f.shape) == tuple(r.shape) and f.dtype == r.dtype and f.device == r.device


@pytest.mark.gpu
@pytest.mark.parametrize("trace_mode", ["hutchinson", "exact"])
def test_symbolic_artifact_launches_the_kernel(cuda_device, trace_mode):
    """A symbolic-batch artifact exported on the card holds the op and no
    plain net, launches the kernel as often as the eager solve at three
    batch sizes, and gives its densities bitwise."""
    from flowfusion_torch.utils import serving

    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128))
    model = ScoreModel(init_score_mlp(cfg, torch.Generator().manual_seed(2), cuda_device), cfg, VESDE(),
                       trace_mode=trace_mode)
    f = serving.deserialize_log_prob(serving.export_log_prob(model))
    gm = f.program.graph_module
    targets = {str(n.target) for g in [gm, *gm.children()] for n in g.graph.nodes if n.op == "call_function"}
    assert any("fused_mlp" in t for t in targets) and not any("silu" in t for t in targets)
    for n in (1, 1000, 4097):
        x = torch.randn(n, 2, generator=torch.Generator().manual_seed(n)).to(cuda_device) * 2.0
        fused_mlp.reset_launch_counts()
        lp = f(x, seed=3)
        torch.cuda.synchronize()
        launches = fused_mlp.fused_drift.launches
        fused_mlp.reset_launch_counts()
        ref, st = model.log_prob(x, generator=torch.Generator(cuda_device).manual_seed(3), atol=1e-5, rtol=1e-5)
        torch.cuda.synchronize()
        assert launches == fused_mlp.fused_drift.launches == st.n_func_evals
        assert torch.equal(lp, ref)


# ---------------------------------------------------------------------------
# compute mode bfloat16
# ---------------------------------------------------------------------------


def _mean_rel(a, b):
    return float((a - b).abs().mean() / b.abs().max())


def _check_bf16(out, ref, strict):
    """The bfloat16 bars of the module docstring, for each output."""
    for o, r, s in zip(out, ref, strict):
        assert _rel(o, r) <= 4e-3 and _mean_rel(o, r) <= 1e-5, (_rel(o, r), _mean_rel(o, r))
        assert _mean_rel(o, r) <= 0.1 * _mean_rel(r, s), (_mean_rel(o, r), _mean_rel(r, s))
        assert _rel(o, s) <= 3e-2, _rel(o, s)


@pytest.mark.gpu
@pytest.mark.parametrize("activation,units", [("silu", (128, 128, 128)), ("tanh", (112, 112)), ("gelu", (256, 256))])
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact"])
def test_bf16_kernel_matches_its_plain_version(cuda_device, mode, activation, units):
    """The bfloat16 kernel (bf16 mma.sync m16n8k16) against its plain
    version: width 112 pads to 128 (the 16-deep k-step), 1,001 rows a
    ragged row tile; every launch counted as bfloat16."""
    cfg = ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=units, activation=activation)
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), cuda_device)
    g = torch.Generator().manual_seed(1)
    x, cond, e = (torch.randn(1001, n, generator=g).to(cuda_device) for n in (6, 3, 6))
    args = (params, cfg, 0.4, x, cond, torch.sign(e))
    counts = dict(fused_mlp.fused_drift.launches_by_dtype)
    out = _drift_outputs(fused_mlp.fused_drift, mode, *args, c0=-0.2, c1=0.8, compute_dtype="bfloat16")
    ref = _drift_outputs(fused_mlp.fused_drift_reference, mode, *args, c0=-0.2, c1=0.8, compute_dtype="bfloat16")
    strict = _drift_outputs(fused_mlp.fused_drift_reference, mode, *args, c0=-0.2, c1=0.8)
    torch.cuda.synchronize()
    assert fused_mlp.fused_drift.launches_by_dtype == {**counts, "bfloat16": counts["bfloat16"] + 1}
    _check_bf16(out, ref, strict)


@pytest.mark.gpu
def test_bf16_four_row_plan_wide_input_and_other_entries(cuda_device):
    """The exact plan of 16 features at 4 rows a block, a 20-feature input
    projection (rounded past the rank-1 crossover), both tangents entries
    (K = 3), fused_velocity and the symplectic field, each against its
    bfloat16 plain version."""
    for d, c, mode in ((16, 0, "exact"), (4, 16, "hutchinson")):
        cfg = ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=(128, 128))
        params = init_score_mlp(cfg, torch.Generator().manual_seed(2), cuda_device)
        g = torch.Generator().manual_seed(3)
        x, cond, e = (torch.randn(1003, n, generator=g).to(cuda_device) if n else None for n in (d, c, d))
        args = (params, cfg, 0.6, x, cond, torch.sign(e))
        _check_bf16(*(_drift_outputs(fn, mode, *args, c0=0.3, c1=-0.5, **kw) for fn, kw in (
            (fused_mlp.fused_drift, {"compute_dtype": "bfloat16"}),
            (fused_mlp.fused_drift_reference, {"compute_dtype": "bfloat16"}), (fused_mlp.fused_drift_reference, {}))))
    g = torch.Generator().manual_seed(11)
    x, cond = (torch.randn(1003, n, generator=g).to(cuda_device) for n in (6, 3))
    V = torch.randn(3, 1003, 6, generator=g).to(cuda_device)
    bf = {"compute_dtype": "bfloat16"}
    for family in ("drift", "velocity"):
        cfg, params = _net(family, 6, 3, cuda_device, 10)
        kw = dict(c0=-0.2, c1=0.8) if family == "drift" else {}
        fn = fused_mlp.fused_drift_tangents if family == "drift" else fused_mlp.fused_velocity_tangents
        ref_fn = getattr(fused_mlp, fn.__name__ + "_reference")
        outs = [fn(params, cfg, 0.4, x, V, cond, **kw, **bf), ref_fn(params, cfg, 0.4, x, V, cond, **kw, **bf),
                ref_fn(params, cfg, 0.4, x, V, cond, **kw)]
        _check_bf16(*([o[0]] + o[1] for o in outs))
        if family == "velocity":
            e = torch.sign(V[0])
            _check_bf16(*(f(params, cfg, 0.4, x, cond, e=e, **k) for f, k in (
                (fused_mlp.fused_velocity, bf), (fused_mlp.fused_velocity_reference, bf),
                (fused_mlp.fused_velocity_reference, {}))))
    cfg = SymplecticMLPConfig(n_data_dims=2, n_conditionals=3, units=(128, 128))
    params = init_symplectic_mlp(cfg, torch.Generator().manual_seed(14), cuda_device)
    state = torch.randn(2005, 4, generator=g).to(cuda_device)
    c = cond[:1].expand(2005, 3).contiguous()
    _check_bf16(*([f(params, cfg, 0.43, state, c, **k)] for f, k in (
        (fused_mlp.fused_symplectic_velocity, bf), (fused_mlp.fused_symplectic_velocity_reference, bf),
        (fused_mlp.fused_symplectic_velocity_reference, {}))))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact", "tangents"])
def test_bf16_kernel_is_bitwise_across_plans(cuda_device, mode):
    """A row's arithmetic does not depend on the plan in bfloat16 either:
    the launch at its own plan against the same launch forced to 4 rows."""
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(6), cuda_device)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(5003, 2, generator=g).to(cuda_device)
    n_tan = 3 if mode == "tangents" else 0
    e = torch.sign(torch.randn(5003, 2 * max(n_tan, 1), generator=g)).to(cuda_device)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, 0.3, None)
    c0c1 = torch.tensor([0.1, -0.7], device=cuda_device)
    own, forced = (fused_mlp._launch(x, e if mode in ("hutchinson", "tangents") else None, w_in, b_eff,
                                     params["layers"], c0c1, mode, 2, "silu", n_tan=n_tan,
                                     compute_dtype="bfloat16", rows=r) for r in (None, 4))
    assert fused_mlp._plan(128, mode, 2, 2, n_tan, "bfloat16")[0] > 4
    assert torch.equal(own[0], forced[0]) and (own[1] is None or torch.equal(own[1], forced[1]))


def _check_bf16_sketch(out, ref, strict, ref64):
    """The sketch's bfloat16 bars (the module docstring's), drift and div;
    ``ref64`` the plain version with its products summed in float64."""
    for o, r, s, r64 in zip(out, ref, strict, ref64):
        bar = max(1e-5, 2 * _mean_rel(r64, r))
        assert _rel(o, r) <= 3e-2 and _mean_rel(o, r) <= bar, (_rel(o, r), _mean_rel(o, r), bar)
        assert _mean_rel(o, r) <= 0.1 * _mean_rel(r, s), (_mean_rel(o, r), _mean_rel(r, s))
    assert _rel(out[0], strict[0]) <= 3e-2, _rel(out[0], strict[0])


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["drift", "velocity"])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("d,c", [(2, 0), (6, 3)])
def test_bf16_sketch_kernel_matches_its_plain_version(cuda_device, family, mode, d, c, monkeypatch):
    """The sketch kernel in bfloat16 (bf16 mma.sync m16n8k16 products on a
    bf16 plane) against its bfloat16 plain version, 1,001 rows (ragged),
    Rademacher or sphere probes without degenerate rows; every launch
    counted as bfloat16; no local memory at the plan it took."""
    cfg, params = _net(family, d, c, cuda_device, 12)
    x, cond, probes = _sketch_case(d, c, mode, 1001, min(d, 3), cuda_device, 13, degenerate=False)
    if family == "drift":
        fn, ref_fn, kw = fused_sketch.fused_drift_sketch, fused_sketch.fused_drift_sketch_reference, dict(c0=-0.2, c1=0.8)
    else:
        fn, ref_fn, kw = fused_sketch.fused_velocity_sketch, fused_sketch.fused_velocity_sketch_reference, {}
    counts = dict(fn.launches_by_dtype)
    out = fn(params, cfg, 0.4, x, probes, mode, cond, compute_dtype="bfloat16", **kw)
    assert fn.launches_by_dtype == {**counts, "bfloat16": counts["bfloat16"] + 1}
    ref = ref_fn(params, cfg, 0.4, x, probes, mode, cond, compute_dtype="bfloat16", **kw)
    strict = ref_fn(params, cfg, 0.4, x, probes, mode, cond, **kw)
    monkeypatch.setattr(fused_mlp, "bf16_matmul", lambda a, b, round_a=True: (
        (fused_mlp.bf16_round(a) if round_a else a).double() @ fused_mlp.bf16_round(b).double()).float())
    ref64 = ref_fn(params, cfg, 0.4, x, probes, mode, cond, compute_dtype="bfloat16", **kw)
    torch.cuda.synchronize()
    _check_bf16_sketch(out, ref, strict, ref64)
    k = min(d, 3)
    n_s, n_g = (k, k) if mode == "hutchpp" else (k, 0)
    n_act = len(cfg.units) if family == "drift" else len(cfg.hidden_units)
    plan = fused_sketch.sketch_plan(mode, 128, n_act, d + c, d, n_s, n_g, compute_dtype="bfloat16")
    assert fused_sketch.sketch_occupancy(plan, "bfloat16")["local_bytes"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("c", [0, 3])
def test_bf16_em_kernel_matches_plain_version(cuda_device, c):
    """The bfloat16 EM kernel against its plain version on 10 steps of
    streamed noise (within 1e-2 of the max magnitude), in-kernel Philox noise
    running finite; launches counted as bfloat16; no local memory."""
    d = 6 if c else 2
    cfg = ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=(128, 128, 128))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(4), cuda_device)
    g = torch.Generator().manual_seed(5)
    x0 = torch.randn(1001, d, generator=g).to(cuda_device)
    cond = torch.randn(1001, c, generator=g).to(cuda_device) if c else None
    noise = torch.randn(10, 1001, d, generator=g).to(cuda_device)
    kw = dict(conditional=cond, steps=10, no_sigma=True, compute_dtype="bfloat16")
    before = dict(em_sampler.fused_em_sample.launches_by_dtype)
    out = em_sampler.fused_em_sample(params, cfg, VPSDE(), x0, noise=noise, **kw)
    ref = em_sampler.fused_em_sample_reference(params, cfg, VPSDE(), x0, noise, **kw)
    seeded = em_sampler.fused_em_sample(params, cfg, VPSDE(), x0, 2**35, **kw)
    torch.cuda.synchronize()
    assert em_sampler.fused_em_sample.launches_by_dtype == {**before, "bfloat16": before["bfloat16"] + 2}
    assert _rel(out[0], ref[0]) <= 1e-2 and _rel(out[1], ref[1]) <= 1e-2
    assert bool(out[2]) == bool(ref[2]) is False and bool(torch.isfinite(seeded[1]).all())
    occ = em_sampler.em_occupancy(em_sampler.em_plan(128, d, c > 0), "bfloat16")
    assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] == 2, occ


@pytest.mark.gpu
def test_bf16_model_launches_only_bf16_kernels(cuda_device):
    """A bfloat16 model's Hutchinson solve launches the bfloat16 RHS kernel
    every RHS call and no other mode; its fused sampler the bfloat16 EM
    kernel; its XTrace and Hutch++ solves the bfloat16 sketch kernel every
    RHS call and no other mode."""
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), cuda_device)
    model = ScoreModel(params, cfg, VESDE(), trace_mode="hutchinson", kernel_compute_dtype="bfloat16")
    x = torch.randn(257, 2, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    e = torch.sign(torch.randn(257, 2, generator=torch.Generator().manual_seed(2))).to(cuda_device)
    fused_mlp.reset_launch_counts()
    em_sampler.reset_launch_counts()
    lp, st = model.log_prob(x, probes=(e,))
    res = model.sample_sde_fused((257, 2), steps=20, generator=torch.Generator(cuda_device).manual_seed(3))
    assert bool(torch.isfinite(lp).all()) and not bool(res.nan_encountered)
    assert fused_mlp.fused_drift.launches_by_dtype == {"float32": 0, "highf32": 0, "bfloat16": st.n_func_evals}
    assert em_sampler.fused_em_sample.launches_by_dtype == {"float32": 0, "bfloat16": 1}
    for trace_mode, probes in (("xtrace", (e[None],)), ("hutchpp", (e[None], e[None]))):
        fused_sketch.reset_launch_counts()
        lp, st = dataclasses.replace(model, trace_mode=trace_mode).log_prob(x, probes=probes)
        assert bool(torch.isfinite(lp).all())
        assert fused_sketch.fused_drift_sketch.launches_by_dtype == {"float32": 0, "highf32": 0,
                                                                     "bfloat16": st.n_func_evals}


@pytest.mark.gpu
def test_converted_flagship_solve_is_bitwise(cuda_device):
    """chip_smoke.py 16a at 4,096 rows: the flagship written as a reference
    state_dict on the card and converted back solves bitwise like the
    npz-loaded model, launches = NFE."""
    import os

    from chip_smoke import BENCH, reference_state_dict
    from flowfusion_torch.utils.checkpoint import load_npz
    from flowfusion_torch.utils.convert import params_from_numpy, score_mlp_from_torch

    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    tree = load_npz(os.path.join(BENCH, "flagship_ckpt.npz"))
    twin = ScoreModel(params_from_numpy(tree["params"], cuda_device), cfg, VESDE(), trace_mode="hutchinson")
    sd = reference_state_dict(tree, "score", cuda_device)
    model = ScoreModel(score_mlp_from_torch(sd, device=cuda_device), cfg, VESDE(), trace_mode="hutchinson")
    x = torch.randn(4096, 2, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    out = []
    for m in (twin, model):
        before = fused_mlp.fused_drift.launches_by_mode["hutchinson"]
        lp, st = m.log_prob(x, generator=torch.Generator().manual_seed(3), atol=1e-5, rtol=1e-5,
                            options={"controller": "pi"})
        assert fused_mlp.fused_drift.launches_by_mode["hutchinson"] - before == st.n_func_evals
        out.append((lp, st.n_func_evals))
    assert out[0][1] == out[1][1] and torch.equal(out[0][0], out[1][0])


@pytest.mark.gpu
def test_device_memory_reads_the_card(cuda_device):
    from flowfusion_torch.utils import profiling

    torch.ones(1024, device=cuda_device)
    mem = profiling.device_memory()
    assert sorted(mem) == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    s = mem["cuda:0"]
    assert {"bytes_in_use", "peak_bytes_in_use", "bytes_limit", "allocated_bytes.all.current"} <= set(s)
    total = torch.cuda.mem_get_info(0)[1]
    assert abs(s["bytes_limit"] - total) <= 0.01 * total and s["peak_bytes_in_use"] > 0
    assert list(profiling.device_memory(cuda_device)) == [f"cuda:{torch.cuda.current_device()}"]
    assert profiling.format_device_memory().startswith("cuda:0: in use")


@pytest.mark.gpu
def test_loader_batch_on_the_card(cuda_device, tmp_path):
    """A native loader batch moved to the card feeds the conditional
    checkpoint's log_prob: finite, launches = NFE."""
    import os

    import numpy as np

    from chip_smoke import BENCH
    from flowfusion_torch.models.population import PopulationModelDiffusion
    from flowfusion_torch.utils.native_loader import NativeBatchLoader, write_f32

    rng = np.random.default_rng(4)
    rows = np.concatenate([rng.standard_normal((20_000, 6)) * 0.5, rng.uniform(-1, 1, (20_000, 3))], axis=1)
    path = str(tmp_path / "rows.f32")
    write_f32(path, rows)
    loader = NativeBatchLoader(path, n_cols=9, batch=4096, seed=5)
    batch = loader.next()
    loader.close()
    on_card = torch.from_numpy(batch).to(cuda_device)
    assert torch.equal(on_card.cpu(), torch.from_numpy(batch))
    model, _ = PopulationModelDiffusion.from_conditional_npz(os.path.join(BENCH, "conditional_ckpt.npz"),
                                                              device=cuda_device)
    before = fused_mlp.fused_drift.launches_by_mode["hutchinson"]
    lp, st = model.log_prob(on_card[:, :6], conditional=on_card[:, 6:], generator=torch.Generator().manual_seed(6))
    assert bool(torch.isfinite(lp).all()) and lp.shape == (4096,)
    assert fused_mlp.fused_drift.launches_by_mode["hutchinson"] - before == st.n_func_evals


# -- the wide plans: tangent chains in groups, highf32 without its planes,
# the sketch's probe columns in groups, any depth --------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "highf32", "bfloat16"])
@pytest.mark.parametrize("D, C, H", [(2, 0, 128), (6, 3, 256)])
def test_rhs_wide_plan_forms_are_bitwise_the_default_plan(cuda_device, D, C, H, compute_dtype):
    """Each mode's launch at its own plan equals, bitwise, the same launch
    forced to each wide form: passes of one, half and all the tangent
    chains, and highf32 without its TF32 planes (alone and with one chain a
    pass); 1,001 ragged rows.  Every wide instantiation keeps no local
    memory."""
    for mode in ("forward", "hutchinson", "exact", "tangents"):
        x_in, e, w_in, b_eff, layers, c0c1, mode, D_, n_tan = _rhs_launch_args(cuda_device, D, C, H, mode)
        n_t = {"forward": 0, "hutchinson": 1, "exact": D, "tangents": n_tan}[mode]
        forced = [dict(group=g) for g in sorted({1, max(1, n_t // 2), n_t}) if n_t]
        if compute_dtype == "highf32":
            forced += [dict(planes=False)] + ([dict(planes=False, group=1)] if n_t else [])
        launch = lambda **kw: fused_mlp._launch(x_in, e, w_in, b_eff, layers, c0c1, mode, D, "silu",  # noqa: E731
                                                 n_tan=n_tan, compute_dtype=compute_dtype, **kw)
        own = launch()
        for kw in forced:
            out = launch(**kw)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, own) if a is not None), (mode, kw)
            plan = fused_mlp._plan(H, mode, D + C, D, n_tan, compute_dtype, **kw)
            occ = fused_mlp.occupancy(plan, compute_dtype)
            assert fused_mlp.plan_wide(plan, compute_dtype) and occ["local_bytes"] == 0, (mode, kw, occ)
            assert occ["blocks_per_sm"] >= 1, (mode, kw, occ)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "highf32", "bfloat16"])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("d,c", [(2, 0), (6, 3), (16, 8)])
def test_sketch_probe_groups_are_bitwise_one_group(cuda_device, d, c, mode, compute_dtype):
    """The sketch launch at its own plan (one group of every probe column)
    equals, bitwise, the same launch with its applications in groups of 1,
    half and all the columns (the wide instantiations; XTrace's late
    matrices then past the probe tile), some exactly parallel Hutch++
    sketch rows and a zero-probe row, 1,001 rows."""
    cfg = ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=(128, 128, 128))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(14), cuda_device)
    k = min(d, 3)
    x, cond, probes = _sketch_case(d, c, mode, 1001, k, cuda_device, 15)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, 0.4, cond)
    x_in = x if cond is None else torch.cat([x, cond], dim=-1)
    n_s, n_g = (k, k) if mode == "hutchpp" else (k, 0)
    kmax = fused_sketch._layout(mode, n_s, n_g)[0]
    c0c1 = torch.tensor([-0.2, 0.8], device=cuda_device)
    plans = [fused_sketch.sketch_plan(mode, 128, 3, d + c, d, n_s, n_g, compute_dtype=compute_dtype, group=g)
             for g in (None, 1, max(1, kmax // 2), kmax)]
    outs = [fused_sketch._launch(x_in, torch.cat(probes), w_in, b_eff, params["layers"], c0c1, mode, d, n_s, n_g,
                                 "silu", plan, fused_sketch.fused_drift_sketch, compute_dtype) for plan in plans]
    torch.cuda.synchronize()
    for plan, out in zip(plans[1:], outs[1:]):
        assert torch.equal(out[0], outs[0][0]) and torch.equal(out[1], outs[0][1]), plan
        occ = fused_sketch.sketch_occupancy(plan, compute_dtype)
        assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "highf32", "bfloat16"])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
@pytest.mark.parametrize("d,c,k", [(2, 0, 2), (16, 8, 3), (64, 0, 36)])
def test_sketch_storage_form_is_bitwise_the_default_plan(cuda_device, d, c, k, mode, compute_dtype):
    """The storage form (the probe tile and XTrace's algebra in a workspace
    in device memory, a persistent grid) forced where the shared-memory
    plan fits: every column an application, one column, and 8 rows, each
    bitwise the launch at its own plan, 1,001 rows; 0 local bytes."""
    cfg = ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=(128, 128, 128))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(18), cuda_device)
    x, cond, probes = _sketch_case(d, c, mode, 1001, k, cuda_device, 19)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, 0.4, cond)
    x_in = x if cond is None else torch.cat([x, cond], dim=-1)
    n_s, n_g = (k, k) if mode == "hutchpp" else (k, 0)
    c0c1 = torch.tensor([-0.2, 0.8], device=cuda_device)
    args = (mode, 128, 3, d + c, d, n_s, n_g)
    plans = [fused_sketch.sketch_plan(*args, compute_dtype=compute_dtype),
             fused_sketch.sketch_plan(*args, compute_dtype=compute_dtype, store=True),
             fused_sketch.sketch_plan(*args, compute_dtype=compute_dtype, store=True, group=1),
             fused_sketch.sketch_plan(*args, compute_dtype=compute_dtype, store=True, group=1, rows=8)]
    assert len(plans[0]) == 4 and all(len(plan) == 5 for plan in plans[1:])
    outs = [fused_sketch._launch(x_in, torch.cat(probes), w_in, b_eff, params["layers"], c0c1, mode, d, n_s, n_g,
                                 "silu", plan, fused_sketch.fused_drift_sketch, compute_dtype) for plan in plans]
    torch.cuda.synchronize()
    for plan, out in zip(plans[1:], outs[1:]):
        assert torch.equal(out[0], outs[0][0]) and torch.equal(out[1], outs[0][1]), plan
    assert fused_sketch.sketch_occupancy(plans[1], compute_dtype)["local_bytes"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "highf32", "bfloat16"])
def test_kernels_at_gap_widths_match_plain_versions(cuda_device, compute_dtype):
    """The JAX gate's widest where the wide plans take over: Hutchinson at
    H = 3,072 (highf32 without its planes), exact at 1,280 with D = 6,
    C = 3 (passes of fewer basis chains, float32 and highf32) and Hutch++
    r = 2, m = 1 at 2,048 (groups of probe columns), on a VP SDE's RHS
    (c0 = -0.3: A = c0 I + c1 J well conditioned for the sketch's QR),
    against their plain versions at the bars above (the sketch's highf32
    drift 5e-5, div 5e-4 of the max), one block of 4 rows an SM; bf16 at
    its mean bar and a 2x guard (10x at H <= 256: past that the fp32 sums
    over H terms move more activations across a bf16 rounding boundary,
    and the sketch's QR carries a flip on; a kernel that skipped a rounding
    point sits at 1x)."""
    g = torch.Generator().manual_seed(16)
    B = 1003
    for D, C, H, mode in ((2, 0, 3072, "hutchinson"), (6, 3, 1280, "exact"), (2, 0, 2048, "hutchpp")):
        cfg = ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(H,) * 3)
        params = init_score_mlp(cfg, torch.Generator().manual_seed(17), cuda_device)
        x = torch.randn(B, D, generator=g).to(cuda_device)
        cond = torch.randn(B, C, generator=g).to(cuda_device) if C else None
        if mode == "hutchpp":
            probes = tuple(torch.sign(torch.randn(n, B, D, generator=g)).to(cuda_device) for n in (2, 1))
            assert fused_sketch.sketch_plan(mode, H, 3, D + C, D, 2, 1, compute_dtype=compute_dtype)[3] > 0
            kw = dict(c0=-0.3, c1=0.9, compute_dtype=compute_dtype)
            out = fused_sketch.fused_drift_sketch(params, cfg, 0.4, x, probes, mode, cond, **kw)
            ref = fused_sketch.fused_drift_sketch_reference(params, cfg, 0.4, x, probes, mode, cond, **kw)
            strict = fused_sketch.fused_drift_sketch_reference(params, cfg, 0.4, x, probes, mode, cond, c0=-0.3,
                                                               c1=0.9)
            bars = {"float32": (1e-5, None), "highf32": (5e-5, 5e-4)}.get(compute_dtype)
        else:
            plan = fused_mlp._plan(H, mode, D + C, D, 0, compute_dtype)
            occ = fused_mlp.occupancy(plan, compute_dtype)
            assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] == fused_mlp.plan_blocks(plan) == 1, occ
            e = torch.sign(torch.randn(B, D, generator=g)).to(cuda_device) if mode == "hutchinson" else None
            kw = dict(e=e, exact_divergence=mode == "exact", c0=-0.2, c1=0.8, compute_dtype=compute_dtype)
            out = fused_mlp.fused_drift(params, cfg, 0.4, x, cond, **kw)
            ref = fused_mlp.fused_drift_reference(params, cfg, 0.4, x, cond, **kw)
            strict = fused_mlp.fused_drift_reference(params, cfg, 0.4, x, cond, **{**kw, "compute_dtype": "float32"})
            bars = {"float32": (1e-5, 1e-4), "highf32": (1e-5, 5e-5)}.get(compute_dtype)
        for i, (a, b, s) in enumerate(zip(out, ref, strict)):
            assert bool(torch.isfinite(a).all())
            if compute_dtype == "bfloat16":
                mean = float((a - b).abs().mean() / b.abs().max())
                assert mean <= 1e-5 and mean <= float((b - s).abs().mean() / b.abs().max()) / 2, (D, H, mode, i)
            elif bars[i] is None:  # the sketch's float32 div: phase 1d's 2e-4 absolute
                assert float((a - b).abs().max()) <= 2e-4, (D, H, mode)
            else:
                assert _rel(a, b) <= bars[i], (D, H, mode, i, _rel(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_deep_net_on_the_card(cuda_device, compute_dtype):
    """A net of 24 hidden widths of 128 (23 hidden layers, past the 16 the
    kernels' parameter struct held; tanh, the hidden weights' init scale
    times sqrt(3), unit gain, so its Jacobian stays O(1)): the RHS kernel's
    Hutchinson launch and the EM kernel over 10 steps of streamed noise
    against their plain versions at the bars above."""
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128,) * 24, activation="tanh")
    params = init_score_mlp(cfg, torch.Generator().manual_seed(18), cuda_device)
    for layer in params["layers"][1:-1]:
        layer["w"] = layer["w"] * 3 ** 0.5
    g = torch.Generator().manual_seed(19)
    x = torch.randn(4096, 2, generator=g).to(cuda_device)
    e = torch.sign(torch.randn(4096, 2, generator=g)).to(cuda_device)
    out = fused_mlp.fused_drift(params, cfg, 0.4, x, e=e, c0=0.0, c1=1.0, compute_dtype=compute_dtype)
    ref = fused_mlp.fused_drift_reference(params, cfg, 0.4, x, e=e, c0=0.0, c1=1.0, compute_dtype=compute_dtype)
    if compute_dtype == "float32":
        assert _rel(out[0], ref[0]) <= 1e-5 and _rel(out[1], ref[1]) <= 1e-4
    else:  # a 2x guard: the flips of the fp32 sum order compound through the depth (9.4x measured)
        strict = fused_mlp.fused_drift_reference(params, cfg, 0.4, x, e=e, c0=0.0, c1=1.0)
        for a, b, s in zip(out, ref, strict):
            mean = float((a - b).abs().mean() / b.abs().max())
            assert mean <= 0.5 * float((b - s).abs().mean() / b.abs().max()), mean
    assert float(out[1].abs().max()) > 1e-2
    z = torch.randn(10, 4096, 2, generator=g).to(cuda_device)
    got = em_sampler.fused_em_sample(params, cfg, VPSDE(), x, noise=z, steps=10, compute_dtype=compute_dtype)
    want = em_sampler.fused_em_sample_reference(params, cfg, VPSDE(), x, z, steps=10, compute_dtype=compute_dtype)
    assert not bool(got[2]) and not bool(want[2])
    if compute_dtype == "float32":
        for a, b in zip(got[:2], want[:2]):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-4)
    else:  # the same 2x guard against float32's plain samples
        strict = em_sampler.fused_em_sample_reference(params, cfg, VPSDE(), x, z, steps=10)
        for a, b, s in zip(got[:2], want[:2], strict[:2]):
            assert float((a - b).abs().mean()) <= 0.5 * float((b - s).abs().mean())
