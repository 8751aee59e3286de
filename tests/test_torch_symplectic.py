"""The symplectic flow family of the port (the separable-Hamiltonian net,
``fused_symplectic_velocity`` and ``SymplecticFlowModel``) against the JAX
package, on the CPU.

* The q and p halves and the joint field within 1e-6 (C = 0 and 3), and the
  checkpoint loader leaf for leaf against the JAX loader.
* ``fused_symplectic_velocity``'s plain version (CPU tensors) against the
  JAX Pallas kernel in interpret mode at B = 70 (its ragged tile), within
  the JAX test's bar (tests/test_kernels.py:711, atol 2e-5).
* ``log_prob`` on ``benchmarks/symplectic_ckpt.npz`` with the same momentum
  draw: equal solver counts and mean |dlogp| <= 1e-4 at 1e-5, and with
  K = 3 draws; the float64 oracle gate of tests/test_checkpoint_quality.py
  (64 rows at 1e-7: mean <= 1.2e-4, max <= 6e-4, NFE <= 220).
* ``sample`` by Euler (1 and 4 steps) and leapfrog from the same base
  within 1e-5 of the samples' scale.
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
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.kernels import fused_mlp
from flowfusion_torch.models import nets
from flowfusion_torch.models.symplectic import SymplecticFlowModel
from flowfusion_torch.utils import convert

torch.set_num_threads(1)

SYM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "symplectic_ckpt.npz")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _stats(st):
    return tuple(int(v) for v in st[:3])


@pytest.fixture(scope="module")
def sym_pair():
    from benchmarks.make_flow_symplectic_ckpts import load_symplectic_model

    jm = dataclasses.replace(load_symplectic_model()[0], use_fused_kernel=False)
    tm, extra = SymplecticFlowModel.from_npz(SYM, device="cpu")
    assert extra["family"] == "symplectic"
    return jm, tm


def _random_pair(C, units=(48, 48)):
    jcfg = jnets.SymplecticMLPConfig(n_data_dims=2, n_conditionals=C, units=units)
    jparams = jnets.init_symplectic_mlp(jax.random.PRNGKey(C), jcfg)
    cfg = nets.SymplecticMLPConfig(n_data_dims=2, n_conditionals=C, units=units)
    return jcfg, jparams, cfg, convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("C", [0, 3])
def test_symplectic_net_matches_jax(C):
    jcfg, jparams, cfg, params = _random_pair(C)
    rng = np.random.default_rng(C)
    state = rng.standard_normal((64, 4)).astype(np.float32)
    cond = rng.standard_normal((64, C)).astype(np.float32) if C else None
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else torch.as_tensor(cond)
    for t in (0.0, 0.43, 1.0):
        jt, tt = jnp.float32(t), torch.tensor(t)
        s, js = torch.as_tensor(state), jnp.asarray(state)
        assert _rel(nets.apply_symplectic_mlp(cfg, params, tt, s, tc), jnets.apply_symplectic_mlp(jcfg, jparams, jt, js, jc)) <= 1e-6
        q, p = s[:, :2], s[:, 2:]
        assert _rel(nets.apply_symplectic_q_velocity(cfg, params, tt, p, tc),
                    jnets.apply_symplectic_q_velocity(jcfg, jparams, jt, js[:, 2:], jc)) <= 1e-6
        assert _rel(nets.apply_symplectic_p_velocity(cfg, params, tt, q, tc),
                    jnets.apply_symplectic_p_velocity(jcfg, jparams, jt, js[:, :2], jc)) <= 1e-6
    fresh = nets.init_symplectic_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(fresh) == ["W", "p_layers", "q_layers"]
    assert fresh["q_layers"][0]["w"].shape == (2 + C + 8, 48) and fresh["W"].shape == (4,)


def test_loader_matches_jax_leaf_for_leaf(sym_pair):
    jm, tm = sym_pair
    assert tm.net == nets.SymplecticMLPConfig(n_data_dims=2, units=(128, 128))
    jleaves = jax.tree_util.tree_leaves_with_path(
        {"params": jm.params, "shift": jm.shift, "scale": jm.scale})
    tleaves = {"params": tm.params, "shift": tm.shift, "scale": tm.scale}
    assert len(jleaves) == 15
    for path, leaf in jleaves:
        node = tleaves
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tm.conditional_shift is None and tm.conditional_scale is None


@pytest.mark.parametrize("C,units", [(0, (128, 128)), (3, (128, 128)), (0, (60, 100))])
def test_fused_symplectic_velocity_matches_jax_kernel(C, units):
    """The plain version (CPU tensors) against the Pallas kernel in
    interpret mode; odd widths pad (to 100 here, to 128 in JAX): both exact."""
    jcfg, jparams, cfg, params = _random_pair(C, units)
    rng = np.random.default_rng(7)
    B = 70
    state = rng.standard_normal((B, 4)).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32) if C else None
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else torch.as_tensor(cond)
    ref = jfm.fused_symplectic_velocity(jparams, jcfg, jnp.float32(0.43), jnp.asarray(state), jc,
                                        tile=64, interpret=True)
    before = fused_mlp.fused_symplectic_velocity.launches
    out = fused_mlp.fused_symplectic_velocity(params, cfg, torch.tensor(0.43), torch.as_tensor(state), tc)
    assert fused_mlp.fused_symplectic_velocity.launches == before  # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    padded, pcfg = fused_mlp.pad_to_lanes(params, cfg)
    if units == (60, 100):
        assert pcfg.units == (100, 100) and padded["p_layers"][1]["w"].shape == (100, 100)
    torch.testing.assert_close(
        fused_mlp.fused_symplectic_velocity_reference(padded, pcfg, 0.43, torch.as_tensor(state), tc),
        out, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="state of shape"):
        fused_mlp.fused_symplectic_velocity(params, cfg, 0.43, torch.zeros(4, 3), tc)


@pytest.mark.parametrize("K", [1, 3])
def test_log_prob_matches_jax(sym_pair, K):
    jm, tm = sym_pair
    x = (np.random.default_rng(8).standard_normal((256, 2)) * 1.5).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jlp, jst = jax.jit(lambda m, xx: m.log_prob(key, xx, n_momentum_samples=K))(jm, jnp.asarray(x))
    p0 = torch.as_tensor(np.asarray(jax.random.normal(key, (K * 256, 2), jnp.float32)))
    lp, st = tm.log_prob(torch.as_tensor(x), momentum=p0, n_momentum_samples=K)
    assert _stats(st) == _stats(jst)
    err = np.abs(lp.numpy() - np.asarray(jlp))
    assert err.mean() <= 1e-4, (err.mean(), err.max())
    # use_fused_kernel=True on CPU tensors runs the wrapper's plain version
    lp_f, st_f = dataclasses.replace(tm, use_fused_kernel=True).log_prob(
        torch.as_tensor(x), momentum=p0, n_momentum_samples=K)
    assert _stats(st_f) == _stats(st) and float((lp_f - lp).abs().max()) <= 1e-6
    lp_g, _ = tm.log_prob(torch.as_tensor(x[:8]), generator=torch.Generator().manual_seed(0),
                          n_momentum_samples=K)
    assert lp_g.shape == (8,) and torch.isfinite(lp_g).all()


def test_log_prob_float64_oracle_gate(sym_pair):
    """tests/test_checkpoint_quality.py's gate, run on the port: the 1e-7
    PI solve tracks the matched-momentum float64 oracle."""
    from oracles import numpy_dopri5, std_normal_logprob_f64, symplectic_rhs_f64
    from flowfusion_tpu.utils.data import DEMO_GMM

    jm, tm = sym_pair
    x = np.asarray(DEMO_GMM.sample(jax.random.PRNGKey(400), 64), np.float32)
    k_lp = jax.random.PRNGKey(80)
    q0 = (x.astype(np.float64) - np.asarray(jm.shift)) / np.asarray(jm.scale)
    p0 = np.asarray(jax.random.normal(k_lp, q0.shape, jnp.float32))
    B, D = q0.shape
    rhs = symplectic_rhs_f64(jm.params)(D)
    ys, _ = numpy_dopri5(rhs, np.concatenate([q0, p0.astype(np.float64)], axis=1).ravel(), [0.0, 1.0], 1e-9, 1e-9)
    z1 = ys[-1].reshape(B, 2 * D)
    truth = (std_normal_logprob_f64(z1) - std_normal_logprob_f64(p0.astype(np.float64))
             - np.sum(np.log(np.asarray(jm.scale, np.float64))))
    lp, st = tm.log_prob(torch.as_tensor(x), momentum=torch.as_tensor(p0), atol=1e-7, rtol=1e-7,
                         options={"controller": "pi"})
    err = np.abs(lp.numpy().astype(np.float64) - truth)
    assert err.mean() <= 1.2e-4, err.mean()
    assert err.max() <= 6e-4, err.max()
    assert st.n_func_evals <= 220


@pytest.mark.parametrize("method,steps", [("euler", 1), ("euler", 4), ("leapfrog", 3)])
def test_sample_matches_jax(sym_pair, method, steps):
    jm, tm = sym_pair
    base = np.random.default_rng(10).standard_normal((128, 4)).astype(np.float32)
    js = jm.sample(jax.random.PRNGKey(0), (128, 2), num_steps=steps, method=method, base=jnp.asarray(base))
    s = tm.sample((128, 2), num_steps=steps, method=method, base=torch.as_tensor(base))
    assert s.shape == (128, 2)
    assert _rel(s.numpy(), js) <= 1e-5
    # use_fused_kernel=True on CPU tensors: the wrapper's plain version
    sf = dataclasses.replace(tm, use_fused_kernel=True).sample(
        (128, 2), num_steps=steps, method=method, base=torch.as_tensor(base))
    torch.testing.assert_close(sf, s, rtol=0, atol=1e-6)


def test_create_refusals_and_dispatch(sym_pair):
    _, tm = sym_pair
    m = SymplecticFlowModel.create(n_data_dims=2, n_conditionals=1, units=(16,), conditional_shift=[1.0],
                                   conditional_scale=[2.0], generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    c = torch.ones(6, 1)
    s = m.sample((6, 2), conditional=c, generator=torch.Generator().manual_seed(1))
    lp, st = m.log_prob(s, conditional=c, generator=torch.Generator().manual_seed(2))
    assert s.shape == (6, 2) and torch.isfinite(lp).all() and st.succeeded
    x = torch.zeros(4, 2)
    # training is ported: the joint flow-matching loss is finite
    assert torch.isfinite(tm.loss_fn(torch.Generator().manual_seed(0), x))
    # highf32 and bfloat16 are ported; an unknown compute mode raises
    assert dataclasses.replace(tm, kernel_compute_dtype="highf32").kernel_compute_dtype == "highf32"
    assert dataclasses.replace(tm, kernel_compute_dtype="bfloat16").kernel_compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="unknown"):
        dataclasses.replace(tm, kernel_compute_dtype="float16")
    # the solvers of item 13 run: the adjoint log_prob equals the plain
    # one, and per-sample stepping agrees within the solve's tolerance
    p0 = torch.randn(4, 2, generator=torch.Generator().manual_seed(3))
    xr = torch.randn(4, 2, generator=torch.Generator().manual_seed(4))
    lp, _ = tm.log_prob(xr, momentum=p0)
    lp_a, st = tm.log_prob(xr, momentum=p0, adjoint=True)
    assert st is None and float((lp_a - lp).abs().max()) <= 1e-5
    lp_ps, st_ps = tm.log_prob_per_sample(xr, momentum=p0)
    assert st_ps.n_func_evals.shape == (4,) and float((lp_ps - lp).abs().max()) <= 1e-2
    with pytest.raises(ValueError, match="num_steps"):
        tm.sample((4, 2), num_steps=0)
    with pytest.raises(ValueError, match="n_momentum_samples"):
        tm.log_prob(x, n_momentum_samples=0)
    with pytest.raises(ValueError, match="momentum of shape"):
        tm.log_prob(x, momentum=torch.zeros(3, 2))
    with pytest.raises(ValueError, match="parameters are on"):
        tm.sample((4, 2), base=torch.zeros(4, 4, device="meta"))
    # auto dispatch on a CUDA tensor takes the kernel (a stand-in plays it)
    on_card = type("OnCard", (), {"is_cuda": True})()
    solve = tm._solve_dynamics(None, on_card)
    assert solve.__code__.co_names.count("fused_symplectic_velocity") == 1
    assert "fused_symplectic_velocity" not in tm._solve_dynamics(None, x).__code__.co_names
