"""The training kernel's compute modes ``highf32`` and ``bfloat16``, on the CPU.

On CPU tensors ``fused_train_epoch`` and ``fused_train_epoch_symplectic``
run their plain versions in the mode: the JAX kernel's explicit forward and
backward chain (``fused_train._chain_grads``) with every layer product
through ``fused_mlp.tf32x3_matmul`` (``highf32``) or ``bf16_matmul``
(``bfloat16``) and the tanh-form SiLU.  Here they are held against the JAX
package's Pallas kernel itself in interpret mode, which runs both modes on
this CPU (jax 0.9.0; the RHS kernel's ``bfloat16`` does not), on the same
tables made from a numpy seed, at H = 128 (the JAX kernel's narrowest
width).

What is compared, each relative to the largest magnitude of its own
float32 result:

* the first Adam moment after one step, m = (1 - b1) g: the gradient;
* the per-step losses;
* the weights' updates after 4 steps at eps = 1, where Adam's step is close
  to linear in the gradient (at eps = 1e-8 a gradient near zero flips the
  sign of a weight's step in any mode).

Bars.  ``highf32``: each package's first moment within its bar of its own
float32 result (the port 1e-5; the JAX kernel 2e-5, measured 1.02e-5) and
the losses within rtol 1e-5; the two packages' within the sum of those
bars.  The modes differ: the port splits into TF32 halves (22 bits), the
JAX kernel into bf16 halves (16 bits), so the JAX result is the farther
from float32.  Updates at eps = 1 within 1e-4 of the largest update (one
float32 ulp of a weight is 1.2e-5 of it).  ``bfloat16``: the port against
the JAX kernel,
mean |d| at most a tenth of the JAX kernel's own mean distance from its
float32 result (the 10x guard: the two round at the same points and differ
in the order of the fp32 sums alone), max |d| <= 3e-2; the same against a
numpy spec of ``_make_dots``' rounding points (both operands of every
product rounded to bf16, exact products, sums in float64), so that a change
in how XLA's CPU runtime treats bf16 cannot weaken the check unseen; the
losses within rtol 3e-5 and closer than the mode is to float32.  Where the
two packages differ in float32 already (the EMA's operations run in other
orders), each bar adds to that float32 floor.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from flowfusion_tpu.kernels import fused_train as jft
from flowfusion_tpu.models import nets as jnets
from flowfusion_torch.kernels import fused_train as ft
from flowfusion_torch.models import nets
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

MODES = ("highf32", "bfloat16")
LR = 1e-3


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# (JAX config, port config, tables' D and C, symplectic, keywords of the call)
CASES = {
    "score": (jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128)),
              nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128)), 2, 0, False, {}),
    "score_conditional": (jnets.ScoreMLPConfig(n_dimensions=2, n_conditionals=3, units=(128, 128)),
                          nets.ScoreMLPConfig(n_dimensions=2, n_conditionals=3, units=(128, 128)), 2, 3, False, {}),
    "velocity_mean_over_dims": (jnets.VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128)),
                                nets.VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128)), 2, 0, False,
                                {"mean_over_dims": True}),
    "tanh": (jnets.ScoreMLPConfig(n_dimensions=3, units=(128,), activation="tanh"),
             nets.ScoreMLPConfig(n_dimensions=3, units=(128,), activation="tanh"), 3, 0, False, {}),
    "symplectic": (jnets.SymplecticMLPConfig(n_data_dims=2, units=(128,)),
                   nets.SymplecticMLPConfig(n_data_dims=2, units=(128,)), 2, 0, True, {}),
}


def _init(jcfg, key=0):
    init = {jnets.ScoreMLPConfig: jnets.init_score_mlp, jnets.VelocityMLPConfig: jnets.init_velocity_mlp,
            jnets.SymplecticMLPConfig: jnets.init_symplectic_mlp}[type(jcfg)]
    return init(jax.random.PRNGKey(key), jcfg)


def _tables(steps, bs, D, C, symplectic, seed=1):
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


def _flat_params(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel() for k in ("layers", "q_layers", "p_layers")
                           if k in tree for lyr in tree[k] for a in (lyr["w"], lyr["b"])])


def _flat_moment(opt, sympl, jax_layout):
    """The first moment of an optimizer state (a symplectic pair's two),
    flat in the port's layout: the JAX kernel keeps (O, K) / (O, 1)."""
    opts = opt if sympl else (opt,)
    flat = []
    for m, _, _ in opts:
        for a in m:
            a = np.asarray(a, np.float64)
            flat.append((a.T if a.shape[-1] != 1 else a[:, 0]) if jax_layout else a)
    return np.concatenate([a.ravel() for a in flat])


def _run(case, mode, steps, eps=1e-8, bs=32):
    """Both packages' ``(first moment, losses, params before, params
    after)`` of one call on the same tables."""
    jcfg, tcfg, D, C, sympl, kw = CASES[case]
    jp = _init(jcfg)
    tab = _tables(steps, bs, D, C, sympl)
    common = dict(lr=LR, eps=eps, compute_dtype=mode, **kw)
    jfn = jft.fused_train_epoch_symplectic if sympl else jft.fused_train_epoch
    tfn = ft.fused_train_epoch_symplectic if sympl else ft.fused_train_epoch
    j = jfn(jp, jcfg, None, interpret=True, **common, **tab)
    tp = to_torch(jp)
    t = tfn(tp, tcfg, None, **common, **{k: None if v is None else torch.as_tensor(v) for k, v in tab.items()})
    before = _flat_params(jp)
    return {
        "jax": (_flat_moment(j[1], sympl, True), np.asarray(j[3], np.float64), before, _flat_params(j[0])),
        "port": (_flat_moment(t[1], sympl, False), t[3].double().numpy(), before, _flat_params(t[0])),
    }


def _rel_max(a, b, scale):
    return float(np.abs(a - b).max() / np.abs(scale).max())


def _rel_mean(a, b, scale):
    return float(np.abs(a - b).mean() / np.abs(scale).max())


@functools.lru_cache(maxsize=None)
def _cached_run(case, mode, steps, eps=1e-8):
    return _run(case, mode, steps, eps)


# ---------------------------------------------------------------------------
# both modes against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

# highf32: the port's first moment sits within 6.4e-7 of its float32 result
# on these cases, the JAX kernel's within 1.02e-5 (score_conditional; its
# bf16 halves keep 16 bits): the JAX side's bar is 2e-5.  Updates at eps = 1
# after 4 steps: 1.2e-5 of the largest update is one float32 ulp of a weight
# (the update is the difference of two weights), the JAX kernel's split adds
# to 4.5e-5 (symplectic): bar 1e-4 for every pair.
_HF_M_BAR = {"port": 1e-5, "jax": 2e-5}
_HF_UPDATE_BAR = 1e-4
# bfloat16 losses, port against the JAX kernel: rtol 3e-5 (measured up to
# 9.4e-6, tanh over 4 steps, where a flip of a rounded activation moves the
# residual), and closer than the mode is to float32.
_BF_LOSS_BAR = 3e-5


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_first_moment_and_loss_match_the_jax_kernel(case, mode):
    """One step from fresh Adam state: the first moment is (1 - b1) g."""
    f32, r = _cached_run(case, "float32", 1), _cached_run(case, mode, 1)
    scale = {pkg: f32[pkg][0] for pkg in ("jax", "port")}
    own = {pkg: (_rel_max(r[pkg][0], f32[pkg][0], scale[pkg]), _rel_mean(r[pkg][0], f32[pkg][0], scale[pkg]))
           for pkg in ("jax", "port")}
    across = (_rel_max(r["port"][0], r["jax"][0], scale["jax"]), _rel_mean(r["port"][0], r["jax"][0], scale["jax"]))
    loss_own = {pkg: float(np.abs(r[pkg][1] / f32[pkg][1] - 1).max()) for pkg in ("jax", "port")}
    loss_across = float(np.abs(r["port"][1] / r["jax"][1] - 1).max())
    if mode == "highf32":
        for pkg in ("jax", "port"):
            assert own[pkg][0] <= _HF_M_BAR[pkg], (pkg, own[pkg])
            assert loss_own[pkg] <= 1e-5, (pkg, loss_own[pkg])
        assert across[0] <= sum(_HF_M_BAR.values()) and loss_across <= 2e-5, (across, loss_across)
    else:
        # the mode is on in both packages, at its accuracy class
        assert 1e-6 <= own["jax"][1] and own["jax"][0] <= 3e-2 and own["port"][0] <= 3e-2, own
        assert across[1] <= 0.1 * own["jax"][1] and across[0] <= 3e-2, (across, own)
        assert loss_across <= min(_BF_LOSS_BAR, loss_own["jax"]), (loss_across, loss_own)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_updates_at_eps_one_match_the_jax_kernel(case, mode):
    """4 steps at eps = 1: the per-step losses and each weight's update."""
    f32, r = _cached_run(case, "float32", 4, 1.0), _cached_run(case, mode, 4, 1.0)
    upd = {pkg: {m: res[pkg][3] - res[pkg][2] for m, res in (("f32", f32), ("mode", r))} for pkg in ("jax", "port")}
    scale = upd["jax"]["f32"]
    own = {pkg: (_rel_max(upd[pkg]["mode"], upd[pkg]["f32"], scale), _rel_mean(upd[pkg]["mode"], upd[pkg]["f32"], scale))
           for pkg in ("jax", "port")}
    across = (_rel_max(upd["port"]["mode"], upd["jax"]["mode"], scale),
              _rel_mean(upd["port"]["mode"], upd["jax"]["mode"], scale))
    loss_own = {pkg: float(np.abs(r[pkg][1] / f32[pkg][1] - 1).max()) for pkg in ("jax", "port")}
    loss_across = float(np.abs(r["port"][1] / r["jax"][1] - 1).max())
    if mode == "highf32":
        assert max(own["jax"][0], own["port"][0], across[0]) <= _HF_UPDATE_BAR, (own, across)
        assert max(loss_own.values()) <= 1e-5 and loss_across <= 2e-5, (loss_own, loss_across)
    else:
        assert across[1] <= 0.1 * own["jax"][1] and across[0] <= 3e-2, (across, own)
        assert loss_across <= min(_BF_LOSS_BAR, loss_own["jax"]), (loss_across, loss_own)


@pytest.mark.parametrize("mode", MODES)
def test_chained_calls_with_ema_match_the_jax_kernel(mode):
    """Two chained calls of 2 steps with the EMA on (the step0 carry and the
    EMA of the previous call), at eps = 1: losses, first moment, weights'
    and EMA's moves against float32's, each package and across, relative to
    the largest of the weights' moves."""
    jcfg, tcfg, D, C, _, _ = CASES["score"]
    jp = _init(jcfg)
    tab = _tables(4, 32, D, C, False, seed=4)
    halves = [{k: None if v is None else v[sl] for k, v in tab.items()} for sl in (slice(0, 2), slice(2, 4))]
    out = {}
    for dt in ("float32", mode):
        kw = dict(lr=LR, eps=1.0, ema_decay=0.9, compute_dtype=dt)
        j1 = jft.fused_train_epoch(jp, jcfg, None, ema=jp, interpret=True, **kw, **halves[0])
        j2 = jft.fused_train_epoch(j1[0], jcfg, j1[1], ema=j1[2], interpret=True, **kw, **halves[1])
        th = [{k: None if v is None else torch.as_tensor(v) for k, v in h.items()} for h in halves]
        t1 = ft.fused_train_epoch(to_torch(jp), tcfg, None, **kw, **th[0])
        t2 = ft.fused_train_epoch(t1[0], tcfg, t1[1], ema=t1[2], **kw, **th[1])
        before = _flat_params(jp)
        for pkg, (a, b) in (("jax", (j1, j2)), ("port", (t1, t2))):
            out[pkg, dt] = dict(loss=np.concatenate([np.asarray(a[3], np.float64), np.asarray(b[3], np.float64)]),
                                m=_flat_moment(b[1], False, pkg == "jax"), p=_flat_params(b[0]) - before,
                                ema=_flat_params(b[2]) - before)
        assert t2[1][2] == j2[1][2] == 4
    for key in ("m", "p", "ema"):
        # the EMA moves a tenth of the weights' step: both against the step,
        # whose float32 ulps set the floor.  The packages' EMAs differ in
        # float32 already (2.5e-6 in the mean, 8.4e-5 at most: the order of
        # the EMA's fp32 operations), so each mode's bar adds to that floor.
        scale = out["jax", "float32"]["m" if key == "m" else "p"]
        floor = (_rel_max(out["port", "float32"][key], out["jax", "float32"][key], scale),
                 _rel_mean(out["port", "float32"][key], out["jax", "float32"][key], scale))
        own = _rel_max(out["port", mode][key], out["port", "float32"][key], scale)
        own_mean = _rel_mean(out["jax", mode][key], out["jax", "float32"][key], scale)
        across = (_rel_max(out["port", mode][key], out["jax", mode][key], scale),
                  _rel_mean(out["port", mode][key], out["jax", mode][key], scale))
        if mode == "highf32":
            bar = sum(_HF_M_BAR.values()) if key == "m" else _HF_UPDATE_BAR
            assert own <= bar and across[0] <= floor[0] + bar, (key, own, across, floor)
        else:
            assert across[1] <= floor[1] + 0.1 * own_mean and across[0] <= 3e-2, (key, across, floor, own_mean)
    loss_own = float(np.abs(out["jax", mode]["loss"] / out["jax", "float32"]["loss"] - 1).max())
    loss_across = float(np.abs(out["port", mode]["loss"] / out["jax", mode]["loss"] - 1).max())
    assert loss_across <= (2e-5 if mode == "highf32" else min(_BF_LOSS_BAR, loss_own)), (loss_across, loss_own)


# ---------------------------------------------------------------------------
# bfloat16 against a numpy spec of the JAX kernel's rounding points
# ---------------------------------------------------------------------------


def _bf16(a):
    """float32 -> bf16 (round to nearest, ties to even) -> float32, on the
    bits (finite values)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _spec_mm(a, b):
    """``_make_dots``' products in bfloat16: both operands cast to bf16,
    the products exact, here summed in float64."""
    return (_bf16(a).astype(np.float64) @ _bf16(b).astype(np.float64)).astype(np.float32)


def _spec_pair(a, activation):
    """``_act_pair_fn`` with the throughput modes' tanh-form sigmoid."""
    if activation == "silu":
        s = 0.5 + 0.5 * np.tanh(0.5 * a)
        return a * s, s * (1.0 + a * (1.0 - s))
    h = np.tanh(a)  # tanh
    return h, 1.0 - h * h


def _spec_first_moment(jp, jcfg, tab, mean_over_dims):
    """The first moment after one step of the JAX kernel's ``_kernel``
    (kernels/fused_train.py:285-330) in bfloat16, in numpy: u = [temb | x |
    cond] or [x | t | cond], the forward keeping h and act', r = zw + beta
    net, delta = 2 inv beta r, dW = mm_lane(delta, h), db = sum delta
    (unrounded), delta <- mm_tw(W, delta) act'; m = (1 - b1) g."""
    xt, zw, t, beta = (tab[k][0] for k in ("xt", "zw", "t", "beta"))
    cond = [] if tab["conditional"] is None else [tab["conditional"][0]]
    if isinstance(jcfg, jnets.ScoreMLPConfig):
        proj = np.float32(2.0 * np.pi) * np.asarray(jp["W"], np.float32)[None, :] * t[:, None]
        u = np.concatenate([np.sin(proj), np.cos(proj), xt] + cond, axis=1).astype(np.float32)
        activation = jcfg.activation
    else:
        u = np.concatenate([xt, t[:, None]] + cond, axis=1)
        activation = jcfg.activation
    layers = [(np.asarray(l["w"], np.float32), np.asarray(l["b"], np.float32)) for l in jp["layers"]]
    bs, D = xt.shape
    inv = np.float32(1.0 / (bs * D) if mean_over_dims else 1.0 / bs)
    hs, dhs = [u], []
    a = _spec_mm(u, layers[0][0]) + layers[0][1]
    for w, b in layers[1:]:
        h, dh = _spec_pair(a, activation)
        hs.append(h)
        dhs.append(dh)
        a = _spec_mm(h, w) + b
    r = zw + beta[:, None] * a
    delta = (np.float32(2.0) * inv) * beta[:, None] * r
    grads = [None] * (2 * len(layers))
    for l in range(len(layers) - 1, -1, -1):
        grads[2 * l] = _spec_mm(hs[l].T, delta)
        grads[2 * l + 1] = delta.astype(np.float64).sum(axis=0)
        if l > 0:
            delta = _spec_mm(delta, layers[l][0].T) * dhs[l - 1]
    return np.concatenate([(0.1 * np.asarray(g, np.float64)).ravel() for g in grads])


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][4]])
def test_bfloat16_first_moment_matches_the_numpy_spec(case):
    """The port's plain version and the JAX kernel against the spec: the
    10x guard on the mean against the spec's own distance from float32,
    max 3e-2."""
    jcfg, _, D, C, _, kw = CASES[case]
    spec = _spec_first_moment(_init(jcfg), jcfg, _tables(1, 32, D, C, False), kw.get("mean_over_dims", False))
    f32, r = _cached_run(case, "float32", 1), _cached_run(case, "bfloat16", 1)
    scale = f32["jax"][0]
    spread = _rel_mean(spec, scale, scale)
    assert spread >= 1e-6, spread  # the spec rounds
    for pkg in ("port", "jax"):
        assert _rel_mean(r[pkg][0], spec, scale) <= 0.1 * spread and _rel_max(r[pkg][0], spec, scale) <= 3e-2, pkg


# ---------------------------------------------------------------------------
# the plain versions' chain, guards, counts
# ---------------------------------------------------------------------------


def _exact_pair(activation):
    def pair(a):
        if activation == "silu":
            s = torch.sigmoid(a)
            return a * s, s * (1.0 + a * (1.0 - s))
        h = torch.tanh(a)
        return h, 1.0 - h * h
    return pair


@pytest.mark.parametrize("cfg", [nets.ScoreMLPConfig(n_dimensions=2, n_conditionals=3, units=(24, 24)),
                                 nets.VelocityMLPConfig(target_dimension=3, hidden_units=(16, 16, 16)),
                                 nets.ScoreMLPConfig(n_dimensions=3, units=(20,), activation="tanh")],
                         ids=["score_conditional", "velocity", "tanh"])
def test_explicit_chain_is_the_gradient_of_the_table_loss(cfg):
    """The modes' explicit forward and backward chain, with strict fp32
    products and the exact act pair, is autograd's gradient of the table
    loss (the float32 plain version's): the chain's algebra alone."""
    init = nets.init_score_mlp if isinstance(cfg, nets.ScoreMLPConfig) else nets.init_velocity_mlp
    params = init(cfg, torch.Generator().manual_seed(0), "cpu")
    D, C = (cfg.n_dimensions, cfg.n_conditionals) if isinstance(cfg, nets.ScoreMLPConfig) else (
        cfg.target_dimension, cfg.conditional_dimension)
    tab = {k: None if v is None else torch.as_tensor(v[0]) for k, v in _tables(1, 16, D, C, False, seed=9).items()}
    leaves = [a.clone().requires_grad_(True) for l in params["layers"] for a in (l["w"], l["b"])]
    p = dict(params, layers=ft._as_layers(zip(leaves[0::2], leaves[1::2])))
    apply = nets.apply_score_mlp if isinstance(cfg, nets.ScoreMLPConfig) else nets.apply_velocity_mlp
    r = tab["zw"] + tab["beta"][:, None] * apply(cfg, p, tab["t"], tab["xt"], tab["conditional"])
    want = torch.autograd.grad(torch.sum(r * r) / 16, leaves)
    u = ft._net_input(cfg, params, tab["t"], tab["xt"], tab["conditional"])
    loss, got = ft._chain_grads(params["layers"], u, tab["zw"], tab["beta"], 1 / 16, lambda a, b: a @ b,
                                _exact_pair(cfg.activation))
    torch.testing.assert_close(loss, torch.sum(r * r).detach() / 16, rtol=1e-6, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_modes_keep_float32_state(mode):
    """Every mode stores float32 state and refuses a bf16 leaf, as the JAX
    kernel does (the JAX package's tests/test_fused_train.py:334); the plain
    version on CPU tensors launches nothing."""
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(32,))
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    tab = {k: None if v is None else torch.as_tensor(v) for k, v in _tables(2, 8, 2, 0, False).items()}
    ft.reset_launch_counts()
    p2, (m, v, step), _, losses = ft.fused_train_epoch(params, cfg, lr=LR, compute_dtype=mode, **tab)
    assert step == 2 and losses.dtype == torch.float32 and bool(torch.isfinite(losses).all())
    assert all(a.dtype == torch.float32 for a in (*m, *v, *(x for l in p2["layers"] for x in l.values())))
    assert ft.fused_train_epoch.launches == 0 and ft.fused_train_epoch.launches_by_dtype[mode] == 0
    bf_leaf = dict(params, layers=[dict(params["layers"][0], w=params["layers"][0]["w"].bfloat16())]
                   + params["layers"][1:])
    with pytest.raises(ValueError, match="float32 state"):
        ft.fused_train_epoch(bf_leaf, cfg, lr=LR, compute_dtype=mode, **tab)


def test_train_flops_by_unit():
    """The modes' bound splits :func:`train_flops`: the flagship's hidden
    products on the tensor cores, its input (K = 10) and output (D = 2)
    layers on the CUDA cores (the input layer's forward product and weight
    gradient, no delta product through it), three passes of them in
    highf32."""
    flag = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    assert ft.train_flops_by_unit(flag, 1, 1, "bfloat16") == (196_608, 6_656)
    assert ft.train_flops_by_unit(flag, 1, 1, "highf32") == (196_608, 19_968)
    for cfg in (flag, nets.VelocityMLPConfig(target_dimension=2, conditional_dimension=3, hidden_units=(100, 100))):
        tc, cc = ft.train_flops_by_unit(cfg, 48, 512, "bfloat16")
        assert tc + cc == ft.train_flops(cfg, 48, 512)
    with pytest.raises(ValueError, match="highf32"):
        ft.train_flops_by_unit(flag, 1, 1, "float32")

