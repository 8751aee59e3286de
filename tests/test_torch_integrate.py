"""flowfusion_torch's adaptive solvers against the JAX solver and the
torch oracle ``tests/torchdiffeq_shim.py``: dopri5, then every other
tableau (tsit5, bosh3, fehlberg2, adaptive_heun, dop853) on the analytic
field and on the flagship net.

Against JAX: the same step sequence (equal n_func_evals, n_accepted and
n_rejected) and outputs within 1e-6 relative — both solvers keep time and
controller scalars in float32 and take the same decisions.  Against the
torchdiffeq-convention shim (float64, steps clipped onto output times
instead of dense output): agreement to within the requested tolerance.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.integrate.adaptive import odeint_adaptive as jodeint
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.models.nets import ScoreMLPConfig
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.integrate.tableaus import get_adaptive_tableau
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.utils import convert
from flowfusion_torch.utils.checkpoint import load_npz
from flowfusion_torch.ops.integrate import odeint
from flowfusion_torch.ops.integrate.adaptive import _mixed_rms_norm, odeint_adaptive

import torchdiffeq_shim

torch.set_num_threads(1)


def _jax_rhs(t, y):
    a, b = y
    return (-a * b[:, None] + jnp.sin(3.0 * t), jnp.sum(a * a, axis=1) - 0.5 * b)


def _torch_rhs(t, y):
    a, b = y
    return (-a * b[:, None] + torch.sin(3.0 * t), torch.sum(a * a, dim=1) - 0.5 * b)


def _y0():
    rng = np.random.default_rng(0)
    return rng.standard_normal((16, 3)).astype(np.float32), rng.uniform(0.5, 1.5, 16).astype(np.float32)


# min_step / max_step keep every step truncation-dominated: an error ratio
# at the float32 rounding level (a tiny first step) would let rounding pick
# the next step size, and two independent float32 solvers would drift apart
# by O(rtol) while taking equally many steps.
CASES = {
    "i_decreasing_min_step": ([1.0, 0.3, 0.0], {"min_step": 0.05}),
    "i_decreasing_min_step_fine": ([1.0, 0.3, 0.0], {"min_step": 0.02}),
    "pi_beta_min_step": ([0.0, 1.0], {"controller": "pi", "beta": 0.08, "min_step": 0.05}),
    "pi_decreasing_max_step": ([1.0, 0.0], {"controller": "pi", "max_step": 0.1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dopri5_matches_jax(case):
    ts, opts = CASES[case]
    a, b = _y0()
    jys, jst = jodeint(_jax_rhs, (jnp.asarray(a), jnp.asarray(b)), ts, rtol=1e-5, atol=1e-6, options=opts)
    ys, st = odeint(_torch_rhs, (torch.as_tensor(a), torch.as_tensor(b)), ts, rtol=1e-5, atol=1e-6, options=opts)
    assert (st.n_func_evals, st.n_accepted, st.n_rejected) == (
        int(jst.n_func_evals), int(jst.n_accepted), int(jst.n_rejected)
    )
    assert st.succeeded and bool(jst.succeeded)
    for leaf, jleaf in zip(ys, jys):
        assert leaf.shape == jleaf.shape
        ref = np.asarray(jleaf, np.float64)
        err = np.max(np.abs(leaf.numpy() - ref)) / np.max(np.abs(ref))
        assert err <= 1e-6, err


def test_dopri5_matches_torchdiffeq_shim():
    a, b = _y0()
    y0 = (torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64))
    ref = torchdiffeq_shim.odeint(_torch_rhs, y0, torch.tensor([0.0, 1.0]), rtol=1e-8, atol=1e-9)
    ys, st = odeint(_torch_rhs, (torch.as_tensor(a), torch.as_tensor(b)), [0.0, 1.0], rtol=1e-5, atol=1e-6)
    for leaf, rleaf in zip(ys, ref):
        err = (leaf[-1].double() - rleaf[-1]).abs().max() / rleaf[-1].abs().max()
        assert err <= 1e-4, float(err)
    # same conventions, same tolerance: step counts agree closely (the
    # shim clips its last step onto t1 instead of overshooting)
    shim_pts = []

    def counting(t, y):
        shim_pts.append(float(t))
        return _torch_rhs(t, y)

    torchdiffeq_shim.odeint(counting, y0, torch.tensor([0.0, 1.0]), rtol=1e-5, atol=1e-6)
    assert abs(len(shim_pts) - st.n_func_evals) <= 12


def test_single_tensor_state_and_solver_edges():
    y0 = torch.ones(8, 2)
    ys, st = odeint_adaptive(lambda t, y: -y, y0, [0.0, 1.0], rtol=1e-6, atol=1e-8)
    assert ys.shape == (2, 8, 2)
    np.testing.assert_allclose(ys[-1].numpy(), np.exp(-1.0), rtol=1e-5)
    assert st.n_func_evals == 2 + 6 * (st.n_accepted + st.n_rejected)
    # max_num_steps exhausted -> succeeded False
    _, st = odeint_adaptive(lambda t, y: -y, y0, [0.0, 1.0], rtol=1e-9, atol=1e-12,
                            options={"max_num_steps": 3})
    assert not st.succeeded and st.n_accepted + st.n_rejected == 3
    # empty state components are skipped by the norm
    assert float(_mixed_rms_norm((torch.ones(3), torch.zeros(0)))) == 1.0


def test_solver_refusals():
    f = lambda t, y: -y  # noqa: E731
    y0 = torch.ones(2)
    with pytest.raises(ValueError, match="unknown solver options"):
        odeint(f, y0, [0.0, 1.0], options={"bogus": 1})
    with pytest.raises(ValueError, match="controller"):
        odeint(f, y0, [0.0, 1.0], options={"beta": 0.04})
    with pytest.raises(ValueError, match="monotonic"):
        odeint(f, y0, [0.0, 1.0, 0.5])
    # the multistep methods take 16 steps an interval by default, the
    # tableaus of item 13 run (tests/test_torch_multistep.py and the
    # tableau test above hold them against the JAX package)
    for method in ("explicit_adams", "tsit5"):
        ys, _ = odeint(f, y0, [0.0, 1.0], method=method)
        np.testing.assert_allclose(ys[-1].numpy(), np.exp(-1.0), rtol=1e-5)
    with pytest.raises(ValueError, match="steps"):
        odeint(f, y0, [0.0, 1.0], method="implicit_adams", options={"steps": 4, "steps_per_interval": 4})
    # the fixed-step methods run (tests/test_torch_fixed.py holds them
    # against the JAX package); adaptive options are unknown to them
    ys, st = odeint(f, y0, [0.0, 1.0], method="rk4", options={"steps": 10})
    assert st is None and ys.shape == (2, 2)
    np.testing.assert_allclose(ys[-1].numpy(), np.exp(-1.0), rtol=1e-5)
    with pytest.raises(ValueError, match="unknown fixed-step options"):
        odeint(f, y0, [0.0, 1.0], method="rk4", options={"min_step": 1e-3})
    with pytest.raises(ValueError, match="unknown method"):
        odeint(f, y0, [0.0, 1.0], method="nope")


# the flagship solve's tolerance a method (PI controller): where a row's
# error ratios sit at float32 rounding, the two packages' step sizes differ
# in the last digits with equal counts (ROADMAP.md queue 3, step-size
# noise), so each method runs at a tolerance where its steps are
# truncation-dominated
TABLEAUS = {"tsit5": 3e-5, "bosh3": 1e-5, "fehlberg2": 1e-4, "adaptive_heun": 1e-4, "dop853": 1e-4}
FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                        "flagship_ckpt.npz")


def _rel(out, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(out, np.float64) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("method", sorted(TABLEAUS))
def test_tableau_matches_jax(method):
    """Each tableau against the JAX solver: on the analytic field (I and
    PI controllers, increasing and decreasing grids) and on the flagship
    net's Hutchinson log_prob at 64 rows with the JAX probes: the same
    step sequence (equal n_func_evals, n_accepted, n_rejected) and finals
    within 1e-5 relative.  The cost of an attempt is the tableau's own
    (last-stage reuse for adaptive_heun and fehlberg2).  The kernel
    wrapper's plain version takes the same steps, its densities within
    the kernel-against-plain bar (mean |dlogp| <= 1e-4)."""
    tab = get_adaptive_tableau(method)
    assert tab.evals_per_step == tab.n_stages - 1 and tab.reuses_last_stage
    assert tab.clip_steps == (method in ("tsit5", "dop853"))
    assert (tab.pi_beta_scale, tab.pi_beta_default) == ((0.2, 0.0) if method == "dop853" else (0.75, 0.04))
    a, b = _y0()
    for ts, opts in (([0.0, 1.0], {}), ([1.0, 0.3, 0.0], {"controller": "pi"})):
        jys, jst = jodeint(_jax_rhs, (jnp.asarray(a), jnp.asarray(b)), ts, rtol=1e-5, atol=1e-6,
                           method=method, options=opts)
        ys, st = odeint(_torch_rhs, (torch.as_tensor(a), torch.as_tensor(b)), ts, rtol=1e-5, atol=1e-6,
                        method=method, options=opts)
        assert st.succeeded and (st.n_func_evals, st.n_accepted, st.n_rejected) == (
            int(jst.n_func_evals), int(jst.n_accepted), int(jst.n_rejected))
        assert st.n_func_evals == 2 + tab.evals_per_step * (st.n_accepted + st.n_rejected)
        for leaf, jleaf in zip(ys, jys):
            assert _rel(leaf, jleaf) <= 1e-5

    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    jm = jckpt.load_npz(FLAGSHIP, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg,
                                              sde=JVESDE(), trace_mode="hutchinson", use_fused_kernel=False))
    tm = ScoreModel(convert.params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu"),
                    ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), VESDE(), trace_mode="hutchinson")
    x = np.random.default_rng(5).standard_normal((64, 2)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    kw = dict(atol=TABLEAUS[method], rtol=TABLEAUS[method], method=method, options={"controller": "pi"})
    jlp, jst = jax.jit(lambda m, xx: m.log_prob(xx, key=key, **kw))(jm, jnp.asarray(x))
    probes = tuple(torch.as_tensor(np.asarray(p)) for p in jtrace.make_probes("hutchinson", key, jnp.asarray(x)))
    lp, st = tm.log_prob(torch.as_tensor(x), probes=probes, **kw)
    assert (st.n_func_evals, st.n_accepted, st.n_rejected) == (
        int(jst.n_func_evals), int(jst.n_accepted), int(jst.n_rejected))
    assert _rel(lp.numpy(), jlp) <= 1e-5
    # the kernel wrapper's plain version (use_fused_kernel=True on the CPU)
    lp_f, st_f = dataclasses.replace(tm, use_fused_kernel=True).log_prob(torch.as_tensor(x), probes=probes, **kw)
    assert st_f.n_func_evals == st.n_func_evals and float((lp_f - lp).abs().mean()) <= 1e-4


def test_dop853_needs_scipy_only_when_asked(monkeypatch):
    """dop853's coefficients load from scipy on first use; without scipy
    the lookup raises a ValueError naming it."""
    import sys

    from flowfusion_torch.ops.integrate import tableaus

    monkeypatch.setattr(tableaus, "_TABLEAUS", {k: v for k, v in tableaus._TABLEAUS.items() if k != "dop853"})
    monkeypatch.setitem(sys.modules, "scipy.integrate._ivp", None)
    with pytest.raises(ValueError, match="scipy"):
        odeint(lambda t, y: -y, torch.ones(2), [0.0, 1.0], method="dop853")
