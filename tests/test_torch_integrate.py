"""flowfusion_torch adaptive dopri5 against the JAX solver and the torch
oracle ``tests/torchdiffeq_shim.py``.

Against JAX: the same step sequence (equal n_func_evals, n_accepted and
n_rejected) and outputs within 1e-6 relative — both solvers keep time and
controller scalars in float32 and take the same decisions.  Against the
torchdiffeq-convention shim (float64, steps clipped onto output times
instead of dense output): agreement to within the requested tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.ops.integrate.adaptive import odeint_adaptive as jodeint
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
    for method, item in (("rk4", "item 8"), ("explicit_adams", "item 13"), ("tsit5", "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            odeint(f, y0, [0.0, 1.0], method=method)
    with pytest.raises(ValueError, match="unknown method"):
        odeint(f, y0, [0.0, 1.0], method="nope")
