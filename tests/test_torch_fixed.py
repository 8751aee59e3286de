"""flowfusion_torch fixed-step solvers, leapfrog and Euler--Maruyama
against the JAX package's ``ops/integrate/fixed.py``, on the CPU.

Both keep time and step sizes in float32 and take the same steps, so the
outputs agree to float32 rounding: <= 1e-6 relative.  Euler--Maruyama's
noise streams differ between the packages, so it is compared with the
diffusion switched off (the deterministic part), and its freeze and
active-step rules are checked on the port alone with streamed noise.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.ops.integrate import odeint as jodeint
from flowfusion_tpu.ops.integrate import fixed as jfixed
from flowfusion_torch.ops.integrate import EMResult, euler_maruyama, leapfrog, odeint, odeint_fixed

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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _assert_trees_close(ys, jys, bar=1e-6):
    for leaf, jleaf in zip(ys, jys):
        assert tuple(leaf.shape) == tuple(jleaf.shape)
        assert _rel(leaf.numpy(), jleaf) <= bar


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun3", "rk4"])
@pytest.mark.parametrize("ts,steps", [([0.0, 0.4, 1.0], 5), ([1.0, 0.25, 0.0], 3)])
def test_odeint_fixed_matches_jax(method, ts, steps):
    """Increasing and decreasing grids with sub-stepping; row 0 is y0."""
    a, b = _y0()
    jys = jfixed.odeint_fixed(_jax_rhs, (jnp.asarray(a), jnp.asarray(b)), ts, method=method,
                              steps_per_interval=steps)
    ys = odeint_fixed(_torch_rhs, (torch.as_tensor(a), torch.as_tensor(b)), ts, method=method,
                      steps_per_interval=steps)
    assert ys[0].shape == (len(ts), 16, 3)
    np.testing.assert_array_equal(ys[0][0].numpy(), a)
    _assert_trees_close(ys, jys)


@pytest.mark.parametrize("options", [
    {"step_size": 0.07}, {"steps": 4}, {"steps_per_interval": 2}, None,
])
def test_odeint_fixed_options_match_jax(options):
    """The dispatcher's option handling: step_size rounds up to whole
    sub-steps per interval; steps is the alias of steps_per_interval."""
    a, b = _y0()
    ts = [0.0, 0.5, 1.0]
    jys, jst = jodeint(_jax_rhs, (jnp.asarray(a), jnp.asarray(b)), ts, method="rk4", options=options)
    ys, st = odeint(_torch_rhs, (torch.as_tensor(a), torch.as_tensor(b)), ts, method="rk4", options=options)
    assert st is None and jst is None
    _assert_trees_close(ys, jys)


def test_odeint_fixed_option_refusals():
    f = lambda t, y: -y  # noqa: E731
    y0 = torch.ones(2)
    with pytest.raises(ValueError, match="not both"):
        odeint(f, y0, [0.0, 1.0], method="euler", options={"steps": 2, "steps_per_interval": 2})
    with pytest.raises(ValueError, match="unknown fixed-step options"):
        odeint(f, y0, [0.0, 1.0], method="euler", options={"rtol": 1e-3})
    with pytest.raises(ValueError, match="unknown fixed-step options"):
        odeint(f, y0, [0.0, 1.0], method="euler", options={"step_size": 0.1, "steps": 2})
    with pytest.raises(ValueError, match=">= 1"):
        odeint_fixed(f, y0, [0.0, 1.0], steps_per_interval=0)
    # a single tensor state, exp(-1) to rk4 accuracy
    ys, _ = odeint(f, torch.ones(3), [0.0, 1.0], method="rk4", options={"steps": 20})
    np.testing.assert_allclose(ys[-1].numpy(), np.exp(-1.0), rtol=1e-6)


def test_leapfrog_matches_jax():
    """Pendulum-like separable system; q, p after 25 kick-drift-kicks."""
    rng = np.random.default_rng(3)
    q0, p0 = (rng.standard_normal((8, 2)).astype(np.float32) for _ in range(2))
    jq, jp = jfixed.leapfrog(
        lambda t, p: p * (1.0 + 0.1 * t), lambda t, q: -jnp.sin(q), jnp.asarray(q0), jnp.asarray(p0),
        t0=0.0, t1=2.0, steps=25,
    )
    calls = []

    def vq(t, p):
        calls.append("q")
        return p * (1.0 + 0.1 * t)

    def vp(t, q):
        calls.append("p")
        return -torch.sin(q)

    q, p = leapfrog(vq, vp, torch.as_tensor(q0), torch.as_tensor(p0), t0=0.0, t1=2.0, steps=25)
    # the closing kick's force is carried into the next step: 2N + 1 calls
    assert len(calls) == 2 * 25 + 1
    assert _rel(q.numpy(), jq) <= 1e-6 and _rel(p.numpy(), jp) <= 1e-6


def test_euler_maruyama_deterministic_part_matches_jax():
    """Zero diffusion: the EM loop is forward Euler on the float32 grid
    t0 + dt * arange(steps), the same in both packages."""
    import jax

    x0 = np.random.default_rng(4).standard_normal((32, 2)).astype(np.float32)
    kw = dict(t0=1.0, t1=1e-3, steps=40, epsilon=1e-3)
    jres = jfixed.euler_maruyama(
        jax.random.PRNGKey(0), lambda t, x: -x * t + jnp.sin(x), lambda t, x: jnp.zeros_like(x),
        jnp.asarray(x0), **kw,
    )
    res = euler_maruyama(
        torch.Generator().manual_seed(0), lambda t, x: -x * t + torch.sin(x),
        lambda t, x: torch.zeros_like(x), torch.as_tensor(x0), **kw,
    )
    assert isinstance(res, EMResult) and not bool(res.nan_encountered)
    assert _rel(res.x_mean.numpy(), jres.x_mean) <= 1e-6
    assert _rel(res.x.numpy(), jres.x) <= 1e-6


def _em_by_hand(x0, noise, t0, t1, epsilon):
    """The reference sampler's loop in float64 numpy: stop at the first
    non-finite step, skip steps below epsilon."""
    steps = noise.shape[0]
    dt = (t1 - t0) / steps
    x = xm = x0.astype(np.float64)
    for i in range(steps):
        t = np.float32(t0) + np.float32(dt) * np.float32(i)
        if t < epsilon:
            continue
        new_mean = x + (-0.5 * x) * dt
        new_x = new_mean + 0.3 * np.sqrt(abs(dt)) * noise[i]
        if not np.all(np.isfinite(new_x)):
            return xm, x, True
        x, xm = new_x, new_mean
    return xm, x, False


@pytest.mark.parametrize("nan_step", [None, 3, 8])
def test_euler_maruyama_freeze_and_active_steps(nan_step):
    """Steps with t < epsilon change nothing (the grid 1.0 - 0.1 i is
    active for i <= 6 at epsilon 0.35); the first non-finite new x on an
    active step freezes the whole batch and sets the flag; a NaN on an
    inactive step (8) is never seen."""
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((16, 2)).astype(np.float32)
    noise = rng.standard_normal((10, 16, 2)).astype(np.float32)
    if nan_step is not None:
        noise[nan_step, 5, 1] = np.nan
    res = euler_maruyama(
        None, lambda t, x: -0.5 * x, lambda t, x: torch.full_like(x, 0.3), torch.as_tensor(x0),
        t0=1.0, t1=0.0, steps=10, epsilon=0.35, noise=torch.as_tensor(noise),
    )
    xm, x, nan = _em_by_hand(x0, noise, 1.0, 0.0, 0.35)
    assert bool(res.nan_encountered) == nan == (nan_step == 3)
    np.testing.assert_allclose(res.x_mean.numpy(), xm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.x.numpy(), x, rtol=1e-5, atol=1e-6)
    assert np.all(np.isfinite(res.x.numpy()))


def test_euler_maruyama_refusals():
    f = lambda t, x: x  # noqa: E731
    # progress=True runs (a tqdm bar, or one warning without tqdm) and
    # changes no sample
    noise = torch.ones(2, 2, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        shown = euler_maruyama(None, f, f, torch.zeros(2, 2), t0=1.0, t1=0.0, steps=2, noise=noise, progress=True)
    quiet = euler_maruyama(None, f, f, torch.zeros(2, 2), t0=1.0, t1=0.0, steps=2, noise=noise)
    assert all(torch.equal(a, b) for a, b in zip(shown, quiet))
    with pytest.raises(ValueError, match="noise of shape"):
        euler_maruyama(None, f, f, torch.zeros(2, 2), t0=1.0, t1=0.0, steps=2, noise=torch.zeros(3, 2, 2))
