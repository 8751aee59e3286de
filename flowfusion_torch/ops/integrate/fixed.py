"""Fixed-step ODE solvers, leapfrog and the Euler--Maruyama SDE sampler.

Counterpart of the JAX package's ``ops/integrate/fixed.py``.  The JAX loops
are ``lax.scan``s; here they are Python loops whose times, step sizes and
flags stay float32/bool tensors on the state's device, so a loop never
synchronises with the host.  A state "tree" is a tensor or a tuple of
tensors.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...parallel import _collective

__all__ = [
    "tree_map",
    "tree_leaves",
    "odeint_fixed",
    "leapfrog",
    "make_progress_callback",
    "euler_maruyama",
    "FIXED_METHODS",
    "EMResult",
]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over a tensor or a tuple/list of tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tuple(fn(*leaves) for leaves in zip(tree, *rest))


def tree_leaves(tree: Any) -> list:
    return [tree] if isinstance(tree, torch.Tensor) else list(tree)


def _tree_axpy(y: Any, scale, x: Any) -> Any:
    """y + scale * x, leafwise."""
    return tree_map(lambda a, b: a + scale * b, y, x)


def _euler_step(func, t, dt, y):
    return _tree_axpy(y, dt, func(t, y))


def _midpoint_step(func, t, dt, y):
    k1 = func(t, y)
    k2 = func(t + 0.5 * dt, _tree_axpy(y, 0.5 * dt, k1))
    return _tree_axpy(y, dt, k2)


def _heun3_step(func, t, dt, y):
    k1 = func(t, y)
    k2 = func(t + dt / 3.0, _tree_axpy(y, dt / 3.0, k1))
    k3 = func(t + 2.0 * dt / 3.0, _tree_axpy(y, 2.0 * dt / 3.0, k2))
    return _tree_axpy(y, dt, tree_map(lambda a, c: 0.25 * a + 0.75 * c, k1, k3))


def _rk4_step(func, t, dt, y):
    k1 = func(t, y)
    k2 = func(t + 0.5 * dt, _tree_axpy(y, 0.5 * dt, k1))
    k3 = func(t + 0.5 * dt, _tree_axpy(y, 0.5 * dt, k2))
    k4 = func(t + dt, _tree_axpy(y, dt, k3))
    upd = tree_map(lambda a, b, c, d: (a + 2.0 * b + 2.0 * c + d) / 6.0, k1, k2, k3, k4)
    return _tree_axpy(y, dt, upd)


FIXED_METHODS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "heun3": _heun3_step,
    "rk4": _rk4_step,
}


def odeint_fixed(
    func: Callable[[torch.Tensor, Any], Any],
    y0: Any,
    ts: Sequence[float],
    *,
    method: str = "euler",
    steps_per_interval: int = 1,
):
    """Integrate on the fixed grid ``ts`` (with optional sub-stepping).

    Returns a tree whose leaves gain a leading axis of len(ts); row 0 is
    ``y0``.  ``ts`` may be increasing or decreasing.  The sub-stepped grid
    is built in float64 and rounded to float32, and each step's dt is the
    float32 difference of its ends, as in the JAX package.
    """
    step_fn = FIXED_METHODS[method]
    if steps_per_interval < 1:
        raise ValueError(f"steps_per_interval must be >= 1, got {steps_per_interval}")
    ts = np.asarray(ts, np.float64)
    fine = []
    for a, b in zip(ts[:-1], ts[1:]):
        fine.extend(np.linspace(a, b, steps_per_interval + 1)[:-1])
    fine.append(ts[-1])
    fine = np.asarray(fine, np.float32)
    dev = tree_leaves(y0)[0].device
    t_dev = torch.as_tensor(fine[:-1]).to(dev)
    dt_dev = torch.as_tensor(np.diff(fine)).to(dev)
    outs = [y0]
    y = y0
    for i in range(len(fine) - 1):
        y = step_fn(func, t_dev[i], dt_dev[i], y)
        if (i + 1) % steps_per_interval == 0:
            outs.append(y)
    return tree_map(lambda *leaves: torch.stack(leaves), *outs)


def leapfrog(
    vq_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    vp_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    q0: torch.Tensor,
    p0: torch.Tensor,
    *,
    t0: float,
    t1: float,
    steps: int,
):
    """Stormer--Verlet (leapfrog) integration of a separable Hamiltonian,
    dq/dt = vq(t, p), dp/dt = vp(t, q): one kick-drift-kick per step, the
    closing kick's force carried into the next step (N + 1 evaluations of
    ``vp_fn``, 2N + 1 in all).  Returns (q, p)."""
    dt = (t1 - t0) / steps
    ts = t0 + dt * torch.arange(steps, dtype=torch.float32, device=q0.device)
    q, p, f = q0, p0, vp_fn(t0, q0)
    for i in range(steps):
        t = ts[i]
        p_half = p + 0.5 * dt * f
        q = q + dt * vq_fn(t + 0.5 * dt, p_half)
        f = vp_fn(t + dt, q)
        p = p_half + 0.5 * dt * f
    return q, p


def make_progress_callback(total: int, desc: str = "sampling"):
    """A tqdm ticker for a sampler's host loop (the reference's per-step
    bar).  The bar is made lazily on the first tick of a run, and closed
    (and the counter reset) when ``total`` ticks have arrived, so one
    sampler can run again.  The tick's argument is ignored."""
    state = {"bar": None, "count": 0}

    def tick(_t=None):
        import tqdm

        if state["bar"] is None:
            state["bar"] = tqdm.tqdm(total=total, desc=desc)
        state["bar"].update(1)
        state["count"] += 1
        if state["count"] >= total:
            state["bar"].close()
            state["bar"] = None
            state["count"] = 0

    return tick


def _progress_tick(steps: int):
    """The sampler's ticker, or None (with one warning) when tqdm does
    not import."""
    try:
        import tqdm  # noqa: F401
    except ImportError:
        warnings.warn("progress bars need tqdm, which does not import here; running without a bar")
        return None
    return make_progress_callback(steps, "sample_sde")


class EMResult(NamedTuple):
    x_mean: torch.Tensor  # final denoised mean (the reference's return value)
    x: torch.Tensor  # final noisy state
    nan_encountered: torch.Tensor  # 0-d bool on the state's device


def euler_maruyama(
    generator: Optional[torch.Generator],
    drift_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    diffusion_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    t0: float,
    t1: float,
    steps: int,
    epsilon: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    progress: bool = False,
) -> EMResult:
    """Euler--Maruyama integration of dx = f dt + g dW from t0 to t1.

    ``steps`` uniform steps of dt = (t1 - t0)/steps on the float32 grid
    t0 + dt * arange(steps), per-step noise sqrt(|dt|) N(0, 1); the *mean*
    update is returned as ``x_mean``.  The whole batch freezes at its last
    finite state at the first non-finite new x on an active step (t >=
    ``epsilon``), and ``nan_encountered`` says so; inactive steps change
    nothing.  The freeze is a ``torch.where`` on the device: the loop never
    synchronises with the host, but inside ``parallel.data_parallel``,
    where a non-finite row of any process freezes every process's batch
    (one all-reduce a step).

    Noise is drawn from ``generator`` on its own device (one on the state's
    device avoids a copy a step), or streamed from ``noise`` of shape
    (steps, *x0.shape).

    ``progress=True`` shows a tqdm bar, ticked once a step from the host
    loop (no synchronisation, no launch; the samples are bitwise those of
    ``progress=False``).  tqdm is not a dependency of the port: where it
    does not import, the sampler warns once and runs without a bar.
    """
    if noise is not None and tuple(noise.shape) != (steps, *x0.shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)}; expected {(steps, *x0.shape)}")
    dev = x0.device
    dt = (t1 - t0) / steps
    sqrt_dt = torch.sqrt(torch.tensor(abs(dt), dtype=torch.float32)).to(dev)
    f32 = torch.float32
    ts = (torch.tensor(t0, dtype=f32) + torch.tensor(dt, dtype=f32) * torch.arange(steps, dtype=f32)).to(dev)
    gen_dev = generator.device if generator is not None else dev
    x, x_mean = x0, x0
    frozen = torch.zeros((), dtype=torch.bool, device=dev)
    tick = _progress_tick(steps) if progress else None
    group = _collective.active_group()
    for i in range(steps):
        t = ts[i]
        if tick is not None:
            tick(t)
        active = ~frozen & (t >= epsilon)
        g = diffusion_fn(t, x)
        f = drift_fn(t, x)
        new_mean = x + f * dt
        z = noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, dtype=x.dtype, device=gen_dev
        ).to(dev)
        new_x = new_mean + g * (z * sqrt_dt)
        has_nan = ~torch.isfinite(new_x).all()
        if group is not None:
            # the whole batch of every process freezes together
            has_nan = _collective.any_over_group(has_nan, group)
        use = active & ~has_nan
        x = torch.where(use, new_x, x)
        x_mean = torch.where(use, new_mean, x_mean)
        # only NaNs on active steps count: the reference never evaluates
        # the steps below epsilon
        frozen = frozen | (active & has_nan)
    return EMResult(x_mean=x_mean, x=x, nan_encountered=frozen)
