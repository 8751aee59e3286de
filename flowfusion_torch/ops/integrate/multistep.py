"""Fixed-step linear multistep (Adams) solvers.

Counterpart of the JAX package's ``ops/integrate/multistep.py``:
``explicit_adams`` (Adams--Bashforth 4) and ``implicit_adams`` (PECE
Adams--Bashforth--Moulton 4), fixed order 4 with an RK4 start for the
first three steps, the derivative history restarted at every output
interval (each interval runs on its own uniform sub-grid).  After the
start AB4 costs one RHS evaluation a step and ABM4 two.

Coefficients (Hairer, Norsett & Wanner I.III.1):
  AB4: y_{n+1} = y_n + dt/24 (55 f_n - 59 f_{n-1} + 37 f_{n-2} - 9 f_{n-3})
  AM4: y_{n+1} = y_n + dt/24 ( 9 f_{n+1} + 19 f_n - 5 f_{n-1} + f_{n-2})

The loops are Python loops whose times stay float32 tensors on the
state's device, so a solve never synchronises with the host.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from .fixed import _tree_axpy as _axpy
from .fixed import tree_leaves, tree_map

__all__ = ["odeint_multistep", "MULTISTEP_METHODS", "multistep_evals"]

_AB4 = (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0)  # f_n .. f_{n-3}
_AM4 = (9.0 / 24.0, 19.0 / 24.0, -5.0 / 24.0, 1.0 / 24.0)  # f_{n+1} .. f_{n-2}

MULTISTEP_METHODS = ("explicit_adams", "implicit_adams")


def multistep_evals(method: str, steps_per_interval: int, n_intervals: int) -> int:
    """RHS evaluations of a solve: an interval costs f(t0) and three RK4
    steps of three fresh stages and one f(t, y) each (at most
    ``steps_per_interval`` of them), then one evaluation a step (AB4) or
    two (ABM4)."""
    start = min(3, steps_per_interval)
    per = 1 + 4 * start + (1 if method == "explicit_adams" else 2) * max(0, steps_per_interval - 3)
    return per * n_intervals


def _ab4_increment(hist):
    """dt-free AB4 combination of the history [f_n, f_{n-1}, f_{n-2}, f_{n-3}]."""
    return tree_map(
        lambda h0, h1, h2, h3: _AB4[0] * h0 + _AB4[1] * h1 + _AB4[2] * h2 + _AB4[3] * h3, *hist
    )


def _am4_increment(f_new, hist):
    return tree_map(
        lambda fn, h0, h1, h2: _AM4[0] * fn + _AM4[1] * h0 + _AM4[2] * h1 + _AM4[3] * h2,
        f_new, hist[0], hist[1], hist[2],
    )


def _rk4_known_k1(func, t, dt, y, k1):
    """One RK4 step reusing the already evaluated ``k1 = f(t, y)``."""
    k2 = func(t + 0.5 * dt, _axpy(y, 0.5 * dt, k1))
    k3 = func(t + 0.5 * dt, _axpy(y, 0.5 * dt, k2))
    k4 = func(t + dt, _axpy(y, dt, k3))
    upd = tree_map(lambda a, b, c, d: (a + 2.0 * b + 2.0 * c + d) / 6.0, k1, k2, k3, k4)
    return _axpy(y, dt, upd)


def _integrate_interval(func, y0, t0, dt, n_steps, method):
    """Uniform-grid Adams integration of one output interval.  ``hist``
    holds the last four derivatives, newest first (the start repeats
    f(t0) into the unfilled slots, as the JAX history does)."""
    n_startup = min(3, n_steps)
    f_t = func(t0, y0)
    hist = [f_t] * 4
    y = y0
    for i in range(n_startup):
        y = _rk4_known_k1(func, t0 + i * dt, dt, y, f_t)
        f_t = func(t0 + (i + 1) * dt, y)
        hist = [f_t] + hist[:-1]
    for i in range(3, n_steps):
        t_n = t0 + float(i) * dt
        y_pred = _axpy(y, dt, _ab4_increment(hist))
        if method == "explicit_adams":
            y = y_pred
        else:  # PECE
            f_star = func(t_n + dt, y_pred)
            y = _axpy(y, dt, _am4_increment(f_star, hist))
        hist = [func(t_n + dt, y)] + hist[:-1]
    return y


def odeint_multistep(
    func: Callable[[torch.Tensor, Any], Any],
    y0: Any,
    ts: Sequence[float] | np.ndarray,
    *,
    method: str = "implicit_adams",
    steps_per_interval: int = 16,
):
    """Integrate on the output grid ``ts`` with AB4/ABM4 sub-stepping.

    Returns leaves with a leading axis of len(ts); row 0 is ``y0``.  ``ts``
    may be increasing or decreasing (dt is signed).  ``func`` gets ``t``
    as a float32 0-d tensor on the state's device.
    """
    if method not in MULTISTEP_METHODS:
        raise ValueError(f"unknown multistep method {method!r}; use one of {MULTISTEP_METHODS}")
    if steps_per_interval < 1:
        raise ValueError(f"steps_per_interval must be >= 1; got {steps_per_interval}")
    ts = np.asarray(ts, np.float64)
    if ts.ndim != 1 or len(ts) < 2:
        raise ValueError("ts must be a 1-D grid with at least two times")
    device = tree_leaves(y0)[0].device
    # sub-step sizes in float64 on the host, cast once
    t0s = torch.as_tensor(ts[:-1].astype(np.float32), device=device)
    dts = torch.as_tensor(((ts[1:] - ts[:-1]) / steps_per_interval).astype(np.float32), device=device)
    outs, y = [y0], y0
    for j in range(len(ts) - 1):
        y = _integrate_interval(func, y, t0s[j], dts[j], steps_per_interval, method)
        outs.append(y)
    if isinstance(y0, torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack([o[k] for o in outs]) for k in range(len(y0)))
