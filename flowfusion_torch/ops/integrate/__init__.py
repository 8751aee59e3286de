"""ODE/SDE integration for the port (counterpart of the JAX package's
``ops/integrate``).

``odeint`` is the single entry point.  It dispatches to the adaptive
embedded RK solver or the fixed-grid solvers (euler, midpoint, heun3,
rk4); the JAX package's multistep, per-sample and adjoint solvers are not
ported yet and raise.  ``euler_maruyama`` and ``leapfrog`` are the SDE
sampler and the symplectic integrator.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from .adaptive import SolverStats, odeint_adaptive
from .fixed import FIXED_METHODS, EMResult, euler_maruyama, leapfrog, odeint_fixed
from .tableaus import _NOT_PORTED as _ADAPTIVE_NOT_PORTED
from .tableaus import ADAPTIVE_TABLEAUS, get_adaptive_tableau

__all__ = [
    "odeint",
    "odeint_adaptive",
    "odeint_fixed",
    "euler_maruyama",
    "leapfrog",
    "SolverStats",
    "EMResult",
]

_MULTISTEP = ("explicit_adams", "implicit_adams")


def _fixed_steps(ts, options: Optional[dict]) -> int:
    """Sub-steps per output interval from the fixed-step options:
    ``step_size`` (a uniform step, rounded up to whole sub-steps) or
    ``steps_per_interval`` / its alias ``steps`` (default 1); giving both
    spellings, or any other option, raises."""
    opts = dict(options or {})
    if "step_size" in opts:
        h = float(opts.pop("step_size"))
        spans = np.abs(np.diff(np.asarray(ts, float)))
        steps = max(1, int(np.ceil(float(np.max(spans)) / h)))
    elif "steps_per_interval" in opts and "steps" in opts:
        raise ValueError("pass either 'steps_per_interval' or its alias 'steps', not both")
    elif "steps_per_interval" in opts:
        steps = int(opts.pop("steps_per_interval"))
    else:
        steps = int(opts.pop("steps", 1))
    if opts:
        raise ValueError(f"unknown fixed-step options: {sorted(opts)}")
    return steps


def odeint(
    func: Callable,
    y0: Any,
    ts,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    options: Optional[dict] = None,
):
    """Integrate dy/dt = func(t, y) through the times ``ts``.

    Returns ``(ys, stats)``; for fixed-step methods ``stats`` is None.
    Default tolerances match torchdiffeq's (rtol=1e-7, atol=1e-9).
    """
    if method in ADAPTIVE_TABLEAUS:
        return odeint_adaptive(
            func, y0, ts, rtol=rtol, atol=atol, method=method, options=options
        )
    if method in FIXED_METHODS:
        steps = _fixed_steps(ts, options)
        return odeint_fixed(func, y0, ts, method=method, steps_per_interval=steps), None
    if method in _MULTISTEP:
        raise NotImplementedError(
            f"multistep method {method!r} is not ported to flowfusion_torch "
            "yet (ROADMAP.md queue 1, item 13); use 'dopri5'"
        )
    if method in _ADAPTIVE_NOT_PORTED:
        get_adaptive_tableau(method)  # raises the NotImplementedError
    raise ValueError(
        f"unknown method {method!r}; adaptive: {sorted(ADAPTIVE_TABLEAUS)}, "
        f"fixed: {sorted(FIXED_METHODS)}"
    )
