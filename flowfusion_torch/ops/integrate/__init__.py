"""ODE/SDE integration for the port (counterpart of the JAX package's
``ops/integrate``).

``odeint`` is the single entry point.  It dispatches to the adaptive
embedded RK solvers (dopri5, tsit5, bosh3, fehlberg2, adaptive_heun,
dop853), the fixed-grid solvers (euler, midpoint, heun3, rk4) or the
fixed-grid Adams multistep solvers (explicit_adams, implicit_adams).
``odeint_per_sample`` steps every batch row on its own, ``odeint_adjoint``
differentiates an adaptive solve with the continuous adjoint, and
``dpm_solver_sample`` is the DPM-Solver sampler.  ``euler_maruyama`` and
``leapfrog`` are the SDE sampler and the symplectic integrator.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from .adaptive import SolverStats, odeint_adaptive, odeint_per_sample
from .adjoint import odeint_adjoint
from .dpm import dpm_solver_sample
from .fixed import FIXED_METHODS, EMResult, euler_maruyama, leapfrog, odeint_fixed
from .multistep import MULTISTEP_METHODS, odeint_multistep
from .tableaus import ADAPTIVE_METHODS

__all__ = [
    "odeint",
    "odeint_adaptive",
    "odeint_per_sample",
    "odeint_adjoint",
    "odeint_fixed",
    "odeint_multistep",
    "dpm_solver_sample",
    "euler_maruyama",
    "leapfrog",
    "SolverStats",
    "EMResult",
]

def _fixed_steps(ts, options: Optional[dict], default: int) -> int:
    """Sub-steps per output interval from the fixed-step options:
    ``step_size`` (a uniform step, rounded up to whole sub-steps) or
    ``steps_per_interval`` / its alias ``steps`` (default ``default``);
    giving both spellings, or any other option, raises."""
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
        steps = int(opts.pop("steps", default))
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

    Returns ``(ys, stats)``; for fixed-step and multistep methods
    ``stats`` is None.  Default tolerances match torchdiffeq's (rtol=1e-7,
    atol=1e-9).  Fixed-step methods take one step an output interval by
    default, the multistep methods 16.
    """
    if method in ADAPTIVE_METHODS:
        return odeint_adaptive(
            func, y0, ts, rtol=rtol, atol=atol, method=method, options=options
        )
    if method in FIXED_METHODS:
        steps = _fixed_steps(ts, options, default=1)
        return odeint_fixed(func, y0, ts, method=method, steps_per_interval=steps), None
    if method in MULTISTEP_METHODS:
        steps = _fixed_steps(ts, options, default=16)
        return odeint_multistep(func, y0, ts, method=method, steps_per_interval=steps), None
    raise ValueError(
        f"unknown method {method!r}; adaptive: {sorted(ADAPTIVE_METHODS)}, "
        f"fixed: {sorted(FIXED_METHODS)}, multistep: {sorted(MULTISTEP_METHODS)}"
    )
