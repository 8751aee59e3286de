"""ODE integration for the port (counterpart of
the JAX package's ``ops/integrate``).

``odeint`` is the single entry point.  It dispatches to the adaptive
embedded RK solver; the JAX package's fixed-step, multistep, per-sample
and adjoint solvers are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .adaptive import SolverStats, odeint_adaptive
from .tableaus import _NOT_PORTED as _ADAPTIVE_NOT_PORTED
from .tableaus import ADAPTIVE_TABLEAUS, get_adaptive_tableau

__all__ = ["odeint", "odeint_adaptive", "SolverStats"]

_FIXED = ("euler", "midpoint", "heun3", "rk4")
_MULTISTEP = ("explicit_adams", "implicit_adams")


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

    Returns ``(ys, stats)``.  Default tolerances match torchdiffeq's
    (rtol=1e-7, atol=1e-9).
    """
    if method in ADAPTIVE_TABLEAUS:
        return odeint_adaptive(
            func, y0, ts, rtol=rtol, atol=atol, method=method, options=options
        )
    if method in _FIXED:
        raise NotImplementedError(
            f"fixed-step method {method!r} is not ported to flowfusion_torch "
            "yet (ROADMAP.md queue 1, item 8); use 'dopri5'"
        )
    if method in _MULTISTEP:
        raise NotImplementedError(
            f"multistep method {method!r} is not ported to flowfusion_torch "
            "yet (ROADMAP.md queue 1, item 13); use 'dopri5'"
        )
    if method in _ADAPTIVE_NOT_PORTED:
        get_adaptive_tableau(method)  # raises the NotImplementedError
    raise ValueError(
        f"unknown method {method!r}; ported: {sorted(ADAPTIVE_TABLEAUS)}"
    )
