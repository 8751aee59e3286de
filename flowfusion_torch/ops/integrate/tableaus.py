"""Butcher tableaus for explicit embedded Runge--Kutta methods.

Counterpart of the JAX package's ``ops/integrate/tableaus.py``; dopri5 only
so far (the other tableaus are ROADMAP.md queue 1, item 13).

Layout (the classical embedded-RK formulation):
  * ``alpha``   — stage times c_2..c_s (s-1 entries; c_1 = 0).
  * ``beta``    — stage weight rows a_ij, row i has i entries.
  * ``c_sol``   — solution weights b_i (s entries).
  * ``c_error`` — b_i - b*_i (error-estimate weights, s entries).
  * ``c_mid``   — dense-output midpoint weights (s entries).
  * ``order``   — order used by the step-size controller.
  * ``pi_beta_scale``/``pi_beta_default`` — the PI controller constants of
    the method's classic Hairer code.

The last beta row of an FSAL method equals ``c_sol[:-1]``, so the final
stage is f(t1, y1) and seeds the next step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ButcherTableau", "DOPRI5", "ADAPTIVE_TABLEAUS", "get_adaptive_tableau"]


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    alpha: Tuple[float, ...]
    beta: Tuple[Tuple[float, ...], ...]
    c_sol: Tuple[float, ...]
    c_error: Tuple[float, ...]
    order: int
    c_mid: Optional[Tuple[float, ...]] = None
    pi_beta_scale: float = 0.75
    pi_beta_default: float = 0.04

    @property
    def n_stages(self) -> int:
        return len(self.c_sol)


# Dormand--Prince 5(4) ("dopri5"; RK45 with Shampine dense-output midpoint).
DOPRI5 = ButcherTableau(
    alpha=(1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    beta=(
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    c_sol=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    c_error=(
        35 / 384 - 1951 / 21600,
        0.0,
        500 / 1113 - 22642 / 50085,
        125 / 192 - 451 / 720,
        -2187 / 6784 - -12231 / 42400,
        11 / 84 - 649 / 6300,
        -1.0 / 60.0,
    ),
    c_mid=(
        0.5 * (6025192743 / 30085553152),
        0.0,
        0.5 * (51252292925 / 65400821598),
        0.5 * (-2691868925 / 45128329728),
        0.5 * (187940372067 / 1594534317056),
        0.5 * (-1776094331 / 19743644256),
        0.5 * (11237099 / 235043384),
    ),
    order=5,
)

ADAPTIVE_TABLEAUS = {"dopri5": DOPRI5}

# Adaptive methods of the JAX package that the port does not carry yet.
_NOT_PORTED = ("tsit5", "bosh3", "fehlberg2", "adaptive_heun", "dop853")


def get_adaptive_tableau(method: str) -> ButcherTableau:
    """Lookup; the JAX package's other adaptive methods raise."""
    tab = ADAPTIVE_TABLEAUS.get(method)
    if tab is not None:
        return tab
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported to flowfusion_torch yet "
            "(ROADMAP.md queue 1, item 13: remaining tableaus); use 'dopri5'"
        )
    raise KeyError(method)
