"""Butcher tableaus for explicit embedded Runge--Kutta methods.

Counterpart of the JAX package's ``ops/integrate/tableaus.py``: dopri5,
tsit5, bosh3, fehlberg2, adaptive_heun and dop853 (Dormand & Prince 1980;
Tsitouras 2011; Bogacki & Shampine 1989; Fehlberg 1969; Heun; Hairer's
DOP853).

Layout (the classical embedded-RK formulation):
  * ``alpha``   — stage times c_2..c_s (s-1 entries; c_1 = 0).
  * ``beta``    — stage weight rows a_ij, row i has i entries.
  * ``c_sol``   — solution weights b_i (s entries).
  * ``c_error`` — b_i - b*_i (error-estimate weights, s entries).
  * ``c_mid``   — dense-output midpoint weights (s entries), or None for
    the cubic Hermite midpoint.
  * ``c_error_low`` — the secondary (3rd-order) error weights of DOP853,
    combined by the solver into Hairer's stabilized norm.
  * ``clip_steps`` — land exactly on each output time instead of
    overshooting and interpolating (tsit5, dop853).
  * ``order``   — order used by the step-size controller.
  * ``pi_beta_scale``/``pi_beta_default`` — the PI controller constants of
    the method's classic Hairer code.

The last beta row of an FSAL method equals ``c_sol[:-1]``, so the final
stage is f(t1, y1) and seeds the next step.

dop853's coefficients come from scipy (``scipy.integrate._ivp.
dop853_coefficients``), loaded on the first lookup of 'dop853', so the
package imports without scipy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ButcherTableau", "DOPRI5", "ADAPTIVE_METHODS", "ADAPTIVE_TABLEAUS", "get_adaptive_tableau"]


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    alpha: Tuple[float, ...]
    beta: Tuple[Tuple[float, ...], ...]
    c_sol: Tuple[float, ...]
    c_error: Tuple[float, ...]
    order: int
    c_mid: Optional[Tuple[float, ...]] = None
    c_error_low: Optional[Tuple[float, ...]] = None
    clip_steps: bool = False
    pi_beta_scale: float = 0.75
    pi_beta_default: float = 0.04

    @property
    def n_stages(self) -> int:
        return len(self.c_sol)

    @property
    def is_fsal(self) -> bool:
        last = self.beta[-1] + (0.0,) * (self.n_stages - 1 - len(self.beta[-1]))
        sol = self.c_sol[: self.n_stages - 1]
        return (
            len(self.beta) == self.n_stages - 1
            and self.alpha[-1] == 1.0
            and all(abs(a - b) < 1e-15 for a, b in zip(last, sol))
            and self.c_sol[-1] == 0.0
        )

    @property
    def reuses_last_stage(self) -> bool:
        """Whether the last stage seeds the next step's derivative: FSAL
        pairs by construction, and (torchdiffeq's ``f1 = k[..., -1]``) any
        pair whose final stage lands at t1 (adaptive_heun, fehlberg2)."""
        return self.is_fsal or (bool(self.alpha) and self.alpha[-1] == 1.0)

    @property
    def evals_per_step(self) -> int:
        """Fresh RHS evaluations an attempted step costs."""
        return self.n_stages - 1 if self.reuses_last_stage else self.n_stages


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

# Bogacki--Shampine 3(2).
BOSH3 = ButcherTableau(
    alpha=(1 / 2, 3 / 4, 1.0),
    beta=((1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
    c_sol=(2 / 9, 1 / 3, 4 / 9, 0.0),
    c_error=(2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8),
    order=3,
)

# Fehlberg 2(1).
FEHLBERG2 = ButcherTableau(
    alpha=(1 / 2, 1.0),
    beta=((1 / 2,), (1 / 256, 255 / 256)),
    c_sol=(1 / 512, 255 / 256, 1 / 512),
    c_error=(1 / 512 - 1 / 256, 0.0, 1 / 512),
    order=2,
)

# Adaptive Heun 2(1).
ADAPTIVE_HEUN = ButcherTableau(
    alpha=(1.0,),
    beta=((1.0,),),
    c_sol=(1 / 2, 1 / 2),
    c_error=(-1 / 2, 1 / 2),
    order=2,
)

# Tsitouras 5(4) ("tsit5"; Tsitouras 2011, Comput. Math. Appl. 62).  Same
# cost shape as DOPRI5 (7 stages, FSAL: 6 evals a step); steps clip onto
# the output times, so no dense-output midpoint row is needed.
TSIT5 = ButcherTableau(
    alpha=(0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    beta=(
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (
            5.325864828439257,
            -11.748883564062828,
            7.4955393428898365,
            -0.09249506636175525,
        ),
        (
            5.86145544294642,
            -12.92096931784711,
            8.159367898576159,
            -0.071584973281401,
            -0.028269050394068383,
        ),
        (
            0.09646076681806523,
            0.01,
            0.4798896504144996,
            1.379008574103742,
            -3.290069515436081,
            2.324710524099774,
        ),
    ),
    c_sol=(
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    ),
    c_error=(
        -0.00178001105222577714,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        0.015151515151515152,
    ),
    order=5,
    clip_steps=True,
)


def _build_dop853() -> ButcherTableau:
    """Hairer's DOP853 8(5,3) from scipy's published coefficient module:
    12 stages plus the FSAL stage f(t1, y1), so 12 evals a step; the 5th-
    and 3rd-order error rows combine into Hairer's stabilized norm, and
    steps clip onto the output times (the quartic dense output is far
    below the method's order)."""
    try:
        from scipy.integrate._ivp import dop853_coefficients as _d
    except (ImportError, AttributeError):  # scipy absent or module moved
        raise ValueError(
            "method 'dop853' requires scipy (its coefficients are loaded "
            "from scipy.integrate); install scipy or use 'dopri5'"
        ) from None
    n = _d.N_STAGES  # 12
    alpha = tuple(float(c) for c in _d.C[1:n]) + (1.0,)
    beta = tuple(tuple(float(a) for a in _d.A[i][:i]) for i in range(1, n)) + (
        tuple(float(b) for b in _d.B),
    )
    return ButcherTableau(
        alpha=alpha,
        beta=beta,
        c_sol=tuple(float(b) for b in _d.B) + (0.0,),
        c_error=tuple(float(e) for e in _d.E5),
        c_error_low=tuple(float(e) for e in _d.E3),
        order=8,
        clip_steps=True,
        pi_beta_scale=0.2,  # Hairer's DOP853: expo1 = 1/8 - 0.2*beta
        pi_beta_default=0.0,  # his DOP853 BETA default (DOPRI5's is 0.04)
    )


_TABLEAUS = {
    "dopri5": DOPRI5,
    "tsit5": TSIT5,
    "bosh3": BOSH3,
    "fehlberg2": FEHLBERG2,
    "adaptive_heun": ADAPTIVE_HEUN,
}
ADAPTIVE_METHODS = tuple(_TABLEAUS) + ("dop853",)
# The JAX package's method -> tableau dict, of the tableaus built at import:
# 'dop853' is built from scipy at its first use (get_adaptive_tableau), so
# it is in ADAPTIVE_METHODS and not here.
# A copy: the lookup below caches 'dop853' into _TABLEAUS, not into this.
ADAPTIVE_TABLEAUS = dict(_TABLEAUS)


def get_adaptive_tableau(method: str) -> ButcherTableau:
    """Lookup; 'dop853' builds from scipy on its first use (and raises a
    ValueError naming scipy where it is absent)."""
    tab = _TABLEAUS.get(method)
    if tab is not None:
        return tab
    if method == "dop853":
        _TABLEAUS["dop853"] = tab = _build_dop853()
        return tab
    raise KeyError(method)
