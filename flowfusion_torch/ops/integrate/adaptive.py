"""Adaptive embedded Runge--Kutta ODE solver (batch-global stepping).

PyTorch counterpart of the JAX package's ``ops/integrate/adaptive.py``'s
``odeint_adaptive`` with the same torchdiffeq-0.2.x conventions:

  * mixed RMS error norm: for a tuple state, the max over state
    components of the RMS over all elements of that component, skipping
    empty components (one global accept/reject decision for the batch —
    it is integrated as one coupled system);
  * error scale ``atol + rtol * max(|y0|, |y1|)``, accept iff ratio <= 1;
  * I controller ``dt * clip(safety / ratio**(1/order), dfactor, ifactor)``
    with safety 0.9, ifactor 10, dfactor 0.2 and no shrink on accepted
    steps, or the Lund-stabilized PI controller
    (``options={"controller": "pi"}``);
  * the Hairer initial-step heuristic (d0/d1/d2), clamped to the span;
  * FSAL reuse of the last stage;
  * no clipping of steps onto output times: the solver overshoots and
    reads each output off the quartic dense interpolant (Shampine midpoint
    fit for dopri5);
  * ``min_step``/``max_step``/``max_num_steps``, and the time reflection
    for decreasing grids.

The loop runs on the host.  Time, step size and the controller's scalars
stay float32 tensors on the state's device — as in the JAX solver, so the
accept/reject decisions near ratio ~ 1 match it — and each attempted step
reads one pair of numbers (the error ratio and the new time) back to the
host: the accept decision is the loop's one synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .fixed import _tree_axpy, tree_leaves, tree_map
from .tableaus import ButcherTableau, get_adaptive_tableau

__all__ = ["odeint_adaptive", "SolverStats"]


class SolverStats(NamedTuple):
    """Counters describing the work an adaptive solve performed."""

    n_func_evals: int
    n_accepted: int
    n_rejected: int
    succeeded: bool  # False iff max_num_steps was exhausted


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


def _mixed_rms_norm(tree: Any) -> torch.Tensor:
    """Max over state components of per-component RMS (empty ones skipped:
    the mean of an empty tensor is NaN and would poison the norm)."""
    leaves = [l for l in tree_leaves(tree) if l.numel() > 0]
    return torch.max(torch.stack([_rms(l) for l in leaves]))


def _weighted_sum(trees: Sequence[Any], weights: Sequence[float], scale) -> Any:
    """scale * sum_i weights[i] * trees[i], skipping zero weights."""
    terms = [(w, t) for w, t in zip(weights, trees) if w != 0.0]

    def combine(*leaves):
        acc = terms[0][0] * leaves[0]
        for (w, _), leaf in zip(terms[1:], leaves[1:]):
            acc = acc + w * leaf
        return scale * acc

    return tree_map(combine, *[t for _, t in terms])


def _rk_step(func, t0, dt, y0, f0, tab: ButcherTableau):
    """One embedded FSAL RK step.  Returns (y1, f1, err, k_stages)."""
    k = [f0]
    for alpha_i, beta_row in zip(tab.alpha, tab.beta):
        yi = tree_map(torch.add, y0, _weighted_sum(k, beta_row, dt))
        k.append(func(t0 + alpha_i * dt, yi))
    # FSAL: the last stage was evaluated at (t1, y1)
    err = _weighted_sum(k, tab.c_error, dt)
    return yi, k[-1], err, k


def _error_ratio(err, y0, y1, rtol, atol, norm):
    def scaled(e, a, b):
        return e / (atol + rtol * torch.maximum(a.abs(), b.abs()))

    return norm(tree_map(scaled, err, y0, y1))


def _interp_fit(y0, y1, y_mid, f0, f1, dt):
    """Quartic through (y0, y_mid, y1) with end slopes (f0, f1):
    coefficients of e + d x + c x^2 + b x^3 + a x^4 on x = (t-t0)/dt."""

    def fit(y0_, y1_, ym_, f0_, f1_):
        a = 2.0 * dt * (f1_ - f0_) - 8.0 * (y1_ + y0_) + 16.0 * ym_
        b = dt * (5.0 * f0_ - 3.0 * f1_) + 18.0 * y0_ + 14.0 * y1_ - 32.0 * ym_
        c = dt * (f1_ - 4.0 * f0_) - 11.0 * y0_ - 5.0 * y1_ + 16.0 * ym_
        d = dt * f0_
        return (y0_, d, c, b, a)

    return tree_map(fit, y0, y1, y_mid, f0, f1)


def _interp_eval(coeffs, t0, t1, t):
    """Evaluate the fitted polynomial (Horner) at time t in [t0, t1]."""
    x = (t - t0) / (t1 - t0)

    def horner(cs):
        acc = cs[4]
        for i in (3, 2, 1, 0):
            acc = acc * x + cs[i]
        return acc

    if isinstance(coeffs[0], torch.Tensor):  # single-tensor state
        return horner(coeffs)
    return tuple(horner(cs) for cs in coeffs)


def _select_initial_step(func, t0, y0, f0, order, rtol, atol, norm, span):
    """Hairer, Norsett & Wanner (1993) starting step, clamped to the span;
    a NaN probe derivative falls back to the d1-only estimate."""
    scale = tree_map(lambda y: atol + y.abs() * rtol, y0)
    d0 = norm(tree_map(torch.div, y0, scale))
    d1 = norm(tree_map(torch.div, f0, scale))
    h0 = torch.where(
        (d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6), 0.01 * d0 / d1
    ).clamp(max=span)

    f1 = func(t0 + h0, _tree_axpy(y0, h0, f0))
    d2 = norm(tree_map(lambda a, b, s: (a - b) / s, f1, f0, scale)) / h0
    d2 = torch.where(torch.isfinite(d2), d2, d1)

    h1 = torch.where(
        (d1 <= 1e-15) & (d2 <= 1e-15),
        (h0 * 1e-3).clamp(min=1e-6),
        (0.01 / torch.maximum(d1, d2)) ** (1.0 / float(order + 1)),
    )
    dt0 = torch.minimum(100.0 * h0, h1)
    dt0 = torch.where(torch.isfinite(dt0), dt0, torch.full_like(dt0, 1e-6))
    return dt0.clamp(max=span)


def _optimal_step_size(last_step, error_ratio, safety, ifactor, dfactor, order):
    """torchdiffeq's I controller (never shrink an accepted step); a
    non-finite ratio shrinks by ``dfactor`` instead of poisoning dt."""
    dfac = torch.where(
        error_ratio < 1.0, torch.ones_like(error_ratio), torch.full_like(error_ratio, dfactor)
    )
    factor = torch.minimum(
        torch.full_like(error_ratio, ifactor),
        torch.maximum(safety / error_ratio ** (1.0 / order), dfac),
    )
    factor = torch.where(torch.isfinite(factor), factor, torch.full_like(factor, dfactor))
    return torch.where(error_ratio == 0.0, last_step * ifactor, last_step * factor)


def _pi_step_size(
    last_step, error_ratio, prev_ratio, prev_rejected: bool, accept,
    safety, ifactor, dfactor, order, beta, beta_scale,
):
    """Lund-stabilized PI controller (Hairer, Norsett & Wanner II.4):
    growth ``safety * prev_ratio**beta / ratio**(1/order - bs*beta)``,
    capped at 1 right after a rejection; a rejection only shrinks."""
    fac11 = error_ratio ** (1.0 / order - beta_scale * beta)
    grow_cap = 1.0 if prev_rejected else ifactor
    f_acc = torch.clamp(safety * prev_ratio**beta / fac11, dfactor, grow_cap)
    f_rej = torch.clamp(safety / fac11, dfactor, 1.0)
    factor = torch.where(accept, f_acc, f_rej)
    factor = torch.where(torch.isfinite(factor), factor, torch.full_like(factor, dfactor))
    factor = torch.where(error_ratio == 0.0, torch.full_like(factor, grow_cap), factor)
    return last_step * factor


@dataclasses.dataclass(frozen=True)
class _AdaptiveOptions:
    rtol: float
    atol: float
    safety: float = 0.9
    ifactor: float = 10.0
    dfactor: float = 0.2
    min_step: float = 0.0
    max_step: float = float("inf")
    max_num_steps: int = 2**14
    controller: str = "i"  # "i" (torchdiffeq-identical) | "pi" (Lund-stabilized)
    beta: Optional[float] = None  # PI weight; None -> the method's Hairer default


def _parse_options(rtol, atol, options) -> _AdaptiveOptions:
    opts = dict(options or {})
    cfg = _AdaptiveOptions(
        rtol=float(rtol),
        atol=float(atol),
        safety=float(opts.pop("safety", _AdaptiveOptions.safety)),
        ifactor=float(opts.pop("ifactor", _AdaptiveOptions.ifactor)),
        dfactor=float(opts.pop("dfactor", _AdaptiveOptions.dfactor)),
        min_step=float(opts.pop("min_step", _AdaptiveOptions.min_step)),
        max_step=float(opts.pop("max_step", _AdaptiveOptions.max_step)),
        max_num_steps=int(opts.pop("max_num_steps", _AdaptiveOptions.max_num_steps)),
        controller=str(opts.pop("controller", _AdaptiveOptions.controller)),
        beta=(lambda b: None if b is None else float(b))(opts.pop("beta", None)),
    )
    if cfg.controller not in ("i", "pi"):
        raise ValueError(f"unknown controller {cfg.controller!r}; use 'i' or 'pi'")
    if cfg.beta is not None and cfg.controller != "pi":
        raise ValueError(
            "options={'beta': ...} is the PI controller's damping weight; "
            "pass options={'controller': 'pi', 'beta': ...}"
        )
    if opts:
        raise ValueError(f"unknown solver options: {sorted(opts)}")
    return cfg


def odeint_adaptive(
    func: Callable[[torch.Tensor, Any], Any],
    y0: Any,
    ts: Sequence[float] | np.ndarray,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    options: Optional[dict] = None,
    norm: Callable[[Any], torch.Tensor] = _mixed_rms_norm,
):
    """Integrate ``dy/dt = func(t, y)`` from ts[0] through each time in ts.

    ``y0`` is a tensor or a tuple of tensors; ``func`` gets ``t`` as a
    float32 0-d tensor on the state's device.  ``ts`` are host values,
    strictly monotonic.  Returns ``(ys, stats)``: leaves with a leading
    axis of ``len(ts)`` (ys[0] == y0) and a ``SolverStats``.
    """
    tab = get_adaptive_tableau(method)
    cfg = _parse_options(rtol, atol, options)

    ts = np.asarray(ts, np.float64)
    if ts.ndim != 1 or len(ts) < 2:
        raise ValueError("ts must be a 1-D grid with at least two times")
    diffs = np.diff(ts)
    if np.all(diffs < 0):
        base = func
        func = lambda t, y: tree_map(torch.neg, base(-t, y))  # noqa: E731
        ts = -ts
    elif not np.all(diffs > 0):
        raise ValueError("ts must be strictly monotonic")

    device = tree_leaves(y0)[0].device
    ts32 = ts.astype(np.float32)
    ts_dev = torch.as_tensor(ts32, device=device)

    t1 = ts_dev[0]
    f = func(t1, y0)
    dt = _select_initial_step(
        func, t1, y0, f, tab.order - 1, cfg.rtol, cfg.atol, norm, float(ts[-1] - ts[0])
    )
    y = y0
    t_prev = t1
    t1_host = float(ts32[0])
    nfe = 2  # f0 + the probe eval of the initial-step heuristic
    n_acc = n_rej = steps = 0
    prev_ratio = torch.tensor(1e-4, dtype=torch.float32, device=device)  # FACOLD
    prev_rejected = False
    last_accepted = None  # (y0, y1, y_mid, f0, f1, dt) of the last accepted step
    beta = cfg.beta if cfg.beta is not None else tab.pi_beta_default
    evals_per_step = tab.n_stages - 1  # FSAL

    outs = [y0]
    for i in range(1, len(ts32)):
        target_host = float(ts32[i])
        while t1_host < target_host and steps < cfg.max_num_steps:
            dt_c = dt.clamp(cfg.min_step, cfg.max_step)
            t_new = t1 + dt_c
            y1, f1, err, k = _rk_step(func, t1, dt_c, y, f, tab)
            ratio = _error_ratio(err, y, y1, cfg.rtol, cfg.atol, norm)
            if cfg.controller == "pi":
                dt = _pi_step_size(
                    dt_c, ratio, prev_ratio, prev_rejected, ratio <= 1.0,
                    cfg.safety, cfg.ifactor, cfg.dfactor, tab.order, beta,
                    tab.pi_beta_scale,
                )
            else:
                dt = _optimal_step_size(
                    dt_c, ratio, cfg.safety, cfg.ifactor, cfg.dfactor, tab.order
                )
            # the one host synchronisation of the attempt
            ratio_host, t_new_host = torch.stack([ratio, t_new]).tolist()
            accept = ratio_host <= 1.0  # False for a NaN ratio
            if accept:
                y_mid = tree_map(torch.add, y, _weighted_sum(k, tab.c_mid, dt_c))
                last_accepted = (y, y1, y_mid, f, f1, dt_c)
                t_prev, t1, t1_host = t1, t_new, t_new_host
                y, f = y1, f1
                prev_ratio = ratio.clamp(min=1e-4)
                n_acc += 1
            else:
                n_rej += 1
            prev_rejected = not accept
            nfe += evals_per_step
            steps += 1
        if n_acc > 0:
            # read the output off the dense interpolant of the last
            # accepted step (the solver overshot the target)
            outs.append(_interp_eval(_interp_fit(*last_accepted), t_prev, t1, ts_dev[i]))
        else:
            # nothing accepted (e.g. a NaN-poisoned RHS): no interpolant
            outs.append(y)

    if isinstance(y0, torch.Tensor):
        ys = torch.stack(outs)
    else:
        ys = tuple(torch.stack([o[j] for o in outs]) for j in range(len(y0)))
    stats = SolverStats(
        n_func_evals=nfe,
        n_accepted=n_acc,
        n_rejected=n_rej,
        succeeded=t1_host >= float(ts32[-1]),
    )
    return ys, stats
