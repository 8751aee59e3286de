"""Adaptive embedded Runge--Kutta ODE solvers: batch-global stepping
(``odeint_adaptive``) and per-sample stepping (``odeint_per_sample``).

PyTorch counterpart of the JAX package's ``ops/integrate/adaptive.py``
with the same torchdiffeq-0.2.x conventions:

  * mixed RMS error norm: for a tuple state, the max over state
    components of the RMS over all elements of that component, skipping
    empty components (one global accept/reject decision for the batch —
    it is integrated as one coupled system);
  * error scale ``atol + rtol * max(|y0|, |y1|)``, accept iff ratio <= 1;
    dop853 combines its 5th- and 3rd-order estimates into Hairer's
    stabilized norm;
  * I controller ``dt * clip(safety / ratio**(1/order), dfactor, ifactor)``
    with safety 0.9, ifactor 10, dfactor 0.2 and no shrink on accepted
    steps, or the Lund-stabilized PI controller
    (``options={"controller": "pi"}``);
  * the Hairer initial-step heuristic (d0/d1/d2), clamped to the span;
  * reuse of the last stage as the next step's derivative wherever it
    lands at t1 (FSAL pairs, and adaptive_heun / fehlberg2 as torchdiffeq
    does), so an attempt costs ``tab.evals_per_step`` evaluations;
  * the solver overshoots and reads each output off the quartic dense
    interpolant (Shampine midpoint for dopri5, cubic Hermite otherwise);
    tableaus with ``clip_steps`` (tsit5, dop853) land exactly on each
    output time instead, the landing time assigned, not accumulated;
  * ``min_step``/``max_step``/``max_num_steps``, and the time reflection
    for decreasing grids.

The loops run on the host.  Time, step size and the controller's scalars
stay float32 tensors on the state's device — as in the JAX solver, so the
accept/reject decisions near ratio ~ 1 match it.  ``odeint_adaptive``
reads one pair of numbers (the error ratio and the new time) back to the
host an attempt; ``odeint_per_sample`` reads the set of unfinished rows.
``odeint_adaptive_traced`` is the batch-global solve as one ``while_loop``
an output interval, the form ``torch.export`` traces (``utils.serving``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch._higher_order_ops.while_loop import while_loop, while_loop_op

from ...parallel import _collective
from .fixed import tree_leaves, tree_map
from .tableaus import ButcherTableau, get_adaptive_tableau

__all__ = ["odeint_adaptive", "odeint_adaptive_traced", "odeint_per_sample", "SolverStats"]


class SolverStats(NamedTuple):
    """Counters describing the work an adaptive solve performed: ints for
    a batch-global solve, (B,) tensors for a per-sample one."""

    n_func_evals: Any
    n_accepted: Any
    n_rejected: Any
    succeeded: Any  # False iff max_num_steps was exhausted


def _per_row(s, leaf: torch.Tensor):
    """A per-row scalar (B,) shaped to broadcast against ``leaf`` (B, ...);
    a 0-d tensor or a float passes through."""
    if isinstance(s, torch.Tensor) and s.ndim == 1:
        return s.reshape(s.shape + (1,) * (leaf.ndim - 1))
    return s


def _axpy(y: Any, scale, x: Any) -> Any:
    """y + scale * x, leafwise (``scale`` a scalar or per row)."""
    return tree_map(lambda a, b: a + _per_row(scale, a) * b, y, x)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


def _mixed_rms_norm(tree: Any) -> torch.Tensor:
    """Max over state components of per-component RMS (empty ones skipped:
    the mean of an empty tensor is NaN and would poison the norm).  Inside
    ``parallel.data_parallel`` the RMS runs over the rows of every process
    of the group: one all-reduce of the squares and the counts, so every
    process takes the same batch-global accept/reject decision."""
    group = _collective.active_group()
    if group is not None:
        ms = [m for m in _collective.mean_squares(tree_leaves(tree), group) if m is not None]
        return torch.max(torch.stack([torch.sqrt(m) for m in ms]))
    leaves = [l for l in tree_leaves(tree) if l.numel() > 0]
    return torch.max(torch.stack([_rms(l) for l in leaves]))


def _row_mixed_rms_norm(tree: Any) -> torch.Tensor:
    """The mixed RMS norm of each row, (B,): the max over state components
    of the RMS over that row's own elements of the component (components
    with no element a row skipped)."""
    leaves = [l for l in tree_leaves(tree) if l[0].numel() > 0]
    rms = [torch.sqrt(torch.mean(torch.square(l.reshape(l.shape[0], -1)), dim=1)) for l in leaves]
    return torch.max(torch.stack(rms), dim=0).values


def _weighted_sum(trees: Sequence[Any], weights: Sequence[float], scale) -> Any:
    """scale * sum_i weights[i] * trees[i], skipping zero weights."""
    terms = [(w, t) for w, t in zip(weights, trees) if w != 0.0]
    if not terms:
        return tree_map(torch.zeros_like, trees[0])

    def combine(*leaves):
        acc = terms[0][0] * leaves[0]
        for (w, _), leaf in zip(terms[1:], leaves[1:]):
            acc = acc + w * leaf
        return _per_row(scale, acc) * acc

    return tree_map(combine, *[t for _, t in terms])


def _rk_step(func, t0, dt, y0, f0, tab: ButcherTableau):
    """One embedded RK step.  Returns (y1, f1, err, err_low, k_stages);
    ``err_low`` is dop853's secondary estimate, else None."""
    k = [f0]
    for alpha_i, beta_row in zip(tab.alpha, tab.beta):
        yi = tree_map(torch.add, y0, _weighted_sum(k, beta_row, dt))
        k.append(func(t0 + alpha_i * dt, yi))
    if tab.is_fsal:
        # the last stage was evaluated at (t1, y1)
        y1, f1 = yi, k[-1]
    else:
        y1 = tree_map(torch.add, y0, _weighted_sum(k, tab.c_sol, dt))
        # torchdiffeq's ``f1 = k[..., -1]``: a final stage that lands at t1
        # (on the pair's predictor, not y1) seeds the next step anyway
        f1 = k[-1] if tab.reuses_last_stage else func(t0 + dt, y1)
    err = _weighted_sum(k, tab.c_error, dt)
    err_low = _weighted_sum(k, tab.c_error_low, dt) if tab.c_error_low is not None else None
    return y1, f1, err, err_low, k


def _error_ratio(err, y0, y1, rtol, atol, norm):
    def scaled(e, a, b):
        return e / (atol + rtol * torch.maximum(a.abs(), b.abs()))

    return norm(tree_map(scaled, err, y0, y1))


def _error_ratio_dual(err5, err3, y0, y1, rtol, atol, norm):
    """Hairer's DOP853 stabilized norm ``r5^2 / sqrt(r5^2 + 0.01 r3^2)``
    on the tolerance-scaled estimates; a non-finite estimate gives a NaN
    ratio, so the step is rejected (not silently accepted through the
    zero-denominator branch)."""
    r5 = _error_ratio(err5, y0, y1, rtol, atol, norm)
    r3 = _error_ratio(err3, y0, y1, rtol, atol, norm)
    denom = torch.sqrt(r5 * r5 + 0.01 * r3 * r3)
    pos = denom > 0.0
    safe = torch.where(pos, r5 * r5 / torch.where(pos, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    finite = torch.isfinite(r5) & torch.isfinite(r3)
    return torch.where(finite, safe, torch.full_like(safe, float("nan")))


def _step_ratio(tab, err, err_low, y0, y1, cfg, norm):
    if err_low is not None:
        return _error_ratio_dual(err, err_low, y0, y1, cfg.rtol, cfg.atol, norm)
    return _error_ratio(err, y0, y1, cfg.rtol, cfg.atol, norm)


def _interp_fit(y0, y1, y_mid, f0, f1, dt):
    """Quartic through (y0, y_mid, y1) with end slopes (f0, f1):
    coefficients of e + d x + c x^2 + b x^3 + a x^4 on x = (t-t0)/dt."""

    def fit(y0_, y1_, ym_, f0_, f1_):
        h = _per_row(dt, y0_)
        a = 2.0 * h * (f1_ - f0_) - 8.0 * (y1_ + y0_) + 16.0 * ym_
        b = h * (5.0 * f0_ - 3.0 * f1_) + 18.0 * y0_ + 14.0 * y1_ - 32.0 * ym_
        c = h * (f1_ - 4.0 * f0_) - 11.0 * y0_ - 5.0 * y1_ + 16.0 * ym_
        d = h * f0_
        return (y0_, d, c, b, a)

    return tree_map(fit, y0, y1, y_mid, f0, f1)


def _dense_fit(tab, y0, y1, f0, f1, k, dt):
    """The dense interpolant of an accepted step: the tableau's midpoint
    row where it has one, else the cubic Hermite midpoint."""
    if tab.c_mid is not None:
        y_mid = tree_map(torch.add, y0, _weighted_sum(k, tab.c_mid, dt))
    else:
        y_mid = tree_map(
            lambda a, b, fa, fb: 0.5 * (a + b) + 0.125 * _per_row(dt, a) * (fa - fb), y0, y1, f0, f1
        )
    return _interp_fit(y0, y1, y_mid, f0, f1, dt)


def _interp_eval(coeffs, t0, t1, t):
    """Evaluate the fitted polynomial (Horner) at time t in [t0, t1]."""
    x = (t - t0) / (t1 - t0)

    def horner(cs):
        xr = _per_row(x, cs[0])
        acc = cs[4]
        for i in (3, 2, 1, 0):
            acc = acc * xr + cs[i]
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

    f1 = func(t0 + h0, _axpy(y0, h0, f0))
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
    last_step, error_ratio, prev_ratio, prev_rejected, accept,
    safety, ifactor, dfactor, order, beta, beta_scale,
):
    """Lund-stabilized PI controller (Hairer, Norsett & Wanner II.4):
    growth ``safety * prev_ratio**beta / ratio**(1/order - bs*beta)``,
    capped at 1 right after a rejection (``prev_rejected``: a bool, or a
    bool tensor per row); a rejection only shrinks."""
    fac11 = error_ratio ** (1.0 / order - beta_scale * beta)
    rej = torch.as_tensor(prev_rejected, device=error_ratio.device)
    grow_cap = torch.where(rej, torch.ones_like(error_ratio), torch.full_like(error_ratio, ifactor))
    f_acc = torch.minimum(torch.clamp(safety * prev_ratio**beta / fac11, min=dfactor), grow_cap)
    f_rej = torch.clamp(safety / fac11, dfactor, 1.0)
    factor = torch.where(accept, f_acc, f_rej)
    factor = torch.where(torch.isfinite(factor), factor, torch.full_like(factor, dfactor))
    factor = torch.where(error_ratio == 0.0, grow_cap, factor)
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


def _prepare(func, ts, rtol, atol, method, options):
    """(tableau, options, func, ts) with a decreasing grid reflected."""
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
    return tab, cfg, func, ts


def _attempt(func, tab, cfg, norm, t1, dt, y, f, target, prev_ratio, prev_rejected):
    """One attempted step from (t1, y, f) with proposal ``dt`` towards
    ``target`` (scalars, or (B,) per row).  Returns (accept, t_new, y1, f1,
    coeffs, dt_next, ratio); ``coeffs`` is None for clipped methods (the
    output is read off the state) and when not ``dense``."""
    dt_c = dt.clamp(cfg.min_step, cfg.max_step)
    if tab.clip_steps:
        landed = t1 + dt_c >= target
        t_new = torch.where(landed, target, t1 + dt_c)
        dt_c = t_new - t1
    else:
        t_new = t1 + dt_c
    y1, f1, err, err_low, k = _rk_step(func, t1, dt_c, y, f, tab)
    ratio = _step_ratio(tab, err, err_low, y, y1, cfg, norm)
    accept = ratio <= 1.0
    if cfg.controller == "pi":
        beta = cfg.beta if cfg.beta is not None else tab.pi_beta_default
        dt_next = _pi_step_size(
            dt_c, ratio, prev_ratio, prev_rejected, accept, cfg.safety, cfg.ifactor,
            cfg.dfactor, tab.order, beta, tab.pi_beta_scale,
        )
    else:
        dt_next = _optimal_step_size(dt_c, ratio, cfg.safety, cfg.ifactor, cfg.dfactor, tab.order)
    if tab.clip_steps:
        # a clipped step's error says nothing about the natural step scale:
        # after an accepted landing keep the larger of the controller's
        # proposal and the pre-clip dt
        dt_next = torch.where(landed & accept, torch.maximum(dt_next, dt), dt_next)
    coeffs = None if tab.clip_steps else (lambda: _dense_fit(tab, y, y1, f, f1, k, dt_c))
    return accept, t_new, y1, f1, coeffs, dt_next, ratio


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
    axis of ``len(ts)`` (ys[0] == y0) and a ``SolverStats``.  Inside
    ``torch.export`` the solve is :func:`odeint_adaptive_traced`, the same
    arithmetic as one ``while_loop``, and its stats are tensors.
    """
    if torch.compiler.is_exporting():
        return odeint_adaptive_traced(func, y0, ts, rtol=rtol, atol=atol, method=method, options=options,
                                      norm=norm)
    tab, cfg, func, ts = _prepare(func, ts, rtol, atol, method, options)
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
    coeffs = None  # dense output of the last accepted step

    outs = [y0]
    for i in range(1, len(ts32)):
        target_host = float(ts32[i])
        while t1_host < target_host and steps < cfg.max_num_steps:
            accept, t_new, y1, f1, fit, dt, ratio = _attempt(
                func, tab, cfg, norm, t1, dt, y, f, ts_dev[i], prev_ratio, prev_rejected
            )
            # the one host synchronisation of the attempt
            ratio_host, t_new_host = torch.stack([ratio, t_new]).tolist()
            accepted = ratio_host <= 1.0  # False for a NaN ratio
            if accepted:
                if fit is not None:
                    coeffs = fit()
                t_prev, t1, t1_host = t1, t_new, t_new_host
                y, f = y1, f1
                prev_ratio = ratio.clamp(min=1e-4)
                n_acc += 1
            else:
                n_rej += 1
            prev_rejected = not accepted
            nfe += tab.evals_per_step
            steps += 1
        if tab.clip_steps or n_acc == 0:
            # landed exactly on the target by assignment, or nothing was
            # accepted (e.g. a NaN-poisoned RHS): no interpolant
            outs.append(y)
        else:
            # read the output off the dense interpolant of the last
            # accepted step (the solver overshot the target)
            outs.append(_interp_eval(coeffs, t_prev, t1, ts_dev[i]))

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


def _while(cond, body, carried: tuple) -> tuple:
    """``torch._higher_order_ops.while_loop``: captured as one graph node
    inside ``torch.export`` (the body traced once, the tensors it captures
    lifted to inputs); outside it, the operator's own loop, which reads
    the condition on the host once an iteration."""
    if torch.compiler.is_exporting():
        return while_loop(cond, body, carried)
    return while_loop_op(cond, body, carried, ())


def odeint_adaptive_traced(
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
    """:func:`odeint_adaptive` in a form ``torch.export`` can trace: each
    output interval is one ``while_loop`` over :func:`_attempt`, with the
    host loop's arithmetic.  The loop carries as tensors what the host
    loop keeps in Python: the time ``t1`` and the last accepted step's
    start ``t_prev``, the proposal ``dt``, the state and its derivative,
    the PI controller's memory, the counts and the dense-output
    coefficients of the last accepted step.  An attempt takes accept or
    reject with ``torch.where``; an interval ends when ``t1`` reaches its
    time or ``max_num_steps`` attempts are spent, and its output is read
    off the interpolant as the host loop reads it.  Eagerly the loop
    reads its condition once an attempt, the host loop's one sync.

    Returns ``(ys, stats)`` as :func:`odeint_adaptive` does, the stats as
    0-d tensors.  The fixed-step and multistep methods trace as they are
    written (their step counts are known on the host)."""
    tab, cfg, func, ts = _prepare(func, ts, rtol, atol, method, options)
    single = isinstance(y0, torch.Tensor)
    leaves0 = tuple(tree_leaves(y0))
    n = len(leaves0)
    device = leaves0[0].device
    ts32 = ts.astype(np.float32)
    ts_dev = torch.as_tensor(ts32, device=device)

    def tree(leaves):
        return leaves[0] if single else tuple(leaves)

    t1 = ts_dev[0]
    f0 = tuple(tree_leaves(func(t1, y0)))
    dt = _select_initial_step(
        func, t1, y0, tree(f0), tab.order - 1, cfg.rtol, cfg.atol, norm, float(ts[-1] - ts[0])
    )
    zero_i = torch.zeros((), dtype=torch.int32, device=device)
    # (t1, t_prev, dt, prev_ratio, prev_rejected, n_acc, n_rej, steps, y.., f.., coeffs..): the
    # dense-output coefficients, five a leaf, where the tableau interpolates
    n_coeffs = 0 if tab.clip_steps else 5 * n
    carried = (
        t1.clone(), t1.clone(), dt, torch.full((), 1e-4, dtype=torch.float32, device=device),  # FACOLD
        torch.zeros((), dtype=torch.bool, device=device), zero_i, zero_i.clone(), zero_i.clone(),
        *(l.clone() for l in leaves0), *f0, *(torch.zeros_like(l) for l in leaves0 for _ in range(n_coeffs // n)),
    )

    outs = [y0]
    for i in range(1, len(ts32)):
        target = ts_dev[i]

        def cond(t1, t_prev, dt, prev_ratio, prev_rejected, n_acc, n_rej, steps, *rest):
            return (t1 < target) & (steps < cfg.max_num_steps)

        def body(t1, t_prev, dt, prev_ratio, prev_rejected, n_acc, n_rej, steps, *rest):
            y, f, coeffs = rest[:n], rest[n:2 * n], rest[2 * n:]
            accept, t_new, y1, f1, fit, dt_next, ratio = _attempt(
                func, tab, cfg, norm, t1, dt, tree(y), tree(f), target, prev_ratio, prev_rejected
            )

            def pick(new, old):
                return torch.where(accept, new, old)

            if fit is not None:
                fitted = fit()
                fitted = (fitted,) if single else fitted
                coeffs = tuple(pick(c, old) for c, old in zip((c for cs in fitted for c in cs), coeffs))
            # the loop's outputs may not alias its inputs: torch.where and
            # arithmetic make new tensors, dt_next is cloned
            return (
                pick(t_new, t1), pick(t1, t_prev), dt_next.clone(), pick(ratio.clamp(min=1e-4), prev_ratio),
                ~accept, n_acc + accept.to(torch.int32), n_rej + (~accept).to(torch.int32), steps + 1,
                *(pick(a, b) for a, b in zip(tree_leaves(y1), y)),
                *(pick(a, b) for a, b in zip(tree_leaves(f1), f)),
                *coeffs,
            )

        carried = tuple(_while(cond, body, carried))
        t1, t_prev, n_acc = carried[0], carried[1], carried[5]
        y, coeffs = carried[8:8 + n], carried[8 + 2 * n:]
        if tab.clip_steps:
            # landed exactly on the target by assignment: no interpolant
            outs.append(tree(y))
        else:
            # the dense interpolant of the last accepted step (the solver
            # overshot the target); the state where nothing was accepted
            # (e.g. a NaN-poisoned RHS)
            dense = [_interp_eval(coeffs[5 * j:5 * j + 5], t_prev, t1, target) for j in range(n)]
            outs.append(tree([torch.where(n_acc > 0, d, l) for d, l in zip(dense, y)]))

    if single:
        ys = torch.stack(outs)
    else:
        ys = tuple(torch.stack([o[j] for o in outs]) for j in range(n))
    stats = SolverStats(
        n_func_evals=2 + tab.evals_per_step * carried[7],
        n_accepted=carried[5],
        n_rejected=carried[6],
        succeeded=carried[0] >= ts_dev[-1],
    )
    return ys, stats


def odeint_per_sample(
    func: Callable[[torch.Tensor, Any], Any],
    y0: Any,
    ts: Sequence[float] | np.ndarray,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    options: Optional[dict] = None,
):
    """Per-sample adaptive stepping: every batch row gets its own step
    sequence, error norm (the mixed RMS over that row's own elements of
    each component), controller memory and ``SolverStats``, as the JAX
    package's vmapped solve gives it.

    ``func(t, y)`` is the batched RHS with ``t`` a (n,) float32 time a row;
    every leaf of ``y0`` has the batch as its leading axis.  The rows
    advance in lock step on one host loop, compacted to the active rows:
    an attempt gathers the rows that have not reached the current output
    time, evaluates the RHS on those rows only and scatters them back, so
    a row's NFE counts only while it is active.  Reading the rows still
    unfinished is the attempt's one host synchronisation.  Returns
    ``(ys, stats)`` with leaves (B, len(ts), ...) and per-row (B,) stats.
    """
    single = isinstance(y0, torch.Tensor)
    fn = (lambda t, y: (func(t, y[0]),)) if single else func
    tab, cfg, fn, ts = _prepare(fn, ts, rtol, atol, method, options)
    y = tuple(tree_leaves(y0))
    B, device = y[0].shape[0], y[0].device
    ts32 = ts.astype(np.float32)
    ts_dev = torch.as_tensor(ts32, device=device)

    t1 = ts_dev[0].expand(B).clone()
    f = tuple(fn(t1, y))
    dt = _select_initial_step(
        fn, t1, y, f, tab.order - 1, cfg.rtol, cfg.atol, _row_mixed_rms_norm, float(ts[-1] - ts[0])
    )
    t0 = t1.clone()
    y = tuple(l.clone() for l in y)
    coeffs = tuple(tuple(torch.zeros_like(l) for _ in range(5)) for l in y)
    zeros_i = torch.zeros(B, dtype=torch.int32, device=device)
    nfe, n_acc, n_rej, steps = zeros_i + 2, zeros_i.clone(), zeros_i.clone(), zeros_i.clone()
    prev_ratio = torch.full((B,), 1e-4, dtype=torch.float32, device=device)  # FACOLD
    prev_rejected = torch.zeros(B, dtype=torch.bool, device=device)

    def take(tree, idx):
        return tuple(l[idx] for l in tree)

    def put(tree, idx, accept, new):
        for l, n in zip(tree, new):
            l[idx] = torch.where(_per_row(accept, n), n, l[idx])

    outs = [tuple(l.clone() for l in y)]
    for i in range(1, len(ts32)):
        target = ts_dev[i]
        idx = torch.nonzero((t1 < target) & (steps < cfg.max_num_steps)).squeeze(1)
        while idx.numel() > 0:
            ya, fa = take(y, idx), take(f, idx)
            accept, t_new, y1, f1, fit, dt_next, ratio = _attempt(
                fn, tab, cfg, _row_mixed_rms_norm, t1[idx], dt[idx], ya, fa, target,
                prev_ratio[idx], prev_rejected[idx],
            )
            if fit is not None:
                for cs, new in zip(coeffs, fit()):
                    put(cs, idx, accept, new)
            t0[idx] = torch.where(accept, t1[idx], t0[idx])
            t1[idx] = torch.where(accept, t_new, t1[idx])
            dt[idx] = dt_next
            put(y, idx, accept, y1)
            put(f, idx, accept, f1)
            nfe[idx] += tab.evals_per_step
            n_acc[idx] += accept.to(torch.int32)
            n_rej[idx] += (~accept).to(torch.int32)
            prev_ratio[idx] = torch.where(accept, ratio.clamp(min=1e-4), prev_ratio[idx])
            prev_rejected[idx] = ~accept
            steps[idx] += 1
            # the one host synchronisation of the attempt
            idx = idx[(t1[idx] < target) & (steps[idx] < cfg.max_num_steps)]
        if tab.clip_steps:
            outs.append(tuple(l.clone() for l in y))
        else:
            dense = _interp_eval(coeffs, t0, t1, target)
            outs.append(tuple(torch.where(_per_row(n_acc > 0, d), d, l) for d, l in zip(dense, y)))

    ys = tuple(torch.stack([o[j] for o in outs], dim=1) for j in range(len(y)))
    stats = SolverStats(
        n_func_evals=nfe, n_accepted=n_acc, n_rejected=n_rej, succeeded=t1 >= ts_dev[-1]
    )
    return (ys[0] if single else ys), stats
