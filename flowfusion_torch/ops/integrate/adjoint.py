"""Continuous-adjoint differentiation through the adaptive ODE solver.

Counterpart of the JAX package's ``ops/integrate/adjoint.py`` (a
``custom_vjp`` there, a ``torch.autograd.Function`` here): the O(1)-memory
method of Pontryagin / Chen et al. 2018.  The forward solve runs under
``no_grad`` and keeps only the outputs at ``ts``; the backward pass
integrates the augmented adjoint system

    d/dt [y, a_y, a_theta] = [f, -a_y^T df/dy, -a_y^T df/dtheta]

backwards through each output interval with the same adaptive solver,
adding the output cotangents at every requested time.  The vector-Jacobian
products come from ``torch.autograd.grad`` on the plain field (a kernel
launch has no autodiff rule); a parameter the field does not use gets a
zero cotangent.  Second derivatives work: the plain divergence estimators
are themselves forward-mode derivatives, and the VJP differentiates
through them.

``func(t, y, params)`` takes every differentiable tensor in ``params``.
A ``torch.autograd.Function`` gives no gradient to a tensor it was not
passed, so a caller passes what it wants gradients into (a conditioning
batch, standardization statistics) in ``params`` rather than closing
over it.  Output times are host floats: there is no gradient for ``ts``.

Failure surface: a solve that exhausts ``max_num_steps`` (forward or any
backward interval) poisons its outputs with NaN — silently finite wrong
gradients would be worse.  Both solves run with TF32 off.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._device import strict_fp32_matmul
from .adaptive import odeint_adaptive
from .tableaus import ADAPTIVE_METHODS

__all__ = ["odeint_adjoint"]


def _poison(leaves: Tuple[torch.Tensor, ...], succeeded: bool) -> Tuple[torch.Tensor, ...]:
    """NaN in place of a failed solve's outputs (stats do not cross the
    autograd boundary)."""
    return leaves if succeeded else tuple(torch.full_like(l, float("nan")) for l in leaves)


class _OdeintAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, ts, solve_kw, adjoint_kw, n_y, *tensors):
        y0, params = tensors[:n_y], tensors[n_y:]
        with torch.no_grad(), strict_fp32_matmul():
            ys, stats = odeint_adaptive(lambda t, y: func(t, y, params), y0, ts, **solve_kw)
        ys = _poison(ys, stats.succeeded)
        ctx.func, ctx.ts, ctx.adjoint_kw, ctx.n_y = func, ts, adjoint_kw, n_y
        ctx.save_for_backward(*ys, *params)
        return ys

    @staticmethod
    def backward(ctx, *g_ys):
        func, ts, n_y = ctx.func, ctx.ts, ctx.n_y
        saved = ctx.saved_tensors
        ys, params = saved[:n_y], saved[n_y:]
        n_p = len(params)

        def aug_dynamics(t, aug):
            y, a_y = aug[:n_y], aug[n_y:2 * n_y]
            with torch.enable_grad():
                y_ = tuple(l.detach().requires_grad_(True) for l in y)
                p_ = tuple(p.detach().requires_grad_(True) for p in params)
                out = func(t, y_, p_)
                out = (out,) if isinstance(out, torch.Tensor) else tuple(out)
                pairs = [(o, -a) for o, a in zip(out, a_y) if o.requires_grad]
                vjps = (None,) * (n_y + n_p)
                if pairs:
                    vjps = torch.autograd.grad(
                        [o for o, _ in pairs], y_ + p_, grad_outputs=[a for _, a in pairs],
                        allow_unused=True,
                    )
            vjps = tuple(torch.zeros_like(x) if v is None else v for v, x in zip(vjps, y_ + p_))
            return tuple(o.detach() for o in out) + vjps

        a_y = tuple(g[-1] for g in g_ys)
        a_p = tuple(torch.zeros_like(p) for p in params)
        # one adaptive solve an output interval, backwards, re-seeding the
        # state with the stored forward solution at the interval's right end
        with torch.no_grad(), strict_fp32_matmul():
            for i in range(len(ts) - 1, 0, -1):
                aug0 = tuple(y[i] for y in ys) + a_y + a_p
                aug_ys, bwd_stats = odeint_adaptive(aug_dynamics, aug0, [ts[i], ts[i - 1]], **ctx.adjoint_kw)
                last = _poison(tuple(l[-1] for l in aug_ys), bwd_stats.succeeded)
                a_y, a_p = last[n_y:2 * n_y], last[2 * n_y:]
                if i - 1 > 0:
                    a_y = tuple(a + g[i - 1] for a, g in zip(a_y, g_ys))
            # the cotangent of y0 also takes the (identity) term of ys[0]
            a_y0 = tuple(a + g[0] for a, g in zip(a_y, g_ys))
        return (None, None, None, None, None) + a_y0 + a_p


def odeint_adjoint(
    func: Callable[[torch.Tensor, Any, Tuple[torch.Tensor, ...]], Any],
    y0: Any,
    ts: Sequence[float],
    params: Sequence[torch.Tensor],
    *,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    options: Optional[dict] = None,
    adjoint_rtol: Optional[float] = None,
    adjoint_atol: Optional[float] = None,
):
    """Differentiable odeint: returns ``ys`` only (leaves with a leading
    axis of len(ts)), differentiable in ``y0`` and in every tensor of
    ``params``.  ``adjoint_rtol``/``adjoint_atol`` default to the forward
    solve's tolerances.
    """
    if method not in ADAPTIVE_METHODS:
        raise ValueError(
            f"odeint_adjoint is adaptive-only; method {method!r} is not one "
            f"of {sorted(ADAPTIVE_METHODS)} (fixed-step/multistep methods "
            "are differentiable directly by autograd — call odeint "
            "without adjoint instead)"
        )
    ts = tuple(float(t) for t in np.asarray(ts, np.float64))
    single = isinstance(y0, torch.Tensor)
    y_leaves = (y0,) if single else tuple(y0)
    solve_kw = dict(rtol=float(rtol), atol=float(atol), method=method, options=options)
    adjoint_kw = dict(
        rtol=float(adjoint_rtol if adjoint_rtol is not None else rtol),
        atol=float(adjoint_atol if adjoint_atol is not None else atol),
        method=method, options=options,
    )
    base = (lambda t, y, p: (func(t, y[0], p),)) if single else func
    ys = _OdeintAdjoint.apply(base, ts, solve_kw, adjoint_kw, len(y_leaves), *y_leaves, *params)
    return ys[0] if single else tuple(ys)
