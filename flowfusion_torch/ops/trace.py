"""Jacobian-trace (divergence) estimators for CNF log-likelihoods.

PyTorch counterpart of the JAX package's ``ops/trace.py``, on
``torch.func.jvp``:

  * ``exact``      — D forward-mode JVP columns with the basis tangents
    e_d: div = sum_d [J e_d]_d (the RHS acts row-wise, so the batched
    Jacobian is block-diagonal);
  * ``hutchinson`` — e^T J e with a fixed probe, one JVP;
  * ``hutchpp``    — Hutch++: a low-rank QR sketch plus a residual
    Hutchinson term, the sketch construction detached;
  * ``xtrace``     — the XTrace leave-one-out estimator (Epperly, Tropp &
    Webber 2023).

The sketch estimators apply A = J through one JVP per column and run their
small per-row algebra with the batch in the last axis: a "column" is a
(D, B) tensor and a matrix "entry" a (B,) tensor, unrolled over the small
D and probe counts.  The layout and the order of every step follow the JAX
package term by term, and so does the fused sketch kernel's plain version
(``kernels/fused_sketch.py``), which calls these functions.

Probes are drawn once per solve and held fixed across every RHS
evaluation; they are explicit arguments, so tests hand the same numpy
probes to both packages.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.autograd.forward_ad as fwAD
from torch.func import jvp

__all__ = [
    "rademacher",
    "exact_divergence",
    "hutchinson_divergence",
    "hutchpp_divergence",
    "hutchpp_core",
    "xtrace_divergence",
    "xtrace_core",
    "divergence_fn",
    "make_probes",
    "probe_counts",
]

Cols = List[torch.Tensor]


def rademacher(
    generator: Optional[torch.Generator], shape, dtype=torch.float32, device=None
) -> torch.Tensor:
    """sign(N(0,1)) probes, drawn on the generator's device then moved."""
    gen_dev = generator.device if generator is not None else None
    z = torch.randn(shape, generator=generator, dtype=dtype, device=gen_dev)
    return torch.sign(z).to(device if device is not None else z.device)


def exact_divergence(
    f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact divergence via D forward-mode JVP columns."""
    D = x.shape[-1]
    x_dot = None
    div = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for d in range(D):
        tangent = torch.zeros_like(x)
        tangent[..., d] = 1.0
        out, jv = jvp(f, (x,), (tangent,))
        if x_dot is None:
            x_dot = out
        div = div + jv[..., d]
    return x_dot, div


def hutchinson_divergence(
    f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, e: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Skilling--Hutchinson estimate e^T J e with one JVP."""
    x_dot, je = jvp(f, (x,), (e,))
    div = torch.sum(je * e, dim=tuple(range(1, x.ndim)))
    return x_dot, div


def _linearized(f, x) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """(f(x), v_col -> (J v)_col): one JVP per (D, B) column."""

    def apply(col: torch.Tensor) -> torch.Tensor:
        return jvp(f, (x,), (col.T.contiguous(),))[1].T

    return f(x), apply


# ---------------------------------------------------------------------------
# Batch-in-lanes sketch algebra: columns (D, B), entries (B,).
# ---------------------------------------------------------------------------


def _qr_cols(cols: Cols) -> Tuple[Cols, List[List[torch.Tensor]]]:
    """Thin QR of per-row (D, m) matrices given as m columns of (D, B).

    Modified Gram--Schmidt, each column's updates by q_0, q_1, ... in
    order; the later columns take q_j's update together as q_j is
    accepted (the same operations on each column).  A column whose
    residual norm falls under ``max(scale * 1e-6, 1e-30)`` (``scale`` the
    root of the summed squared norms of all columns) is degenerate: it is
    replaced by the canonical basis vector with the largest residual
    against the accepted columns (the first index among equals), kept
    incrementally, so Q stays orthonormal while R keeps the ~0 entry.
    Returns (q_cols, R) with R an m x m grid of (B,) entries, zeros below
    the diagonal.  Raises when m > D."""
    m = len(cols)
    if m == 0:
        return [], []
    D, B = cols[0].shape
    if m > D:
        raise ValueError(
            f"QR of {m} columns in dimension {D}: at most D orthonormal "
            "columns exist — reduce the probe count (make_probes clamps "
            "automatically; direct callers must too)"
        )
    scale = torch.sqrt(sum(torch.sum(c * c, dim=0) for c in cols))  # (B,)
    floor = torch.clamp_min(scale * 1e-6, 1e-30)
    zeros = torch.zeros_like(scale)
    q_cols: Cols = []
    R = [[zeros] * m for _ in range(m)]
    # res[c] = e_c orthogonalized against the accepted columns so far
    eye = torch.eye(D, dtype=cols[0].dtype, device=cols[0].device)
    res = eye[:, :, None].expand(D, D, B)  # (c, d, B)
    V = _stack_cols(cols)  # columns j.. with the updates by q_0 .. q_{j-1}
    for j in range(m):
        v = V[0]
        r_jj = torch.sqrt(torch.sum(v * v, dim=0))
        R[j][j] = r_jj

        res_norm = torch.sqrt(torch.sum(res * res, dim=1))  # (c, B)
        best = torch.argmax(res_norm, dim=0)  # (B,): the first maximum
        q_fb = torch.take_along_dim(res, best[None, None, :], dim=0)[0]  # (D, B)
        q_fb = q_fb / torch.clamp_min(torch.take_along_dim(res_norm, best[None, :], dim=0)[0], 1e-30)
        degenerate = (r_jj < floor)[None, :]
        q_j = torch.where(degenerate, q_fb, v / torch.maximum(r_jj, floor)[None, :])
        q_cols.append(q_j)
        if j + 1 < m:
            r_j = torch.sum(q_j * V[1:], dim=1)  # (m - j - 1, B): R's row j past the diagonal
            R[j][j + 1:] = list(r_j.unbind(0))
            V = V[1:] - r_j[:, None, :] * q_j
            proj = torch.sum(res * q_j[None, :, :], dim=1)  # (c, B)
            res = res - proj[:, None, :] * q_j[None, :, :]
    return q_cols, R


def _stack_cols(cols: Cols) -> torch.Tensor:
    """The (D, B) columns as one (m, D, B) tensor in their own memory
    layout: a JVP's columns are transposed (B, D) rows, and a product with
    them sums over D as the column's own product does."""
    if all(c.dim() == 2 and c.shape[0] > 1 and c.stride(0) == 1 for c in cols):
        return torch.stack([c.T for c in cols]).transpose(1, 2)
    return torch.stack(cols)


def _tri_inv(R: torch.Tensor) -> torch.Tensor:
    """inv(R) of the upper-triangular (k, k, B) R, by back-substitution a
    row of inv(R) at a time (rows k-1 down to 0, every column at once).  A
    diagonal under ``max(scale * 1e-6, 1e-30)`` (``scale`` the largest
    |diagonal|) is clamped to ``sign(d) floor + (d == 0) floor``, so a
    degenerate sketch gives a bounded estimate instead of a NaN.  Entry
    (i, j) is 1 or 0 less R[i][l] inv[l][j] for l = i+1 .. j in order,
    divided by the clamped diagonal; the terms l > j of a row's update meet
    inv's zeros below the diagonal and leave a finite sum as it is."""
    k = R.shape[0]
    scale = R[0, 0] * 0
    for i in range(k):
        scale = torch.maximum(scale, torch.abs(R[i, i]))
    floor = torch.clamp_min(scale * 1e-6, 1e-30)
    inv = torch.zeros_like(R)
    upper = torch.arange(k, device=R.device)[:, None]  # column index j, against row i
    for i in range(k - 1, -1, -1):
        acc = torch.zeros_like(R[0])
        acc[i] = 1.0
        for l in range(i + 1, k):
            acc = acc - R[i, l] * inv[l]
        d = R[i, i]
        safe = torch.where(torch.abs(d) < floor, torch.sign(d) * floor + (d == 0) * floor, d)
        inv[i] = torch.where(upper >= i, acc / safe, 0.0)
    return inv


def _tri_inv_entries(R, k: int):
    """Entries of inv(R), R upper-triangular as a k x k grid of (B,)
    entries: :func:`_tri_inv` on the stacked grid."""
    inv = _tri_inv(torch.stack([torch.stack(list(row[:k])) for row in R[:k]]))
    return [[inv[i, j] for j in range(k)] for i in range(k)]


def hutchpp_core(apply_cols, s_cols: Cols, g_cols: Cols, measure_cols=None) -> torch.Tensor:
    """Hutch++ divergence from a column operator.

    ``apply_cols`` maps a list of (D, B) columns to their A v columns and
    builds the sketch; ``measure_cols`` (default ``apply_cols``) applies A
    in the quadratic forms tr(Q^T A Q) + (1/m) tr(U^T A U), U = (I - QQ^T)
    G.  Returns the (B,) estimate."""
    if measure_cols is None:
        measure_cols = apply_cols
    m = len(g_cols)
    y_cols = apply_cols(s_cols)
    q_cols, _ = _qr_cols(y_cols)

    # U = (I - QQ^T) G, every residual probe at once: each probe's
    # projection on q by torch.sum over the D axis, the updates in q's order
    u_cols = list(g_cols)
    if q_cols and g_cols:
        G = _stack_cols(g_cols)
        U = G
        for q in q_cols:
            U = U - torch.sum(q * G, dim=1)[:, None, :] * q
        u_cols = list(U.unbind(0))

    # U depends only on Q and the probes: A Q and A U share one application
    applied = measure_cols(q_cols + u_cols)
    aq_cols, au_cols = applied[: len(q_cols)], applied[len(q_cols):]
    trace_lr = sum(torch.sum(q * aq, dim=0) for q, aq in zip(q_cols, aq_cols))
    trace_res = sum(torch.sum(u * au, dim=0) for u, au in zip(u_cols, au_cols))
    return trace_lr + trace_res / float(m)


def hutchpp_divergence(
    f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, S: torch.Tensor, G: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hutch++ with ``S`` (r, B, D) sketch and ``G`` (m, B, D) residual
    probes; the sketch construction is detached, the measurement is not."""
    x_dot, jv = _linearized(f, x)
    div = hutchpp_core(
        lambda cols: [jv(c).detach() for c in cols],
        [S[i].T for i in range(S.shape[0])],
        [G[i].T for i in range(G.shape[0])],
        measure_cols=lambda cols: [jv(c) for c in cols],
    )
    return x_dot, div


def xtrace_core(apply_cols, o_cols: Cols) -> torch.Tensor:
    """XTrace divergence from a column operator (see :func:`hutchpp_core`):
    for each left-out probe j,
      est_j = tr(H) - S_j^T H S_j + (w_j^T s_j)(s_j^T r_j) - t_j^T x_j + x_j^T H x_j
    averaged over j, S the transpose of the row-normalized inv(R)."""
    m = len(o_cols)
    y_cols = apply_cols(o_cols)
    q_cols, R = _qr_cols(y_cols)
    aq_cols = apply_cols(q_cols)
    Q, AQ, O = _stack_cols(q_cols), _stack_cols(aq_cols), _stack_cols(o_cols)  # (m, D, B)
    # The m x m matrices as (m, m, B) grids, [i][j] the (B,) entry: each sum
    # over i, j or l below runs in index order, one grid row or column of
    # entries at a time, and each dot over D is torch.sum over the D axis.

    def grid(a, b):  # [i][j] = a_i . b_j
        return torch.stack([torch.sum(a[i] * b, dim=1) for i in range(m)])

    H, W, T = grid(Q, AQ), grid(Q, O), grid(AQ, O)
    R = torch.stack([torch.stack(row) for row in R])
    S_t = _tri_inv(R)  # inv(R), row i / col j
    norm = torch.clamp_min(torch.sqrt(sum(S_t[:, j] * S_t[:, j] for j in range(m))), 1e-30)
    # S[i][j] pairs row index i with W's and T's row index (a Q column)
    S = (S_t / norm[:, None]).transpose(0, 1)

    trace_H = sum(H[i, i] for i in range(m))
    # X = W - colsum(S .* W) * S (leave-one-out deflation)
    csum = sum(S[i] * W[i] for i in range(m))
    X = W - csum[None] * S

    def quad(V):  # [V^T H V]_jj for each left-out column j
        HV = sum(H[:, l, None] * V[l][None] for l in range(m))
        return sum(V[i] * HV[i] for i in range(m))

    SHS = quad(S)
    XHX = quad(X)
    WS = sum(W[i] * S[i] for i in range(m))
    SR = sum(S[i] * R[i] for i in range(m))
    TX = sum(T[i] * X[i] for i in range(m))
    ests = trace_H - SHS + WS * SR - TX + XHX
    return sum(ests[j] for j in range(m)) / float(m)


def xtrace_divergence(
    f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, O: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """XTrace with ``O`` (m, B, D) probes, m <= D.  Every application of A
    is detached: the value is right, its gradient is zero.  So A v is a
    forward-mode dual number's tangent (``torch.autograd.forward_ad``),
    the tangent formulas ``torch.func.jvp`` runs, at a small part of its
    cost a call (a call applies A to 2 m columns, 128 at m = 64); where
    forward AD does not reach ``f`` (inside a registered op's kernel, below
    autograd), ``torch.func.jvp``."""

    def apply_cols(cols: Cols) -> Cols:
        out = []
        for col in cols:
            v = col.T.contiguous()
            with fwAD.dual_level():
                jv = fwAD.unpack_dual(f(fwAD.make_dual(x, v))).tangent
            if jv is None:
                jv = jvp(f, (x,), (v,))[1]
            out.append(jv.T.detach())
        return out

    div = xtrace_core(apply_cols, [O[i].T for i in range(O.shape[0])])
    return f(x), div


def make_probes(
    mode: str,
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    hpp_rank: int = 1,
    hpp_vecs: int = 1,
    xt_vecs: int = 1,
) -> tuple:
    """The probe set an estimator needs, drawn once per solve from
    ``generator`` and moved to ``x``'s device: 'exact' -> (); 'hutchinson'
    -> (e,) Rademacher; 'hutchpp' -> (S, G), Rademacher (r, B, D) and
    (m, B, D) with r = clamp(hpp_rank, 1, D), m = max(1, hpp_vecs);
    'xtrace' -> (O,), m = clamp(xt_vecs, 1, D) sphere probes scaled by
    sqrt(D) (Rademacher pairs are parallel half the time at D = 2)."""
    if mode not in ("exact", "hutchinson", "hutchpp", "xtrace"):
        raise ValueError(f"unknown trace mode {mode!r}")
    if mode == "exact":
        return ()
    if generator is None:
        raise ValueError(
            f"trace mode {mode!r} needs a torch.Generator (or explicit "
            "probes) for its probes"
        )
    if mode == "hutchinson":
        return (rademacher(generator, x.shape, x.dtype, x.device),)
    if x.ndim != 2:
        raise ValueError(
            f"sketch trace modes consume (B, D) batches; got x.ndim={x.ndim} "
            "— flatten trailing dims first"
        )
    batch, D = x.shape
    if mode == "hutchpp":
        r = max(1, min(hpp_rank, D))
        m = max(1, hpp_vecs)
        return (
            rademacher(generator, (r, batch, D), x.dtype, x.device),
            rademacher(generator, (m, batch, D), x.dtype, x.device),
        )
    m = min(max(1, xt_vecs), D)
    gen_dev = generator.device
    g = torch.randn((m, batch, D), generator=generator, dtype=x.dtype, device=gen_dev)
    u = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return ((u * math.sqrt(D)).to(x.device),)


def divergence_fn(mode: str):
    """Look up an estimator by name ('exact' | 'hutchinson' | 'hutchpp' |
    'xtrace')."""
    table = {
        "exact": exact_divergence,
        "hutchinson": hutchinson_divergence,
        "hutchpp": hutchpp_divergence,
        "xtrace": xtrace_divergence,
    }
    if mode not in table:
        raise ValueError(f"unknown trace mode {mode!r}; use one of {sorted(table)}")
    return table[mode]


def probe_counts(mode: str, probes: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(sketch columns, residual columns) of a sketch mode's probes:
    (r, m) for hutchpp's (S, G), (m, 0) for xtrace's (O,)."""
    if mode == "hutchpp":
        return probes[0].shape[0], probes[1].shape[0]
    return probes[0].shape[0], 0
