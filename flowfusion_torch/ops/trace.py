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

    Modified Gram--Schmidt unrolled over the columns.  A column whose
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
    for j in range(m):
        v = cols[j]
        for i in range(j):
            r_ij = torch.sum(q_cols[i] * v, dim=0)
            R[i][j] = r_ij
            v = v - r_ij[None, :] * q_cols[i]
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
            proj = torch.sum(res * q_j[None, :, :], dim=1)  # (c, B)
            res = res - proj[:, None, :] * q_j[None, :, :]
    return q_cols, R


def _tri_inv_entries(R, k: int):
    """Entries of inv(R), R upper-triangular as a k x k grid of (B,)
    entries, by back-substitution.  A diagonal under ``max(scale * 1e-6,
    1e-30)`` (``scale`` the largest |diagonal|) is clamped to
    ``sign(d) floor + (d == 0) floor``, so a degenerate sketch gives a
    bounded estimate instead of a NaN."""
    scale = R[0][0] * 0
    for i in range(k):
        scale = torch.maximum(scale, torch.abs(R[i][i]))
    floor = torch.clamp_min(scale * 1e-6, 1e-30)

    def safe_diag(i):
        d = R[i][i]
        return torch.where(torch.abs(d) < floor, torch.sign(d) * floor + (d == 0) * floor, d)

    zeros = torch.zeros_like(scale)
    inv = [[zeros] * k for _ in range(k)]
    for j in range(k):
        for i in range(j, -1, -1):
            acc = torch.full_like(scale, 1.0 if i == j else 0.0)
            for l in range(i + 1, j + 1):
                acc = acc - R[i][l] * inv[l][j]
            inv[i][j] = acc / safe_diag(i)
    return inv


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

    u_cols = []
    for g in g_cols:
        u = g
        for q in q_cols:
            u = u - torch.sum(q * g, dim=0)[None, :] * q
        u_cols.append(u)

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

    def dot(a, b):
        return torch.sum(a * b, dim=0)

    H = [[dot(q_cols[i], aq_cols[j]) for j in range(m)] for i in range(m)]
    W = [[dot(q_cols[i], o_cols[j]) for j in range(m)] for i in range(m)]
    T = [[dot(aq_cols[i], o_cols[j]) for j in range(m)] for i in range(m)]

    S_t = _tri_inv_entries(R, m)  # inv(R), row i / col j
    for i in range(m):
        norm = torch.clamp_min(torch.sqrt(sum(S_t[i][j] * S_t[i][j] for j in range(m))), 1e-30)
        S_t[i] = [S_t[i][j] / norm for j in range(m)]
    # S[i][j] pairs row index i with W's and T's row index (a Q column)
    S = [[S_t[j][i] for j in range(m)] for i in range(m)]

    trace_H = sum(H[i][i] for i in range(m))
    # X = W - colsum(S .* W) * S (leave-one-out deflation)
    csum = [sum(S[i][j] * W[i][j] for i in range(m)) for j in range(m)]
    X = [[W[i][j] - csum[j] * S[i][j] for j in range(m)] for i in range(m)]

    def quad(V):  # [V^T H V]_jj for each left-out column j
        HV = [[sum(H[i][l] * V[l][j] for l in range(m)) for j in range(m)] for i in range(m)]
        return [sum(V[i][j] * HV[i][j] for i in range(m)) for j in range(m)]

    SHS = quad(S)
    XHX = quad(X)
    WS = [sum(W[i][j] * S[i][j] for i in range(m)) for j in range(m)]
    SR = [sum(S[i][j] * R[i][j] for i in range(m)) for j in range(m)]
    TX = [sum(T[i][j] * X[i][j] for i in range(m)) for j in range(m)]
    ests = [trace_H - SHS[j] + WS[j] * SR[j] - TX[j] + XHX[j] for j in range(m)]
    return sum(ests) / float(m)


def xtrace_divergence(
    f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, O: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """XTrace with ``O`` (m, B, D) probes, m <= D.  Every application of A
    is detached: the value is right, its gradient is zero."""
    x_dot, jv = _linearized(f, x)
    div = xtrace_core(lambda cols: [jv(c).detach() for c in cols], [O[i].T for i in range(O.shape[0])])
    return x_dot, div


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
