"""The whole Hutch++ or XTrace right-hand side in one launch on the card.

Counterpart of the JAX package's ``kernels/fused_mlp.py::fused_drift_sketch``
and ``fused_velocity_sketch`` (the kernel modes ``hutchpp`` and ``xtrace``)
at compute mode ``float32`` (strict fp32), ``highf32`` (3xTF32 layer
products and the tanh-form SiLU, as ``kernels.fused_mlp`` computes that
mode) or ``bfloat16`` (bf16 operands and fp32 sums on the bf16 tensor
cores, the tanh-form SiLU, at ``kernels.fused_mlp``'s rounding points).
On CUDA tensors the wrappers launch the hand-written kernel
``csrc/fused_sketch.cu`` (built at first use, see ``_build``) in the
compute mode or raise; on CPU tensors they run the plain PyTorch versions,
the ``ops.trace`` estimators on the plain drift in the same compute mode
(``fused_drift_sketch_reference``, ``fused_velocity_sketch_reference``;
in ``bfloat16`` over the explicit chain of ``fused_mlp._bf16_chains``).

The kernel runs the forward chain once, keeps act' of every layer in
shared memory, and applies A v = c0 v + c1 J_net v to the sketch through
that stored chain (2r + m tangent chains for Hutch++, 2m for XTrace), with
the per-row QR, projections and leave-one-out algebra between the
applications.  The time, the first-layer fold and (c0, c1) enter as in
``kernels.fused_mlp``.  Each wrapper counts its launches, split by mode
(``launches_by_mode``) and by compute mode (``launches_by_dtype``).

The kernel takes every D up to ``MAX_SKETCH_DIM`` = 64, the JAX sketch
kernel's envelope (D + C <= 64 features).  Its per-row algebra keeps a
row's D-vectors in registers for D <= 8 (the buckets 2, 4 and 8) and, on
the wide path (bucket 64), in the element-major tiles of shared memory that
the narrow path already stores them in, with loops to the runtime D; the
wide path needs no shared memory beyond that layout.  A probe's projection
through w_in[:D] is strict up to ``fused_mlp.RANK1_MAX`` = 16 rows and, past
that, goes through the 3xTF32 split in ``highf32`` and through rounded
operands in ``bfloat16``, as the JAX kernel's ``in_proj_rows`` takes it.

A launch's plan, :func:`sketch_plan`, is ``(rows, smem_bytes, md,
group)``: the rows a block owns (the most blocks an SM holds, up to three,
at the most rows that reach them), its shared memory, the algebra's bucket
of D and the probe columns an application carries at once (0: all of
them, wherever that fits; groups of fewer, at 4 rows a block, only where
it does not).  A grouped plan is wide: it fits one block an SM and
launches the kernel's wide instantiations.  Where even that does not fit,
because the probe tile (every probe column of a row, D values each) and
XTrace's algebra fill shared memory beside the act' store, the plan takes
the *storage form*, ``(rows, smem_bytes, 64, group, ws_row)``: the wide
path with each row's probe tile and algebra in a workspace in device
memory, ``ws_row`` floats a row, which the wrapper allocates on the
launch's device and stream for a persistent grid of one block an SM
(:func:`store_workspace`; each block walks its row tiles with a slot of
its own), and the act' store and the chain buffers alone in shared
memory.  The JAX sketch kernel's gate counts no probe storage, so with it
the kernel takes every configuration that gate admits.  A row's arithmetic
does not depend on the rows, on the group, on the form, nor on the bucket
among 2, 4 and 8.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .._device import strict_fp32_matmul
from ..models.nets import apply_score_mlp, apply_velocity_mlp
from ..ops import trace as trace_lib
from . import _build, fused_mlp
from .fused_mlp import (
    COMPUTE_DTYPES,
    _KERNEL_ACTIVATIONS,
    _SMEM_LIMIT,
    _check_conditional,
    _pick_rows,
    blocks_per_sm,
    _net_ops,
    _score_first_layer,
    _velocity_first_layer,
    check_operands,
    lane,
    pad_to_lanes,
)

__all__ = [
    "fused_drift_sketch",
    "fused_drift_sketch_reference",
    "fused_velocity_sketch",
    "fused_velocity_sketch_reference",
    "supports_sketch",
    "sketch_plan",
    "sketch_md",
    "sketch_occupancy",
    "store_workspace",
    "algebra_flops",
    "reset_launch_counts",
    "MAX_SKETCH_DIM",
]

SKETCH_MODES = ("hutchpp", "xtrace")  # index = kernel's SketchMode
MAX_SKETCH_DIM = 64  # D the per-row algebra takes (csrc kMaxDim)
# the algebra's compile-time bounds of D (csrc instantiations): 2, 4 and 8
# in registers, MAX_SKETCH_DIM the wide path in shared memory
SKETCH_MD = (2, 4, 8, MAX_SKETCH_DIM)
SKETCH_BLOCKS = 3  # blocks an SM the kernel's launch bounds allow (csrc kMinBlocks)
STORE_BLOCKS = 1  # blocks an SM of the storage form's persistent grid (its launch bounds)
SKETCH_DTYPES = COMPUTE_DTYPES  # the compute modes this kernel takes, index = its precision


def check_compute_dtype(compute_dtype: str) -> None:
    """Accept the sketch kernel's compute modes, 'float32', 'highf32' and
    'bfloat16'; anything else is not a compute mode."""
    if compute_dtype not in SKETCH_DTYPES:
        raise ValueError(f"unknown kernel compute dtype {compute_dtype!r}; use one of {SKETCH_DTYPES}")


def _stack_sketch_probes(probes: Sequence[torch.Tensor], sketch_mode: str, D: int):
    """Validate the probes and stack them: ``(V (n_s + n_g, B, D), n_s,
    n_g)``.  The QR orthonormalizes at most D columns, and Hutch++ divides
    by its residual-probe count."""
    if sketch_mode == "hutchpp":
        S, G = probes
        if G.shape[0] < 1:
            raise ValueError(
                "hutchpp needs at least one residual probe (G); got 0 "
                "(the trace estimate divides by the residual count)"
            )
        if S.shape[0] > D:
            raise ValueError(
                f"hutchpp sketch rank {S.shape[0]} > D={D}: at most D "
                "orthonormal columns exist — reduce hpp_rank"
            )
        return torch.cat([S, G], dim=0), S.shape[0], G.shape[0]
    if sketch_mode == "xtrace":
        (O,) = probes
        if not 1 <= O.shape[0] <= D:
            raise ValueError(f"xtrace needs 1 <= m <= D={D} probes; got {O.shape[0]}")
        return O, O.shape[0], 0
    raise ValueError(f"unknown sketch mode {sketch_mode!r}")


def _layout(sketch_mode: str, n_s: int, n_g: int) -> Tuple[int, int]:
    """(kmax, ncols): the widest application's chain count and the probe
    tile's columns a row (xtrace keeps O and Q side by side)."""
    if sketch_mode == "hutchpp":
        return n_s + n_g, n_s + n_g
    return n_s, 2 * n_s


def sketch_md(D: int) -> int:
    """The per-row algebra's bucket: the smallest of ``SKETCH_MD`` >= D
    (2, 4 or 8 in registers; 9 <= D <= 64 the wide path); raise past
    ``MAX_SKETCH_DIM``, the JAX sketch kernel's envelope."""
    for md in SKETCH_MD:
        if D <= md:
            return md
    raise ValueError(
        f"fused sketch kernel takes D <= {MAX_SKETCH_DIM} (the JAX sketch kernel's "
        f"envelope); got D={D}: use use_fused_kernel=False"
    )


def _algebra_floats(sketch_mode: str, n_s: int, D: int, d_in: int, n_act: int, H: int,
                    grouped: bool = False) -> int:
    """XTrace's matrices a row in shared memory past the rest of the layout.
    Each lies over storage that is free when it is needed, where that holds
    it: R of the QR (m x m) over the input tile (d_in floats a row), A Q
    (m x D), inv(R) and the H, W, T grids (m x m each) over the act' store
    (n_act x H), unless the last application runs in groups (``grouped``):
    each group reads the store, and A Q is written as a group ends, so
    these stay past it; Hutch++ keeps none.  The wide path (D > 8) counts nothing
    more: its QR runs in place on the probe tile's columns, basis completion
    in the degenerate column itself, and Hutch++'s r projections of a
    residual probe lie over the input tile (d_in >= D >= r floats a row)."""
    if sketch_mode == "hutchpp":
        return 0
    rr, late = n_s * n_s, 4 * n_s * n_s + n_s * D
    return (rr if rr > d_in else 0) + (late if grouped or late > n_act * H else 0)


def _smem_bytes(rows: int, H: int, n_act: int, d_in: int, D: int, group: int, ncols: int, n_alg: int,
                compute_dtype: str = "float32") -> int:
    """Shared memory of one block in the kernel's layout: the act' store
    (n_act x rows x H), the double buffer of a group of chains
    (2 x group x rows x H; in ``bfloat16`` one fp32 buffer and one 2-byte
    bf16 plane, group x rows x (H + ``fused_mlp.PAD_BF16``) values each),
    the (rows, d_in) input tile, the (rows, ncols, D) probe tile and the
    algebra's n_alg floats a row, float32 but for the plane.  The same at
    every D: the wide path's vectors are the probe tile's columns."""
    tiles = 4 * rows * (n_act * H + d_in + ncols * D + n_alg)
    if compute_dtype == "bfloat16":
        return tiles + (4 + 2) * group * rows * (H + fused_mlp.PAD_BF16)
    return tiles + 4 * 2 * group * rows * H


def _layout_bytes(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype="float32", group=0):
    """``smem_bytes(rows)`` of the kernel's layout in ``compute_dtype``,
    for groups of ``group`` chains (0: the widest application's kmax, one
    group)."""
    kmax, ncols = _layout(sketch_mode, n_s, n_g)
    group = group or kmax
    n_alg = _algebra_floats(sketch_mode, n_s, D, d_in, n_act, H, group < kmax)
    return lambda rows: _smem_bytes(rows, H, n_act, d_in, D, group, ncols, n_alg, compute_dtype)


def _store_floats(sketch_mode: str, n_s: int, n_g: int, D: int) -> int:
    """Floats a row of the storage form's workspace (csrc ``store_floats``):
    the probe tile (ncols x D); then for Hutch++ each residual probe's
    projections on Q (n_g x n_s) and each column's quadratic form (n_s +
    n_g); for XTrace R of the QR (m x m), A Q (m x D), inv(R) and the H, W,
    T, H S and H X grids (m x m each) and five sums a left-out probe."""
    if sketch_mode == "hutchpp":
        return (n_s + n_g) * D + n_g * n_s + n_s + n_g
    return 2 * n_s * D + n_s * n_s + n_s * D + 6 * n_s * n_s + 5 * n_s


def _store_layout_bytes(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype="float32", group=0):
    """``smem_bytes(rows)`` of the storage form: the layout of
    :func:`_layout_bytes` without the probe tile and the algebra."""
    kmax, _ = _layout(sketch_mode, n_s, n_g)
    return lambda rows: _smem_bytes(rows, H, n_act, d_in, D, group or kmax, 0, 0, compute_dtype)


def _default_plan(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype="float32"):
    """``(rows, group, store)`` of the plan :func:`sketch_plan` takes, or
    None: every column of an application in one group (group 0) at the rows
    of ``fused_mlp._pick_rows``; else the largest group that fits at 4 rows
    a block; else the storage form (``store``) at 4 rows a block with the
    largest group that fits beside the act' store (0 for every column)."""
    kmax, _ = _layout(sketch_mode, n_s, n_g)
    picked = _pick_rows(_layout_bytes(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype), SKETCH_BLOCKS)
    if picked is not None:
        return picked[0], 0, False
    group = next((g for g in range(kmax - 1, 0, -1)
                  if _layout_bytes(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype, g)(4) <= _SMEM_LIMIT),
                 None)
    if group is not None:
        return 4, group, False
    group = _store_group(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype)
    return None if group is None else (4, group, True)


def _store_group(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype="float32"):
    """The storage form's group at 4 rows a block: 0 where every column of
    an application fits, else the largest group that does, else None."""
    kmax, _ = _layout(sketch_mode, n_s, n_g)
    group = next((g for g in range(kmax, 0, -1)
                  if _store_layout_bytes(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype, g)(4)
                  <= _SMEM_LIMIT), None)
    return None if group is None else group % kmax


def sketch_plan(sketch_mode: str, H: int, n_act: int, d_in: int, D: int, n_s: int, n_g: int,
                rows: Optional[int] = None, md: Optional[int] = None, compute_dtype: str = "float32",
                group: Optional[int] = None, store: Optional[bool] = None):
    """``(rows, smem_bytes, md, group)`` of a launch in ``compute_dtype``
    (float32 and highf32 share a layout), or ``(rows, smem_bytes, 64,
    group, ws_row)`` in the storage form; raise when D is past
    ``MAX_SKETCH_DIM`` = 64 or not even the storage form fits.
    ``n_act`` counts the activation layers (the hidden widths).  Rows: the
    most blocks an SM holds, at the most rows that reach them.  ``md``: the
    bucket of :func:`sketch_md`, 2, 4 or 8 (the register algebra) or 64 (the
    wide path, 8 < D <= 64).  ``group``: the probe columns an application
    carries at once, 0 for all of them (r, then r + m, for Hutch++; m for
    XTrace) wherever that fits, else the largest group that fits at 4 rows
    a block (a wide plan, one block an SM).  ``store``: the storage form,
    where no group fits at 4 rows a block: the probe tile and XTrace's
    algebra, ``ws_row`` floats a row, in a workspace in device memory, at 4
    rows a block with the largest group that fits beside the act' store;
    always the wide path (md 64).  ``rows``, ``md``, ``group`` and ``store``
    force a plan (a multiple of 4 rows, a bucket >= D, a group of 0 to the
    widest application's columns, either form); what is not forced is the
    default plan's.  A row's arithmetic does not depend on rows, group or
    form, nor on md among 2, 4 and 8."""
    bucket = sketch_md(D)
    kmax, _ = _layout(sketch_mode, n_s, n_g)
    own = _default_plan(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype)
    if own is None and rows is None and group is None and store is None:
        smem_bytes = _store_layout_bytes(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype, 1)
        raise ValueError(
            f"fused sketch kernel shared-memory plan does not fit: {n_act} stored act' "
            f"layers and 2 chains of width H={H} need {smem_bytes(4)} bytes at "
            f"4 rows a block in {compute_dtype} (limit {_SMEM_LIMIT}); use a "
            "narrower or shallower net, or use_fused_kernel=False"
        )
    store = (own[2] if own else False) if store is None else store
    md = (MAX_SKETCH_DIM if store else bucket) if md is None else md
    if md not in SKETCH_MD or md < D or (store and md != MAX_SKETCH_DIM):
        raise ValueError(f"sketch algebra bucket {md} is not one of {SKETCH_MD} at least D={D}"
                         + (f" (the storage form takes {MAX_SKETCH_DIM})" if store else ""))
    if own is not None and own[2] == store:
        rows_own, group_own = own[:2]
    else:  # a forced form: 4 rows, and the storage form's own group
        rows_own = 4
        group_own = (store and _store_group(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype)) or 0
    rows = rows_own if rows is None else rows
    group = group_own if group is None else group
    if not 0 <= group <= kmax:
        raise ValueError(f"sketch plan of group {group}: 0 to the widest application's {kmax} columns")
    layout = _store_layout_bytes if store else _layout_bytes
    smem_bytes = layout(sketch_mode, H, n_act, d_in, D, n_s, n_g, compute_dtype, group)
    if rows % 4 or not 4 <= rows <= 256 or smem_bytes(rows) > _SMEM_LIMIT:
        raise ValueError(f"sketch plan of {rows} rows: a multiple of 4 up to 256 whose block fits")
    if store:
        return rows, smem_bytes(rows), md, group, _store_floats(sketch_mode, n_s, n_g, D)
    return rows, smem_bytes(rows), md, group


def algebra_flops(sketch_mode: str, n_s: int, n_g: int, D: int) -> int:
    """fp32 flops a row of the per-row algebra, a multiply-add as two:
    Y = c0 V + c1 J V; the MGS QR of r (Hutch++) or m (XTrace) columns;
    Hutch++'s projections of the m residual probes on Q and the r + m
    quadratic forms; XTrace's A Q, its H, W, T grids (m^2 dots of D),
    inv(R) (m (m^2 - 1) / 3), S and X (m^2 each) and the leave-one-out sums
    (the H S, H X grids, 4 m^3, and 10 m^2).  Under 1% of the chains' flops
    at D <= 8; at m = D = 64 a quarter of them (``fused_mlp.flops_per_row``
    counts the chains alone)."""
    k = n_s
    qr = 2 * D * k * (k - 1) + 3 * D * k
    if sketch_mode == "hutchpp":
        return 3 * k * D + qr + 4 * n_g * k * D + 4 * (k + n_g) * D
    m = n_s
    return 6 * m * D + qr + 6 * m * m * D + m * (m * m - 1) // 3 + 4 * m * m + 4 * m ** 3 + 10 * m * m


def store_workspace(plan, B: int, sms: int = 132) -> Tuple[int, int]:
    """``(grid, bytes)`` of a storage-form ``plan``'s launch over B rows on a
    card of ``sms`` SMs (132 on the H100): one block a row tile up to
    ``STORE_BLOCKS`` an SM, each walking its tiles with a slot of rows x
    ws_row floats, so the workspace grows with the grid, not with B."""
    rows, ws_row = plan[0], plan[4]
    grid = min(-(-B // rows), sms * STORE_BLOCKS)
    return grid, 4 * grid * rows * ws_row


def _wrapper_plan(*args, **kwargs):
    """A wrapper's plan, :func:`sketch_plan` for its config, which also
    checks the envelope.  While ``torch.export`` traces a solve it is
    ``(0, 0, 0, -1)``: inside the traced loop body the sizes may be
    symbolic, and the op's launch plans from the concrete shapes (and
    raises) when the program runs."""
    return (0, 0, 0, -1) if torch.compiler.is_compiling() else sketch_plan(*args, **kwargs)


def sketch_blocks(plan) -> int:
    """Blocks of ``plan`` an SM holds by its shared memory and the launch
    bounds (``sketch_occupancy`` asks the card).  A default plan that groups
    holds one block by its shared memory; the storage form's grid one
    (``STORE_BLOCKS``)."""
    return min(STORE_BLOCKS if len(plan) > 4 else SKETCH_BLOCKS, blocks_per_sm(plan[1]))


def supports_sketch(
    sketch_mode: str, hidden: int, n_act: int, n_features: int, n_dimensions: int, n_s: int, n_g: int,
    compute_dtype: str = "float32",
) -> bool:
    """Whether :func:`sketch_plan` fits (hidden width padded to the kernel's
    lanes in ``compute_dtype``)."""
    if n_dimensions > MAX_SKETCH_DIM:
        return False
    H = -(-hidden // lane(compute_dtype)) * lane(compute_dtype)
    return _default_plan(sketch_mode, H, n_act, n_features, n_dimensions, n_s, n_g, compute_dtype) is not None


def _sketch_reference(f, x, probes, sketch_mode):
    if sketch_mode == "hutchpp":
        return trace_lib.hutchpp_divergence(f, x, *probes)
    return trace_lib.xtrace_divergence(f, x, *probes)


def _bf16_sketch_reference(layers, w_in, b_eff, x, conditional, activation, c0, c1, probes, sketch_mode):
    """The plain version of one ``bfloat16`` launch on folded operands
    (``layers[1:]`` the layers after the first, ``w_in`` and ``b_eff`` the
    fold): drift = c0 x + c1 net, and the ``ops.trace`` estimator's algebra
    (``hutchpp_core`` or ``xtrace_core``) over A v = c0 v + c1 J_net v,
    where every application is the explicit bf16 chain of
    ``fused_mlp._bf16_chains`` -- the kernel's rounding points and its
    act' = s (1 + a (1 - s)), not the product rule of an autograd JVP
    through the rounded net.  Returns ``(drift (B, D), div (B,))``."""
    D = x.shape[1]
    x_in = x if conditional is None else torch.cat([x, conditional], dim=-1)
    net, _ = fused_mlp._bf16_chains(layers, w_in, b_eff, x_in, [], activation, D)

    def apply_cols(cols):
        _, jv = fused_mlp._bf16_chains(layers, w_in, b_eff, x_in, [v.T for v in cols], activation, D)
        return [c0 * v + c1 * j.T for v, j in zip(cols, jv)]

    cols = [[p[i].T for i in range(p.shape[0])] for p in probes]
    core = trace_lib.hutchpp_core if sketch_mode == "hutchpp" else trace_lib.xtrace_core
    return c0 * x + c1 * net, core(apply_cols, *cols)


def fused_drift_sketch_reference(
    params, cfg, t, x, probes, sketch_mode, conditional=None, c0=0.0, c1=1.0, compute_dtype="float32"
):
    """The plain PyTorch version of :func:`fused_drift_sketch`: the
    ``ops.trace`` Hutch++ or XTrace estimator on the plain drift
    c0 x + c1 net (TF32 off); in ``highf32`` the net's layer products
    through ``fused_mlp.tf32x3_matmul`` (tangents included) and the
    tanh-form SiLU, as ``fused_mlp.fused_drift_reference`` runs them; in
    ``bfloat16`` :func:`_bf16_sketch_reference` on the folded first
    layer, whose probe projection rounds the probes past
    ``fused_mlp.RANK1_MAX`` = 16 rows, as the kernel does.

    In ``highf32`` the first layer takes the split once D + C > 16
    (``fused_mlp._net_ops``), the probes' projection with it, where the
    kernel (and the JAX kernel's ``in_proj_rows``) keeps a probe strict up
    to D = 16 rows and splits it past that.  So for D <= 16 < D + C the
    two differ by the split's error on a probe's projection, ~2^-22
    relative, far inside the ``highf32`` sketch bars; past D = 16 both
    split."""
    _stack_sketch_probes(probes, sketch_mode, x.shape[-1])
    if compute_dtype == "bfloat16":
        with strict_fp32_matmul():
            return _bf16_sketch_reference(params["layers"], *_score_first_layer(params, cfg, t, conditional), x,
                                          conditional, cfg.activation, c0, c1, probes, sketch_mode)
    ops = _net_ops(compute_dtype, cfg.activation, cfg.n_dimensions + cfg.n_conditionals)
    with strict_fp32_matmul():
        return _sketch_reference(
            lambda xx: c0 * xx + c1 * apply_score_mlp(cfg, params, t, xx, conditional, **ops),
            x, probes, sketch_mode,
        )


def fused_velocity_sketch_reference(params, cfg, t, x, probes, sketch_mode, conditional=None,
                                    compute_dtype="float32"):
    """The plain PyTorch version of :func:`fused_velocity_sketch` (the
    split in ``highf32`` and the bf16 chain in ``bfloat16`` as in
    :func:`fused_drift_sketch_reference`)."""
    _stack_sketch_probes(probes, sketch_mode, x.shape[-1])
    if compute_dtype == "bfloat16":
        with strict_fp32_matmul():
            return _bf16_sketch_reference(params["layers"], *_velocity_first_layer(params, cfg, t, conditional), x,
                                          conditional, cfg.activation, 0.0, 1.0, probes, sketch_mode)
    ops = _net_ops(compute_dtype, cfg.activation, cfg.target_dimension + cfg.conditional_dimension)
    with strict_fp32_matmul():
        return _sketch_reference(
            lambda xx: apply_velocity_mlp(cfg, params, t, xx, conditional, **ops), x, probes, sketch_mode
        )


def fused_drift_sketch(
    params: dict,
    cfg,
    t,
    x: torch.Tensor,
    probes: Sequence[torch.Tensor],
    sketch_mode: str,
    conditional: Optional[torch.Tensor] = None,
    c0=0.0,
    c1=1.0,
    compute_dtype: str = "float32",
):
    """The whole Hutch++ or XTrace RHS of the score drift in one launch.

    ``sketch_mode`` 'hutchpp' takes ``probes = (S, G)``, (r, B, D) sketch
    and (m, B, D) residual probes; 'xtrace' takes ``(O,)``, (m, B, D).
    Returns ``(drift (B, D), div (B,))``, the divergence of the affine
    drift c0 x + c1 net.  ``compute_dtype`` is 'float32', 'highf32' or
    'bfloat16'.
    CUDA tensors launch the kernel in that mode
    (``fused_drift_sketch.launches``); CPU tensors run
    :func:`fused_drift_sketch_reference`."""
    check_compute_dtype(compute_dtype)
    _check_conditional(cfg.n_conditionals, conditional)
    params, cfg = pad_to_lanes(params, cfg, compute_dtype)
    D = cfg.n_dimensions
    V, n_s, n_g = _stack_sketch_probes(probes, sketch_mode, D)
    plan = _wrapper_plan(sketch_mode, cfg.units[0], len(cfg.units), D + cfg.n_conditionals, D, n_s, n_g,
                         compute_dtype=compute_dtype)
    if not fused_mlp._on_card(x):
        return fused_drift_sketch_reference(params, cfg, t, x, probes, sketch_mode, conditional, c0, c1,
                                            compute_dtype)
    with strict_fp32_matmul():
        w_in, b_eff = _score_first_layer(params, cfg, t, conditional)
    x_in = x if conditional is None else torch.cat([x, conditional], dim=-1)
    c0c1 = torch.stack([
        torch.as_tensor(c, dtype=torch.float32, device=x.device).reshape(()) for c in (c0, c1)
    ])
    return _launch(x_in, V, w_in, b_eff, params["layers"], c0c1, sketch_mode, D, n_s, n_g,
                   cfg.activation, plan, fused_drift_sketch, compute_dtype)


def fused_velocity_sketch(
    params: dict,
    cfg,
    t,
    x: torch.Tensor,
    probes: Sequence[torch.Tensor],
    sketch_mode: str,
    conditional: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
):
    """One-launch Hutch++ or XTrace for a flow velocity net: the contract of
    :func:`fused_drift_sketch` with (c0, c1) = (0, 1) and the raw-time
    fold.  CUDA tensors launch the kernel (``fused_velocity_sketch.launches``);
    CPU tensors run :func:`fused_velocity_sketch_reference`."""
    check_compute_dtype(compute_dtype)
    _check_conditional(cfg.conditional_dimension, conditional)
    params, cfg = pad_to_lanes(params, cfg, compute_dtype)
    D = cfg.target_dimension
    V, n_s, n_g = _stack_sketch_probes(probes, sketch_mode, D)
    plan = _wrapper_plan(
        sketch_mode, cfg.hidden_units[0], len(cfg.hidden_units), D + cfg.conditional_dimension, D, n_s, n_g,
        compute_dtype=compute_dtype,
    )
    if not fused_mlp._on_card(x):
        return fused_velocity_sketch_reference(params, cfg, t, x, probes, sketch_mode, conditional,
                                               compute_dtype)
    with strict_fp32_matmul():
        w_in, b_eff = _velocity_first_layer(params, cfg, t, conditional)
    x_in = x if conditional is None else torch.cat([x, conditional], dim=-1)
    c0c1 = torch.arange(2, dtype=torch.float32, device=x.device)  # (0, 1), no host copy
    return _launch(x_in, V, w_in.contiguous(), b_eff, params["layers"], c0c1, sketch_mode, D, n_s,
                   n_g, cfg.activation, plan, fused_velocity_sketch, compute_dtype)


def reset_launch_counts() -> None:
    """Zero the launch counts of both sketch wrappers, and their splits by
    mode and by compute mode."""
    for fn in (fused_drift_sketch, fused_velocity_sketch):
        fn.launches = 0
        fn.launches_by_mode = dict.fromkeys(SKETCH_MODES, 0)
        fn.launches_by_dtype = dict.fromkeys(SKETCH_DTYPES, 0)


reset_launch_counts()


def _kernel_lib(compute_dtype: str) -> ctypes.CDLL:
    """The kernel's library for ``compute_dtype``: the build compiles
    ``csrc/fused_sketch.cu`` once a compute mode (``_build.VARIANTS``)."""
    lib = _build.load("fused_sketch", compute_dtype)
    fn = lib.ff_fused_sketch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, p, p, p, p, p] + [i] * 12 + [ctypes.c_size_t, p, i, i, p]
        fn.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ff_sketch_occupancy.argtypes = [i, i, i, i, ctypes.c_size_t, ip, ip, ip]
        lib.ff_sketch_occupancy.restype = ctypes.c_int
        lib.ff_sketch_store_floats.argtypes = [i, i, i, i]
        lib.ff_sketch_store_floats.restype = ctypes.c_int
        want = {"ff_sketch_max_dim": MAX_SKETCH_DIM, "ff_sketch_min_blocks": SKETCH_BLOCKS,
                "ff_sketch_precision": COMPUTE_DTYPES.index(compute_dtype)}
        for name in want:
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        got = {name: getattr(lib, name)() for name in want}
        if got != want:
            raise RuntimeError(f"fused_sketch.cu's geometry {got} differs from the wrapper's plan {want}")
    return lib


def sketch_occupancy(plan, compute_dtype: str = "float32") -> dict:
    """What the card says of a plan's instantiation: resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local-memory bytes a thread.  Builds the kernel; needs a card."""
    check_compute_dtype(compute_dtype)
    rows, smem, md, group = plan[:4]
    store = len(plan) > 4
    out = [ctypes.c_int(0) for _ in range(3)]
    err = _kernel_lib(compute_dtype).ff_sketch_occupancy(md, COMPUTE_DTYPES.index(compute_dtype), group, int(store),
                                                         smem, *[ctypes.byref(v) for v in out])
    if err != 0:
        raise RuntimeError(f"fused_sketch occupancy query failed with CUDA error {err}")
    blocks, regs, local_bytes = (v.value for v in out)
    return dict(rows=rows, smem_bytes=smem, md=md, group=group, store=store, blocks_per_sm=blocks, registers=regs,
                local_bytes=local_bytes)


def _launch(x_in, V, w_in, b_eff, layers, c0c1, sketch_mode, D, n_s, n_g, activation, plan, counter,
            compute_dtype="float32"):
    """Launch the kernel through the registered op ``fused_sketch`` (eager
    and traced calls alike) in ``compute_dtype`` on the current stream, at
    ``plan`` (its rows, MD, group and form; the bytes follow from them); the
    launch is added to ``counter``'s counts.  ``V`` is the (n_s + n_g, B, D) probe
    stack.  Returns ``(drift (B, D), div (B,))``."""
    hidden = layers[1:-1]
    rows, _, md, group = plan[:4]
    store = -1 if group < 0 else int(len(plan) > 4)  # -1: the traced placeholder, planned at run time
    return fused_sketch_op(
        x_in, V, w_in, b_eff, [l["w"] for l in hidden], [l["b"] for l in hidden], layers[-1]["w"],
        layers[-1]["b"], c0c1, sketch_mode, D, n_s, n_g, activation, compute_dtype, counter.__name__, rows, md,
        group, store,
    )


def _fused_sketch_cuda(x_in, V, w_in, b_eff, hidden_w, hidden_b, w_out, b_out, c0c1, mode, D, n_s, n_g,
                       activation, compute_dtype, counter, rows, md, group=-1, store=-1):
    """The CUDA kernel of the op ``fused_sketch``: check the operands,
    allocate the outputs, launch ``csrc/fused_sketch.cu`` on the current
    stream at the plan of :func:`sketch_plan` (``rows`` and ``md`` > 0,
    ``group`` >= 0 and ``store`` >= 0 force one) and add one to the counts of the wrapper named ``counter``.
    The storage form's workspace is allocated here, on the device and the
    current stream (:func:`store_workspace`, the card's SMs); a failed
    allocation raises.  In ``bfloat16`` the weights are converted once a
    call as the RHS kernel takes them (``fused_mlp._bf16_operands``).
    Returns ``(drift (B, D), div (B,))``."""
    B, d_in = x_in.shape
    H = b_eff.shape[0]
    x_in = x_in.contiguous()
    probes = V.permute(1, 0, 2).contiguous()
    expect = [
        (x_in, (B, d_in)), (probes, (B, n_s + n_g, D)), (w_in, (d_in, H)), (b_eff, (H,)),
        (w_out, (H, D)), (b_out, (D,)), (c0c1, (2,)),
    ]
    expect += [(w, (H, H)) for w in hidden_w] + [(b, (H,)) for b in hidden_b]
    check_compute_dtype(compute_dtype)
    device = check_operands(expect, [{"w": w} for w in hidden_w], H, "fused sketch kernel", lane(compute_dtype))
    plan = sketch_plan(mode, H, len(hidden_w) + 1, d_in, D, n_s, n_g, rows or None, md or None, compute_dtype,
                       None if group < 0 else group, None if store < 0 else bool(store))
    rows, smem, md, group = plan[:4]
    if compute_dtype == "bfloat16":
        w_in, hidden_w, w_out = fused_mlp._bf16_operands(w_in, hidden_w, w_out)

    drift = torch.empty((B, D), dtype=torch.float32, device=device)
    div = torch.empty((B,), dtype=torch.float32, device=device)
    if B == 0:
        return drift, div
    lib = _kernel_lib(compute_dtype)
    work, ws_row, grid = None, 0, 0
    if len(plan) > 4:
        ws_row = plan[4]
        if lib.ff_sketch_store_floats(SKETCH_MODES.index(mode), n_s, n_g, D) != ws_row:
            raise RuntimeError("fused_sketch.cu's storage-form workspace differs from the wrapper's plan")
        grid, nbytes = store_workspace(plan, B, torch.cuda.get_device_properties(device).multi_processor_count)
        work = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    err = lib.ff_fused_sketch(
        x_in.data_ptr(), probes.data_ptr(), w_in.data_ptr(), b_eff.data_ptr(),
        fused_mlp.layer_table(hidden_w, hidden_b, device), len(hidden_w),
        w_out.data_ptr(), b_out.data_ptr(), c0c1.data_ptr(), drift.data_ptr(), div.data_ptr(),
        B, d_in, D, H, SKETCH_MODES.index(mode), _KERNEL_ACTIVATIONS.index(activation),
        COMPUTE_DTYPES.index(compute_dtype), n_s, n_g, md, rows, group, smem,
        None if work is None else work.data_ptr(), ws_row, grid,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_sketch kernel launch failed with CUDA error {err}")
    _build.count_launch(globals()[counter], launches_by_mode=mode, launches_by_dtype=compute_dtype)
    return drift, div


# The sketch kernel as a registered op, ``flowfusion_torch::fused_sketch``: what
# the wrappers call and an exported program holds.  Its CUDA kernel is the
# launch above; its CPU kernel, below, the ``ops.trace`` estimator on the plain
# net of the same folded operands (the bf16 chain in ``bfloat16``).
fused_sketch_op = torch.library.custom_op(
    f"{fused_mlp.OP_NAMESPACE}::fused_sketch", _fused_sketch_cuda, mutates_args=(), device_types="cuda",
    schema="(Tensor x_in, Tensor V, Tensor w_in, Tensor b_eff, Tensor[] hidden_w, Tensor[] hidden_b, "
           "Tensor w_out, Tensor b_out, Tensor c0c1, str mode, int D, int n_s, int n_g, str activation, "
           "str compute_dtype, str counter, int rows, int md, int group=-1, int store=-1) -> (Tensor, Tensor)",
)


@fused_sketch_op.register_kernel("cpu")
def _fused_sketch_op_cpu(x_in, V, w_in, b_eff, hidden_w, hidden_b, w_out, b_out, c0c1, mode, D, n_s, n_g,
                         activation, compute_dtype, counter, rows, md, group=-1, store=-1):
    """The op on CPU tensors: the ``ops.trace`` estimator on the plain net
    of the folded operands (TF32 off; in ``bfloat16``
    :func:`_bf16_sketch_reference`), counting nothing."""
    probes = (V[:n_s], V[n_s:]) if mode == "hutchpp" else (V,)
    if compute_dtype == "bfloat16":
        layers = [None] + [{"w": w, "b": b} for w, b in zip(hidden_w, hidden_b)] + [{"w": w_out, "b": b_out}]
        with strict_fp32_matmul():
            return _bf16_sketch_reference(layers, w_in, b_eff, x_in[:, :D], x_in[:, D:], activation, c0c1[0],
                                          c0c1[1], probes, mode)
    net = fused_mlp.folded_net(x_in, w_in, b_eff, hidden_w, hidden_b, w_out, b_out, D, activation, compute_dtype)
    c0, c1 = c0c1[0], c0c1[1]
    with strict_fp32_matmul():
        return _sketch_reference(lambda xx: c0 * xx + c1 * net(xx), x_in[:, :D], probes, mode)


@fused_sketch_op.register_fake
def _fused_sketch_op_fake(x_in, V, w_in, b_eff, hidden_w, hidden_b, w_out, b_out, c0c1, mode, D, n_s, n_g,
                          activation, compute_dtype, counter, rows, md, group=-1, store=-1):
    """The op's output shapes, for tracing: drift (B, D) and div (B,) (the
    wrappers check the plan before the call)."""
    B = x_in.shape[0]
    return x_in.new_empty((B, D)), x_in.new_empty((B,))
