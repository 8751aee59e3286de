"""A whole score-matching or flow-matching training epoch in one launch.

Counterpart of the JAX package's ``kernels/fused_train.py`` in its three
compute modes: ``fused_train_epoch`` runs ``steps`` Adam updates of an MLP on
per-step tables and ``fused_train_epoch_symplectic`` trains the two stacks of
a symplectic net by one such launch each.  On CUDA tensors the wrappers
launch the hand-written kernel ``csrc/fused_train.cu`` (one cooperative
launch a call, any number of steps) or raise; on CPU tensors they run the
plain PyTorch version, :func:`fused_train_epoch_reference`.

The compute mode reaches the three layer products of a step and the
activation, as the JAX kernel's ``_make_dots`` and ``_act_pair_fn`` take it
(the JAX package's ``kernels/fused_train.py:164-199``, ``:281-283``): the
forward products (layer 0 on the whole input), the delta products by W^T
and the weight gradients summed over the batch run in ``float32`` strict
fp32, in ``highf32`` as the 3xTF32 split (``fused_mlp.tf32x3_matmul``), in
``bfloat16`` on bf16-rounded operands with fp32 sums
(``fused_mlp.bf16_matmul``); both throughput modes take the tanh-form
sigmoid.  The biases, the residual and loss, the output delta, the bias
gradient (an unrounded sum), the multiply by act', Adam, the moments, the
EMA and the Fourier features stay fp32.  ``fit`` trains in ``float32``, as
the JAX ``fit`` does.

Loss algebra (why the kernel needs no SDE code): every family's loss is

    loss_s = inv * sum((zw + beta * net(t, xt[, cond]))^2)

over per-step tables built on the host from one draw function per family
(``ops.losses``), with inv = 1/bs, 1/(bs D) (``mean_over_dims``) or an
explicit ``loss_scale``:

  * DSM:  xt = nu(t) x + sigma(t) z,  zw = z,  beta = 1 (sigma under no_sigma)
  * likelihood-weighted:  the same xt,  zw = (g/sigma) z,
    beta = g/sigma (g under no_sigma)
  * flow matching (raw-time velocity nets): xt = (1-t) x0 + t xT,
    zw = -(xT - x0), beta = 1, inv = 1/(bs D)
  * symplectic: the joint flow-matching residual splits into one residual
    per stack, beta = +1 (q) and -1 (p), inv = 1/(bs 2D).

The tables do not depend on the parameters, so the kernel's manual backward
and autograd through the table loss give the same gradient.  Adam is
optax.adam's update (bias-corrected moments, eps outside the square root,
bias corrections 1 - exp(t log beta) with t = step0 + s + 1), and the EMA is
taken of the updated parameters.  The Fourier ``W`` of score nets is an
input only, so it stays frozen as ``train.trainable_mask`` keeps it.

The optimizer state ``(m, v, step)`` holds the moments in the parameters'
own layout, one tensor per leaf of ``params["layers"]`` (w, b, w, b, ...),
and chains across calls as optax state chains across a stage's epochs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .._device import same_device, strict_fp32_matmul
from ..models.nets import (
    ScoreMLPConfig,
    SymplecticMLPConfig,
    VelocityMLPConfig,
    apply_score_mlp,
    apply_velocity_mlp,
    fourier_time_embedding,
)
from ..ops import losses as losses_lib
from . import _build
from .fused_mlp import (
    _KERNEL_ACTIVATIONS,
    _SMEM_LIMIT,
    COMPUTE_DTYPES,
    LANE,
    _act_pair,
    bf16_matmul,
    check_compute_dtype,
    fusable_config,
    tf32x3_matmul,
)

__all__ = [
    "fused_train_epoch",
    "fused_train_epoch_reference",
    "fused_train_epoch_symplectic",
    "fused_train_epoch_symplectic_reference",
    "launch_packed",
    "train_tables",
    "train_tables_flow",
    "train_tables_symplectic",
    "train_plan",
    "supports_batch",
    "train_flops",
    "train_flops_by_unit",
    "param_tiles",
    "workspace_floats",
    "occupancy",
    "reset_launch_counts",
]

_THREADS = 256  # csrc kThreads: a block's threads
_TILE_ROWS, _TILE_COLS = 16, 32  # phase B's weight tiles (csrc: 32 lanes of 4 k x 4 n)
_PHASE_B_FLOATS = 2 * 16 * _THREADS  # csrc kPhaseBFloats: partials, then row buffers
_WPAD = 4  # csrc kWPad: floats past N in a staged weight row
_ROWS = (64, 32, 16, 8, 4, 2, 1)  # rows a block may take
SMS = 132  # the H100's SMs: the plan spreads row tiles over this many blocks


def _cfg_fields(cfg):
    """(units, D, C, E) of a net config: score nets (Fourier embedding,
    input [temb | x | cond]) and one symplectic half-stack report E, raw-time
    velocity nets (input [x | t | cond]) E = None."""
    if isinstance(cfg, SymplecticMLPConfig):
        return cfg.units, cfg.n_data_dims, cfg.n_conditionals, cfg.embedding_dimensions
    if isinstance(cfg, ScoreMLPConfig):
        return cfg.units, cfg.n_dimensions, cfg.n_conditionals, cfg.embedding_dimensions
    return cfg.hidden_units, cfg.target_dimension, cfg.conditional_dimension, None


def _pad(n: int) -> int:
    return -(-n // LANE) * LANE


def _dims(cfg) -> Tuple[int, int, int, int]:
    """(K, H, n_hidden, D) the kernel runs: the input width, the hidden
    width (every hidden layer zero-padded to the widest, in multiples of
    LANE), the hidden layer count and the output width; K and D unpadded."""
    units, D, C, E = _cfg_fields(cfg)
    K = (E + D + C) if E is not None else (D + 1 + C)
    return K, _pad(max(units)), len(units), D


def _layer_shapes(K: int, H: int, n_hidden: int, D: int) -> List[Tuple[int, int]]:
    """(K_l, N_l) of every layer in the kernel's padded widths."""
    return [(_pad(K), H)] + [(H, H)] * (n_hidden - 1) + [(H, _pad(D))]


def _row_floats(K: int, H: int, n_hidden: int, D: int) -> int:
    """Shared floats of one row in phase A: the padded layer input, every
    hidden layer's activation and act' (then delta), the padded output."""
    return _pad(K) + 2 * n_hidden * H + _pad(D)


# Admission: a net is admitted when one row of phase A holds at most this
# many floats (``_row_floats``).  It is a policy, not a layout's size: the
# envelope of the kernel's first version (4 rows a block and a 256-float
# scratch within ``_SMEM_LIMIT``: 4 (4 x 14,464 + 256) = 232,448 bytes), kept
# so that every net admitted before is admitted now and none refused before
# is admitted.  Every admitted net has a plan that fits (``train_plan``).
_ADMIT_ROW_FLOATS = 14_464


def _acts_floats(rows: int, K: int, H: int, n_hidden: int, D: int) -> int:
    """Phase A's row tile, at least phase B's partials and as many floats
    again for its rows (csrc ``kPhaseBFloats``): csrc ``acts``."""
    return max(rows * _row_floats(K, H, n_hidden, D), _PHASE_B_FLOATS)


def _staged_floats(K: int, H: int, n_hidden: int, D: int) -> int:
    """Shared floats of the whole net staged at row stride N + 4."""
    return sum(k * (n + _WPAD) for k, n in _layer_shapes(K, H, n_hidden, D))


def _wbuf_floats(rows: int, K: int, H: int, n_hidden: int, D: int) -> Optional[int]:
    """Shared floats for staged weights at ``rows`` rows a block: the whole
    net where it fits beside the row tile, else what is left for k-chunks
    (at least 4 rows of the widest layer); None when the block does not
    fit."""
    left = _SMEM_LIMIT // 4 - _acts_floats(rows, K, H, n_hidden, D)
    least = 4 * (max(H, _pad(D)) + _WPAD)
    return None if left < least else min(left, _staged_floats(K, H, n_hidden, D))


def supports_batch(cfg, bs: int) -> bool:
    """Whether the kernel trains ``cfg`` on batches of ``bs`` rows: the JAX
    package's name for :func:`train_plan` admitting the net (admission does
    not depend on ``bs`` here; ``train.fit(engine='auto')`` routes a net it
    does not admit to the plain engine)."""
    return train_plan(cfg, bs) is not None


def train_plan(cfg, bs: int = 1, sms: int = SMS, rows: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """``(rows, smem_bytes)`` of a launch on a batch of ``bs`` rows, or None
    for a net the kernel does not admit.

    Admission is the policy ``_ADMIT_ROW_FLOATS`` (the first version's
    envelope), and does not depend on ``bs``.  Rows: of 64, 32, 16,
    8, 4, 2 and 1 whose block fits, the fewest among those that give the
    busiest of ``sms`` blocks the fewest row tiles (a block strides over
    ceil(bs / rows) tiles): at least ``sms`` tiles where the batch allows,
    so 4 rows (128 tiles) at bs 512 and 1 row at bs 128.  ``rows`` forces a
    plan.  Shared memory: the row tile, then the staged weights.  No
    result depends on the plan."""
    dims = _dims(cfg)
    if _row_floats(*dims) > _ADMIT_ROW_FLOATS:
        return None

    def smem(r):
        wbuf = _wbuf_floats(r, *dims)
        return None if wbuf is None else 4 * (_acts_floats(r, *dims) + wbuf)

    if rows is not None:
        if not 1 <= rows <= 256 or smem(rows) is None:
            raise ValueError(f"fused_train plan of {rows} rows: 1 to 256 rows whose block fits")
        return rows, smem(rows)
    fits = [r for r in _ROWS if smem(r) is not None]
    assert fits, f"an admitted net {dims} has no plan that fits"

    def busiest(r):  # row tiles on the busiest of sms blocks
        tiles = -(-bs // r)
        return -(-tiles // sms)

    rows = min(fits, key=lambda r: (busiest(r), r))
    return rows, smem(rows)


def plan_wbuf(cfg, plan) -> int:
    """The staged-weight floats of ``plan``: csrc ``wbuf``."""
    rows, smem = plan
    return smem // 4 - _acts_floats(rows, *_dims(cfg))


def param_tiles(K: int, H: int, n_hidden: int, D: int) -> List[Tuple[int, int, int, int, int]]:
    """Phase B's tile map: ``(layer, k0, kc, n0, nc)`` tiles of every
    layer's (K_l + 1, N_l) parameters, row K_l the bias.  Weight tiles are
    kc = 16 rows (what is left at the end) by nc = 32 columns (N_l where it
    is narrower; what is left at the end), at most 32 items of 4 k by 4 n;
    the bias row goes in tiles of one row by up to 32 columns.  Largest
    first, so the blocks that take a second tile take a small one."""
    tiles = []
    for l, (k_l, n_l) in enumerate(_layer_shapes(K, H, n_hidden, D)):
        for k0 in list(range(0, k_l, _TILE_ROWS)) + [k_l]:
            for n0 in range(0, n_l, _TILE_COLS):
                kc = min(_TILE_ROWS, k_l - k0) if k0 < k_l else 1
                tiles.append((l, k0, kc, n0, min(_TILE_COLS, n_l - n0)))
    return sorted(tiles, key=lambda tile: -tile[2] * tile[4])


def workspace_floats(cfg, bs: int) -> Tuple[int, int, int]:
    """Floats of phase A's workspace: each row's layer inputs (bs, K + L H),
    deltas (bs, L H + D) and loss (bs,), at the kernel's padded widths."""
    K, H, n_hidden, D = _dims(cfg)
    return bs * (_pad(K) + n_hidden * H), bs * (n_hidden * H + _pad(D)), bs


def train_flops(cfg, steps: int, bs: int) -> int:
    """Flops of an epoch: 2 H (2 K + 3 (n_hidden - 1) H + 3 D) a row a step
    at the net's real widths.  Every layer's forward product and weight
    gradient, and the delta product of every layer but the first: no delta
    goes back through layer 0 to the input (``row_tile``)."""
    units, _, _, _ = _cfg_fields(cfg)
    K, _, n_hidden, D = _dims(cfg)
    H = max(units)
    return steps * bs * 2 * H * (2 * K + 3 * (n_hidden - 1) * H + 3 * D)


def train_flops_by_unit(cfg, steps: int, bs: int, compute_dtype: str) -> Tuple[int, int]:
    """``(tensor_core, cuda_core)`` flops of an epoch in a throughput mode,
    the split of :func:`train_flops` that the modes' bounds take (as
    ``fused_mlp.highf32_flops_per_row`` / ``bf16_flops_per_row`` split a
    launch): the (H, H) products of the forward, the delta products and the
    weight gradients on the tensor cores, one pass (the ``highf32`` bound
    counts them three times at the TF32 rate); on the CUDA cores the input
    (K) and output (D) layers' products, three passes in ``highf32`` (the
    split in FMAs), one in ``bfloat16``: two products of the input layer
    (forward and weight gradient), three of the output layer."""
    if compute_dtype not in ("highf32", "bfloat16"):
        raise ValueError(f"train_flops_by_unit splits 'highf32' or 'bfloat16'; got {compute_dtype!r}")
    units, _, _, _ = _cfg_fields(cfg)
    K, _, n_hidden, D = _dims(cfg)
    H = max(units)
    passes = 3 if compute_dtype == "highf32" else 1
    return steps * bs * 3 * 2 * H * (n_hidden - 1) * H, passes * steps * bs * 2 * H * (2 * K + 3 * D)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def train_tables(sde, generator: Optional[torch.Generator], xb: torch.Tensor, no_sigma: bool,
                 weighting: str = "dsm"):
    """Per-step ``(xt, zw, t, beta)`` tables for ``fused_train_epoch``.

    ``xb``: (steps, bs, D) standardized minibatches.  Step by step, the
    draws of ``ops.losses._draw_t_and_z`` from ``generator`` (the loss's
    own draw, in the loss's order), folded with the loss weighting
    ``weighting``: 'dsm' (denoising_score_matching) or 'lw'
    (log_prob_score_matching).  Returns (steps, bs, D) x2, (steps, bs) x2.
    """
    if weighting not in ("dsm", "lw"):
        raise ValueError(f"unknown weighting {weighting!r}; use 'dsm' or 'lw'")
    out = []
    for x in xb:
        t, z = losses_lib._draw_t_and_z(generator, sde, x)
        nu, sigma = sde.marginal_prob_scalars(t)
        xt = nu[:, None] * x + sigma[:, None] * z
        if weighting == "dsm":
            zw, beta = z, (sigma if no_sigma else torch.ones_like(sigma))
        else:
            g = torch.sqrt(sde.diffusion_squared_scalar(t))
            zw, beta = (g / sigma)[:, None] * z, (g if no_sigma else g / sigma)
        out.append((xt, zw, t, beta))
    return tuple(torch.stack(col) for col in zip(*out))


def train_tables_flow(generator: Optional[torch.Generator], xb: torch.Tensor):
    """Per-step ``(xt, zw, t, beta)`` tables for flow matching: the draws of
    ``ops.losses._draw_xT_and_t`` step by step, x_t = (1-t) x0 + t x_T,
    zw = -(x_T - x0), beta = 1.  Train with ``mean_over_dims=True``."""
    out = []
    for x0 in xb:
        xT, t = losses_lib._draw_xT_and_t(generator, x0)
        xt = (1.0 - t[:, None]) * x0 + t[:, None] * xT
        out.append((xt, -(xT - x0), t, torch.ones_like(t)))
    return tuple(torch.stack(col) for col in zip(*out))


def train_tables_symplectic(generator: Optional[torch.Generator], qb: torch.Tensor):
    """Per-step per-stack tables of the symplectic joint flow-matching loss.

    ``qb``: (steps, bs, D) standardized q minibatches.  Draw for draw as
    ``SymplecticFlowModel.loss_fn``: the momentum p0 ~ N(0, 1), then the
    flow-matching draw on the joint state s0 = [q0 | p0].  The joint field
    is [mlp_q(p_t), -mlp_p(q_t)], so the joint residual splits into the
    q stack's r_q = zw_q + mlp_q(xt_q) (xt_q = p_t, zw_q = -vhat_q) and the
    p stack's r_p = zw_p - mlp_p(xt_p) (xt_p = q_t, zw_p = -vhat_p).
    Returns ``(xt_q, zw_q, xt_p, zw_p, t)``.
    """
    D = qb.shape[-1]
    out = []
    for q0 in qb:
        s0 = torch.cat([q0, losses_lib._normal_like(generator, q0)], dim=-1)
        xT, t = losses_lib._draw_xT_and_t(generator, s0)
        xt = (1.0 - t[:, None]) * s0 + t[:, None] * xT
        vhat = xT - s0
        out.append((xt[:, D:], -vhat[:, :D], xt[:, :D], -vhat[:, D:], t))
    return tuple(torch.stack(col) for col in zip(*out))


# ---------------------------------------------------------------------------
# checks shared by the kernel and its plain version
# ---------------------------------------------------------------------------


def _fresh_opt_state(layers) -> Tuple[tuple, tuple, int]:
    zeros = tuple(torch.zeros_like(a) for lyr in layers for a in (lyr["w"], lyr["b"]))
    return zeros, zeros, 0


def _check_epoch(params, cfg, xt, zw, t, beta, conditional, ema, compute_dtype) -> None:
    """The guards of the JAX package's fused_train_epoch: a config family
    the kernel computes, a compute mode, its activation, float32 leaves, at
    least one step, the data and conditional widths, an even embedding."""
    if not isinstance(cfg, (ScoreMLPConfig, VelocityMLPConfig)):
        raise ValueError(
            "the fused training kernel computes ScoreMLPConfig / VelocityMLPConfig nets only; "
            f"got {type(cfg).__name__} — custom nets train on the plain engine "
            "(train.fit(engine='plain'))"
        )
    check_compute_dtype(compute_dtype)
    units, D_cfg, n_cond, E = _cfg_fields(cfg)
    if not fusable_config(units, cfg.activation):
        raise ValueError(
            f"the fused training kernel does not take units={units} activation={cfg.activation!r} "
            f"(activation one of {_KERNEL_ACTIVATIONS}) — train on the plain engine "
            "(train.fit(engine='plain'))"
        )
    leaves = [a for lyr in params["layers"] for a in (lyr["w"], lyr["b"])]
    leaves += [a for a in (xt, zw, t, beta, conditional) if a is not None]
    if ema is not None:
        leaves += [a for lyr in ema["layers"] for a in (lyr["w"], lyr["b"])]
    if E is not None:
        leaves.append(params["W"])
    bad = sorted({str(a.dtype) for a in leaves if a.dtype != torch.float32})
    if bad:
        raise ValueError(
            f"the fused training kernel stores float32 state; got tensors of dtype {bad} — cast "
            "the params and tables to float32 or train on the plain engine (train.fit(engine='plain'))"
        )
    if xt.ndim != 3 or xt.shape[0] < 1:
        raise ValueError(
            f"the fused training kernel needs (steps, bs, D) tables with at least one step; got "
            f"xt of shape {tuple(xt.shape)} (is the dataset smaller than the batch size?)"
        )
    steps, bs, D = xt.shape
    if D != D_cfg:
        raise ValueError(f"xt feature dim {D} != config data dim {D_cfg}")
    for name, a, shape in (("zw", zw, (steps, bs, D)), ("t", t, (steps, bs)), ("beta", beta, (steps, bs))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} of shape {tuple(a.shape)}; expected {shape}")
    if n_cond and conditional is None:
        raise ValueError(f"model expects {n_cond} conditional feature(s)")
    if not n_cond and conditional is not None:
        raise ValueError("conditional given to an unconditional model")
    if conditional is not None and tuple(conditional.shape) != (steps, bs, n_cond):
        raise ValueError(f"conditional of shape {tuple(conditional.shape)}; expected {(steps, bs, n_cond)}")
    if E is not None and E % 2:
        raise ValueError(f"embedding_dimensions must be even; got {E}")
    widths = [_dims(cfg)[0], *units, D_cfg]
    want = [((widths[i], widths[i + 1]), (widths[i + 1],)) for i in range(len(widths) - 1)]
    for name, tree in (("params", params), ("ema", ema)):
        got = [(tuple(l["w"].shape), tuple(l["b"].shape)) for l in tree["layers"]] if tree is not None else want
        if got != want:
            raise ValueError(f"{name} layers of shapes {got} do not match the config's {want}")


def _inv(bs: int, D: int, mean_over_dims: bool, loss_scale: Optional[float]) -> float:
    if loss_scale is not None:
        return float(loss_scale)
    return 1.0 / (bs * D) if mean_over_dims else 1.0 / bs


def _as_layers(pairs) -> list:
    return [{"w": w, "b": b} for w, b in pairs]


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _net_input(cfg, params, t: torch.Tensor, xt: torch.Tensor, conditional: Optional[torch.Tensor]):
    """The first layer's input u as the plain nets build it: [temb | x |
    cond] for score nets (``apply_score_mlp``), [x | t | cond] for velocity
    nets (``apply_velocity_mlp``)."""
    parts = [fourier_time_embedding(t, params["W"]), xt] if isinstance(cfg, ScoreMLPConfig) else [xt, t[:, None]]
    return torch.cat(parts + ([] if conditional is None else [conditional]), dim=-1)


def _chain_grads(layers, u, zw, beta, inv, mm, pair):
    """``(loss, grads)`` of one step of the table loss by the JAX kernel's
    explicit forward and backward chain (``_kernel``, the JAX package's
    ``kernels/fused_train.py:285-330``), every layer product through ``mm``
    and the activation through ``pair``: forward keeping each layer input h
    and act'; r = zw + beta net; delta = 2 inv beta r; per layer dW =
    mm(h^T, delta), db = sum delta (unrounded), delta <- mm(delta, W^T) *
    act'.  ``grads`` in the leaves' order (w, b, w, b, ...)."""
    hs, dhs = [u], []
    a = mm(u, layers[0]["w"]) + layers[0]["b"]
    for layer in layers[1:]:
        h, dh = pair(a)
        hs.append(h)
        dhs.append(dh)
        a = mm(h, layer["w"]) + layer["b"]
    r = zw + beta[:, None] * a
    loss = inv * torch.sum(r * r)
    delta = (2.0 * inv) * beta[:, None] * r
    grads = [None] * (2 * len(layers))
    for l in range(len(layers) - 1, -1, -1):
        grads[2 * l] = mm(hs[l].T, delta)
        grads[2 * l + 1] = torch.sum(delta, dim=0)
        if l > 0:
            delta = mm(delta, layers[l]["w"].T) * dhs[l - 1]
    return loss, grads


def fused_train_epoch_reference(
    params: dict,
    cfg,
    opt_state: Optional[Tuple] = None,
    *,
    xt: torch.Tensor,
    zw: torch.Tensor,
    t: torch.Tensor,
    beta: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    lr: float,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    ema: Optional[dict] = None,
    ema_decay: float = 0.0,
    mean_over_dims: bool = False,
    loss_scale: Optional[float] = None,
    compute_dtype: str = "float32",
):
    """The plain PyTorch version of :func:`fused_train_epoch`: each step,
    autograd of the table loss through ``apply_score_mlp`` /
    ``apply_velocity_mlp`` (TF32 off) in ``float32``, or in ``highf32`` and
    ``bfloat16`` the JAX kernel's explicit chain (:func:`_chain_grads`)
    over ``tf32x3_matmul`` / ``bf16_matmul`` and the tanh-form act pair;
    then the kernel's Adam formula in float32 and the EMA.  Returns what
    :func:`fused_train_epoch` returns."""
    check_compute_dtype(compute_dtype)
    apply = apply_score_mlp if isinstance(cfg, ScoreMLPConfig) else apply_velocity_mlp
    mm = {"highf32": tf32x3_matmul, "bfloat16": bf16_matmul}.get(compute_dtype)
    pair = _act_pair(cfg.activation)
    steps, bs, D = xt.shape
    inv = _inv(bs, D, mean_over_dims, loss_scale)
    leaves = [a.detach().clone() for lyr in params["layers"] for a in (lyr["w"], lyr["b"])]
    m, v, step0 = opt_state if opt_state is not None else _fresh_opt_state(params["layers"])
    m, v = [a.clone() for a in m], [a.clone() for a in v]
    with_ema = ema_decay > 0.0
    if with_ema:
        src = ema if ema is not None else params
        ema_leaves = [a.detach().clone() for lyr in src["layers"] for a in (lyr["w"], lyr["b"])]

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=xt.device)

    b1, b2, lr_, eps_, d = f32(beta1), f32(beta2), f32(lr), f32(eps), f32(ema_decay)
    log_b1, log_b2 = torch.log(b1), torch.log(b2)
    losses = []
    with strict_fp32_matmul():
        for s in range(steps):
            cond_s = None if conditional is None else conditional[s]
            if mm is None:
                for a in leaves:
                    a.requires_grad_(True)
                p = dict(params, layers=_as_layers(zip(leaves[0::2], leaves[1::2])))
                net = apply(cfg, p, t[s], xt[s], cond_s)
                r = zw[s] + beta[s][:, None] * net
                loss = inv * torch.sum(r * r)
                grads = torch.autograd.grad(loss, leaves)
            else:
                u = _net_input(cfg, params, t[s], xt[s], cond_s)
                loss, grads = _chain_grads(_as_layers(zip(leaves[0::2], leaves[1::2])), u, zw[s], beta[s], inv, mm,
                                           pair)
            losses.append(loss.detach())
            tstep = f32(step0 + s + 1)
            bc1 = 1.0 - torch.exp(tstep * log_b1)
            bc2 = 1.0 - torch.exp(tstep * log_b2)
            with torch.no_grad():
                for k, g in enumerate(grads):
                    m[k] = b1 * m[k] + (1.0 - b1) * g
                    v[k] = b2 * v[k] + (1.0 - b2) * g * g
                    leaves[k] = leaves[k].detach() - lr_ * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps_)
                    if with_ema:
                        ema_leaves[k] = d * ema_leaves[k] + (1.0 - d) * leaves[k]
    params_new = dict(params, layers=_as_layers(zip(leaves[0::2], leaves[1::2])))
    ema_out = dict(params, layers=_as_layers(zip(ema_leaves[0::2], ema_leaves[1::2]))) if with_ema else None
    return params_new, (tuple(m), tuple(v), step0 + steps), ema_out, torch.stack(losses)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def fused_train_epoch(
    params: dict,
    cfg,
    opt_state: Optional[Tuple] = None,
    *,
    xt: torch.Tensor,
    zw: torch.Tensor,
    t: torch.Tensor,
    beta: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    lr: float,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    ema: Optional[dict] = None,
    ema_decay: float = 0.0,
    compute_dtype: str = "float32",
    mean_over_dims: bool = False,
    loss_scale: Optional[float] = None,
):
    """Run ``steps`` Adam updates of a score or velocity net in one launch.

    ``xt``/``zw``: (steps, bs, D) tables, ``t``/``beta``: (steps, bs),
    ``conditional``: (steps, bs, C) — from :func:`train_tables` /
    :func:`train_tables_flow`, or given directly.  ``opt_state`` is None
    (fresh Adam) or the ``(m, v, step)`` of a previous call; ``ema`` /
    ``ema_decay`` keep the EMA of the updated parameters (from ``params``
    when ``ema`` is None).  ``mean_over_dims`` divides by bs D (the flow
    loss), ``loss_scale`` sets the normalization outright.

    ``compute_dtype`` is the JAX kernel's compute mode of the layer
    products, ``'float32'``, ``'highf32'`` or ``'bfloat16'`` (module
    docstring); the state stays float32 in every mode.

    Returns ``(params', (m, v, step'), ema', losses)`` with ``losses`` the
    (steps,) loss of each step before its update.  CUDA tensors launch the
    kernel (``fused_train_epoch.launches`` counts launches,
    ``launches_by_dtype`` by compute mode); CPU tensors run
    :func:`fused_train_epoch_reference` in the same mode.
    """
    return _epoch(params, cfg, opt_state, xt, zw, t, beta, conditional, lr, beta1, beta2, eps, ema,
                  ema_decay, compute_dtype, mean_over_dims, loss_scale, fused_train_epoch)


def _epoch(params, cfg, opt_state, xt, zw, t, beta, conditional, lr, beta1, beta2, eps, ema, ema_decay,
           compute_dtype, mean_over_dims, loss_scale, counter, plain=False):
    """The guards, then the kernel (CUDA tensors) or the plain version (CPU
    tensors, or ``plain``)."""
    with_ema = ema_decay > 0.0
    _check_epoch(params, cfg, xt, zw, t, beta, conditional, ema if with_ema else None, compute_dtype)
    plan = train_plan(cfg, xt.shape[1])
    if plan is None:
        K, H, n_hidden, D = _dims(cfg)
        raise ValueError(
            f"the fused training kernel's shared-memory plan does not fit: {n_hidden} hidden "
            f"layers of width {H} need {_row_floats(K, H, n_hidden, D)} floats a row, over its "
            f"limit of {_ADMIT_ROW_FLOATS} — train on the plain engine (train.fit(engine='plain'))"
        )
    kw = dict(xt=xt, zw=zw, t=t, beta=beta, conditional=conditional, lr=lr, beta1=beta1, beta2=beta2,
              eps=eps, ema=ema, ema_decay=ema_decay, mean_over_dims=mean_over_dims, loss_scale=loss_scale,
              compute_dtype=compute_dtype)
    if plain or not xt.is_cuda:
        return fused_train_epoch_reference(params, cfg, opt_state, **kw)
    return _launch_epoch(params, cfg, opt_state, plan, counter, **kw)


def _pack(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], K: int, H: int, D: int) -> torch.Tensor:
    """Layers as one flat float32 buffer in the kernel's layout: per layer
    the (K_l, N_l) weight row-major, then its (N_l,) bias, each zero-padded
    to the kernel's widths (K and D to multiples of LANE, hidden to H)."""
    parts = []
    for (w, b), (k_l, n_l) in zip(pairs, _layer_shapes(K, H, len(pairs) - 1, D)):
        parts.append(F.pad(w, (0, n_l - w.shape[1], 0, k_l - w.shape[0])).reshape(-1))
        parts.append(F.pad(b, (0, n_l - b.shape[0])))
    return torch.cat(parts).contiguous()


def _unpack(flat: torch.Tensor, like: Sequence[Tuple[torch.Tensor, torch.Tensor]], K: int, H: int,
            D: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The inverse of :func:`_pack`, padding stripped to ``like``'s shapes."""
    out, off = [], 0
    for (w, b), (k_l, n_l) in zip(like, _layer_shapes(K, H, len(like) - 1, D)):
        wp = flat[off: off + k_l * n_l].view(k_l, n_l)
        off += k_l * n_l
        out.append((wp[: w.shape[0], : w.shape[1]].contiguous(), flat[off: off + b.shape[0]].clone()))
        off += n_l
    return out


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_train")
    if lib.ff_fused_train.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip = ctypes.POINTER(i)
        lib.ff_fused_train.argtypes = [p] * 16 + [i] * 15 + [f] * 6 + [i, p]
        lib.ff_fused_train.restype = ctypes.c_int
        lib.ff_fused_train_capacity.argtypes = [i, ctypes.c_size_t, ip, ip]
        lib.ff_fused_train_capacity.restype = ctypes.c_int
        lib.ff_fused_train_attributes.argtypes = [i, ip, ip]
        lib.ff_fused_train_attributes.restype = ctypes.c_int
    return lib


_CAPACITY: Dict[Tuple[int, int, str], Tuple[int, int]] = {}


def _capacity(device: torch.device, smem: int, compute_dtype: str) -> Tuple[int, int]:
    """(blocks an SM can hold for this plan, SM count) of the mode's
    instantiation: a cooperative launch's grid may not exceed their
    product.  Raises where the card cannot make a cooperative launch of
    this plan."""
    key = (device.index or 0, smem, compute_dtype)
    if key not in _CAPACITY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _kernel_lib().ff_fused_train_capacity(COMPUTE_DTYPES.index(compute_dtype), smem,
                                                        ctypes.byref(per_sm), ctypes.byref(sms))
        if err != 0 or per_sm.value < 1:
            raise RuntimeError(
                f"fused_train kernel: no cooperative launch of blocks with {smem} bytes of shared memory on "
                f"{device} (CUDA error {err}, {per_sm.value} blocks an SM)"
            )
        _CAPACITY[key] = (per_sm.value, sms.value)
    return _CAPACITY[key]


def launch_grid(device: torch.device, plan, bs: int, compute_dtype: str = "float32") -> int:
    """The grid of a launch: a block for every row tile, at least one for
    every SM (phase B strides over the parameter tiles with the whole
    grid), never more than the card holds at once."""
    per_sm, sms = _capacity(device, plan[1], compute_dtype)
    return min(per_sm * sms, max(-(-bs // plan[0]), sms))


def occupancy(plan, device: Optional[torch.device] = None, compute_dtype: str = "float32") -> dict:
    """What the card makes of ``plan`` in ``compute_dtype``: blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local-memory bytes a thread of the instantiation it launches."""
    check_compute_dtype(compute_dtype)
    device = device or torch.device("cuda")
    regs, local_bytes = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = _kernel_lib().ff_fused_train_attributes(COMPUTE_DTYPES.index(compute_dtype), ctypes.byref(regs),
                                                      ctypes.byref(local_bytes))
    if err != 0:
        raise RuntimeError(f"fused_train attribute query failed with CUDA error {err}")
    return dict(rows=plan[0], smem_bytes=plan[1], blocks_per_sm=_capacity(device, plan[1], compute_dtype)[0],
                registers=regs.value, local_bytes=local_bytes.value)


_TILES: Dict[Tuple[Tuple[int, int, int, int], torch.device], torch.Tensor] = {}


def _tiles_on(device: torch.device, dims: Tuple[int, int, int, int]) -> torch.Tensor:
    """:func:`param_tiles` as an int32 tensor on ``device``, made once."""
    key = (dims, device)
    if key not in _TILES:
        _TILES[key] = torch.tensor(param_tiles(*dims), dtype=torch.int32, device=device)
    return _TILES[key]


def _launch_epoch(params, cfg, opt_state, plan, counter, *, xt, zw, t, beta, conditional, lr, beta1, beta2,
                  eps, ema, ema_decay, mean_over_dims, loss_scale, compute_dtype):
    """Pack the state, launch the kernel once on the current stream, unpack."""
    steps, bs, D = xt.shape
    K, H, _, _ = _dims(cfg)
    E = _cfg_fields(cfg)[3]
    pairs = [(lyr["w"], lyr["b"]) for lyr in params["layers"]]
    m, v, step0 = opt_state if opt_state is not None else _fresh_opt_state(params["layers"])
    with_ema = ema_decay > 0.0
    ema_src = (ema if ema is not None else params) if with_ema else None
    tensors = [a for pair in pairs for a in pair] + list(m) + list(v) + [xt, zw, t, beta]
    tensors += [conditional] if conditional is not None else []
    tensors += [a for lyr in ema_src["layers"] for a in (lyr["w"], lyr["b"])] if with_ema else []
    same_device(*tensors, params["W"] if E is not None else None)
    if not all(a.is_cuda for a in tensors):
        raise ValueError("fused_train kernel takes CUDA tensors only")
    state = [_pack(pairs, K, H, D), _pack(list(zip(m[0::2], m[1::2])), K, H, D),
             _pack(list(zip(v[0::2], v[1::2])), K, H, D),
             _pack([(l["w"], l["b"]) for l in ema_src["layers"]], K, H, D) if with_ema else None]
    tables = [None if a is None else a.contiguous() for a in (xt, zw, t, beta, conditional, params.get("W"))]
    loss = launch_packed(cfg, plan, *tables, *state, int(step0), lr, beta1, beta2, eps, ema_decay,
                         _inv(bs, D, mean_over_dims, loss_scale), counter, compute_dtype=compute_dtype)

    def unpack(flat):
        return _unpack(flat, pairs, K, H, D)

    params_new = dict(params, layers=_as_layers(unpack(state[0])))
    m_new = tuple(a for pair in unpack(state[1]) for a in pair)
    v_new = tuple(a for pair in unpack(state[2]) for a in pair)
    ema_out = dict(params, layers=_as_layers(unpack(state[3]))) if with_ema else None
    return params_new, (m_new, v_new, int(step0) + steps), ema_out, loss


def launch_packed(cfg, plan, xt, zw, t, beta, conditional, W, p_flat, m_flat, v_flat, ema_flat, step0, lr, beta1,
                  beta2, eps, ema_decay, inv, counter=None, grid: Optional[int] = None,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """One launch of the kernel in ``compute_dtype`` on state already in
    its flat layout (:func:`_pack`), updated in place; returns the (steps,)
    losses and adds the launch to ``counter`` (default
    ``fused_train_epoch``) and its ``launches_by_dtype``.  ``grid`` forces
    a grid (at most what the card holds).  Checks the operands and raises
    on anything the kernel does not take."""
    check_compute_dtype(compute_dtype)
    rows, _ = plan
    steps, bs, D = xt.shape
    dims = _dims(cfg)
    K, H, n_hidden, _ = dims
    _, _, C, E = _cfg_fields(cfg)
    n_param = sum((k + 1) * n for k, n in _layer_shapes(*dims))
    ops = [xt, zw, t, beta] + [a for a in (conditional, W if E is not None else None, ema_flat) if a is not None]
    ops += [p_flat, m_flat, v_flat]
    device = same_device(*ops)
    for a in ops:
        if not a.is_cuda or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError("fused_train kernel takes contiguous float32 CUDA tensors")
    if any(a.numel() != n_param for a in (p_flat, m_flat, v_flat, ema_flat) if a is not None):
        raise ValueError(f"fused_train kernel: flat state must hold {n_param} floats")
    per_sm, sms = _capacity(device, plan[1], compute_dtype)
    if grid is None:
        grid = launch_grid(device, plan, bs, compute_dtype)
    elif not 1 <= grid <= per_sm * sms:
        raise ValueError(f"fused_train kernel: a grid of {grid} blocks is more than the card holds at once")
    tiles = _tiles_on(device, dims)
    temb = None if E is None else torch.empty((steps * bs * E,), dtype=torch.float32, device=device)
    ws_h, ws_d, ws_loss = (torch.empty((n,), dtype=torch.float32, device=device)
                           for n in workspace_floats(cfg, bs))
    loss = torch.empty((steps,), dtype=torch.float32, device=device)

    def ptr(a):
        return None if a is None else a.data_ptr()

    with torch.cuda.device(device):
        err = _kernel_lib().ff_fused_train(
            ptr(xt), ptr(zw), ptr(t), ptr(beta), ptr(conditional), ptr(W if E is not None else None), ptr(temb),
            ptr(tiles),
            ptr(p_flat), ptr(m_flat), ptr(v_flat), ptr(ema_flat), ptr(ws_h), ptr(ws_d), ptr(ws_loss), ptr(loss),
            steps, bs, D, C, 0 if E is None else E // 2, _pad(K), H, n_hidden, _pad(D),
            _KERNEL_ACTIVATIONS.index(cfg.activation), rows, tiles.shape[0], step0, plan_wbuf(cfg, plan),
            COMPUTE_DTYPES.index(compute_dtype), lr, beta1, beta2, eps, ema_decay, inv, grid,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_train kernel launch failed with CUDA error {err}")
    _build.count_launch(counter or fused_train_epoch, launches_by_dtype=compute_dtype)
    return loss


# ---------------------------------------------------------------------------
# the symplectic form: two launches, one a stack
# ---------------------------------------------------------------------------


def _sympl_half_cfg(cfg: SymplecticMLPConfig) -> ScoreMLPConfig:
    """The ScoreMLP-shaped config of one symplectic stack: a Fourier-time
    net over [x, cond, temb], the score net's [temb, x, cond] up to the
    input order, which :func:`_sympl_perm_layer0` folds into layer 0."""
    return ScoreMLPConfig(
        n_dimensions=cfg.n_data_dims, n_conditionals=cfg.n_conditionals,
        embedding_dimensions=cfg.embedding_dimensions, units=cfg.units, activation=cfg.activation,
    )


def _sympl_perm_layer0(layers, D: int, C: int, E: int, inverse: bool) -> list:
    """Permute the layer-0 weight rows between a stack's input order
    [x(D), cond(C), temb(E)] and the score kernel's [temb(E), x(D), cond(C)]
    (``inverse``: back).  A relabeling of the inputs: training in the
    permuted basis trains the net itself."""
    w0 = layers[0]["w"]
    if inverse:
        w0p = torch.cat([w0[E: E + D], w0[E + D:], w0[:E]])
    else:
        w0p = torch.cat([w0[D + C:], w0[:D], w0[D: D + C]])
    return [dict(layers[0], w=w0p)] + list(layers[1:])


def fused_train_epoch_symplectic(
    params: dict,
    cfg: SymplecticMLPConfig,
    opt_state: Optional[Tuple] = None,
    *,
    xt_q: torch.Tensor,
    zw_q: torch.Tensor,
    xt_p: torch.Tensor,
    zw_p: torch.Tensor,
    t: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    lr: float,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    ema: Optional[dict] = None,
    ema_decay: float = 0.0,
    compute_dtype: str = "float32",
):
    """Training epochs of a ``SymplecticFlowModel``'s two stacks, one
    launch each in ``compute_dtype`` (CUDA tensors;
    ``fused_train_epoch_symplectic.launches`` counts them) or the plain
    version (CPU tensors).

    The stacks share no parameter, so each trains as its own
    :func:`fused_train_epoch` on its half of the tables
    (:func:`train_tables_symplectic`): beta = +1 for the q stack and -1 for
    the p stack (dp/dt = -mlp_p), inv = 1/(bs 2D) for the joint mean, and
    the stack's input order folded into a layer-0 row permutation.
    ``opt_state`` is None or the ``(opt_q, opt_p)`` of a previous call.
    Returns ``(params', (opt_q, opt_p), ema', losses)``, ``losses`` the
    joint (q + p) loss of each step.
    """
    return _symplectic(params, cfg, opt_state, xt_q, zw_q, xt_p, zw_p, t, conditional, lr, beta1, beta2, eps, ema,
                       ema_decay, compute_dtype, plain=False)


def fused_train_epoch_symplectic_reference(
    params: dict,
    cfg: SymplecticMLPConfig,
    opt_state: Optional[Tuple] = None,
    *,
    xt_q: torch.Tensor,
    zw_q: torch.Tensor,
    xt_p: torch.Tensor,
    zw_p: torch.Tensor,
    t: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    lr: float,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    ema: Optional[dict] = None,
    ema_decay: float = 0.0,
    compute_dtype: str = "float32",
):
    """The plain PyTorch version of :func:`fused_train_epoch_symplectic`
    on any device: both stacks through :func:`fused_train_epoch_reference`
    in ``compute_dtype``."""
    return _symplectic(params, cfg, opt_state, xt_q, zw_q, xt_p, zw_p, t, conditional, lr, beta1, beta2, eps, ema,
                       ema_decay, compute_dtype, plain=True)


def _symplectic(params, cfg, opt_state, xt_q, zw_q, xt_p, zw_p, t, conditional, lr, beta1, beta2, eps, ema,
                ema_decay, compute_dtype, plain):
    if not isinstance(cfg, SymplecticMLPConfig):
        raise ValueError(
            "fused_train_epoch_symplectic trains SymplecticMLPConfig nets only; got "
            f"{type(cfg).__name__} — custom nets train on the plain engine (train.fit(engine='plain'))"
        )
    D, C, E = cfg.n_data_dims, cfg.n_conditionals, cfg.embedding_dimensions
    half_cfg = _sympl_half_cfg(cfg)
    steps, bs = t.shape
    opt_q, opt_p = opt_state if opt_state is not None else (None, None)
    with_ema = ema_decay > 0.0
    ema_src = (ema if ema is not None else params) if with_ema else None
    outs = {}
    for stack, xt_s, zw_s, sign, opt_s in (("q_layers", xt_q, zw_q, 1.0, opt_q),
                                            ("p_layers", xt_p, zw_p, -1.0, opt_p)):
        half = {"W": params["W"], "layers": _sympl_perm_layer0(params[stack], D, C, E, False)}
        half_ema = ({"W": params["W"], "layers": _sympl_perm_layer0(ema_src[stack], D, C, E, False)}
                    if with_ema else None)
        p_new, opt_new, ema_new, losses = _epoch(
            half, half_cfg, opt_s, xt_s, zw_s, t, torch.full_like(t, sign), conditional, lr, beta1, beta2,
            eps, half_ema, ema_decay, compute_dtype, False, 1.0 / (bs * 2 * D), fused_train_epoch_symplectic,
            plain=plain,
        )
        outs[stack] = (
            _sympl_perm_layer0(p_new["layers"], D, C, E, True), opt_new,
            _sympl_perm_layer0(ema_new["layers"], D, C, E, True) if with_ema else None, losses,
        )
    params_new = dict(params, q_layers=outs["q_layers"][0], p_layers=outs["p_layers"][0])
    ema_out = dict(params, q_layers=outs["q_layers"][2], p_layers=outs["p_layers"][2]) if with_ema else None
    return params_new, (outs["q_layers"][1], outs["p_layers"][1]), ema_out, outs["q_layers"][3] + outs["p_layers"][3]


def reset_launch_counts() -> None:
    """Zero the launch counts of both wrappers of the training kernel, and
    their splits by compute mode (``launches_by_dtype``)."""
    for fn in (fused_train_epoch, fused_train_epoch_symplectic):
        fn.launches = 0
        fn.launches_by_dtype = dict.fromkeys(COMPUTE_DTYPES, 0)


reset_launch_counts()
