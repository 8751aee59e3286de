"""Fused score-MLP drift and flow velocity (+ Hutchinson or exact
divergence, or K Jacobian-vector columns) on the card, and the symplectic
velocity built from two forward launches.

Counterpart of the JAX package's ``kernels/fused_mlp.py::fused_drift``,
``fused_velocity``, ``fused_drift_tangents``, ``fused_velocity_tangents``
and ``fused_symplectic_velocity`` in their modes ``forward``,
``hutchinson``, ``exact`` and ``tangents``, at compute mode ``float32``
(strict fp32), ``highf32`` (3xTF32 layer products and the tanh-form SiLU,
the JAX package's 3-pass split mode; :func:`tf32x3_matmul` is the port's
one source of the split) or ``bfloat16`` (the JAX package's fast serving
mode: bf16 operands, fp32 sums, the tanh-form SiLU; :func:`bf16_matmul` is
the port's one source of its rounding points).  On CUDA tensors the wrappers launch the
hand-written kernel ``csrc/fused_mlp.cu`` (built at first use, see
``_build``) or raise; on CPU tensors they run the plain PyTorch versions
(``*_reference``) in the same compute mode.  The sketch estimators'
one-launch kernel is ``kernels/fused_sketch.py``.

During a solve the time ``t`` is a batch-global scalar, so the Fourier
embedding contributes a t-dependent bias to the first layer:
  in = [temb | x | cond]  =>  a1 = [x | cond] W1[E:] + (b1 + temb W1[:E])
computed here with plain tensor ops on the device (``_score_first_layer``);
the kernel never sees the embedding rows.  The SDE enters through two
scalars, read by the kernel from a 2-float device buffer so no RHS call
syncs with the host:
  drift = c0 * x + c1 * net(t, x[, cond])
  div   = c0 |e|^2 + c1 e.J_net e   (hutchinson)  |  c0 D + c1 tr J_net  (exact)
  J v_k = c0 v_k + c1 J_net v_k      (tangents, K probes)

The velocity net takes raw t as an input feature after x, so its fold is
``b_eff = b1 + t W1[D]`` with ``w_in`` the [x | cond] rows
(``_velocity_first_layer``), and it runs the same kernel with
(c0, c1) = (0, 1).  Each symplectic stack takes [x_other | cond | temb], so
its fold takes the TRAILING rows: ``b_eff = b1 + temb W1[D+C:]``; the q
stack runs on p with (0, +1), the p stack on q with (0, -1).  Each wrapper
counts its own launches.

A launch's plan, :func:`_plan`, is ``(rows, smem_bytes, group, planes)``:
the rows a block owns (the most blocks an SM holds, up to three, counted
with the 1 KB each block reserves, at the most rows that reach them), its
shared memory, the tangent chains a pass carries and whether ``highf32``
keeps its TF32 hi and lo planes.  Every tangent chain rides in one pass,
with the planes, wherever that fits; only the widest nets take passes of
fewer chains (exact and tangents) or a ``highf32`` product that splits as
it loads.  A row's arithmetic does not depend on the plan.  The sketch
and EM kernels plan with :func:`_pick_rows` too, each at its own block
cap.  The hidden layers reach every kernel through a table of their
pointers in device memory (:func:`layer_table`), so a net may have any
depth.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.func import jvp

from .._device import same_device, strict_fp32_matmul
from ..models.nets import (
    _apply_mlp_stack,
    apply_score_mlp,
    apply_symplectic_mlp,
    apply_velocity_mlp,
    fourier_time_embedding,
)
from . import _build

__all__ = [
    "tf32_round",
    "tf32x3_matmul",
    "bf16_round",
    "bf16_matmul",
    "fused_drift",
    "fused_drift_reference",
    "fused_velocity",
    "fused_velocity_reference",
    "fused_drift_tangents",
    "fused_drift_tangents_reference",
    "fused_velocity_tangents",
    "fused_velocity_tangents_reference",
    "fused_symplectic_velocity",
    "fused_symplectic_velocity_reference",
    "pad_to_lanes",
    "paddable_config",
    "fusable_config",
    "supports_config",
    "supports_features",
    "flops_per_row",
    "occupancy",
    "plan_blocks",
    "reset_launch_counts",
]

_KERNEL_ACTIVATIONS = ("silu", "tanh", "relu", "gelu")  # index = kernel's Act
_MODES = ("forward", "hutchinson", "exact", "tangents")  # index = kernel's Mode
COMPUTE_DTYPES = ("float32", "highf32", "bfloat16")  # index = the kernel's precision
# Hidden widths are padded to a multiple of this: the kernel reads four
# activations and four weight columns at a time.  highf32 pads to the
# 8-wide n-tile of its tensor-core product (LANE_HIGHF32), bfloat16 to the
# 16-deep k-step of its m16n8k16 product (LANE_BF16).
LANE = 4
LANE_HIGHF32 = 8
LANE_BF16 = 16
# Input features up to which the highf32 mode keeps the input projection
# strict (the JAX kernel's rank-1 crossover, in_proj_rows; csrc kRank1Max).
RANK1_MAX = 16
_SMEM_LIMIT = 232_448  # shared memory one block may use on sm_90
# What an SM holds for its resident blocks: 228 KB of shared memory, of which
# each block also reserves 1 KB for the system.  k blocks share an SM when
# k x (smem + _SMEM_BLOCK_RESERVE) <= _SMEM_PER_SM.
_SMEM_PER_SM = 233_472
_SMEM_BLOCK_RESERVE = 1_024
KERNEL_BLOCKS = 3  # blocks an SM the kernel's launch bounds allow (csrc kMinBlocks)
PAD = 4  # floats past H in a row of the kernel's activation buffers (csrc kPad)
PAD_BF16 = 8  # the same in bfloat16, where the bf16 plane shares the row stride (csrc kPadBF16)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as PTX ``cvt.rna.tf32.f32``: on the int32 view, add 0x1000 and
    clear the low 13 bits.  Non-finite values pass through unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _split(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the 3xTF32 split product of compute mode ``highf32``:
    each operand splits into hi = tf32(v) and lo = tf32(v - hi), and the
    product is hi hi + hi lo + lo hi in fp32, lo lo dropped (the
    counterpart of the JAX package's ``bf16_3pass_dot_general``, with TF32
    halves).  The three products run with TF32 off, so the card does not
    round the halves a second time."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    with strict_fp32_matmul():
        return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (8 mantissa bits, to nearest even, as
    ``__float2bfloat16_rn`` and the TPU's casts), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor, round_a: bool = True) -> torch.Tensor:
    """``a @ b`` as compute mode ``bfloat16`` multiplies: both operands
    rounded to bf16 (``round_a=False``: the weights ``b`` alone, the JAX
    kernel's rank-1 input projection), the products then exact in fp32 and
    summed in strict fp32.

    The rounding points are the JAX kernel's on the TPU
    (the JAX package's ``kernels/fused_mlp.py``):

    - ``_compute_mode`` (:175-201) gives bf16 operands at
      ``Precision.DEFAULT``, one MXU pass, f32 accumulation;
    - the wrapper casts ``w_in``, every hidden weight and ``w_out`` to bf16
      (:1311-1314, :1323, :1326); biases and ``b_eff`` (the time fold)
      stay f32;
    - ``_kernel``'s ``mm`` (:554-560) casts the activation, or the tangent
      ``act'(a) * t``, to bf16 before every hidden product (:682, :801) and
      the output product (:685, :693, :807, :810); the tangent chains round
      like the drift (``relax_tangents`` is float32's alone, :577-582);
    - ``in_proj_rows`` (:313-331) projects up to ``RANK1_MAX`` inputs (the
      data and conditional, or a probe's D) as a rank-1 sum of bf16 weights
      times the f32 inputs, and more than that through ``mm``;
    - the activation is the tanh-form sigmoid (:598, ``_act_pair_fn``
      :257-300).

    XLA's CPU runtime promotes an f32 x bf16 dot to exact f32, so only the
    MXU rounds both operands: the port follows the TPU.  A bf16 x bf16
    product is exact in f32, so the kernel and this plain version differ
    only in the order of the f32 sums (and where that moves an activation
    across a bf16 rounding boundary).  The EM kernel rounds the same way
    (the JAX package's ``kernels/em_sampler.py``: ``_em_weight_dtype`` :64-70,
    the casts :417-441, the dots :160-170, the tanh-form sigmoid :177)."""
    with strict_fp32_matmul():
        return (bf16_round(a) if round_a else a) @ bf16_round(b)


def _tanh_silu(a: torch.Tensor) -> torch.Tensor:
    """SiLU through the tanh-form sigmoid 0.5 + 0.5 tanh(a / 2), the JAX
    kernel's throughput-mode activation (kernels/fused_mlp.py:257-279)."""
    return a * (0.5 + 0.5 * torch.tanh(0.5 * a))


def _act_pair(activation: str):
    """``a -> (act(a), act'(a))`` as the kernels compute the pair in their
    throughput modes (the JAX kernel's ``_act_pair_fn`` with the tanh-form
    sigmoid, kernels/fused_mlp.py:257-300; the port's ``act_pair_highf32``
    in csrc/mlp_tile.cuh)."""
    if activation == "silu":
        def pair(a):
            s = 0.5 + 0.5 * torch.tanh(0.5 * a)
            return a * s, s * (1.0 + a * (1.0 - s))
    elif activation == "tanh":
        def pair(a):
            h = torch.tanh(a)
            return h, 1.0 - h * h
    elif activation == "relu":
        def pair(a):
            m = (a > 0).to(a.dtype)
            return a * m, m
    else:  # gelu, the exact erf form: a Phi(a), Phi(a) + a phi(a)
        def pair(a):
            cdf = 0.5 * (1.0 + torch.erf(a * 0.7071067811865476))
            return a * cdf, cdf + a * (0.3989422804014327 * torch.exp(-0.5 * a * a))
    return pair


def _bf16_chains(layers, w_in, b_eff, x_in, probes, activation: str, d_out: int):
    """``(net, [J_net v for v in probes])`` of one layer stack in compute
    mode ``bfloat16``, its first layer folded as the kernel takes it
    (``x_in`` = [x | cond] times ``w_in`` plus ``b_eff``; ``layers[1:]``
    the rest), computed as the JAX kernel's ``_kernel`` computes them
    (``compute_chunk``, kernels/fused_mlp.py:780-830): every product through
    :func:`bf16_matmul`, the input projection of ``x_in`` and of each probe
    (B, d_out) rounded past ``RANK1_MAX`` features only, each tangent chain
    multiplied by act'(a) and rounded like the drift."""
    pair = _act_pair(activation)
    a = bf16_matmul(x_in, w_in, x_in.shape[1] > RANK1_MAX) + b_eff
    ts = [bf16_matmul(v, w_in[:d_out], d_out > RANK1_MAX) for v in probes]
    for layer in layers[1:]:
        h, dh = pair(a)
        ts = [bf16_matmul(dh * t, layer["w"]) for t in ts]
        a = bf16_matmul(h, layer["w"]) + layer["b"]
    return a, ts


def _bf16_reference(layers, w_in, b_eff, x, conditional, activation, c0, c1, e=None, exact=False, V=None):
    """The plain version of one kernel launch in ``bfloat16`` on folded
    operands: ``drift = c0 x + c1 net`` and, with a probe ``e``, the
    Hutchinson ``div = c0 |e|^2 + c1 e.J_net e``; with ``exact``, ``c0 D +
    c1 tr J_net`` over the D basis chains; with tangents ``V`` (K, B, D),
    the K columns ``c0 v + c1 J_net v`` as a list."""
    D = x.shape[1]
    x_in = x if conditional is None else torch.cat([x, conditional], dim=-1)
    if V is not None:
        probes = list(V)
    elif e is not None:
        probes = [e]
    elif exact:
        probes = list(torch.eye(D, dtype=x.dtype, device=x.device)[:, None, :].expand(D, x.shape[0], D))
    else:
        probes = []
    net, jv = _bf16_chains(layers, w_in, b_eff, x_in, probes, activation, D)
    drift = c0 * x + c1 * net
    if V is not None:
        return drift, [c0 * v + c1 * j for v, j in zip(V, jv)]
    if e is not None:
        return drift, c0 * torch.sum(e * e, dim=-1) + c1 * torch.sum(jv[0] * e, dim=-1)
    if exact:
        return drift, c0 * D + c1 * sum(j[:, d] for d, j in enumerate(jv))
    return drift


class _TF32x3(torch.autograd.Function):
    """:func:`tf32x3_matmul` whose forward derivative is the same split
    product of the tangent, as the kernel runs its tangent chains."""

    @staticmethod
    def forward(a, b):
        return tf32x3_matmul(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, a_dot, b_dot):
        a, b = ctx.saved_tensors
        out = 0.0
        if a_dot is not None:
            out = out + tf32x3_matmul(a_dot, b)
        if b_dot is not None:
            out = out + tf32x3_matmul(a, b_dot)
        return out


def _net_ops(compute_dtype: str, activation: str, n_features: int) -> dict:
    """The ``matmul``/``in_matmul``/``act`` keywords that make the
    ``models.nets`` forwards compute as the kernel does in
    ``compute_dtype`` ({} in ``float32``): in ``highf32`` the split on every
    layer after the first, and on the first when its [x | cond] input has
    more than ``RANK1_MAX`` features, and the tanh-form SiLU.  The first
    layer's split also covers the time-embedding rows, which the kernel
    folds strictly into its bias: the two differ by the split's error on
    those rows, far inside the kernel's bars.  (``bfloat16`` has its own
    plain version, :func:`_bf16_reference`.)"""
    if compute_dtype == "float32":
        return {}
    ops = {"matmul": _TF32x3.apply}
    if n_features > RANK1_MAX:
        ops["in_matmul"] = _TF32x3.apply
    if activation == "silu":
        ops["act"] = _tanh_silu
    return ops


def lane(compute_dtype: str = "float32") -> int:
    """The multiple the kernel pads hidden widths to in ``compute_dtype``."""
    return {"highf32": LANE_HIGHF32, "bfloat16": LANE_BF16}.get(compute_dtype, LANE)


def paddable_config(units: Sequence[int], activation: str = "silu") -> bool:
    """True when :func:`pad_to_lanes` can lift the config into the kernel's
    envelope: any hidden widths and any depth, with an activation the
    kernel implements.  Every kernel activation has act(0) == 0, which
    makes the zero-padding exact."""
    return len(units) >= 1 and activation in _KERNEL_ACTIVATIONS


def fusable_config(units: Sequence[int], activation: str = "silu") -> bool:
    """Config half of the fused envelope, padding included: what the
    models' dispatch consults.  Every config :func:`supports_config` takes
    as it is is paddable, so this is :func:`paddable_config`; the
    feature-count half is :func:`supports_features` (and
    ``fused_sketch.supports_sketch``)."""
    return paddable_config(units, activation)


def supports_config(
    units: Sequence[int], activation: str = "silu", compute_dtype: str = "float32"
) -> bool:
    """The configs the kernel takes as they are: :func:`fusable_config`
    with uniform hidden widths in multiples of ``lane(compute_dtype)``."""
    return (
        fusable_config(units, activation)
        and all(u == units[0] for u in units)
        and units[0] % lane(compute_dtype) == 0
    )


def supports_features(
    n_features: int, mode: str = "hutchinson", hidden: int = 128,
    n_dimensions: Optional[int] = None, compute_dtype: str = "float32", n_tan: int = 0,
) -> bool:
    """Feature-count half of the envelope: whether the kernel's
    shared-memory plan (:func:`_plan`) fits ``n_features`` = D + C inputs
    and D = ``n_dimensions`` outputs (default: every feature) at hidden
    width ``hidden`` in ``mode`` (``n_tan`` probes in mode tangents).  The
    JAX package's ``exact`` flag becomes ``mode`` here, because the plan
    grows with the chain count.  The depth is the config half's
    (:func:`fusable_config`): the RHS kernel's plan does not depend on it."""
    d_out = n_features if n_dimensions is None else n_dimensions
    H = -(-hidden // lane(compute_dtype)) * lane(compute_dtype)
    return _default_plan(H, mode, n_features, d_out, n_tan, compute_dtype) is not None


def _pad_stack(layers: list, H: int) -> list:
    """One layer stack with its hidden widths zero-padded to ``H``."""
    padded = []
    for i, lyr in enumerate(layers):
        w, b = lyr["w"], lyr["b"]
        pad_in = H - w.shape[0] if i > 0 else 0
        pad_out = H - w.shape[1] if i < len(layers) - 1 else 0
        padded.append({"w": F.pad(w, (0, pad_out, 0, pad_in)), "b": F.pad(b, (0, pad_out))})
    return padded


def pad_to_lanes(params: dict, cfg, compute_dtype: str = "float32"):
    """Zero-pad hidden widths to one uniform multiple of
    ``lane(compute_dtype)``, for the score, the velocity and the symplectic
    net alike (every layer stack of ``params``: ``layers``, or ``q_layers``
    and ``p_layers``).

    Exact: a padded unit has zero weight column and bias, so zero
    pre-activation, zero activation (act(0) == 0) and zero tangent, and
    contributes nothing downstream.  Returns ``(params, cfg)`` unchanged
    when the config is already supported."""
    field = "units" if hasattr(cfg, "units") else "hidden_units"  # score/symplectic | velocity
    units = getattr(cfg, field)
    if supports_config(units, cfg.activation, compute_dtype):
        return params, cfg
    if not fusable_config(units, cfg.activation):
        raise ValueError(
            f"fused kernel cannot pad units={units} "
            f"activation={cfg.activation!r} into its envelope (activation must "
            f"be one of {_KERNEL_ACTIVATIONS})"
        )
    H = max(-(-u // lane(compute_dtype)) * lane(compute_dtype) for u in units)
    stacks = {k: _pad_stack(params[k], H) for k in ("layers", "q_layers", "p_layers") if k in params}
    return {**params, **stacks}, dataclasses.replace(cfg, **{field: (H,) * len(units)})


def flops_per_row(
    d_in: int, d_out: int, H: int, n_layers: int, mode: str, n_tan: int = 0, n_tan2: int = 0
) -> int:
    """Kernel flops per row: 2 H (D_in + (n_hidden - 1) H + D) per chain,
    1 + n_applies chains (the JAX package's kernels/fused_mlp.py:921-934):
    n_applies = 0, 1, D, K (tangents, ``n_tan`` = K), r + r + m (hutchpp,
    ``n_tan`` = r, ``n_tan2`` = m) or 2 m (xtrace, ``n_tan`` = m);
    ``n_layers`` counts every weight layer.  A probe's chain (hutchinson,
    tangents and the sketch modes) projects its D values through
    w_in[:D], so it counts d_out input rows where the JAX formula counts
    d_in (the same where there is no conditional); exact keeps the JAX
    formula.  The sketch modes' per-row algebra (QR, projections,
    leave-one-out) is not counted: O(k^2 D) a row for k = r + m or m
    probes, under 1% of the chains at D = 64 and k <= 8."""
    n_applies = {
        "forward": 0, "hutchinson": 1, "exact": d_out, "tangents": n_tan,
        "hutchpp": 2 * n_tan + n_tan2, "xtrace": 2 * n_tan,
    }[mode]
    probe_rows = d_in if mode == "exact" else d_out
    return 2 * H * ((d_in + (n_layers - 2) * H + d_out) + (probe_rows + (n_layers - 2) * H + d_out) * n_applies)


def highf32_flops_per_row(
    d_in: int, d_out: int, H: int, n_layers: int, mode: str, n_tan: int = 0, n_tan2: int = 0
) -> tuple:
    """``(tensor_core, cuda_core)`` flops per row of a ``highf32`` launch:
    the (H, H) products of every chain on the tensor cores (one pass of
    the three), and on the CUDA cores the input projections (the primal's
    d_in rows, a probe's d_out; 3x past ``RANK1_MAX`` features) and 3x
    the (H, d_out) output layer.  The sketch modes count their chains as
    :func:`flops_per_row` does (hutchpp: ``n_tan`` = r, ``n_tan2`` = m;
    xtrace: ``n_tan`` = m), each seeded from a probe through w_in[:d_out];
    their per-row algebra is not counted."""
    n_applies = {
        "forward": 0, "hutchinson": 1, "exact": d_out, "tangents": n_tan,
        "hutchpp": 2 * n_tan + n_tan2, "xtrace": 2 * n_tan,
    }[mode]
    probes = 0 if mode in ("forward", "exact") else n_applies
    passes_in, passes_probe = (3 if n > RANK1_MAX else 1 for n in (d_in, d_out))
    tc = 2 * H * H * (n_layers - 2) * (1 + n_applies)
    cc = 2 * H * (passes_in * d_in + passes_probe * probes * d_out + 3 * d_out * (1 + n_applies))
    return tc, cc


def bf16_flops_per_row(
    d_in: int, d_out: int, H: int, n_layers: int, mode: str, n_tan: int = 0, n_tan2: int = 0
) -> tuple:
    """``(tensor_core, cuda_core)`` flops per row of a ``bfloat16``
    launch: the (H, H) products of every chain on the bf16 tensor cores, one
    pass; on the CUDA cores the input projections (the primal's d_in rows,
    a probe's d_out) and the (H, d_out) output layer of every chain.  The
    sketch modes count their chains as :func:`highf32_flops_per_row` does
    (hutchpp: ``n_tan`` = r, ``n_tan2`` = m; xtrace: ``n_tan`` = m)."""
    n_applies = {
        "forward": 0, "hutchinson": 1, "exact": d_out, "tangents": n_tan,
        "hutchpp": 2 * n_tan + n_tan2, "xtrace": 2 * n_tan,
    }[mode]
    probes = 0 if mode in ("forward", "exact") else n_applies
    tc = 2 * H * H * (n_layers - 2) * (1 + n_applies)
    cc = 2 * H * (d_in + probes * d_out + d_out * (1 + n_applies))
    return tc, cc


def check_compute_dtype(compute_dtype: str) -> None:
    """Accept the compute modes of the RHS and EM kernels, 'float32',
    'highf32' and 'bfloat16'; anything else is not a compute mode.  The
    models check theirs with it."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown kernel compute dtype {compute_dtype!r}; use one of {COMPUTE_DTYPES}")


def _mode(e, exact_divergence: bool) -> str:
    """The kernel mode of a call: 'hutchinson' with a probe ``e``, 'exact'
    with ``exact_divergence``, else 'forward'."""
    if e is not None and exact_divergence:
        raise ValueError("pass a probe e OR exact_divergence, not both")
    return "hutchinson" if e is not None else ("exact" if exact_divergence else "forward")


def _check_conditional(n_cond: int, conditional) -> None:
    if n_cond and conditional is None:
        raise ValueError(
            f"model expects {n_cond} conditional feature(s) but conditional=None was given"
        )
    if not n_cond and conditional is not None:
        raise ValueError("conditional given to an unconditional model")
    if conditional is not None and conditional.shape[-1] != n_cond:
        raise ValueError(
            f"conditional has {conditional.shape[-1]} feature(s); the model expects {n_cond}"
        )


def _score_first_layer(params, cfg, t, conditional):
    """``(w_in, b_eff)``: the scalar time's Fourier embedding folded into
    the first-layer bias, and the [x | cond] weight rows."""
    E = cfg.embedding_dimensions
    D = cfg.n_dimensions
    w1 = params["layers"][0]["w"]
    t = torch.as_tensor(t, dtype=torch.float32, device=w1.device).reshape(())
    temb = fourier_time_embedding(t[None], params["W"])[0]
    b_eff = params["layers"][0]["b"] + temb @ w1[:E]
    w_in = w1[E:] if conditional is not None else w1[E : E + D]
    return w_in, b_eff


def _velocity_first_layer(params, cfg, t, conditional):
    """``(w_in, b_eff)`` of the velocity net: the raw scalar time's row
    folded into the first-layer bias, and the [x | cond] weight rows."""
    D = cfg.target_dimension
    w1 = params["layers"][0]["w"]
    t = torch.as_tensor(t, dtype=torch.float32, device=w1.device).reshape(())
    b_eff = params["layers"][0]["b"] + t * w1[D]
    w_in = torch.cat([w1[:D], w1[D + 1 :]]) if conditional is not None else w1[:D]
    return w_in, b_eff


def fused_drift_reference(
    params, cfg, t, x, conditional=None, e=None, exact_divergence=False, c0=0.0, c1=1.0,
    compute_dtype="float32",
):
    """The plain PyTorch version of :func:`fused_drift`, all three modes:
    the net through ``apply_score_mlp`` and its Jacobian through
    ``torch.func.jvp``, with TF32 off; in ``highf32`` the layer products
    through :func:`tf32x3_matmul` (tangents included) and the tanh-form
    SiLU; in ``bfloat16`` :func:`_bf16_reference` on the folded first
    layer."""
    _mode(e, exact_divergence)
    with strict_fp32_matmul():
        if compute_dtype == "bfloat16":
            return _bf16_reference(params["layers"], *_score_first_layer(params, cfg, t, conditional), x,
                                   conditional, cfg.activation, c0, c1, e, exact_divergence)
        ops = _net_ops(compute_dtype, cfg.activation, cfg.n_dimensions + cfg.n_conditionals)
        return _reference(
            lambda xx: apply_score_mlp(cfg, params, t, xx, conditional, **ops),
            x, e, exact_divergence, c0, c1,
        )


def fused_velocity_reference(params, cfg, t, x, conditional=None, e=None, exact_divergence=False,
                             compute_dtype="float32"):
    """The plain PyTorch version of :func:`fused_velocity`, all three modes
    (``apply_velocity_mlp`` and ``torch.func.jvp``, TF32 off; the split in
    ``highf32`` as in :func:`fused_drift_reference`)."""
    _mode(e, exact_divergence)
    with strict_fp32_matmul():
        if compute_dtype == "bfloat16":
            return _bf16_reference(params["layers"], *_velocity_first_layer(params, cfg, t, conditional), x,
                                   conditional, cfg.activation, 0.0, 1.0, e, exact_divergence)
        ops = _net_ops(compute_dtype, cfg.activation, cfg.target_dimension + cfg.conditional_dimension)
        return _reference(
            lambda xx: apply_velocity_mlp(cfg, params, t, xx, conditional, **ops),
            x, e, exact_divergence, 0.0, 1.0,
        )


def _reference(net, x, e, exact_divergence, c0, c1):
    if e is not None:
        out, je = jvp(net, (x,), (e,))
        # e^T (c0 I + c1 J_net) e = c0 |e|^2 + c1 e^T J_net e
        div = c0 * torch.sum(e * e, dim=-1) + c1 * torch.sum(je * e, dim=-1)
        return c0 * x + c1 * out, div
    if not exact_divergence:
        return c0 * x + c1 * net(x)
    D = x.shape[-1]
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    out = None
    for d in range(D):
        basis = torch.zeros_like(x)
        basis[:, d] = 1.0
        out, jv = jvp(net, (x,), (basis,))
        acc = acc + jv[:, d]
    return c0 * x + c1 * out, c0 * D + c1 * acc


def fused_drift(
    params: dict,
    cfg,
    t,
    x: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    e: Optional[torch.Tensor] = None,
    exact_divergence: bool = False,
    c0=0.0,
    c1=1.0,
    compute_dtype: str = "float32",
):
    """Fused drift = c0*x + c1*net(t, x[, cond]) and optional divergence.

    Pass ``e`` for the Hutchinson estimate or ``exact_divergence=True``
    for the exact trace.  Returns ``drift`` (B, D), or ``(drift, div)``
    with div (B,) in either divergence mode.  ``t``, ``c0`` and ``c1`` may
    be floats or 0-d tensors (device tensors keep a solve free of host
    syncs).  CUDA tensors launch the kernel (``fused_drift.launches``
    counts launches); CPU tensors run :func:`fused_drift_reference`.
    """
    check_compute_dtype(compute_dtype)
    mode = _mode(e, exact_divergence)
    _check_conditional(cfg.n_conditionals, conditional)
    params, cfg = pad_to_lanes(params, cfg, compute_dtype)
    # the envelope holds on every device, as the JAX interpret mode's does
    _check_plan(cfg.units[0], mode, cfg.n_dimensions + cfg.n_conditionals, cfg.n_dimensions, compute_dtype=compute_dtype)
    if not _on_card(x):
        return fused_drift_reference(
            params, cfg, t, x, conditional, e, exact_divergence, c0, c1, compute_dtype
        )
    with strict_fp32_matmul():
        w_in, b_eff = _score_first_layer(params, cfg, t, conditional)
    x_in = x if conditional is None else torch.cat([x, conditional], dim=-1)
    c0c1 = torch.stack([
        torch.as_tensor(c, dtype=torch.float32, device=x.device).reshape(()) for c in (c0, c1)
    ])
    drift, div = _launch(
        x_in.contiguous(), None if e is None else e.contiguous(), w_in, b_eff, params["layers"], c0c1, mode,
        cfg.n_dimensions, cfg.activation, compute_dtype=compute_dtype,
    )
    return drift if mode == "forward" else (drift, div)


def fused_velocity(
    params: dict,
    cfg,
    t,
    x: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    e: Optional[torch.Tensor] = None,
    exact_divergence: bool = False,
    compute_dtype: str = "float32",
):
    """Fused flow-matching velocity v(x, t[, cond]) and optional divergence.

    The arguments and returns of :func:`fused_drift` with (c0, c1) = (0, 1)
    and a ``VelocityMLPConfig``.  CUDA tensors launch the kernel
    (``fused_velocity.launches`` counts launches); CPU tensors run
    :func:`fused_velocity_reference`.
    """
    check_compute_dtype(compute_dtype)
    mode = _mode(e, exact_divergence)
    _check_conditional(cfg.conditional_dimension, conditional)
    params, cfg = pad_to_lanes(params, cfg, compute_dtype)
    D = cfg.target_dimension
    _check_plan(cfg.hidden_units[0], mode, D + cfg.conditional_dimension, D, compute_dtype=compute_dtype)
    if not _on_card(x):
        return fused_velocity_reference(params, cfg, t, x, conditional, e, exact_divergence, compute_dtype)
    with strict_fp32_matmul():
        w_in, b_eff = _velocity_first_layer(params, cfg, t, conditional)
    x_in = x if conditional is None else torch.cat([x, conditional], dim=-1)
    # (c0, c1) = (0, 1), made on the device without a host copy
    c0c1 = torch.arange(2, dtype=torch.float32, device=x.device)
    drift, div = _launch(
        x_in.contiguous(), None if e is None else e.contiguous(), w_in.contiguous(), b_eff,
        params["layers"], c0c1, mode, D, cfg.activation, counter=fused_velocity, compute_dtype=compute_dtype,
    )
    return drift if mode == "forward" else (drift, div)


def _tangent_stack(V, B: int, D: int) -> torch.Tensor:
    """Probe tangents as one (K, B, D) tensor: ``V`` is (K, B, D) or a list
    of K (D, B) columns."""
    if isinstance(V, (list, tuple)):
        V = torch.stack([v.T for v in V])
    if V.ndim != 3 or tuple(V.shape[1:]) != (B, D) or V.shape[0] < 1:
        raise ValueError(f"tangents V of shape {tuple(V.shape)}; expected (K, {B}, {D}) with K >= 1")
    return V


def _tangents_reference(f, x, V):
    """(f(x) as (D, B) columns, [J v_k as (D, B) columns]) by torch.func.jvp."""
    cols = [jvp(f, (x,), (V[k],))[1].T for k in range(V.shape[0])]
    return f(x).T, cols


def fused_drift_tangents_reference(params, cfg, t, x, V, conditional=None, c0=0.0, c1=1.0,
                                   compute_dtype="float32"):
    """The plain PyTorch version of :func:`fused_drift_tangents`
    (``apply_score_mlp`` and ``torch.func.jvp``, TF32 off; the split in
    ``highf32`` as in :func:`fused_drift_reference`)."""
    V = _tangent_stack(V, *x.shape)
    with strict_fp32_matmul():
        if compute_dtype == "bfloat16":
            drift, cols = _bf16_reference(params["layers"], *_score_first_layer(params, cfg, t, conditional), x,
                                          conditional, cfg.activation, c0, c1, V=V)
            return drift.T, [c.T for c in cols]
        ops = _net_ops(compute_dtype, cfg.activation, cfg.n_dimensions + cfg.n_conditionals)
        return _tangents_reference(
            lambda xx: c0 * xx + c1 * apply_score_mlp(cfg, params, t, xx, conditional, **ops), x, V
        )


def fused_velocity_tangents_reference(params, cfg, t, x, V, conditional=None, compute_dtype="float32"):
    """The plain PyTorch version of :func:`fused_velocity_tangents`."""
    V = _tangent_stack(V, *x.shape)
    with strict_fp32_matmul():
        if compute_dtype == "bfloat16":
            drift, cols = _bf16_reference(params["layers"], *_velocity_first_layer(params, cfg, t, conditional),
                                          x, conditional, cfg.activation, 0.0, 1.0, V=V)
            return drift.T, [c.T for c in cols]
        ops = _net_ops(compute_dtype, cfg.activation, cfg.target_dimension + cfg.conditional_dimension)
        return _tangents_reference(
            lambda xx: apply_velocity_mlp(cfg, params, t, xx, conditional, **ops), x, V
        )


def fused_drift_tangents(
    params: dict,
    cfg,
    t,
    x: torch.Tensor,
    V,
    conditional: Optional[torch.Tensor] = None,
    c0=0.0,
    c1=1.0,
    compute_dtype: str = "float32",
):
    """Fused drift and J v for K probe tangents in one launch (mode
    tangents).

    ``V`` is (K, B, D) or a list of K (D, B) columns.  Returns
    ``(drift_cols, jv_cols)`` in the batch-in-lanes layout the sketch
    estimators consume (``ops.trace.hutchpp_core``/``xtrace_core``):
    ``drift_cols`` (D, B) and a list of K (D, B) columns of
    J v_k = c0 v_k + c1 J_net v_k (J with respect to x; the conditional's
    tangents are zero).  CUDA tensors launch the kernel
    (``fused_drift_tangents.launches``); CPU tensors run
    :func:`fused_drift_tangents_reference`.
    """
    check_compute_dtype(compute_dtype)
    _check_conditional(cfg.n_conditionals, conditional)
    params, cfg = pad_to_lanes(params, cfg, compute_dtype)
    D = cfg.n_dimensions
    V = _tangent_stack(V, x.shape[0], D)
    _check_plan(cfg.units[0], "tangents", D + cfg.n_conditionals, D, V.shape[0], compute_dtype)
    if not _on_card(x):
        return fused_drift_tangents_reference(params, cfg, t, x, V, conditional, c0, c1, compute_dtype)
    with strict_fp32_matmul():
        w_in, b_eff = _score_first_layer(params, cfg, t, conditional)
    x_in = x if conditional is None else torch.cat([x, conditional], dim=-1)
    c0c1 = torch.stack([
        torch.as_tensor(c, dtype=torch.float32, device=x.device).reshape(()) for c in (c0, c1)
    ])
    return _launch_tangents(x_in, V, w_in, b_eff, params["layers"], c0c1, D, cfg.activation,
                            fused_drift_tangents, compute_dtype)


def fused_velocity_tangents(
    params: dict,
    cfg,
    t,
    x: torch.Tensor,
    V,
    conditional: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
):
    """Fused velocity and J v for K probe tangents of a flow velocity net:
    :func:`fused_drift_tangents` with (c0, c1) = (0, 1) and the raw-time
    fold.  CUDA tensors launch the kernel
    (``fused_velocity_tangents.launches``); CPU tensors run
    :func:`fused_velocity_tangents_reference`."""
    check_compute_dtype(compute_dtype)
    _check_conditional(cfg.conditional_dimension, conditional)
    params, cfg = pad_to_lanes(params, cfg, compute_dtype)
    D = cfg.target_dimension
    V = _tangent_stack(V, x.shape[0], D)
    _check_plan(cfg.hidden_units[0], "tangents", D + cfg.conditional_dimension, D, V.shape[0], compute_dtype)
    if not _on_card(x):
        return fused_velocity_tangents_reference(params, cfg, t, x, V, conditional, compute_dtype)
    with strict_fp32_matmul():
        w_in, b_eff = _velocity_first_layer(params, cfg, t, conditional)
    x_in = x if conditional is None else torch.cat([x, conditional], dim=-1)
    c0c1 = torch.arange(2, dtype=torch.float32, device=x.device)
    return _launch_tangents(x_in, V, w_in.contiguous(), b_eff, params["layers"], c0c1, D,
                            cfg.activation, fused_velocity_tangents, compute_dtype)


def _launch_tangents(x_in, V, w_in, b_eff, layers, c0c1, D, activation, counter, compute_dtype):
    """Launch mode tangents: V (K, B, D) goes in as (B, K, D) rows; the J v
    columns come out (K, B, D) and are returned as (D, B) views."""
    K, B, _ = V.shape
    e = V.permute(1, 0, 2).reshape(B, K * D).contiguous()
    drift, jv = _launch(x_in.contiguous(), e, w_in, b_eff, layers, c0c1, "tangents", D, activation,
                        counter=counter, n_tan=K, compute_dtype=compute_dtype)
    return drift.T, [jv[k].T for k in range(K)]


def fused_symplectic_velocity_reference(params, cfg, t, state, conditional=None, compute_dtype="float32"):
    """The plain PyTorch version of :func:`fused_symplectic_velocity`:
    ``apply_symplectic_mlp`` with TF32 off (the split in ``highf32`` as in
    :func:`fused_drift_reference`; in ``bfloat16`` each stack folded as
    the kernel takes it, the embedding's trailing rows in its bias)."""
    if compute_dtype == "bfloat16":
        D, C = cfg.n_data_dims, cfg.n_conditionals
        q, p = torch.chunk(state, 2, dim=-1)
        with strict_fp32_matmul():
            t = torch.as_tensor(t, dtype=torch.float32, device=state.device).reshape(())
            temb = fourier_time_embedding(t[None], params["W"])[0]
            return torch.cat([
                _bf16_reference(params[stack], *_symplectic_fold(params[stack], temb, D, C, conditional),
                                other, conditional, cfg.activation, 0.0, sign)
                for stack, other, sign in (("q_layers", p, 1.0), ("p_layers", q, -1.0))
            ], dim=-1)
    ops = _net_ops(compute_dtype, cfg.activation, cfg.n_data_dims + cfg.n_conditionals)
    with strict_fp32_matmul():
        return apply_symplectic_mlp(cfg, params, t, state, conditional, **ops)


def _symplectic_fold(layers, temb, D: int, C: int, conditional):
    """``(w_in, b_eff)`` of one symplectic stack: the [x_other | cond]
    rows of its first layer, and its trailing embedding rows folded into
    the bias."""
    w1 = layers[0]["w"]  # (D + C + E, H), rows [x_other | cond | temb]
    b_eff = layers[0]["b"] + temb @ w1[D + C:]
    return (w1[: D + C] if conditional is not None else w1[:D]), b_eff


def fused_symplectic_velocity(
    params: dict,
    cfg,
    t,
    state: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
):
    """The symplectic field [dq/dt | dp/dt] on ``state`` = [q | p] (B, 2D)
    by two forward launches of the kernel, one per stack: the q stack on p
    with (c0, c1) = (0, +1) and the p stack on q with (0, -1), each with
    the embedding folded from its first layer's trailing rows.  The joint
    field is divergence-free, so no divergence is computed.  CUDA tensors
    launch the kernel twice (``fused_symplectic_velocity.launches`` counts
    launches); CPU tensors run :func:`fused_symplectic_velocity_reference`."""
    check_compute_dtype(compute_dtype)
    _check_conditional(cfg.n_conditionals, conditional)
    params, cfg = pad_to_lanes(params, cfg, compute_dtype)
    D, C = cfg.n_data_dims, cfg.n_conditionals
    if state.ndim != 2 or state.shape[1] != 2 * D:
        raise ValueError(f"state of shape {tuple(state.shape)}; expected (B, {2 * D})")
    _check_plan(cfg.units[0], "forward", D + C, D, compute_dtype=compute_dtype)
    if not _on_card(state):
        return fused_symplectic_velocity_reference(params, cfg, t, state, conditional, compute_dtype)
    q, p = torch.chunk(state, 2, dim=-1)
    with strict_fp32_matmul():
        t = torch.as_tensor(t, dtype=torch.float32, device=state.device).reshape(())
        temb = fourier_time_embedding(t[None], params["W"])[0]
    outs = []
    for stack, other, sign in (("q_layers", p, 1.0), ("p_layers", q, -1.0)):
        layers = params[stack]
        with strict_fp32_matmul():
            w_in, b_eff = _symplectic_fold(layers, temb, D, C, conditional)
        x_in = other if conditional is None else torch.cat([other, conditional], dim=-1)
        # (c0, c1) = (0, sign), made on the device without a host copy
        c0c1 = torch.arange(0.0, 2.0 * sign, sign, dtype=torch.float32, device=state.device)
        drift, _ = _launch(x_in.contiguous(), None, w_in, b_eff, layers, c0c1, "forward", D,
                           cfg.activation, counter=fused_symplectic_velocity, compute_dtype=compute_dtype)
        outs.append(drift)
    return torch.cat(outs, dim=-1)


_COUNTED = (
    fused_drift, fused_velocity, fused_drift_tangents, fused_velocity_tangents,
    fused_symplectic_velocity,
)


def reset_launch_counts() -> None:
    """Zero the launch counts of every wrapper of this kernel, and their
    splits by mode (``launches_by_mode``) and by compute mode
    (``launches_by_dtype``)."""
    for fn in _COUNTED:
        fn.launches = 0
        fn.launches_by_mode = dict.fromkeys(_MODES, 0)
        fn.launches_by_dtype = dict.fromkeys(COMPUTE_DTYPES, 0)


reset_launch_counts()


def _chains(mode: str, d_out: int, n_tan: int = 0) -> int:
    """Chains a block carries: the primal, plus 1 (hutchinson), D (exact)
    or K = ``n_tan`` (tangents) tangents."""
    return {"forward": 1, "hutchinson": 2, "exact": 1 + d_out, "tangents": 1 + n_tan}[mode]


def _smem_bytes(rows: int, H: int, chains: int, d_in: int, d_out: int, n_tan: int = 0,
                compute_dtype: str = "float32", planes: bool = True) -> int:
    """Shared memory of one block, in the kernel's layout: chains x rows
    rows of stride H + ``PAD`` floats, twice in ``float32`` (the double
    buffer) and three times in ``highf32`` (the pre-activations and the
    TF32 hi and lo planes; twice without ``planes``, as float32); in
    ``bfloat16`` rows of stride H + ``PAD_BF16``, the fp32 pre-activations
    and one 2-byte bf16 plane; then the (rows, d_in) input tile and the
    (rows, d_out max(1, n_tan)) probe tile.  ``chains`` is those of the
    widest pass, the primal and a group of tangents, and ``n_tan`` the
    probes a pass holds in mode tangents (its group)."""
    tiles = 4 * rows * (d_in + d_out * max(1, n_tan))
    if compute_dtype == "bfloat16":
        return (4 + 2) * chains * rows * (H + PAD_BF16) + tiles
    buffers = 3 if compute_dtype == "highf32" and planes else 2
    return 4 * buffers * chains * rows * (H + PAD) + tiles


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory that one SM holds at once
    (by shared memory alone; registers may allow fewer)."""
    return _SMEM_PER_SM // (smem + _SMEM_BLOCK_RESERVE)


def _pick_rows(smem_bytes: Callable[[int], int], cap: int = KERNEL_BLOCKS) -> Optional[Tuple[int, int]]:
    """``(rows, blocks)``: the most blocks an SM holds (by its shared memory,
    at most ``cap``, what the launch bounds allow) of any of 64, 32, 16, 8
    and 4 rows a block, at the most rows that reach them.  None when not
    even 4 rows fit one block.  The sketch and EM kernels plan with it too."""
    fits = [(rows, min(cap, blocks_per_sm(smem_bytes(rows)))) for rows in (64, 32, 16, 8, 4)
            if smem_bytes(rows) <= _SMEM_LIMIT]
    most = max((blocks for _, blocks in fits), default=0)
    return next(((rows, blocks) for rows, blocks in fits if blocks == most), None)


def _check_plan(*args, **kwargs) -> None:
    """A wrapper's envelope check, :func:`_plan` for its config.  Skipped
    while ``torch.export`` traces a solve: inside the traced loop body the
    sizes may be symbolic, and the op's launch plans from the concrete
    shapes (and raises) when the program runs."""
    if not torch.compiler.is_compiling():
        _plan(*args, **kwargs)


def _group_bytes(rows: int, H: int, mode: str, group: int, d_in: int, d_out: int, n_tan: int, compute_dtype: str,
                 planes: bool) -> int:
    """:func:`_smem_bytes` of a plan whose passes carry ``group`` tangent
    chains (0: all of them in one pass), and, in mode tangents, hold that
    many probes."""
    n = group or _chains(mode, d_out, n_tan) - 1
    return _smem_bytes(rows, H, 1 + n, d_in, d_out, n if mode == "tangents" else 0, compute_dtype, planes)


@functools.lru_cache(maxsize=None)
def _default_plan(H: int, mode: str, d_in: int, d_out: int, n_tan: int = 0, compute_dtype: str = "float32"):
    """The plan :func:`_plan` takes, or None where none fits.  In order:
    every tangent chain in one pass (group 0), with the TF32 planes in
    ``highf32``, at the rows of :func:`_pick_rows`; else the planes kept
    and the largest group of tangent chains a pass that fits at 4 rows a
    block; else (``highf32``) the same two without the planes."""
    n_t = _chains(mode, d_out, n_tan) - 1
    for planes in ((True, False) if compute_dtype == "highf32" else (False,)):
        def smem_bytes(rows, group):
            return _group_bytes(rows, H, mode, group, d_in, d_out, n_tan, compute_dtype, planes)

        picked = _pick_rows(lambda rows: smem_bytes(rows, 0))
        if picked is not None:
            return picked[0], smem_bytes(picked[0], 0), 0, planes
        group = next((g for g in range(n_t - 1, 0, -1) if smem_bytes(4, g) <= _SMEM_LIMIT), None)
        if group is not None:
            return 4, smem_bytes(4, group), group, planes
    return None


@functools.lru_cache(maxsize=None)
def _plan(H: int, mode: str, d_in: int, d_out: int, n_tan: int = 0, compute_dtype: str = "float32",
          rows: Optional[int] = None, group: Optional[int] = None, planes: Optional[bool] = None):
    """``(rows, smem_bytes, group, planes)`` of the launch, or raise when
    the shared-memory plan does not fit (the JAX package's
    vmem_width_clamp analogue).  The plan of :func:`_default_plan`:
    rows the most blocks an SM holds (at most ``KERNEL_BLOCKS``), at the
    most rows that reach them; ``group`` the tangent chains a pass carries,
    0 for all of them (1 in hutchinson, D in exact, K in tangents, none in
    forward) in one pass where that fits, fewer at 4 rows a block where it
    does not; ``planes`` whether ``highf32`` keeps its TF32 hi and lo
    planes (False in the other modes).  A plan that groups or drops the
    planes is wide: it fits one block an SM and launches the kernel's wide
    instantiations.  ``rows``, ``group`` and ``planes`` force a plan (a
    multiple of 4 rows, a group of 0 to the tangent count, planes in
    ``highf32`` only, whose block fits); what is not forced is the default
    plan's.  A row's arithmetic does not depend on the plan.  Cached: a
    solve asks for the same plan at every right-hand side."""
    n_t = _chains(mode, d_out, n_tan) - 1
    own = _default_plan(H, mode, d_in, d_out, n_tan, compute_dtype)
    if rows is None and group is None and planes is None:
        if own is None:
            raise ValueError(
                f"fused kernel shared-memory plan does not fit: its smallest form (the primal and at most one "
                f"tangent chain of width H={H}, 4 rows a block) needs "
                f"{_group_bytes(4, H, mode, min(1, n_t), d_in, d_out, n_tan, compute_dtype, False)} bytes in "
                f"{compute_dtype} (limit {_SMEM_LIMIT}); use a narrower net, fewer features, or "
                "use_fused_kernel=False"
            )
        return own
    rows = (own[0] if own else 4) if rows is None else rows
    group = (own[2] if own else 0) if group is None else group
    planes = (own[3] if own else compute_dtype == "highf32") if planes is None else bool(planes)
    smem = _group_bytes(rows, H, mode, group, d_in, d_out, n_tan, compute_dtype, planes)
    if rows % 4 or not 4 <= rows <= 256 or smem > _SMEM_LIMIT:
        raise ValueError(f"fused kernel plan of {rows} rows: a multiple of 4 up to 256 whose block fits")
    if not 0 <= group <= n_t or (planes and compute_dtype != "highf32"):
        raise ValueError(f"fused kernel plan of group {group} and planes {planes}: a group of 0 to the {n_t} "
                         "tangent chains, planes in highf32 only")
    return rows, smem, group, planes


def plan_wide(plan, compute_dtype: str = "float32") -> bool:
    """Whether ``plan`` is wide: its passes group the tangent chains, or
    ``highf32`` drops its planes.  A wide plan fits one block an SM by its
    shared memory and launches the kernel's wide instantiations (launch
    bounds of one block)."""
    return plan[2] > 0 or (compute_dtype == "highf32" and not plan[3])


def plan_blocks(plan) -> int:
    """Blocks of ``plan`` an SM holds by its shared memory and the launch
    bounds (:func:`occupancy` asks the card).  A default plan that is wide
    (:func:`plan_wide`) holds one block by its shared memory."""
    return min(KERNEL_BLOCKS, blocks_per_sm(plan[1]))


def occupancy(plan, compute_dtype: str = "float32") -> dict:
    """What the card makes of ``plan`` (from :func:`_plan`) in
    ``compute_dtype``: resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local-memory bytes a thread of the instantiation it launches."""
    rows, smem, group, planes = plan
    blocks, regs, local_bytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _kernel_lib().ff_fused_mlp_occupancy(COMPUTE_DTYPES.index(compute_dtype), int(planes), group, smem, blocks,
                                               regs, local_bytes)
    if err != 0:
        raise RuntimeError(f"fused_mlp occupancy query failed with CUDA error {err}")
    return dict(rows=rows, smem_bytes=smem, group=group, planes=planes, blocks_per_sm=blocks.value,
                registers=regs.value, local_bytes=local_bytes.value)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    fn = lib.ff_fused_mlp
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, p, p, p, p, p] + [i] * 11 + [ctypes.c_size_t, p]
        fn.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ff_fused_mlp_occupancy.argtypes = [i, i, i, ctypes.c_size_t, ip, ip, ip]
        lib.ff_fused_mlp_occupancy.restype = ctypes.c_int
        lib.ff_fused_mlp_min_blocks.argtypes = []
        lib.ff_fused_mlp_min_blocks.restype = ctypes.c_int
        if lib.ff_fused_mlp_min_blocks() != KERNEL_BLOCKS:
            raise RuntimeError(f"fused_mlp.cu's launch bounds hold {lib.ff_fused_mlp_min_blocks()} blocks an SM; "
                               f"the wrapper plans for {KERNEL_BLOCKS}")
    return lib


def check_operands(expect, hidden, H: int, what: str, lane_width: int = LANE) -> torch.device:
    """Raise unless every ``(tensor, shape)`` of ``expect`` is a contiguous
    float32 CUDA tensor of that shape on one device, and the ``hidden``
    (H, H) layers fit the kernel (H a multiple of ``lane_width``, weights
    16-byte aligned for float4 reads).  Returns the device.  The RHS,
    sketch and EM kernels' launch wrappers call it."""
    device = same_device(*(t for t, _ in expect))
    for tensor, shape in expect:
        if not tensor.is_cuda or tensor.dtype != torch.float32:
            raise ValueError(f"{what} takes float32 CUDA tensors; got {tensor.dtype} on {tensor.device}")
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{what} operand of shape {tuple(tensor.shape)}; expected {shape}")
        if not tensor.is_contiguous():
            raise ValueError(f"{what} operands must be contiguous")
    if H % lane_width:
        raise ValueError(f"{what} takes hidden layers of a width in multiples of {lane_width}")
    if any(l["w"].data_ptr() % 16 for l in hidden):
        raise ValueError(f"{what} reads hidden weights as float4: they must be 16-byte aligned")
    return device


# The layer tables written so far, by device and pointers (the table's own
# contents): a solve launches on the same weights at every right-hand side.
_TABLES: dict = {}
_MAX_TABLES = 256


def layer_table(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor], device) -> int:
    """The device address of the hidden layers' table as the kernels read
    it (``csrc/mlp_tile.cuh`` HiddenLayers): the n weight pointers, then
    the n bias pointers, int64 in device memory; 0 (null) for no hidden
    layer.  A table holds nothing but these addresses, so one is written
    once for its pointers on its device (on the current stream, before the
    launch that reads it) and kept; past ``_MAX_TABLES`` the card is
    synchronized before the tables are dropped, so that no launch still
    reads one."""
    if not weights:
        return 0
    ptrs = tuple(t.data_ptr() for t in weights) + tuple(t.data_ptr() for t in biases)
    key = (device, ptrs)
    table = _TABLES.get(key)
    if table is None:
        if len(_TABLES) >= _MAX_TABLES:
            torch.cuda.synchronize(device)
            _TABLES.clear()
        table = torch.tensor(ptrs, dtype=torch.int64).to(device, non_blocking=True)
        _TABLES[key] = table
    return table.data_ptr()


def _on_card(x: torch.Tensor) -> bool:
    """Whether a wrapper calls the registered op for ``x``: a CUDA tensor
    does (the op launches the kernel), and so does every tensor inside
    ``torch.export``, where a CPU tensor's op runs the plain version of the
    folded operands (``torch.func.jvp``, which the plain versions use, does
    not trace inside the solver's ``while_loop``).  An eager CPU tensor
    runs the wrapper's plain version.  The sketch wrappers ask it too."""
    return x.is_cuda or torch.compiler.is_exporting()


# The ops' namespace: the package's own name, so that a second copy of the
# package imported under another name (``chip_smoke.py --parent``)
# registers its ops beside these instead of over them.
OP_NAMESPACE = __name__.split(".")[0]


def _launch(x_in, e, w_in, b_eff, layers, c0c1, mode, d_out, activation, counter=fused_drift,
            n_tan=0, compute_dtype="float32", rows=None, group=None, planes=None):
    """Launch the kernel through the registered op ``fused_mlp`` (eager
    and traced calls alike) in ``compute_dtype`` on the current stream, at
    the plan of :func:`_plan` (``rows``, ``group`` and ``planes`` force
    one); the launch is added to ``counter``'s counts.  Returns ``(drift, div)``: div is None (forward),
    (B,) (hutchinson, exact) or the (n_tan, B, d_out) J v columns
    (tangents, ``e`` the (B, n_tan d_out) probe rows).  Raises on anything
    the kernel does not take."""
    hidden = layers[1:-1]
    drift, div = fused_mlp_op(
        x_in, e if mode in ("hutchinson", "tangents") else None, w_in, b_eff,
        [l["w"] for l in hidden], [l["b"] for l in hidden], layers[-1]["w"], layers[-1]["b"], c0c1,
        mode, d_out, n_tan, activation, compute_dtype, counter.__name__, rows or 0,
        -1 if group is None else group, -1 if planes is None else int(planes),
    )
    return drift, (None if mode == "forward" else div)


def _div_shape(mode: str, B, d_out: int, n_tan: int) -> tuple:
    """The op's second output: (0,) in forward mode (no divergence), (B,)
    for hutchinson and exact, (n_tan, B, d_out) J v columns for tangents."""
    return {"forward": (0,), "tangents": (n_tan, B, d_out)}.get(mode, (B,))


def _fused_mlp_cuda(x_in, e, w_in, b_eff, hidden_w, hidden_b, w_out, b_out, c0c1, mode, d_out, n_tan,
                    activation, compute_dtype, counter, rows, group=-1, planes=-1):
    """The CUDA kernel of the op ``fused_mlp``: check the operands,
    allocate the outputs, launch ``csrc/fused_mlp.cu`` on the current
    stream (``rows`` > 0, ``group`` and ``planes`` >= 0 force a plan) and
    add one to the counts of the wrapper named ``counter``.  Returns ``(drift (B, d_out), div)``, div as
    :func:`_div_shape` says."""
    B, d_in = x_in.shape
    H = b_eff.shape[0]
    expect = [
        (x_in, (B, d_in)), (w_in, (d_in, H)), (b_eff, (H,)), (w_out, (H, d_out)),
        (b_out, (d_out,)), (c0c1, (2,)),
    ]
    expect += [(w, (H, H)) for w in hidden_w] + [(b, (H,)) for b in hidden_b]
    if mode == "hutchinson":
        expect.append((e, (B, d_out)))
    elif mode == "tangents":
        expect.append((e, (B, n_tan * d_out)))
    check_compute_dtype(compute_dtype)
    hidden = [{"w": w} for w in hidden_w]
    device = check_operands(expect, hidden, H, "fused kernel", lane(compute_dtype))
    rows, smem, group, planes = _plan(H, mode, d_in, d_out, n_tan, compute_dtype, rows or None,
                                      None if group < 0 else group, None if planes < 0 else bool(planes))
    if compute_dtype == "bfloat16":
        w_in, hidden_w, w_out = _bf16_operands(w_in, hidden_w, w_out)

    drift = torch.empty((B, d_out), dtype=torch.float32, device=device)
    div = torch.empty(_div_shape(mode, B, d_out, n_tan), dtype=torch.float32, device=device)
    if B == 0:
        return drift, div
    lib = _kernel_lib()
    err = lib.ff_fused_mlp(
        x_in.data_ptr(), e.data_ptr() if mode in ("hutchinson", "tangents") else None,
        w_in.data_ptr(), b_eff.data_ptr(), layer_table(hidden_w, hidden_b, device), len(hidden_w),
        w_out.data_ptr(), b_out.data_ptr(), c0c1.data_ptr(), drift.data_ptr(),
        div.data_ptr() if mode != "forward" else None,
        B, d_in, d_out, H, _MODES.index(mode), _KERNEL_ACTIVATIONS.index(activation),
        COMPUTE_DTYPES.index(compute_dtype), n_tan, rows, group, int(planes), smem,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed with CUDA error {err}")
    _build.count_launch(globals()[counter], launches_by_mode=mode, launches_by_dtype=compute_dtype)
    return drift, div


def _bf16_operands(w_in, hidden_w, w_out):
    """The weights as a ``bfloat16`` launch reads them, converted once a
    call: ``w_in`` rounded to bf16 and kept in float32 (the input layer's
    FMAs read it), each hidden weight as bf16 transposed to (out, in), so
    that a tensor-core B fragment's two k values are adjacent, and
    ``w_out`` as bf16 in its (H, D) layout."""
    return (bf16_round(w_in), [w.t().contiguous().to(torch.bfloat16) for w in hidden_w],
            w_out.to(torch.bfloat16).contiguous())


# The RHS kernel as a registered op, ``flowfusion_torch::fused_mlp``: what the
# wrappers call and an exported program holds.  Its CUDA kernel is the launch
# above; its CPU kernel, below, the plain version of the same folded operands.
fused_mlp_op = torch.library.custom_op(
    f"{OP_NAMESPACE}::fused_mlp", _fused_mlp_cuda, mutates_args=(), device_types="cuda",
    schema="(Tensor x_in, Tensor? e, Tensor w_in, Tensor b_eff, Tensor[] hidden_w, Tensor[] hidden_b, "
           "Tensor w_out, Tensor b_out, Tensor c0c1, str mode, int d_out, int n_tan, str activation, "
           "str compute_dtype, str counter, int rows, int group=-1, int planes=-1) -> (Tensor, Tensor)",
)


def folded_net(x_in, w_in, b_eff, hidden_w, hidden_b, w_out, b_out, d_out, activation, compute_dtype):
    """The plain net of the kernel's folded operands as a function of the
    first ``d_out`` columns of ``x_in`` (the rest, the conditional, held):
    the first layer ``[x | cond] w_in + b_eff``, in ``compute_dtype`` as
    :func:`_net_ops` computes it.  The sketch op's CPU kernel uses it too."""
    layers = [{"w": w_in, "b": b_eff}] + [{"w": w, "b": b} for w, b in zip(hidden_w, hidden_b)]
    layers.append({"w": w_out, "b": b_out})
    ops = _net_ops(compute_dtype, activation, x_in.shape[1])
    cond = x_in[:, d_out:]
    return lambda xx: _apply_mlp_stack(layers, torch.cat([xx, cond], dim=-1), activation, **ops)


@fused_mlp_op.register_kernel("cpu")
def _fused_mlp_op_cpu(x_in, e, w_in, b_eff, hidden_w, hidden_b, w_out, b_out, c0c1, mode, d_out, n_tan,
                      activation, compute_dtype, counter, rows, group=-1, planes=-1):
    """The op on CPU tensors: the plain version of the folded operands
    (``torch.func.jvp`` for the divergence and the J v columns, TF32 off;
    in ``bfloat16`` the explicit chain of :func:`_bf16_reference`),
    counting nothing."""
    x = x_in[:, :d_out]
    c0, c1 = c0c1[0], c0c1[1]
    if compute_dtype == "bfloat16":
        layers = [None] + [{"w": w, "b": b} for w, b in zip(hidden_w, hidden_b)] + [{"w": w_out, "b": b_out}]
        V = e.reshape(x.shape[0], n_tan, d_out).permute(1, 0, 2) if mode == "tangents" else None
        with strict_fp32_matmul():
            out = _bf16_reference(layers, w_in, b_eff, x, x_in[:, d_out:], activation, c0, c1,
                                  e if mode == "hutchinson" else None, mode == "exact", V)
        if mode == "tangents":
            return out[0], torch.stack(out[1])
        return (out, x.new_empty((0,))) if mode == "forward" else out
    net = folded_net(x_in, w_in, b_eff, hidden_w, hidden_b, w_out, b_out, d_out, activation, compute_dtype)
    with strict_fp32_matmul():
        if mode == "tangents":
            V = e.reshape(x.shape[0], n_tan, d_out).permute(1, 0, 2)
            drift_cols, cols = _tangents_reference(lambda xx: c0 * xx + c1 * net(xx), x, V)
            return drift_cols.T.contiguous(), torch.stack([c.T for c in cols])
        out = _reference(net, x, e if mode == "hutchinson" else None, mode == "exact", c0, c1)
    if mode == "forward":
        return out, x.new_empty((0,))
    return out


@fused_mlp_op.register_fake
def _fused_mlp_op_fake(x_in, e, w_in, b_eff, hidden_w, hidden_b, w_out, b_out, c0c1, mode, d_out, n_tan,
                       activation, compute_dtype, counter, rows, group=-1, planes=-1):
    """The op's output shapes, for tracing: drift (B, d_out) and div as
    :func:`_div_shape` says (the wrappers check the plan before the call)."""
    B = x_in.shape[0]
    return x_in.new_empty((B, d_out)), x_in.new_empty(_div_shape(mode, B, d_out, n_tan))
