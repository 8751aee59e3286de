"""Fused score-MLP drift (+ Hutchinson or exact divergence) on the card.

Counterpart of the JAX package's ``kernels/fused_mlp.py::fused_drift`` in
its modes ``forward``, ``hutchinson`` and ``exact`` at compute mode
``float32``.  On CUDA tensors the wrapper launches the hand-written kernel
``csrc/fused_mlp.cu`` (built at first use, see ``_build``) or raises; on
CPU tensors it runs the plain PyTorch version, ``fused_drift_reference``.

During a solve the time ``t`` is a batch-global scalar, so the Fourier
embedding contributes a t-dependent bias to the first layer:
  in = [temb | x | cond]  =>  a1 = [x | cond] W1[E:] + (b1 + temb W1[:E])
computed here with plain tensor ops on the device (``_score_first_layer``);
the kernel never sees the embedding rows.  The SDE enters through two
scalars, read by the kernel from a 2-float device buffer so no RHS call
syncs with the host:
  drift = c0 * x + c1 * net(t, x[, cond])
  div   = c0 |e|^2 + c1 e.J_net e   (hutchinson)  |  c0 D + c1 tr J_net  (exact)
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.func import jvp

from .._device import same_device, strict_fp32_matmul
from ..models.nets import apply_score_mlp, fourier_time_embedding
from . import _build

__all__ = [
    "fused_drift",
    "fused_drift_reference",
    "pad_to_lanes",
    "fusable_config",
    "supports_config",
    "supports_features",
    "flops_per_row",
    "reset_launch_counts",
]

_KERNEL_ACTIVATIONS = ("silu", "tanh", "relu", "gelu")  # index = kernel's Act
_MODES = ("forward", "hutchinson", "exact")  # index = kernel's Mode
# Hidden widths are padded to a multiple of this: the kernel reads four
# activations and four weight columns at a time.
LANE = 4
MAX_HIDDEN = 16  # (H, H) layers the kernel takes (csrc kMaxHidden)
_SMEM_LIMIT = 232_448  # shared memory one block may use on sm_90


def fusable_config(units: Sequence[int], activation: str = "silu") -> bool:
    """Config half of the fused envelope, padding included: at most
    ``MAX_HIDDEN + 1`` hidden layers and an activation the kernel
    implements.  Every kernel activation has act(0) == 0, which makes the
    zero-padding of :func:`pad_to_lanes` exact."""
    return 1 <= len(units) <= MAX_HIDDEN + 1 and activation in _KERNEL_ACTIVATIONS


def supports_config(units: Sequence[int], activation: str = "silu") -> bool:
    """The configs the kernel takes as they are: :func:`fusable_config`
    with uniform hidden widths in multiples of ``LANE``."""
    return (
        fusable_config(units, activation)
        and all(u == units[0] for u in units)
        and units[0] % LANE == 0
    )


def supports_features(
    n_features: int, mode: str = "hutchinson", hidden: int = 128,
    n_dimensions: Optional[int] = None,
) -> bool:
    """Feature-count half of the envelope: whether the kernel's
    shared-memory plan fits ``n_features`` = D + C inputs and
    D = ``n_dimensions`` outputs (default: every feature) at hidden width
    ``hidden`` in ``mode``.  The JAX package's ``exact`` flag becomes
    ``mode`` here, because the plan grows with the chain count."""
    d_out = n_features if n_dimensions is None else n_dimensions
    H = -(-hidden // LANE) * LANE
    return _rows_per_block(H, _chains(mode, d_out), n_features, d_out) is not None


def pad_to_lanes(params: dict, cfg):
    """Zero-pad hidden widths to one uniform multiple of ``LANE``.

    Exact: a padded unit has zero weight column and bias, so zero
    pre-activation, zero activation (act(0) == 0) and zero tangent, and
    contributes nothing downstream.  Returns ``(params, cfg)`` unchanged
    when the config is already supported."""
    if supports_config(cfg.units, cfg.activation):
        return params, cfg
    if not fusable_config(cfg.units, cfg.activation):
        raise ValueError(
            f"fused kernel cannot pad units={cfg.units} "
            f"activation={cfg.activation!r} into its envelope (activation must "
            f"be one of {_KERNEL_ACTIVATIONS}, at most {MAX_HIDDEN + 1} hidden layers)"
        )
    H = max(-(-u // LANE) * LANE for u in cfg.units)
    layers = params["layers"]
    padded = []
    for i, lyr in enumerate(layers):
        w, b = lyr["w"], lyr["b"]
        pad_in = H - w.shape[0] if i > 0 else 0
        pad_out = H - w.shape[1] if i < len(layers) - 1 else 0
        padded.append({"w": F.pad(w, (0, pad_out, 0, pad_in)), "b": F.pad(b, (0, pad_out))})
    return {**params, "layers": padded}, dataclasses.replace(cfg, units=(H,) * len(cfg.units))


def flops_per_row(d_in: int, d_out: int, H: int, n_layers: int, mode: str) -> int:
    """Kernel flops per row: 2 H (D_in + (n_hidden - 1) H + D) per chain,
    1 + n_applies chains (the JAX package's kernels/fused_mlp.py:922-934);
    ``n_layers`` counts every weight layer."""
    n_applies = {"forward": 0, "hutchinson": 1, "exact": d_out}[mode]
    return 2 * H * (d_in + (n_layers - 2) * H + d_out) * (1 + n_applies)


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


def fused_drift_reference(
    params, cfg, t, x, conditional=None, e=None, exact_divergence=False, c0=0.0, c1=1.0
):
    """The plain PyTorch version of :func:`fused_drift`, all three modes:
    the net through ``apply_score_mlp`` and its Jacobian through
    ``torch.func.jvp``, with TF32 off (compute mode ``float32``)."""
    if e is not None and exact_divergence:
        raise ValueError("pass a probe e OR exact_divergence, not both")
    with strict_fp32_matmul():
        return _reference(params, cfg, t, x, conditional, e, exact_divergence, c0, c1)


def _reference(params, cfg, t, x, conditional, e, exact_divergence, c0, c1):
    def net(xx):
        return apply_score_mlp(cfg, params, t, xx, conditional)

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
    if compute_dtype != "float32":
        raise NotImplementedError(
            f"kernel compute dtype {compute_dtype!r} is not ported to "
            "flowfusion_torch yet (ROADMAP.md queue 2: the 3xTF32 'highf32' "
            "and 'bfloat16' counterparts of items 1-3); use 'float32'"
        )
    if e is not None and exact_divergence:
        raise ValueError("pass a probe e OR exact_divergence, not both")
    _check_conditional(cfg.n_conditionals, conditional)
    params, cfg = pad_to_lanes(params, cfg)
    mode = "hutchinson" if e is not None else ("exact" if exact_divergence else "forward")
    # the envelope holds on every device, as the JAX interpret mode's does
    _plan(cfg.units[0], mode, cfg.n_dimensions + cfg.n_conditionals, cfg.n_dimensions)
    if not x.is_cuda:
        return fused_drift_reference(
            params, cfg, t, x, conditional, e, exact_divergence, c0, c1
        )
    with strict_fp32_matmul():
        w_in, b_eff = _score_first_layer(params, cfg, t, conditional)
    x_in = x if conditional is None else torch.cat([x, conditional], dim=-1)
    c0c1 = torch.stack([
        torch.as_tensor(c, dtype=torch.float32, device=x.device).reshape(()) for c in (c0, c1)
    ])
    drift, div = _launch(
        x_in.contiguous(), None if e is None else e.contiguous(), w_in, b_eff, params["layers"], c0c1, mode,
        cfg.n_dimensions, cfg.activation,
    )
    return drift if mode == "forward" else (drift, div)


fused_drift.launches = 0
fused_drift.launches_by_mode = dict.fromkeys(_MODES, 0)


def reset_launch_counts() -> None:
    """Zero ``fused_drift.launches`` and its per-mode split."""
    fused_drift.launches = 0
    fused_drift.launches_by_mode = dict.fromkeys(_MODES, 0)


def _chains(mode: str, d_out: int) -> int:
    """Chains a block carries: the primal, plus 1 (hutchinson) or D (exact)
    tangents."""
    return {"forward": 1, "hutchinson": 2, "exact": 1 + d_out}[mode]


def _smem_bytes(rows: int, H: int, chains: int, d_in: int, d_out: int) -> int:
    """Shared memory of one block, in the kernel's layout: the double
    buffer of chains x rows x H floats, then the (rows, d_in) input tile
    and the (rows, d_out) probe tile."""
    return 4 * (2 * chains * rows * H + rows * (d_in + d_out))


def _rows_per_block(H: int, chains: int, d_in: int, d_out: int) -> Optional[int]:
    """Rows a block owns: the most (<= 64) whose shared memory lets two
    blocks share an SM, else 4 rows in one block; None when not even
    that fits."""
    for rows in (64, 32, 16, 8, 4):
        if _smem_bytes(rows, H, chains, d_in, d_out) <= _SMEM_LIMIT // 2:
            return rows
    if _smem_bytes(4, H, chains, d_in, d_out) <= _SMEM_LIMIT:
        return 4
    return None


def _plan(H: int, mode: str, d_in: int, d_out: int):
    """``(rows, smem_bytes)`` of the launch, or raise when the
    shared-memory plan does not fit (the JAX package's vmem_width_clamp
    analogue)."""
    chains = _chains(mode, d_out)
    rows = _rows_per_block(H, chains, d_in, d_out)
    if rows is None:
        raise ValueError(
            f"fused kernel shared-memory plan does not fit: {chains} chains of width "
            f"H={H} need {_smem_bytes(4, H, chains, d_in, d_out)} bytes at 4 rows a "
            f"block (limit {_SMEM_LIMIT}); use trace_mode='hutchinson' instead of "
            "exact trace, a narrower net, or use_fused_kernel=False"
        )
    return rows, _smem_bytes(rows, H, chains, d_in, d_out)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    fn = lib.ff_fused_mlp
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        pp = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = [p, p, p, p, pp, pp, i, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_size_t, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x_in, e, w_in, b_eff, layers, c0c1, mode, d_out, activation):
    """Check the operands, allocate the outputs and launch the kernel on
    the current stream.  Raises on anything the kernel does not take."""
    B, d_in = x_in.shape
    H = b_eff.shape[0]
    hidden = layers[1:-1]
    w_out, b_out = layers[-1]["w"], layers[-1]["b"]
    expect = [
        (x_in, (B, d_in)), (w_in, (d_in, H)), (b_eff, (H,)), (w_out, (H, d_out)),
        (b_out, (d_out,)), (c0c1, (2,)),
    ]
    expect += [(l["w"], (H, H)) for l in hidden] + [(l["b"], (H,)) for l in hidden]
    if mode == "hutchinson":
        expect.append((e, (B, d_out)))
    device = same_device(*(t for t, _ in expect))
    for tensor, shape in expect:
        if not tensor.is_cuda or tensor.dtype != torch.float32:
            raise ValueError(f"fused kernel takes float32 CUDA tensors; got {tensor.dtype} on {tensor.device}")
        if tuple(tensor.shape) != shape:
            raise ValueError(f"fused kernel operand of shape {tuple(tensor.shape)}; expected {shape}")
        if not tensor.is_contiguous():
            raise ValueError("fused kernel operands must be contiguous")
    if len(hidden) > MAX_HIDDEN or H % LANE:
        raise ValueError(f"fused kernel takes <= {MAX_HIDDEN} hidden layers of a width in multiples of {LANE}")
    if any(l["w"].data_ptr() % 16 for l in hidden):
        raise ValueError("fused kernel reads hidden weights as float4: they must be 16-byte aligned")
    rows, smem = _plan(H, mode, d_in, d_out)

    drift = torch.empty((B, d_out), dtype=torch.float32, device=device)
    div = None if mode == "forward" else torch.empty((B,), dtype=torch.float32, device=device)
    if B == 0:
        return drift, div
    lib = _kernel_lib()
    n = len(hidden)
    w_ptrs = (ctypes.c_void_p * max(n, 1))(*[l["w"].data_ptr() for l in hidden])
    b_ptrs = (ctypes.c_void_p * max(n, 1))(*[l["b"].data_ptr() for l in hidden])
    err = lib.ff_fused_mlp(
        x_in.data_ptr(), e.data_ptr() if mode == "hutchinson" else None,
        w_in.data_ptr(), b_eff.data_ptr(), w_ptrs, b_ptrs, n,
        w_out.data_ptr(), b_out.data_ptr(), c0c1.data_ptr(), drift.data_ptr(),
        None if div is None else div.data_ptr(),
        B, d_in, d_out, H, _MODES.index(mode), _KERNEL_ACTIVATIONS.index(activation),
        rows, smem, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed with CUDA error {err}")
    fused_drift.launches += 1
    fused_drift.launches_by_mode[mode] += 1
    return drift, div
