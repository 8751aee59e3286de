"""The whole reverse-SDE Euler--Maruyama sampling loop in one launch.

Counterpart of the JAX package's ``kernels/em_sampler.py::fused_em_sample``
at compute mode ``float32`` (``highf32`` maps to it, as in the JAX
package) and ``bfloat16`` (the JAX package's fast serving mode: the
weights bf16, each activation rounded to bf16 before its product, fp32
sums, the tanh-form SiLU; ``fused_mlp.bf16_matmul`` says where the JAX
kernel rounds).  On CUDA tensors the wrapper launches the hand-written kernel
``csrc/em_sampler.cu`` or raises; on CPU tensors it runs the plain PyTorch
version, :func:`fused_em_sample_reference`.

For the uniform grid t_s = T + s dt (dt = -(T - epsilon)/steps),
``em_prep`` computes on the device, TF32 off:

  coeffs[s] = (1 + c0(t_s) dt,  c1(t_s) dt,  g(t_s) sqrt|dt|)
  b_eff[s]  = b1 + temb(t_s) W1[:E]

with c1 = -g^2 [/sigma] the reverse drift's net coefficient.  Each step:
``x_mean = coeffs[s,0] x + coeffs[s,1] net(x)``, ``x = x_mean + coeffs[s,2] z``.

Noise: streamed (``noise`` of shape (steps, B, D), the parity mode) or,
by default, Philox4x32-10 in the kernel: key = the 64-bit seed, counter =
(global row, step, feature block of 4, 0), four words -> two Box--Muller
pairs -> four normals.  The stream depends only on (seed, row, step,
feature): not on the block size, the grid or B.  :func:`philox_normals`
computes the same numbers with integer tensor arithmetic on any device.

Freeze granularity: a block of R rows (R from :func:`em_plan`, 64 for
the flagship net) stops at its last finite state when any of its real
rows goes non-finite, and ``diverged`` is the OR of the blocks' flags.
The JAX kernel freezes per 2048-row grid tile and the scan path
(``ops.integrate.euler_maruyama``) the whole batch; the granularity
changes only which rows keep updating after a NaN, never ``diverged``.
The plain version freezes per tile of the same R rows.  Rows are
independent until a NaN, so on a finite run the plan moves no output.

Sigmoid is the exp form 1/(1 + exp(-a)) in the kernel and the plain
version alike in ``float32`` (the JAX kernel uses the tanh form; the two
differ by ~1e-7 relative), the tanh form in ``bfloat16``.

A launch's plan, :func:`em_plan`, is ``(rows, smem_bytes)``: the most
blocks an SM (at most ``EM_BLOCKS``, the kernel's launch bounds) at the
most rows that reach them, in the kernel's padded layout;
:func:`em_occupancy` asks the card what it makes of a plan.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import strict_fp32_matmul
from ..models.nets import _ACTIVATIONS, fourier_time_embedding
from . import _build
from .fused_mlp import (
    _KERNEL_ACTIVATIONS,
    _SMEM_LIMIT,
    PAD,
    RANK1_MAX,
    _check_conditional,
    _pick_rows,
    _tanh_silu,
    bf16_matmul,
    bf16_round,
    blocks_per_sm,
    check_operands,
    pad_to_lanes,
)

__all__ = [
    "em_prep",
    "em_plan",
    "em_plan_blocks",
    "em_occupancy",
    "trig_mismatches",
    "philox_normals",
    "fused_em_sample",
    "fused_em_sample_reference",
    "em_bytes",
    "em_flops",
    "reset_launch_counts",
]

EM_BLOCKS = 2  # blocks an SM the kernel's launch bounds allow (csrc kMinBlocks)
EM_DTYPES = ("float32", "bfloat16")  # index = the kernel's precision
_MASK = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the 64-bit product of the 32-bit constant ``m``
    and the 32-bit values in int64 ``b``, from 16-bit limbs of ``b`` (a
    full 32 x 32 product would overflow int64)."""
    lo_part = m * (b & 0xFFFF)  # < 2^48
    hi_part = m * (b >> 16)  # < 2^48
    mid = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (mid >> 32), mid & _MASK


def philox4x32_10(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Salmon et al., SC'11): ``counter`` is four int64
    tensors of 32-bit values (broadcastable), ``key`` two Python ints.
    Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK, (k1 + _PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _box_muller(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two N(0, 1) float32 normals from two words, as the kernel computes
    them: uniforms from the top 24 bits, u1 + 1e-12 so log never sees 0."""
    u1 = (a >> 8).to(torch.float32) * 2.0**-24 + 1e-12
    u2 = (b >> 8).to(torch.float32) * 2.0**-24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = 6.283185307179586 * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2^64); got {seed}")
    return seed


def philox_normals(seed: int, steps: int, B: int, D: int, device=None) -> torch.Tensor:
    """The kernel's in-kernel noise, (steps, B, D) float32, computed with
    integer tensor arithmetic on ``device`` (default CPU)."""
    seed = _check_seed(seed)
    nfb = -(-D // 4)
    kw = dict(dtype=torch.int64, device=device)
    step = torch.arange(steps, **kw)[:, None, None]
    row = torch.arange(B, **kw)[None, :, None]
    fb = torch.arange(nfb, **kw)[None, None, :]
    shape = (steps, B, nfb)
    w = philox4x32_10(
        (row.expand(shape), step.expand(shape), fb.expand(shape), torch.zeros(shape, **kw)),
        (seed & _MASK, seed >> 32),
    )
    z = torch.stack([*_box_muller(w[0], w[1]), *_box_muller(w[2], w[3])], dim=-1)
    return z.reshape(steps, B, 4 * nfb)[..., :D].contiguous()


def em_prep(params: dict, cfg, sde, steps: int, no_sigma: bool):
    """Per-step tables on the parameters' device: ``coeffs`` (steps, 3) =
    (1 + c0 dt, c1 dt, g sqrt|dt|) and ``b_eff`` (steps, H) = b1 +
    temb(t_s) W1[:E], in float32 with TF32 off."""
    w1 = params["layers"][0]["w"]
    dt = -(sde.T - sde.epsilon) / steps
    ts = sde.T + dt * torch.arange(steps, dtype=torch.float32, device=w1.device)
    c0 = sde.drift_coefficient(ts)
    g2 = sde.diffusion_squared_scalar(ts)
    c1 = -g2  # reverse drift: f - g^2 s
    if not no_sigma:
        c1 = c1 / sde.sigma(ts)
    coeffs = torch.stack([1.0 + c0 * dt, c1 * dt, torch.sqrt(g2) * math.sqrt(abs(dt))], dim=1)
    E = cfg.embedding_dimensions
    with strict_fp32_matmul():
        b_eff = params["layers"][0]["b"][None, :] + fourier_time_embedding(ts, params["W"]) @ w1[:E]
    return coeffs.contiguous(), b_eff.contiguous()


def em_bytes(B: int, steps: int, D: int, H: int, n_layers: int, with_cond: bool = False,
             compute_dtype: str = "float32") -> int:
    """Bytes one sampling run must move: x0 read and x_mean and x written
    (4 a value), the per-step tables (3 + H floats a step), the conditional
    projection where there is one, and the weights once, 4 bytes a value
    in ``float32`` and 2 in ``bfloat16`` (hidden and output; w_in and the
    biases stay float32)."""
    n_hidden = n_layers - 2
    wbytes = 2 if compute_dtype == "bfloat16" else 4
    weights = wbytes * (n_hidden * H * H + H * D) + 4 * (D * H + n_hidden * H + D)
    return 4 * (3 * B * D + steps * (3 + H) + (B * H if with_cond else 0)) + weights


def em_flops(B: int, steps: int, D: int, H: int, n_layers: int) -> int:
    """Flops of one sampling run, the JAX kernel's cost estimate: per row
    and step 2 H (D + (n_layers - 2) H + D); ``n_layers`` counts every
    weight layer."""
    return B * steps * 2 * H * (D + (n_layers - 2) * H + D)


def _smem_bytes(rows: int, H: int, D: int, with_cond: bool, pad: int = PAD) -> int:
    """Shared memory of one block, in the kernel's layout: two layer
    buffers of rows x (H + ``pad``) floats, the (rows, H) conditional
    projection where there is one, then two halves each of x and x_mean,
    (rows, D) each."""
    return 4 * (2 * rows * (H + pad) + (rows * H if with_cond else 0) + 4 * rows * D)


def em_plan(H: int, D: int, with_cond: bool, rows: Optional[int] = None) -> Tuple[int, int]:
    """``(rows, smem_bytes)`` of a launch: the most blocks an SM holds (at
    most ``EM_BLOCKS``, counted with the 1 KB each block reserves), at the
    most rows that reach them, in the padded layout (rows H + 4 floats
    apart); the widest nets, where not even 4 padded rows fit, take 4 rows
    at the unpadded stride H.  ``rows`` forces a plan: a multiple of 4 up
    to 256 whose block fits (padded where it can be).  Raises when nothing
    fits."""
    def smem(r: int, pad: int = PAD) -> int:
        return _smem_bytes(r, H, D, with_cond, pad)

    if rows is None:
        picked = _pick_rows(smem, EM_BLOCKS)
        if picked is not None:
            return picked[0], smem(picked[0])
        if smem(4, 0) <= _SMEM_LIMIT:
            return 4, smem(4, 0)
        raise ValueError(
            f"EM kernel shared-memory plan does not fit: H={H}, D={D} need "
            f"{smem(4, 0)} bytes at 4 rows a block (limit {_SMEM_LIMIT})"
        )
    if rows % 4 or not 4 <= rows <= 256 or smem(rows, 0) > _SMEM_LIMIT:
        raise ValueError(f"EM kernel plan of {rows} rows: a multiple of 4 up to 256 whose block fits")
    return rows, smem(rows) if smem(rows) <= _SMEM_LIMIT else smem(rows, 0)


def em_plan_blocks(plan) -> int:
    """Blocks of ``plan`` an SM holds by its shared memory and the launch
    bounds (:func:`em_occupancy` asks the card)."""
    return min(EM_BLOCKS, blocks_per_sm(plan[1]))


def _em_dtype(compute_dtype: str) -> str:
    """The EM kernel's mode of a compute dtype: 'highf32' maps to
    'float32' (the JAX package's ``_em_weight_dtype``), 'bfloat16' is its
    own."""
    if compute_dtype not in ("float32", "highf32", "bfloat16"):
        raise ValueError(f"unknown compute dtype {compute_dtype!r}")
    return "bfloat16" if compute_dtype == "bfloat16" else "float32"


def _prepare(params, cfg, sde, conditional, steps, no_sigma):
    """``(w_in, cond_proj, coeffs, b_eff)``: the [x] rows of the first
    layer, the step-independent conditional projection cond W1[E+D:] (or
    None) and the per-step tables."""
    coeffs, b_eff = em_prep(params, cfg, sde, steps, no_sigma)
    E, D = cfg.embedding_dimensions, cfg.n_dimensions
    w1 = params["layers"][0]["w"]
    cond_proj = None
    if conditional is not None:
        with strict_fp32_matmul():
            cond_proj = (conditional @ w1[E + D :]).contiguous()
    return w1[E : E + D].contiguous(), cond_proj, coeffs, b_eff


def _padded_rows(t: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to ``rows`` entries."""
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, rows - t.shape[dim]]
    return F.pad(t, pad)


def fused_em_sample_reference(
    params: dict,
    cfg,
    sde,
    x0: torch.Tensor,
    noise: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    steps: int = 100,
    no_sigma: bool = False,
    rows: Optional[int] = None,
    compute_dtype: str = "float32",
):
    """The plain PyTorch version of :func:`fused_em_sample` with streamed
    ``noise`` (steps, B, D): the same loop over whole-batch tensor ops,
    TF32 off, freezing per tile of the kernel's R rows (``em_plan``'s, or
    ``rows``); in ``bfloat16`` every product through
    ``fused_mlp.bf16_matmul`` (the input layer's D rows rounded only past
    ``RANK1_MAX`` features, as the JAX kernel's ``in_proj_rows``) and the
    tanh-form SiLU.  Returns ``(x_mean, x, diverged)``."""
    bf16 = _em_dtype(compute_dtype) == "bfloat16"
    _check_conditional(cfg.n_conditionals, conditional)
    params, cfg = pad_to_lanes(params, cfg)
    B, D = x0.shape
    if tuple(noise.shape) != (steps, B, D):
        raise ValueError(f"noise of shape {tuple(noise.shape)}; expected {(steps, B, D)}")
    tile = em_plan(cfg.units[0], D, conditional is not None, rows)[0]
    w_in, cond_proj, coeffs, b_eff = _prepare(params, cfg, sde, conditional, steps, no_sigma)
    act = _tanh_silu if bf16 and cfg.activation == "silu" else _ACTIVATIONS[cfg.activation]
    mm = (lambda a, w: bf16_matmul(a, w)) if bf16 else torch.matmul
    in_mm = (lambda a, w: bf16_matmul(a, w, D > RANK1_MAX)) if bf16 else torch.matmul
    layers = params["layers"]
    n_tiles = -(-B // tile)
    n = n_tiles * tile
    x = _padded_rows(x0, n, 0)
    z_all = _padded_rows(noise, n, 1)
    cp = None if cond_proj is None else _padded_rows(cond_proj, n, 0)
    real = (torch.arange(n, device=x0.device) < B).reshape(n_tiles, tile, 1)
    x_mean = x
    ok = torch.ones(n_tiles, dtype=torch.bool, device=x0.device)
    with strict_fp32_matmul():
        for s in range(steps):
            h = in_mm(x, w_in) + b_eff[s]
            if cp is not None:
                h = h + cp
            for lyr in layers[1:-1]:
                h = mm(act(h), lyr["w"]) + lyr["b"]
            net = mm(act(h), layers[-1]["w"]) + layers[-1]["b"]
            new_mean = coeffs[s, 0] * x + coeffs[s, 1] * net
            new_x = new_mean + coeffs[s, 2] * z_all[s]
            finite = (torch.isfinite(new_x).reshape(n_tiles, tile, D) | ~real).reshape(n_tiles, -1)
            keep = (ok & finite.all(dim=1))[:, None, None]
            x = torch.where(keep, new_x.reshape(n_tiles, tile, D), x.reshape(n_tiles, tile, D)).reshape(n, D)
            x_mean = torch.where(
                keep, new_mean.reshape(n_tiles, tile, D), x_mean.reshape(n_tiles, tile, D)
            ).reshape(n, D)
            ok = keep.reshape(n_tiles)
    return x_mean[:B], x[:B], ~ok.all()


def fused_em_sample(
    params: dict,
    cfg,
    sde,
    x0: torch.Tensor,
    seed: Optional[int] = None,
    conditional: Optional[torch.Tensor] = None,
    steps: int = 100,
    no_sigma: bool = False,
    noise: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
):
    """Run the whole EM loop from prior samples ``x0``; returns
    ``(x_mean, x, diverged)`` with ``diverged`` a 0-d bool tensor.

    ``conditional`` (already standardized) enters as one precomputed
    first-layer projection.  Noise is Philox keyed by ``seed`` (0 <= seed
    < 2^64) unless ``noise`` (steps, B, D) is streamed.  CUDA tensors
    launch the kernel (``fused_em_sample.launches`` counts launches,
    ``launches_by_dtype`` splits them by the kernel's mode); CPU tensors
    run :func:`fused_em_sample_reference` on the same noise
    (:func:`philox_normals` when seeded).  ``compute_dtype`` 'highf32'
    runs 'float32'.
    """
    dtype = _em_dtype(compute_dtype)
    if (seed is None) == (noise is None):
        raise ValueError("pass a seed (in-kernel Philox noise) OR streamed noise, not both")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    _check_conditional(cfg.n_conditionals, conditional)
    params, cfg = pad_to_lanes(params, cfg)
    B, D = x0.shape
    rows, smem = em_plan(cfg.units[0], D, conditional is not None)
    if not x0.is_cuda:
        if noise is None:
            noise = philox_normals(seed, steps, B, D, x0.device)
        return fused_em_sample_reference(params, cfg, sde, x0, noise, conditional, steps, no_sigma,
                                         compute_dtype=dtype)
    w_in, cond_proj, coeffs, b_eff = _prepare(params, cfg, sde, conditional, steps, no_sigma)
    return _launch(
        x0.contiguous(), None if noise is None else noise.contiguous(),
        0 if seed is None else _check_seed(seed), cond_proj, coeffs, b_eff, w_in,
        params["layers"], cfg.activation, steps, rows, smem, dtype,
    )


def reset_launch_counts() -> None:
    """Zero ``fused_em_sample.launches`` and its split by mode."""
    fused_em_sample.launches = 0
    fused_em_sample.launches_by_dtype = dict.fromkeys(EM_DTYPES, 0)


reset_launch_counts()


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("em_sampler")
    fn = lib.ff_em_sample
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        pp = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = [
            p, p, ctypes.c_uint64, p, p, p, p, pp, pp, i, p, p, p, p, p,
            i, i, i, i, i, i, i, ctypes.c_size_t, p,
        ]
        fn.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ff_em_occupancy.argtypes = [i, ctypes.c_size_t, ip, ip, ip]
        lib.ff_em_occupancy.restype = ctypes.c_int
        lib.ff_em_trig_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ff_em_trig_check.restype = ctypes.c_int
        lib.ff_em_min_blocks.argtypes = []
        lib.ff_em_min_blocks.restype = ctypes.c_int
        if lib.ff_em_min_blocks() != EM_BLOCKS:
            raise RuntimeError(f"em_sampler.cu's launch bounds hold {lib.ff_em_min_blocks()} blocks an SM; "
                               f"the wrapper plans for {EM_BLOCKS}")
    return lib


def trig_mismatches(device) -> int:
    """On the CUDA ``device``: how many of the 2^24 Box--Muller angles the
    kernel's written-out sincos gives other bits than ``sincosf`` for
    (0: the in-kernel noise is sincosf's)."""
    count = torch.zeros((), dtype=torch.int32, device=device)
    err = _kernel_lib().ff_em_trig_check(count.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"em_sampler trig check launch failed with CUDA error {err}")
    return int(count)


def em_occupancy(plan, compute_dtype: str = "float32") -> dict:
    """What the card makes of ``plan`` (from :func:`em_plan`) in
    ``compute_dtype``: resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local-memory bytes a thread of the kernel's instantiation."""
    rows, smem = plan
    blocks, regs, local_bytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _kernel_lib().ff_em_occupancy(EM_DTYPES.index(_em_dtype(compute_dtype)), smem, blocks, regs,
                                        local_bytes)
    if err != 0:
        raise RuntimeError(f"em_sampler occupancy query failed with CUDA error {err}")
    return dict(rows=rows, smem_bytes=smem, blocks_per_sm=blocks.value, registers=regs.value,
                local_bytes=local_bytes.value)


def _launch(x0, noise, seed, cond_proj, coeffs, b_eff, w_in, layers, activation, steps, rows, smem,
            compute_dtype="float32"):
    """Check the operands, allocate the outputs and launch the kernel on
    the current stream in ``compute_dtype`` ('float32' or 'bfloat16': the
    weights converted here, once a call: ``w_in`` rounded to bf16 in
    float32, the hidden and output weights as bf16 in their layouts).
    Raises on anything the kernel does not take."""
    B, D = x0.shape
    H = b_eff.shape[1]
    hidden = layers[1:-1]
    w_out, b_out = layers[-1]["w"], layers[-1]["b"]
    expect = [
        (x0, (B, D)), (coeffs, (steps, 3)), (b_eff, (steps, H)), (w_in, (D, H)),
        (w_out, (H, D)), (b_out, (D,)),
    ]
    expect += [(l["w"], (H, H)) for l in hidden] + [(l["b"], (H,)) for l in hidden]
    if noise is not None:
        expect.append((noise, (steps, B, D)))
    if cond_proj is not None:
        expect.append((cond_proj, (B, H)))
    device = check_operands(expect, hidden, H, "EM kernel")

    x_mean = torch.empty((B, D), dtype=torch.float32, device=device)
    x = torch.empty((B, D), dtype=torch.float32, device=device)
    if B == 0:
        return x_mean, x, torch.zeros((), dtype=torch.bool, device=device)
    flags = torch.empty((-(-B // rows),), dtype=torch.int32, device=device)
    lib = _kernel_lib()
    n = len(hidden)
    hidden_w = [l["w"] for l in hidden]
    if compute_dtype == "bfloat16":
        w_in, w_out = bf16_round(w_in), w_out.to(torch.bfloat16).contiguous()
        hidden_w = [w.to(torch.bfloat16).contiguous() for w in hidden_w]
    w_ptrs = (ctypes.c_void_p * max(n, 1))(*[w.data_ptr() for w in hidden_w])
    b_ptrs = (ctypes.c_void_p * max(n, 1))(*[l["b"].data_ptr() for l in hidden])
    err = lib.ff_em_sample(
        x0.data_ptr(), None if noise is None else noise.data_ptr(), seed,
        None if cond_proj is None else cond_proj.data_ptr(), coeffs.data_ptr(),
        b_eff.data_ptr(), w_in.data_ptr(), w_ptrs, b_ptrs, n, w_out.data_ptr(),
        b_out.data_ptr(), x_mean.data_ptr(), x.data_ptr(), flags.data_ptr(),
        B, D, H, steps, _KERNEL_ACTIVATIONS.index(activation), EM_DTYPES.index(compute_dtype), rows, smem,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"em_sampler kernel launch failed with CUDA error {err}")
    fused_em_sample.launches += 1
    fused_em_sample.launches_by_dtype[compute_dtype] += 1
    return x_mean, x, flags.any()
