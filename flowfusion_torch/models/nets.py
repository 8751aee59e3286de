"""Score network as a config dataclass plus a plain dict of tensors.

Counterpart of the JAX package's ``models/nets.py`` for the score MLP (the
velocity and symplectic nets are ROADMAP.md queue 1, items 10-11).  The
parameters keep the JAX tree and layouts, so weights carry over one for
one (``utils.convert.params_from_numpy``):

  ``{"W": (E/2,), "layers": [{"w": (in, out), "b": (out,)}, ...]}``

with the net input ordered ``[t_embedding | x | conditional]``.  ``W`` is
the frozen Gaussian-Fourier embedding (sampled once at init).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device

__all__ = [
    "ScoreMLPConfig",
    "init_score_mlp",
    "apply_score_mlp",
    "fourier_time_embedding",
]

_ACTIVATIONS = {
    "silu": F.silu,
    "relu": F.relu,
    # exact (erf) form, as the JAX package and torch.nn.GELU's default
    "gelu": F.gelu,
    "tanh": torch.tanh,
}


def _validate_net_config(activation, embedding_dimensions):
    if activation not in _ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; use one of {sorted(_ACTIVATIONS)}"
        )
    if embedding_dimensions % 2:
        raise ValueError(
            f"embedding_dimensions must be even (sin/cos pairs); got "
            f"{embedding_dimensions}"
        )


def fourier_time_embedding(t: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """concat([sin(2 pi t W), cos(2 pi t W)]); ``t`` (B,), ``W`` (E/2,) -> (B, E)."""
    proj = t[:, None] * W[None, :] * (2.0 * math.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


@dataclasses.dataclass(frozen=True)
class ScoreMLPConfig:
    """Architecture of the score network (the JAX package's defaults,
    including ``n_conditionals=0``)."""

    n_dimensions: int = 2
    n_conditionals: int = 0
    embedding_dimensions: int = 8
    units: Tuple[int, ...] = (128,)
    activation: str = "silu"
    sigma_initialization: float = 16.0

    def __post_init__(self):
        object.__setattr__(self, "units", tuple(self.units))
        _validate_net_config(self.activation, self.embedding_dimensions)

    @property
    def architecture(self) -> Tuple[int, ...]:
        return (
            self.n_dimensions + self.n_conditionals + self.embedding_dimensions,
            *self.units,
            self.n_dimensions,
        )

    def apply(self, params, t, x, conditional=None) -> torch.Tensor:
        """Alias for :func:`apply_score_mlp`."""
        return apply_score_mlp(self, params, t, x, conditional)


def init_score_mlp(
    cfg: ScoreMLPConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    dtype=torch.float32,
) -> dict:
    """Fresh parameters: frozen Fourier ``W`` ~ N(0, sigma_init^2) and
    torch.nn.Linear's default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) layers,
    drawn from ``generator`` on its own device, then moved to ``device``."""
    dev = resolve_device(device)
    gen_dev = generator.device if generator is not None else None

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=gen_dev)
        return (2.0 * u - 1.0) * bound

    W = torch.randn(
        (cfg.embedding_dimensions // 2,), generator=generator, dtype=dtype, device=gen_dev
    ) * cfg.sigma_initialization
    sizes = cfg.architecture
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = 1.0 / math.sqrt(fan_in)
        layers.append({
            "w": uniform((fan_in, fan_out), bound).to(dev),
            "b": uniform((fan_out,), bound).to(dev),
        })
    return {"W": W.to(dev), "layers": layers}


def _expand_t(t, batch: int, like: torch.Tensor) -> torch.Tensor:
    """Scalar or (B,) time as a (B,) tensor of ``like``'s dtype/device."""
    t = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    if t.ndim == 0:
        return t.expand(batch)
    return t


def apply_score_mlp(
    cfg: ScoreMLPConfig,
    params: dict,
    t,
    x: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """net(t, x, cond) with input concat([t_emb, x, cond])."""
    act = _ACTIVATIONS[cfg.activation]
    if conditional is not None:
        x = torch.cat([x, conditional], dim=-1)
    t_emb = fourier_time_embedding(_expand_t(t, x.shape[0], x), params["W"])
    h = torch.cat([t_emb, x], dim=-1)
    layers = params["layers"]
    for i, layer in enumerate(layers):
        h = h @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            h = act(h)
    return h
